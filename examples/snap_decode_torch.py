"""Snappy frame decode: stdin -> stdout, on gzp_tpu_torch.

Mirror of the reference's examples/snap_decode.rs (snap FrameDecoder over
stdin copied to stdout), on the port's native-codec frame decoder. Host
only: no device.

Usage:
    python examples/pigz_clone_torch.py --format snappy < file > file.sz
    python examples/snap_decode_torch.py < file.sz > file.out
"""

import os
import shutil
import sys

try:
    from gzp_tpu_torch.formats.snap import SnappyFrameDecoder
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gzp_tpu_torch.formats.snap import SnappyFrameDecoder


def main(argv=None) -> None:
    del argv  # no flags
    rdr = SnappyFrameDecoder(sys.stdin.buffer)
    shutil.copyfileobj(rdr, sys.stdout.buffer)


if __name__ == "__main__":
    main()
