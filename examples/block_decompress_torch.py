#!/usr/bin/env python
"""Parallel block decompression of an Mgzip/BGZF stream on gzp_tpu_torch,
mirroring the reference's decompression examples (examples/test3.rs /
snap_decode.rs).

    python examples/block_decompress_torch.py --format bgzf < f.bgzf > f
    python examples/block_decompress_torch.py --backend device < f.bgzf > f

The default backend is the native host codec and uses no device;
``--backend device`` inflates on ``--device`` (default ``cuda:0``) and
exits non-zero where there is no CUDA device, unless given ``--device cpu``.
"""

import argparse
import os
import sys

try:
    from gzp_tpu_torch import Bgzf, Mgzip, ParDecompress, ParDecompressBuilder
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gzp_tpu_torch import Bgzf, Mgzip, ParDecompress, ParDecompressBuilder


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", default="bgzf", choices=["bgzf", "mgzip"])
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--backend", default="native", choices=["native", "device"])
    ap.add_argument("--device", default="cuda:0",
                    help="the device of --backend device (default cuda:0)")
    args = ap.parse_args(argv)

    fmt = Bgzf if args.format == "bgzf" else Mgzip
    if args.backend == "device":
        try:
            reader = ParDecompress(fmt, sys.stdin.buffer, num_threads=args.threads,
                                   backend="device", device=args.device)
        except RuntimeError as e:
            sys.exit(f"block_decompress_torch: {e}")
    else:
        reader = ParDecompressBuilder(fmt).num_threads(args.threads).from_reader(
            sys.stdin.buffer
        )
    while True:
        chunk = reader.read(1 << 20)
        if not chunk:
            break
        sys.stdout.buffer.write(chunk)
    reader.close()


if __name__ == "__main__":
    main()
