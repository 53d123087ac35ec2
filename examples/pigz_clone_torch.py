#!/usr/bin/env python
"""stdin -> stdout parallel gzip on a CUDA card, the reference's
examples/test1.rs (a minimal pigz clone), on gzp_tpu_torch.

    python examples/pigz_clone_torch.py < file > file.gz
    python examples/pigz_clone_torch.py --format bgzf --level 6 --threads 64 < f > f.bgzf
    python examples/pigz_clone_torch.py --device cpu < file > file.gz

Runs on ``cuda:0`` unless given ``--device``; with no CUDA device it exits
non-zero unless given ``--device cpu``.
"""

import argparse
import os
import sys

try:
    from gzp_tpu_torch import ALL_FORMATS, ZBuilder
except ImportError:  # source checkout without `pip install -e .`
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gzp_tpu_torch import ALL_FORMATS, ZBuilder
from gzp_tpu_torch.parallel.mesh import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--format", default="gzip", choices=sorted(ALL_FORMATS))
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--level", type=int, default=3)
    ap.add_argument("--device", default="cuda:0", help="a torch device (default cuda:0)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"pigz_clone_torch: {e}")

    fmt = ALL_FORMATS[args.format]
    writer = (
        ZBuilder(fmt)
        .num_threads(args.threads)
        .compression_level(args.level)
        .device(device)
        .from_writer(sys.stdout.buffer)
    )
    while True:
        chunk = sys.stdin.buffer.read(1 << 20)
        if not chunk:
            break
        writer.write(chunk)
    writer.finish()


if __name__ == "__main__":
    main()
