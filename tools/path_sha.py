#!/usr/bin/env python3
"""sha256 of the streams one checkout of gzp_tpu_torch writes on a card.

    python3 tools/path_sha.py [--root DIR] [--mib 256] [--paths mgzip6,gzip6]

Imports ``gzp_tpu_torch`` from ``--root`` (default: this repository), so
two checkouts can be compared in one call on one card (parent, change).
Compresses ``--mib`` MiB of bench text (``chip_smoke.make_corpus``, seed
1234) with that checkout's ``ZBuilder`` at 64 threads on ``cuda:0``, once
per path (a format and a level: ``mgzip6`` is Mgzip at level 6, ``gzip3``
Gzip at level 3; formats mgzip, bgzf, gzip, zlib, deflate, snappy), and
prints one JSON line: each path's sha256, bytes and ratio. Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
FORMATS = {"mgzip": "Mgzip", "bgzf": "Bgzf", "gzip": "Gzip", "zlib": "Zlib",
           "deflate": "RawDeflate", "snappy": "Snap"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--paths", default="mgzip6,gzip6")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("path_sha: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import gzp_tpu_torch

    if Path(gzp_tpu_torch.__file__).resolve().parents[1] != root:
        raise AssertionError(f"imported {gzp_tpu_torch.__file__}, not from {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    corpus = smoke.make_corpus(args.mib << 20)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "mib": args.mib}
    for path in args.paths.split(","):
        fmt, level = re.fullmatch(r"([a-z]+)(\d)", path).groups()
        buf = io.BytesIO()
        w = (gzp_tpu_torch.ZBuilder(getattr(gzp_tpu_torch, FORMATS[fmt])).num_threads(64)
             .compression_level(int(level)).from_writer(buf))
        w.write(corpus)
        w.finish()
        blob = buf.getvalue()
        out[path] = {"sha256": hashlib.sha256(blob).hexdigest(), "bytes": len(blob),
                     "ratio": len(corpus) / len(blob)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
