#!/usr/bin/env python3
"""Time the match tails K6 and K9 of one checkout of gzp_tpu_torch on a card.

    python3 tools/time_tails.py [--root DIR] [--tiles 2048,4096,8192] [--iters 20]

Imports ``gzp_tpu_torch`` from ``--root`` (default: this repository), so
two checkouts can be compared in one call on one card (parent, change,
change, parent). Makes the main paths' inputs at 64 blocks of 128 KiB of
bench text (``chip_smoke.make_corpus``, seed 1234) with that checkout's
own kernels: level 3's position-order candidates for K6, level 6's two
fields for K9. Holds each tail against its plain version (exact), then
times it with CUDA events, and reads the device memory one call allocates
beyond its inputs and outputs (peak minus the outputs). With ``--tiles``
and a checkout that has ``lz_cuda.TAIL_TILE``, it times each tile size.
Prints one JSON line. Exits non-zero without a card or on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
B, N = 64, 131072


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tiles", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_tails: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from gzp_tpu_torch.ops import lz_cuda
    from gzp_tpu_torch.runtime import cuda_lib

    if Path(lz_cuda.__file__).resolve().parents[2] != root:
        raise AssertionError(f"imported {lz_cuda.__file__}, not from {root}")
    sys.path.insert(1, str(HERE))
    from chip_smoke import make_corpus, time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cuda_lib.build()
    dev = torch.device("cuda", 0)
    text = np.frombuffer(make_corpus(B * N), np.uint8).reshape(B, N).copy()
    text[1] = 0
    text[2] = np.random.default_rng(7).integers(0, 256, N, dtype=np.uint8)
    data = torch.from_numpy(text).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    halo = torch.zeros((B,), dtype=torch.int32, device=dev)
    packed3 = lz_cuda.hash_pass(data, halo, payload_words=3, lags=2, max_dist=32768)
    packed_s = lz_cuda.suffix_pass(data, halo, payload_words=7, lags=16, suffix_keys=5,
                                   max_dist=32768)
    packed_h = lz_cuda.hash_pass(data, halo, payload_words=7, lags=2, max_dist=32768)
    tails = {
        "K6": (lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain,
               (data, packed3, lengths, halo), 12),
        "K9": (lz_cuda.match_tail2_cuda, lz_cuda.match_tail2_plain,
               (data, packed_h, packed_s, lengths, halo), 28),
    }
    tiles = [int(t) for t in args.tiles.split(",") if t]
    if tiles and not hasattr(lz_cuda, "TAIL_TILE"):
        tiles = []
    out = {"root": str(root), "device": torch.cuda.get_device_name(0), "smi": smi}
    for name, (kernel, plain, targs, pb) in tails.items():
        kw = dict(base=0, payload_bytes=pb, max_match=258, min_emit=3, lazy=True)
        row = {}
        for tile in tiles or [None]:
            if tile is not None:
                lz_cuda.TAIL_TILE = tile
            got = kernel(*targs, **kw)
            want = plain(*targs, **kw)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} at tile {tile} disagrees with its plain version")
            del got, want
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernel(*targs, **kw)
            torch.cuda.synchronize()
            scratch = torch.cuda.max_memory_allocated() - base - 2 * B * N * 4
            ms = time_ms(lambda: kernel(*targs, **kw), iters=args.iters, warmup=3)
            row[str(tile or "default")] = {"ms": ms, "scratch_bytes": scratch}
        out[name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
