#!/usr/bin/env python3
"""Where the pack pre-scan K10's time goes, tile by tile, on a card.

    python3 tools/probe_lookback.py [--runs 3]

Builds ``tools/probe_lookback.cu`` (``csrc/pack_prescan.cu`` with its
probe points filled in) into its own library under ``gzp_tpu_torch/_build``
(the package never loads it), runs it on level 3's bit entries of the main
paths' batch (``time_kernels.batch`` and ``time_kernels.level3_entries``),
holds its outputs against ``pack_prescan_plain`` (exact), and reads what
thread 0 of every tile wrote: the clock64() cycles of each phase (loads
and width sum, width look-back, OR sum with the keys' stores, OR
look-back, the values' stores) and each look-back's polls (reloads of a
status word not yet published, plus windows walked past). Prints one JSON
line with the median, 90th percentile and maximum per phase in cycles,
the share of tiles that polled, and the kernel's time (CUDA events, the
last of ``--runs`` launches). Exits non-zero without a card or on a
mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

TOOLS = Path(__file__).resolve().parent
PROBE_WORDS = 8  # as in probe_lookback.cu: 6 clock stamps, 2 poll counts
PHASES = ("load_width_sum", "width_look_back", "or_sum_keys", "or_look_back", "values")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_lookback: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(TOOLS.parent))
    sys.path.insert(0, str(TOOLS))
    from time_kernels import batch, level3_entries

    from gzp_tpu_torch.ops import pack_cuda
    from gzp_tpu_torch.runtime import cuda_lib

    lib_path = cuda_lib.BUILD_DIR / "pack_prescan_probe.so"
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib_path),
                    str(TOOLS / "probe_lookback.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gzp_pack_prescan
    fn.argtypes = pack_cuda.PACK_PRESCAN.argtypes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.gzp_probe_set.argtypes = [ctypes.c_void_p]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    (bits, nbits, base_bits), _ = level3_entries(*batch(dev))
    b, e = bits.shape
    ep = pack_cuda.prescan_len(e)
    want = pack_cuda.pack_prescan_plain(bits, nbits, base_bits)

    tiles, words = pack_cuda.prescan_plan(b, e)
    key = torch.empty((b, ep), dtype=torch.int32, device=dev)
    val = torch.empty_like(key)
    total = torch.empty((b,), dtype=torch.int32, device=dev)
    scratch = torch.empty((words,), dtype=torch.int64, device=dev)
    probe = torch.zeros((b * tiles, PROBE_WORDS), dtype=torch.int64, device=dev)
    if lib.gzp_probe_set(probe.data_ptr()):
        raise RuntimeError("gzp_probe_set failed")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(args.runs):
        start.record()
        err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (bits, nbits, key, val, total,
                                                           scratch)),
                 b, e, ep, base_bits, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        stop.record()
        if err:
            raise RuntimeError(f"gzp_pack_prescan (probe build): CUDA error {err}")
        torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip((key, val, total), want)):
        raise AssertionError("the probe build disagrees with the plain version")
    p = probe.cpu().numpy()
    cycles = np.diff(p[:, :6], axis=1)
    row = {"tile": pack_cuda.PACK_TILE, "threads": pack_cuda.PACK_TILE // 8, "ctas": b * tiles,
           "smi": smi, "kernel_ms": start.elapsed_time(stop)}
    for i, name in enumerate(PHASES):
        x = cycles[:, i]
        row[name] = {"median": float(np.median(x)), "p90": float(np.percentile(x, 90)),
                     "max": int(x.max())}
    total_cycles = cycles.sum(1)
    row["cta_cycles"] = {"median": float(np.median(total_cycles)),
                         "p90": float(np.percentile(total_cycles, 90))}
    for i, name in ((6, "width_polls"), (7, "or_polls")):
        x = p[:, i]
        row[name] = {"tiles_that_polled": float((x > 0).mean()), "median": float(np.median(x)),
                     "max": int(x.max())}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
