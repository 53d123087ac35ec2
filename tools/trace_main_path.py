#!/usr/bin/env python3
"""Trace gzp_tpu_torch's main path on one CUDA card with torch.profiler.

    python3 tools/trace_main_path.py [--level 3] [--batches 8] [--out chiprun_out/trace.json]

Compresses ``batches`` × 64 blocks of 128 KiB of bench text through
``ZBuilder(Mgzip).num_threads(64).compression_level(level)`` on ``cuda:0``
(after one warm-up batch) under ``torch.profiler``, then prints one JSON
line: wall time, the device's busy and idle share of it (union of kernel,
copy and memset intervals in the trace), device operations per batch,
the kernels with the most device time, and the device time per batch of
each of this package's kernels (by function name, ``<library>_kernel``).
Exits non-zero without a card or when the trace holds no device activity.
"""

from __future__ import annotations

import argparse
import io
import json
import re
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

B, N = 64, 131072


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, default=3)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out/trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_main_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the repo root
    from chip_smoke import make_corpus  # bench.py's text generator, seed 1234
    from gzp_tpu_torch import Mgzip, ZBuilder
    from gzp_tpu_torch.ops import lz_cuda, pack_cuda  # noqa: F401  (registers the kernels)
    from gzp_tpu_torch.runtime import cuda_lib

    data = make_corpus(B * N * args.batches)

    def compress(blob: bytes) -> bytes:
        buf = io.BytesIO()
        w = ZBuilder(Mgzip).num_threads(B).compression_level(args.level).from_writer(buf)
        w.write(blob)
        w.finish()
        return buf.getvalue()

    compress(data[: B * N])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        compress(data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(args.out)
    with open(args.out) as f:
        events = json.load(f)["traceEvents"]

    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not device:
        print("trace_main_path: the trace holds no device activity", file=sys.stderr)
        return 1
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    per_name: dict[str, list] = defaultdict(lambda: [0, 0.0])
    for e in device:
        per_name[e["name"]][0] += 1
        per_name[e["name"]][1] += float(e["dur"])
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]
    kernels = [e for e in device if e["cat"] == "kernel"]
    ours = {}
    for lib in cuda_lib.registered():
        pattern = re.compile(rf"\b{lib.name}_kernel\b")
        durs = [float(e["dur"]) for e in kernels if pattern.search(e["name"])]
        if durs:
            ours[lib.name] = {"count": len(durs) / args.batches,
                              "ms": sum(durs) / 1e3 / args.batches}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "level": args.level,
        "batches": args.batches,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / wall_us,
        "kernels_per_batch": len(kernels) / args.batches,
        "device_ops_per_batch": len(device) / args.batches,
        "top_device_ms": {name[:90]: {"count": c, "ms": d / 1e3} for name, (c, d) in top},
        "package_kernels_per_batch": ours,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
