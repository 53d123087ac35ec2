"""The traced span of a run: torch.profiler over a fixed number of
batches, reduced to the summary that ``portbench/metrics/*.py`` read and
to the result line's ``breakdown``.

The reduction follows the repository's ``tools/trace_main_path.py``: the
device is busy in the union of its kernel, copy and memset intervals, and
a package kernel is a device kernel named ``<library>_kernel``.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME = ("cuda_runtime", "cuda_driver")
SPAN = "portbench.span"
# CUDA runtime calls in which the calling thread waits for the device: the
# synchronises, and copies (a copy to pageable host memory returns when done)
WAITS = re.compile(r"Synchronize|^cudaMemcpy")
TOP = 10
NAME_CHARS = 120  # a device operation's name in the breakdown: its C++ signature cut short


def profile(fn) -> list[dict]:
    """Run ``fn`` under torch.profiler inside the range ``SPAN`` (ended by
    a device synchronise) and return the trace's events. The trace goes
    through a temporary file under ``TMPDIR``, deleted at once."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(SPAN):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _short(name: str) -> str:
    return name.removeprefix("void ")[:NAME_CHARS]


def _merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events: list[dict], package: list[str], batches: int,
              marks: tuple[str, ...] = ("write", "finish", "read")) -> dict:
    """The span's summary (seconds): ``window_s``, ``busy_s`` (union of
    device intervals), ``wait_s`` (the span's thread inside CUDA runtime
    calls that wait on the device), ``device_ops``, ``batches``, each
    package kernel's ``launches`` and ``device_s``, and ``breakdown``: the
    device operations with the most time and the longest idle gaps, each
    named by the harness range (``marks``) and the runtime call the host
    was in."""
    span = next(e for e in events if e.get("name") == SPAN and e.get("ph") == "X"
                and e.get("cat") == "user_annotation")
    t0, t1, tid = float(span["ts"]), float(span["ts"]) + float(span["dur"]), span["tid"]

    def clip(e):
        s, d = float(e["ts"]), float(e.get("dur", 0))
        return max(s, t0), min(s + d, t1)

    device = [e for e in events if e.get("cat") in DEVICE and "dur" in e]
    device = [e for e in device if clip(e)[1] > clip(e)[0]]
    busy = _merge([clip(e) for e in device])
    per_name: dict[str, float] = defaultdict(float)
    for e in device:
        per_name[e["name"]] += float(e["dur"])
    kernels = {}
    for lib in package:
        pat = re.compile(rf"\b{re.escape(lib)}_kernel\b")
        durs = [float(e["dur"]) for e in device if e["cat"] == "kernel" and pat.search(e["name"])]
        kernels[lib] = {"launches": len(durs), "device_s": sum(durs) / 1e6}
    runtime = [e for e in events if e.get("cat") in RUNTIME and "dur" in e]
    wait = sum(max(0.0, b - a) for a, b in (clip(e) for e in runtime
               if e["tid"] == tid and WAITS.search(e["name"])))
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") in marks
              and e["tid"] == tid]

    def doing(t: float) -> str:
        mark = next((e["name"] for e in ranges
                     if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])), "harness")
        calls = [e for e in runtime if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
        calls.sort(key=lambda e: e["tid"] != tid)  # the span's thread first
        return f"{mark}/{calls[0]['name'] if calls else 'host'}"

    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    gaps = [(b - a, (a + b) / 2) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(reverse=True)
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "wait_s": wait / 1e6,
        "device_ops": len(device),
        "batches": batches,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[_short(n), d / 1e6] for n, d in top_ops],
            "idle_gaps": [[doing(mid), g / 1e6] for g, mid in gaps[:TOP]],
        },
    }
