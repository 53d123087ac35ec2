#!/usr/bin/env python3
"""What the spans of ``gzp_tpu_torch.runtime.telemetry`` cost.

    python3 tools/span_cost.py [--n 200000]
    python3 tools/span_cost.py --device cuda:0 [--batches 8] [--pairs 4]

Without ``--device``: microseconds per ``with span(...)`` site on the CPU,
with no profiler recording (one flag read and the shared no-op context)
and inside ``torch.profiler.profile`` (the ``record_function`` range and
the table update), beside an empty ``with`` and a ``record_function``
entered with no profiler.

With ``--device``: the write path (Mgzip level 3, 64 blocks of 128 KiB a
batch) and the device read path (BGZF level 6 written by ``zlib``, 64
members a batch, 1 MiB reads) under ``torch.profiler`` (CPU and CUDA),
``--pairs`` times each with the spans on and with every span site given
the no-op context, in alternating order; wall milliseconds per batch of
each run and their medians. The difference is what the spans cost a
traced run.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import sys
import time
import zlib
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from gzp_tpu_torch.runtime import telemetry  # noqa: E402

ROWS, BLOCK, BGZF_BLOCK = 64, 131072, 65280
WORDS = b"the quick brown fox jumps over lazy dog to be or not to be that is the question".split()


def per_call_us(body, n: int) -> float:
    """The best of 5 timings of ``n`` calls, in microseconds per call."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        body(n)
        best = min(best, time.perf_counter_ns() - t0)
    return best / n / 1e3


def cpu_sites(n: int) -> dict:
    null = contextlib.nullcontext()

    def empty(k):
        for _ in range(k):
            with null:
                pass

    def site(k):
        for i in range(k):
            with telemetry.span("gzp.compress.fetch", i):
                pass

    def bare_range(k):
        for _ in range(k):
            with record_function("gzp.compress.fetch#0"):
                pass

    out = {"n": n, "empty_with_us": per_call_us(empty, n), "span_off_us": per_call_us(site, n),
           "record_function_no_profiler_us": per_call_us(bare_range, n)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on_us"] = per_call_us(site, max(n // 100, 100))
    telemetry.reset()
    return out


def text(nbytes: int, seed: int = 1) -> bytes:
    import numpy as np

    rng = np.random.default_rng(seed)
    words = [WORDS[i] + b" " for i in rng.integers(0, len(WORDS), nbytes // 3)]
    return b"".join(words)[:nbytes]


def bgzf(data: bytes) -> bytes:
    """``data`` as BGZF members written by ``zlib`` at level 6, and the
    EOF member."""
    import struct

    from gzp_tpu_torch.constants import BGZF_EOF

    out = []
    for i in range(0, len(data), BGZF_BLOCK):
        raw = data[i: i + BGZF_BLOCK]
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        p = c.compress(raw) + c.flush()
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
                   + struct.pack("<H", 18 + len(p) + 8 - 1) + p
                   + struct.pack("<II", zlib.crc32(raw), len(raw)))
    return b"".join(out) + BGZF_EOF


@contextlib.contextmanager
def spans_off():
    """Every span site of the port given the no-op context."""
    from gzp_tpu_torch.ops import deflate_kernel
    from gzp_tpu_torch.parallel import compress, decompress

    mods = (deflate_kernel, compress, decompress)
    saved = [m.span for m in mods]
    for m in mods:
        m.span = lambda *a, **k: telemetry.OFF
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.span = s


def card(device: str, batches: int, pairs: int) -> dict:
    import gzp_tpu_torch

    data = text(batches * ROWS * BLOCK)
    stream = bgzf(data[: batches * ROWS * BGZF_BLOCK])

    def write(n):
        w = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Mgzip).num_threads(ROWS).compression_level(3)
             .buffer_size(BLOCK).device(device).from_writer(io.BytesIO()))
        for off in range(0, n * ROWS * BLOCK, 65536):
            w.write(data[off: off + 65536])
        w.finish()

    def read(_n):
        r = gzp_tpu_torch.ParDecompress(gzp_tpu_torch.Bgzf, io.BytesIO(stream), num_threads=ROWS,
                                        backend="device", device=device)
        while r.read(1 << 20):
            pass
        r.close()

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    out = {}
    for path, fn in (("write", write), ("read", read)):
        fn(min(batches, 6))  # warm-up, unprofiled
        sync()
        ms = {"on": [], "off": []}
        for k in range(2 * pairs):
            on = (k % 4) in (0, 3)  # on, off, off, on, ...
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                with contextlib.nullcontext() if on else spans_off():
                    t0 = time.perf_counter()
                    fn(batches)
                    sync()
                    ms["on" if on else "off"].append((time.perf_counter() - t0) / batches * 1e3)
        telemetry.reset()
        out[path] = {**ms, "median_on_ms": statistics.median(ms["on"]),
                     "median_off_ms": statistics.median(ms["off"])}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--device")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args(argv)
    out = {"torch": torch.__version__}
    if args.device:
        out.update(card(args.device, args.batches, args.pairs))
    else:
        out.update(cpu_sites(args.n))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
