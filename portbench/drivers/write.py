"""The write driver: one stream through the port's writer, closed loop.

One producer writes ``write_bytes`` chunks of the seeded corpus, cycling
through it, to ``ZBuilder(<format>).num_threads(rows)
.compression_level(level).buffer_size(block).from_writer(sink)``. The
window runs from the first ``write`` until ``--seconds`` have passed and
then through ``finish()`` and a device synchronise: the drain counts. The
traced run writes ``trace_batches`` whole batches instead, under the
profiler. The plain reference then decodes the whole stream."""

from __future__ import annotations

import gc
import time

from portbench import harness, trace
from portbench.formats.members import Expected


def run(ctx) -> dict:
    import torch

    import gzp_tpu_torch
    from gzp_tpu_torch.runtime import cuda_lib
    from torch.profiler import record_function

    cfg, tr, fmt = ctx.cell.config, ctx.cell.traffic, ctx.cell.format
    rows, block, level = cfg["rows"], cfg["block_bytes"], cfg["level"]
    chunk = tr["write_bytes"]
    data = ctx.corpus()
    ring = memoryview(data + data[:chunk])

    def piece(off: int) -> memoryview:
        s = off % len(data)
        return ring[s: s + chunk]

    def writer(sink):
        if ctx.control:
            return fmt.control(sink, cfg)
        return (gzp_tpu_torch.ZBuilder(getattr(gzp_tpu_torch, fmt.PROGRAM)).num_threads(rows)
                .compression_level(level).buffer_size(block).device(ctx.device)
                .from_writer(sink))

    def feed(w, nbytes: int, off: int = 0, mark: bool = False) -> int:
        while off < nbytes:
            if mark:
                with record_function("write"):
                    w.write(piece(off))
            else:
                w.write(piece(off))
            off += chunk
        return off

    # warm-up: whole batches past the queue's depth, and a partial tail
    warm = writer(harness.NullSink())
    feed(warm, tr["warmup_batches"] * rows * block + block // 2)
    warm.finish()
    ctx.synchronize()
    del warm
    sink = harness.Sink(ctx.arena)
    w = writer(sink)
    sink.write(b"")  # waits for the arena's mapping: it belongs to set-up
    ctx.setup_done()

    out: dict = {}
    if ctx.trace:
        fed = []

        def span():
            fed.append(feed(w, tr["trace_batches"] * rows * block, mark=True))
            with record_function("finish"):
                w.finish()

        events = trace.profile(span)
        summary = trace.summarize(events, [k.name for k in cuda_lib.registered()],
                                  tr["trace_batches"])
        harness.kernel_bounds(summary, harness.shapes(cfg, fmt.HALO), ctx.cell.base)
        summary["direction"] = "compress"
        out["summary"] = summary
        written = fed[0]
    else:
        t0 = time.perf_counter()
        written = 0
        while time.perf_counter() - t0 < ctx.seconds:
            w.write(piece(written))
            written += chunk
        w.finish()
        ctx.synchronize()
        elapsed = time.perf_counter() - t0
        out["end_to_end"] = {"compress_GBps": written / elapsed / 1e9,
                             "out_per_in": sink.nbytes / written}
    out["memory_peak_bytes"] = ctx.memory_peak()
    del w
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    bad = fmt.check(sink.parts, Expected(data, written))
    out["compared"] = {k: (v, 0) for k, v in bad.items()}
    out["attempted"] = -(-written // block)
    out["failed"] = bad["frames_bad"] + bad["data_bad"] + bad["checks_bad"]
    return out
