"""The read driver: whole passes over one stream through the port's
reader.

Set-up writes the seeded corpus as the configuration's format with the
plain reference's own ``zlib`` writer (``block_bytes`` a member, on a host
pool), independent of the port's encoder. Each pass reads the stream back
through ``ParDecompress(<format>, reader, num_threads=rows,
backend=<backend>)`` in ``read_bytes`` reads until ``read`` returns
empty; passes repeat until ``--seconds`` have passed, and the window ends
with the last whole pass. The traced run first reads one pass over the
first ``trace_batches`` batches of members (the last of them the closing
member) under the profiler, then the same window unprofiled, so that the
routing (``fallback_stats``) is counted over the window's passes too.
Every read's bytes are compared with the corpus once the window has
closed."""

from __future__ import annotations

import io
import time

from portbench import harness, trace


def run(ctx) -> dict:
    import gzp_tpu_torch
    from gzp_tpu_torch.runtime import cuda_lib
    from torch.profiler import record_function

    cfg, tr, fmt = ctx.cell.config, ctx.cell.traffic, ctx.cell.format
    rows, block, level = cfg["rows"], cfg["block_bytes"], cfg["level"]
    size = tr["read_bytes"]
    data = ctx.corpus()
    members = fmt.write(data, level, block)
    stream = b"".join(members)
    eof = members[-1:] if fmt.FRAMING.eof else []
    batch = max(rows, 8)  # ParDecompress's device batch

    def prefix(batches: int) -> list[bytes]:
        """The members of the first ``batches`` device batches, the last
        of them the closing member."""
        return members[: batches * batch - len(eof)] + eof

    def reader(s: bytes):
        if ctx.control:
            return fmt.control_reader(s, cfg)
        return gzp_tpu_torch.ParDecompress(
            getattr(gzp_tpu_torch, fmt.PROGRAM), io.BytesIO(s), num_threads=rows,
            backend=tr["backend"], device=ctx.device)

    def one_pass(s: bytes, stats: dict, keep=None, mark: bool = False) -> list[int]:
        """Read ``s`` through; keep each read's bytes in ``keep`` and
        return their lengths."""
        r = reader(s)
        lens = []
        while True:
            if mark:
                with record_function("read"):
                    c = r.read(size)
            else:
                c = r.read(size)
            if not c:
                break
            if keep is not None:
                keep.keep(c)
            lens.append(len(c))
        r.close()
        for k, v in r.fallback_stats.items():
            stats[k] += v
        return lens

    one_pass(b"".join(prefix(tr["warmup_batches"])), {"device": 0, "native": 0})
    ctx.synchronize()
    arena = ctx.arena
    arena.keep(b"")  # waits for the mapping: it belongs to set-up
    ctx.setup_done()

    stats = {"device": 0, "native": 0}
    out: dict = {}
    passes: list[tuple[list[int], bytes]] = []  # each pass's read lengths, what it should read
    if ctx.trace:
        traced = prefix(tr["trace_batches"])
        s = b"".join(traced)
        expected = data[: (len(traced) - len(eof)) * block]
        events = trace.profile(
            lambda: passes.append((one_pass(s, stats, arena, mark=True), expected)))
        summary = trace.summarize(events, [k.name for k in cuda_lib.registered()],
                                  tr["trace_batches"])
        payload = sum(len(m) - fmt.FRAMING.header - 8 for m in traced)
        shape = {**harness.shapes(cfg, fmt.HALO), "rows": batch,
                 "inflate_in_bytes": payload / tr["trace_batches"]}
        harness.kernel_bounds(summary, shape, ctx.cell.base)
        summary["direction"] = "decompress"
        summary["fallback"] = stats  # the span's blocks and the window's, below
        out["summary"] = summary
    # the window: the traced run reads it too, for the routing over it
    kept0 = arena.nbytes
    t0 = time.perf_counter()
    while True:
        passes.append((one_pass(stream, stats, arena), data))
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.synchronize()
    elapsed = time.perf_counter() - t0
    if not ctx.trace:
        out["end_to_end"] = {"decompress_GBps": (arena.nbytes - kept0) / elapsed / 1e9}
    out["memory_peak_bytes"] = ctx.memory_peak()
    reads_bad = gap = reads = pos = 0
    for lens, expected in passes:
        off = 0
        for n in lens:
            reads_bad += arena.at(pos, n) != expected[off: off + n]
            off += n
            pos += n
        reads += len(lens)
        gap += abs(off - len(expected))
    out["compared"] = {"reads_bad": (reads_bad, 0), "length_gap": (gap, 0)}
    out["attempted"] = reads
    out["failed"] = reads_bad
    return out
