"""Host milliseconds per batch of one program span: the self time (its
duration less its child spans') that ``gzp_tpu_torch.runtime.telemetry``
recorded under the span's name, over the traced span's batches.

The program's spans record only while a torch profiler records, and in a
run of the benchmark the profiler records only inside ``trace.profile``:
the span that ``host_ms_per_batch.compress`` also divides by its batches.
The write driver's warm-up and the read driver's warm-up run unprofiled,
and so does the window the read cell reads after its traced pass, so the
totals cover exactly the traced span. A program without the telemetry
module, or a span that was not recorded, gives None."""


def per_batch(s: dict, direction: str, span: str) -> float | None:
    if s.get("direction") != direction or not s.get("batches"):
        return None
    try:
        from gzp_tpu_torch.runtime import telemetry
    except ImportError:
        return None
    t = telemetry.totals().get(span)
    if not t or not t["count"]:
        return None
    return t["self_s"] / s["batches"] * 1e3
