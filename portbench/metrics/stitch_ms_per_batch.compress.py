"""Host milliseconds per batch in the span ``gzp.compress.stitch``: the
stitch of a batch's blocks (fallback checks, slicing, the sink's write),
its combine taken out (see ``span_ms.py``)."""

from pathlib import Path

from portbench.harness import load_module

_per_batch = load_module(Path(__file__).with_name("span_ms.py")).per_batch


def read(s: dict) -> float | None:
    return _per_batch(s, "compress", "gzp.compress.stitch")
