"""Host milliseconds per batch in the span ``gzp.compress.combine``: the
combine of the blocks' checks into the stream's, pigz's COMB (see
``span_ms.py``)."""

from pathlib import Path

from portbench.harness import load_module

_per_batch = load_module(Path(__file__).with_name("span_ms.py")).per_batch


def read(s: dict) -> float | None:
    return _per_batch(s, "compress", "gzp.compress.combine")
