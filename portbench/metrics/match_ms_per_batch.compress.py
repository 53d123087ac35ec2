"""Host milliseconds per batch in the span ``gzp.encode.match``: the host
issuing the match stage's device work (halo concat, the matcher's kernels
and sorts) (see ``span_ms.py``)."""

from pathlib import Path

from portbench.harness import load_module

_per_batch = load_module(Path(__file__).with_name("span_ms.py")).per_batch


def read(s: dict) -> float | None:
    return _per_batch(s, "compress", "gzp.encode.match")
