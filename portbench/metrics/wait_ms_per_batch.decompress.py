"""Host milliseconds per batch in the span ``gzp.decompress.wait``: the
reader waiting for a device batch's bytes (see ``span_ms.py``)."""

from pathlib import Path

from portbench.harness import load_module

_per_batch = load_module(Path(__file__).with_name("span_ms.py")).per_batch


def read(s: dict) -> float | None:
    return _per_batch(s, "decompress", "gzp.decompress.wait")
