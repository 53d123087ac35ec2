"""Host milliseconds per batch in the span ``gzp.decompress.stage``: a pool
thread staging a device batch: footers, rows, copies to the device,
issuing K11 and the CRC (see ``span_ms.py``)."""

from pathlib import Path

from portbench.harness import load_module

_per_batch = load_module(Path(__file__).with_name("span_ms.py")).per_batch


def read(s: dict) -> float | None:
    return _per_batch(s, "decompress", "gzp.decompress.stage")
