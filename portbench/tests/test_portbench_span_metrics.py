"""The readers of the program's spans (``metrics/span_ms.py`` and the
``*_ms_per_batch.*`` files): None for the other direction and for a span
not recorded, and self milliseconds per batch from the telemetry's table."""

import json
import sys

import pytest

from portbench import harness

BENCH = json.loads(harness.BENCHMARK.read_text())
SPANS = {
    "dispatch_ms_per_batch.compress": "gzp.compress.dispatch",
    "match_ms_per_batch.compress": "gzp.encode.match",
    "parse_ms_per_batch.compress": "gzp.encode.parse",
    "entries_ms_per_batch.compress": "gzp.encode.entries",
    "pack_ms_per_batch.compress": "gzp.encode.pack",
    "finish_ms_per_batch.compress": "gzp.encode.finish",
    "fetch_ms_per_batch.compress": "gzp.compress.fetch",
    "stitch_ms_per_batch.compress": "gzp.compress.stitch",
    "combine_ms_per_batch.compress": "gzp.compress.combine",
    "scan_ms_per_batch.decompress": "gzp.decompress.scan",
    "stage_ms_per_batch.decompress": "gzp.decompress.stage",
    "gather_ms_per_batch.decompress": "gzp.decompress.gather",
    "wait_ms_per_batch.decompress": "gzp.decompress.wait",
}


def _direction(metric):
    return metric.rsplit(".", 1)[1]


@pytest.fixture
def table(monkeypatch):
    """The telemetry's table replaced by one the test fills."""
    from gzp_tpu_torch.runtime import telemetry

    t = {}
    monkeypatch.setattr(telemetry, "totals", lambda: {k: dict(v) for k, v in t.items()})
    return t


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_reader_gives_self_ms_per_batch(metric, table):
    read = harness.plugin("metrics", metric).read
    here = {"direction": _direction(metric), "batches": 16}
    assert read(here) is None  # not recorded
    table[SPANS[metric]] = {"count": 17, "total_s": 0.5, "self_s": 0.32}
    assert read(here) == pytest.approx(20.0)
    other = "decompress" if here["direction"] == "compress" else "compress"
    assert read({**here, "direction": other}) is None
    table[SPANS[metric]] = {"count": 0, "total_s": 0.0, "self_s": 0.0}
    assert read(here) is None


def test_every_span_metric_is_in_the_benchmark():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for metric in SPANS:
        m = entries[metric]
        assert (m["unit"], m["better"], m["source"]) == ("ms/batch", "lower", "program_counter")
        assert m["moves"] == f"{_direction(metric)}_GBps"


def test_reader_is_silent_on_a_program_without_spans(monkeypatch):
    """A checkout whose port has no telemetry module reads None."""
    from gzp_tpu_torch import runtime

    monkeypatch.delattr(runtime, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "gzp_tpu_torch.runtime.telemetry", None)
    for metric in SPANS:
        read = harness.plugin("metrics", metric).read
        assert read({"direction": _direction(metric), "batches": 16}) is None
