"""The reader of ``graphed_share.compress``: 100 x replayed / (replayed +
eager) of the program's ``graph_stats``, None on the read path, with no
encoder call, and where the program has no such counter; and the cell
``mgzip-l3.text`` traced on the CPU at a size a test can hold, where every
encoder call is eager (the share reads 0)."""

import sys

import pytest

from portbench import harness
from portbench import run as runner

COMPRESS = {"direction": "compress"}


def _read(s):
    return harness.plugin("metrics", "graphed_share.compress").read(s)


@pytest.fixture
def stats():
    from gzp_tpu_torch.ops import graphs

    graphs.reset_graph_stats()
    yield graphs.graph_stats
    graphs.reset_graph_stats()


def test_share_of_replays(stats):
    stats.update(captured=1, replayed=3, eager=1)
    assert _read(COMPRESS) == 75.0
    stats.update(eager=0)
    assert _read(COMPRESS) == 100.0


def test_none_without_calls_or_on_the_read_path(stats):
    assert _read(COMPRESS) is None
    stats.update(replayed=2)
    assert _read({"direction": "decompress"}) is None


def test_none_where_the_program_has_no_graphs(monkeypatch):
    monkeypatch.setitem(sys.modules, "gzp_tpu_torch.ops.graphs", None)  # import raises
    assert _read(COMPRESS) is None


def test_traced_cell_on_the_cpu_reads_every_call_eager(stats):
    cell = harness.load_cell("mgzip-l3.text")
    cell.config["rows"] = 2
    cell.traffic.update(corpus_bytes=1 << 19, warmup_batches=1, trace_batches=2,
                        keep_bytes=1 << 24)
    line = runner.run(runner.Ctx(cell, 2**31 + 2468, 0.5, True, "cpu", False))
    assert line["correct"]
    assert line["metrics"]["graphed_share.compress"] == {"value": 0.0, "unit": "%"}
    assert stats == {"captured": 0, "replayed": 0, "eager": 2}  # the two traced batches
