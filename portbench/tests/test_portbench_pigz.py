"""pigz's default Gzip stream in the benchmark: ``formats/pigz.py`` counts
what ``formats/gzip.py`` counts and ``size_bad``, its reference on shares
of blocks equals it on one, its control fails; the reader of
``halo_share.compress``; and the cells ``gzip-l6.stream`` and
``bgzf-l6.fastq`` run on the CPU at a size a test can hold."""

import io
import json

import pytest

from portbench import harness
from portbench import run as runner
from portbench.corpus import text
from portbench.formats import gzip as gzip_ref
from portbench.formats import pigz
from portbench.formats.members import Expected

SOUND = {"frames_bad": 0, "data_bad": 0, "checks_bad": 0, "length_gap": 0, "size_bad": 0}
COMPRESS = {"direction": "compress"}


@pytest.fixture(scope="module")
def data():
    return text.make(600_000, 2**31 + 77)


def _reference(data, level=pigz.LEVEL, combine=True):
    sink = io.BytesIO()
    w = gzip_ref.Writer(sink, level, pigz.BLOCK, 2, combine=combine)
    for i in range(0, len(data), 65536):
        w.write(data[i: i + 65536])
    w.finish()
    return sink.getvalue()


def test_config_is_the_formats_deployment():
    cfg = json.loads((harness.HERE / "configs" / "pigz-gzip-l6.json").read_text())
    assert (cfg["format"], cfg["level"], cfg["block_bytes"]) == ("pigz", pigz.LEVEL, pigz.BLOCK)
    assert pigz.HALO == 32768 and pigz.PROGRAM == "Gzip"


def test_sound_reference_stream_counts_nothing(data):
    assert pigz.check([_reference(data)], Expected(data, len(data))) == SOUND


def test_control_is_larger_than_the_limit_and_its_check_wrong(data):
    sink = io.BytesIO()
    w = pigz.control(sink, {"block_bytes": pigz.BLOCK, "rows": 2})
    w.write(data)
    w.finish()
    bad = pigz.check([sink.getvalue()], Expected(data, len(data)))
    assert bad["size_bad"] == 1 and bad["checks_bad"] >= 1
    assert bad["frames_bad"] == bad["data_bad"] == bad["length_gap"] == 0


def test_a_port_stream_cut_short_is_bad_framing(data):
    import gzp_tpu_torch

    buf = io.BytesIO()
    w = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Gzip).num_threads(2).compression_level(pigz.LEVEL)
         .buffer_size(pigz.BLOCK).device("cpu").from_writer(buf))
    w.write(data[:300_000])
    w.finish()
    out = buf.getvalue()
    want = Expected(data, 300_000)
    assert pigz.check([out], want) == SOUND
    assert pigz.check([out[:-100]], want)["frames_bad"] >= 1


def test_reference_size_on_shares_equals_one_pass(data):
    one = sum(pigz.body_bytes(*s) for s in pigz._shares(data, pigz.BLOCK, 1))
    three = pigz._shares(data, pigz.BLOCK, 3)
    assert len(three) == 3
    assert sum(pigz.body_bytes(*s) for s in three) == one
    assert 18 + one == len(_reference(data))


def test_pool_and_inline_reference_agree(data, monkeypatch):
    """A window past ``POOL_MIN`` blocks sizes the reference on processes."""
    want = Expected(data, len(data))
    stream = _reference(data)
    inline = pigz.check([stream], want)
    monkeypatch.setattr(pigz, "POOL_MIN", 1)
    assert pigz.check([stream], want, procs=2) == inline == SOUND


def _halo(s):
    return harness.plugin("metrics", "halo_share.compress").read(s)


@pytest.fixture
def halo_stats():
    from gzp_tpu_torch.parallel import compress

    compress.reset_halo_stats()
    yield compress.halo_stats
    compress.reset_halo_stats()


def test_halo_share_reads_the_counter(halo_stats):
    assert _halo(COMPRESS) is None  # nothing counted
    halo_stats.update(blocks=4, block_bytes=4 * 131072, dict_bytes=131072)
    assert _halo(COMPRESS) == 20.0
    assert _halo({"direction": "decompress"}) is None


def test_halo_share_none_where_the_program_has_no_counter(monkeypatch):
    from gzp_tpu_torch.parallel import compress

    monkeypatch.delattr(compress, "halo_stats")  # as on the parent of the counter
    assert _halo(COMPRESS) is None


def _run(name, trace=False, control=False):
    cell = harness.load_cell(name)
    cell.config["rows"] = 2
    cell.traffic.update(corpus_bytes=1 << 20, warmup_batches=1, trace_batches=2,
                        keep_bytes=1 << 24)
    return runner.run(runner.Ctx(cell, 2**31 + 2525, 0.5, trace, "cpu", control))


@pytest.mark.parametrize("name", ["gzip-l6.stream", "bgzf-l6.fastq"])
def test_sound_run_of_a_new_cell_is_correct(name):
    line = _run(name)
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["compared"].values())
    assert ("size_bad" in line["compared"]) == (name == "gzip-l6.stream")


def test_control_of_the_stream_cell_is_not_correct():
    line = _run("gzip-l6.stream", control=True)
    assert not line["correct"]
    assert line["compared"]["size_bad"]["value"] == 1


def test_traced_stream_cell_reads_the_halo_share(halo_stats):
    line = _run("gzip-l6.stream", trace=True)
    assert line["correct"]
    # 2 batches of 2 rows of 131,072 bytes; all but the writer's first row
    # carry 32,768 bytes of dictionary
    assert line["metrics"]["halo_share.compress"]["value"] == pytest.approx(
        100 * 3 * 32768 / (3 * 32768 + 4 * 131072))
    assert halo_stats == {"blocks": 4, "block_bytes": 4 * 131072, "dict_bytes": 3 * 32768}
