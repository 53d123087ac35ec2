"""pigz's default Gzip stream on the CPU: the port's level-6 stream held to
the size zlib reaches in pigz's layout (``utils/pigz_ref.py``), within the
benchmark's limit, which the port's level-5 route exceeds; the reference's
own layout; and ``parallel.compress.halo_stats``, which counts the rows
sent with a dictionary only while a profiler records."""

import io
import zlib

import pytest
from torch.profiler import ProfilerActivity, profile

import gzp_tpu_torch
from gzp_tpu_torch.constants import DICT_SIZE
from gzp_tpu_torch.parallel import compress
from gzp_tpu_torch.utils import pigz_ref
from portbench.corpus import text
from portbench.formats import pigz as bench_pigz

BLOCK = pigz_ref.BLOCK


@pytest.fixture(scope="module")
def data():
    return text.make(512 * 1024, 2**31 + 25)


def _port(data, level, rows=4, block=BLOCK):
    buf = io.BytesIO()
    w = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Gzip).num_threads(rows).compression_level(level)
         .buffer_size(block).device("cpu").from_writer(buf))
    w.write(data)
    w.finish()
    return buf.getvalue()


def test_level6_within_the_limit_of_zlibs_size_and_level5_over_it(data):
    limit = bench_pigz.LIMIT * pigz_ref.size(data, 6)
    six = _port(data, 6)
    assert zlib.decompress(six, 31) == data
    assert len(six) <= limit
    five = _port(data, 5)
    assert zlib.decompress(five, 31) == data
    assert len(five) > limit  # the limit tells the suffix matcher from the hash route


def test_reference_inflates_and_flushes_every_block(data):
    stream = pigz_ref.write(data, 6)
    assert zlib.decompress(stream, 31) == data
    assert len(stream) == pigz_ref.size(data, 6)
    bodies = pigz_ref.blocks(data, 6)
    assert len(bodies) == -(-len(data) // BLOCK)
    d = zlib.decompressobj(-15)
    got = 0
    for k, body in enumerate(bodies, 1):
        got += len(d.decompress(body))
        # a sync flush hands out every byte before it: the boundary
        assert got == min(k * BLOCK, len(data))
        assert d.eof == (k == len(bodies))
        assert body.endswith(pigz_ref.SYNC) == (k < len(bodies))


def test_reference_of_empty_and_short_input():
    for data in (b"", b"abc" * 100):
        stream = pigz_ref.write(data, 6)
        assert zlib.decompress(stream, 31) == data
        assert stream[:10] == pigz_ref.header(6)
        assert len(stream) == pigz_ref.size(data, 6)


@pytest.fixture
def halo_stats():
    compress.reset_halo_stats()
    yield compress.halo_stats
    compress.reset_halo_stats()


def _two_batches(data):
    """Three whole blocks and a short one at two rows a batch, 32 KiB
    blocks: a batch sent by ``write`` and one by ``finish``."""
    return _port(data[: 3 * DICT_SIZE + 1000], 3, rows=2, block=DICT_SIZE)


def test_halo_stats_count_nothing_without_a_profiler(data, halo_stats):
    assert zlib.decompress(_two_batches(data), 31) == data[: 3 * DICT_SIZE + 1000]
    assert halo_stats == {"blocks": 0, "block_bytes": 0, "dict_bytes": 0}


def test_halo_stats_count_each_rows_dictionary_under_a_profiler(data, halo_stats):
    with profile(activities=[ProfilerActivity.CPU]):
        out = _two_batches(data)
    assert zlib.decompress(out, 31) == data[: 3 * DICT_SIZE + 1000]
    # a fresh writer's first row has no dictionary; every later row the
    # 32 KiB before it
    assert halo_stats == {"blocks": 4, "block_bytes": 3 * DICT_SIZE + 1000,
                          "dict_bytes": 3 * DICT_SIZE}
