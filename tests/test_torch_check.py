"""The port's CRC combine against the JAX package's and against the CRC of
the concatenation itself.

``crc32_combine`` and ``crc32c_combine`` build the shift operator for a
length once and keep it in a cache; these tests hold every value to the
reference's matrix-squaring combine (``gzp_tpu.check``) and, where the
bytes fit in memory, to ``zlib.crc32`` or the reference's CRC-32C of the
whole. ``combine_stats`` must count one operator built per distinct length,
alone and inside a Gzip stream. Tolerance: exact equality everywhere.
"""

import gzip
import io
import os
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

import gzp_tpu_torch
from gzp_tpu import check as ref
from gzp_tpu_torch import check

BLOCK = 131072

COMBINES = {
    "crc32": (check.crc32_combine, ref.crc32_combine, zlib.crc32),
    "crc32c": (check.crc32c_combine, ref.crc32c_combine, ref.crc32c),
}


def _crc(whole_fn, data):
    return whole_fn(data) & 0xFFFFFFFF


def _cold():
    """Zero the counts and drop the cached operators."""
    check.reset_combine_stats()
    check._shift_tables.cache_clear()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", list(COMBINES))
def test_combine_random_split_equals_whole(kind, seed):
    port, reference, whole = COMBINES[kind]
    rng = np.random.default_rng(seed)
    data = rng.bytes(int(rng.integers(1, 6000)))
    for cut in rng.integers(0, len(data) + 1, size=8).tolist():
        a, b = data[:cut], data[cut:]
        got = port(_crc(whole, a), _crc(whole, b), len(b))
        assert got == reference(_crc(whole, a), _crc(whole, b), len(b))
        assert got == _crc(whole, data)


@pytest.mark.parametrize("length", [0, 1, 65280, BLOCK])
@pytest.mark.parametrize("kind", list(COMBINES))
def test_combine_length_equals_whole(kind, length):
    port, reference, whole = COMBINES[kind]
    rng = np.random.default_rng(length)
    a, b = rng.bytes(777), rng.bytes(length)
    got = port(_crc(whole, a), _crc(whole, b), length)
    assert got == reference(_crc(whole, a), _crc(whole, b), length)
    assert got == _crc(whole, a + b)


@pytest.mark.parametrize("length", [2**32 + 5, 2**33 + 12345], ids=["2^32+5", "2^33+12345"])
@pytest.mark.parametrize("kind", list(COMBINES))
def test_combine_past_four_gib_equals_reference(kind, length):
    """Lengths past 2^32 stay exact (a multi-host stitch passes them as
    given); too long to hash, so held to the reference alone."""
    port, reference, _ = COMBINES[kind]
    rng = np.random.default_rng(length % 1000)
    for crc1, crc2 in rng.integers(0, 2**32, size=(4, 2)).tolist():
        assert port(crc1, crc2, length) == reference(crc1, crc2, length)


@pytest.mark.parametrize("tail", [1, 4097, BLOCK - 1])
def test_crc32_combine_sum_folds_a_stream(tail):
    """64 full blocks and a ragged tail folded block by block, as the
    stream writer's stitch does, equal the CRC32 of the whole."""
    rng = np.random.default_rng(tail)
    data = rng.bytes(64 * BLOCK + tail)
    run = check.Crc32()
    for start in range(0, len(data), BLOCK):
        piece = data[start:start + BLOCK]
        run.combine_sum(zlib.crc32(piece), len(piece))
    assert run.sum() == zlib.crc32(data)
    assert run.amount() == len(data) & 0xFFFFFFFF


def test_combine_stats_counts_one_operator_per_length():
    _cold()
    crc = 0
    for i in range(64):
        crc = check.crc32_combine(crc, i, BLOCK)
    check.crc32_combine(crc, 7, 12345)
    assert check.combine_stats == {"combined": 65, "operators_built": 2}
    check.reset_combine_stats()
    assert check.combine_stats == {"combined": 0, "operators_built": 0}
    check.crc32_combine(crc, 7, BLOCK)  # a reset keeps the cached operators
    assert check.combine_stats == {"combined": 1, "operators_built": 0}


def test_combine_stats_counts_every_combine_across_threads():
    """Writers on many threads share the counts: none is lost."""
    threads, per_thread = 2 * (os.cpu_count() or 1) + 2, 300
    want = check.crc32_combine(0x12345678, 0x9ABCDEF0, BLOCK)
    wrong = []

    def work():
        for _ in range(per_thread):
            if check.crc32_combine(0x12345678, 0x9ABCDEF0, BLOCK) != want:
                wrong.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _cold()
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert not wrong
    assert check.combine_stats["combined"] == threads * per_thread
    assert 1 <= check.combine_stats["operators_built"] <= threads


def test_gzip_stream_builds_one_operator_per_block_length():
    bs = 32768
    data = np.random.default_rng(5).bytes(5 * bs + 1234)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _cold()
        buf = io.BytesIO()
        w = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Gzip).num_threads(2).buffer_size(bs)
             .device("cpu").from_writer(buf))
        w.write(data)
        w.finish()
    finally:
        torch.set_num_threads(n)
    out = buf.getvalue()
    assert gzip.decompress(out) == data
    assert int.from_bytes(out[-8:-4], "little") == zlib.crc32(data)
    assert check.combine_stats["combined"] >= 6
    assert 1 <= check.combine_stats["operators_built"] <= 2
