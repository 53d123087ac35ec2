"""The Snappy encoder's spans and the stored-block counter on the CPU: the
four encoder spans (``gzp.encode.match``, ``.entries``, ``.pack``,
``.finish``) once a batch under ``torch.profiler`` and never without one;
``parallel.compress.stored_stats`` counting the blocks the writer emits
and those ``_maybe_fallback`` rewrites stored (uncompressed Snappy chunks,
a stored Deflate member), only while a profiler records."""

import gzip
import io
import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gzp_tpu_torch
from gzp_tpu_torch.parallel import compress
from gzp_tpu_torch.runtime import telemetry
from gzp_tpu_torch.utils.snappy_ref import decode_frames

BS = 65536  # Snappy's largest block
THREADS = 2
SNAPPY_SPANS = ["gzp.encode.match", "gzp.encode.entries", "gzp.encode.pack",
                "gzp.encode.finish"]
PIPELINE_SPANS = ["gzp.compress.dispatch", "gzp.compress.fetch", "gzp.compress.stitch",
                  "gzp.compress.combine"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counts():
    telemetry.reset()
    compress.reset_stored_stats()
    yield
    telemetry.reset()
    compress.reset_stored_stats()


def _text(n, seed=0):
    rng = random.Random(seed)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ",
             b"pack my box with five dozen liquor jugs ", b"0123456789" * 3, b"\n"]
    out = [rng.choice(words) for _ in range(n // 8 + 1)]
    return b"".join(out)[:n]


def _write(fmt, data):
    buf = io.BytesIO()
    w = gzp_tpu_torch.ParCompress(getattr(gzp_tpu_torch, fmt), buf, num_threads=THREADS,
                                  buffer_size=BS, device="cpu")
    w.write(data)
    w.finish()
    return buf.getvalue()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_snappy_spans_once_a_batch():
    data = _text(THREADS * BS + 5000, 5)  # a full batch and a tail batch
    out = _profiled(lambda: _write("Snap", data))
    assert decode_frames(out) == data
    t = telemetry.totals()
    assert sorted(t) == sorted(SNAPPY_SPANS + PIPELINE_SPANS)
    for name in SNAPPY_SPANS + PIPELINE_SPANS:
        assert t[name]["count"] == 2, name
        assert 0 <= t[name]["self_s"] <= t[name]["total_s"], name
    # the encoder's stages run inside the batch's dispatch
    stages = sum(t[n]["total_s"] for n in SNAPPY_SPANS)
    dispatch = t["gzp.compress.dispatch"]
    assert dispatch["self_s"] == pytest.approx(dispatch["total_s"] - stages, abs=1e-6)
    assert compress.stored_stats == {"blocks": 3, "stored": 0}


def test_no_spans_and_no_counts_without_a_profiler():
    data = _text(BS + 100, 6)
    assert decode_frames(_write("Snap", data)) == data
    r = random.Random(7).randbytes(70_000)
    assert decode_frames(_write("Snap", r)) == r
    assert gzip.decompress(_write("Mgzip", r)) == r
    assert telemetry.totals() == {}
    assert compress.stored_stats == {"blocks": 0, "stored": 0}


def test_stored_counts_uncompressed_snappy_chunks():
    r = random.Random(8).randbytes(70_000)  # two blocks that compression expands
    out = _profiled(lambda: _write("Snap", r))
    assert decode_frames(out) == r
    assert out[10] == 0x01 and out[18 + BS + 10] == 0x01  # both chunks uncompressed
    assert compress.stored_stats == {"blocks": 2, "stored": 2}


def test_stored_counts_a_stored_deflate_member():
    r = random.Random(9).randbytes(40_000)  # one member, stored
    text = _text(40_000, 10)  # and one compressed
    out = _profiled(lambda: _write("Mgzip", r))
    assert gzip.decompress(out) == r
    assert compress.stored_stats == {"blocks": 1, "stored": 1}
    compress.reset_stored_stats()
    out = _profiled(lambda: _write("Mgzip", text))
    assert gzip.decompress(out) == text
    assert compress.stored_stats == {"blocks": 1, "stored": 0}
