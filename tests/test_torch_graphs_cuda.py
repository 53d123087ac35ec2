"""The graphed encoder (``ops/graphs.py``) on the card, held against an
eager call of the same encoder on the same inputs: every output
(``out``, ``out_len``, ``check``, ``flat``) of Mgzip 3 and 6 (two
sub-blocks a 128 KiB block), BGZF 6, Gzip 3 and 6 with the halo, Zlib 3,
raw Deflate 3 and Snappy, on a batch with a short row, an empty final row
and padding rows; two replays of one graph with other inputs (no stale
static buffer, no output overwritten by the next replay); the launch
counts of a capture and of a replay against an eager call's;
``graph_stats`` (one capture, then replays only); and whole streams
written through the graph against the same writer run eagerly: a ragged
final batch, an empty closing block, a flush mid-stream, a mesh of
``[cuda:0, cuda:0]``, and two writers on two threads sharing one graph;
a 64 MiB Gzip level-6 stream at 64 rows (pigz's default) and its
``halo_stats`` under the profiler, graphed against eager.

Marked ``cuda``; without a CUDA device every test skips (decided in the
fixture, never at import). Run on the card with ``python -m pytest -m cuda
tests/test_torch_graphs_cuda.py``. Tolerance: exact equality.
"""

import io
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gzp_tpu_torch import Bgzf, Gzip, Mgzip, RawDeflate, Snap, ZBuilder, Zlib
from gzp_tpu_torch.ops import graphs
from gzp_tpu_torch.parallel import compress
from gzp_tpu_torch.parallel.compress import make_halo
from gzp_tpu_torch.runtime import cuda_lib

pytestmark = pytest.mark.cuda

B, N = 8, 131072

ENCODERS = [(Mgzip, 3), (Mgzip, 6), (Bgzf, 6), (Gzip, 3), (Gzip, 6), (Zlib, 3),
            (RawDeflate, 3), (Snap, 0)]


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = np.frombuffer(b"to be or not to be that is the question whether tis nobler ", np.uint8)
    starts = rng.integers(0, len(words) - 8, n // 8 + 1)
    return np.concatenate([words[s: s + 8] for s in starts])[:n]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _eager(encode, *inputs):
    return encode(*inputs)


def _batch(fmt, level, seed, dev, rows=B):
    """``(encode, inputs)``: a batch of ``rows`` blocks of the format's block
    size with a short row, an empty final row and padding rows after it,
    with the halo where the format carries one."""
    n = min(N, fmt.max_input_block or N)
    encode, dict_size = fmt.encoder(n, level, True)
    arr = _text(rows * n, seed).reshape(rows, n).copy()
    lengths = np.full(rows, n, np.int32)
    finals = np.zeros(rows, bool)
    lengths[1] = n - 999
    lengths[rows - 3:] = 0  # row rows-3 closes the stream, the rest pad
    finals[rows - 3] = True
    arr[lengths[:, None] <= np.arange(n)[None, :]] = 0
    halo, dict_lens = make_halo(arr, lengths, b"", dict_size)
    host = [arr, lengths, finals] + ([halo, dict_lens] if halo is not None else [])
    return encode, [torch.from_numpy(a).to(dev) for a in host]


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("fmt,level", ENCODERS,
                         ids=[f"{f.name}-{lv}" for f, lv in ENCODERS])
def test_graph_equals_eager(card, fmt, level):
    encode, inputs = _batch(fmt, level, 1, card)
    _same(graphs.run(encode, *inputs), encode(*inputs))


def test_replays_take_new_inputs_and_keep_old_outputs(card):
    encode, a = _batch(Gzip, 3, 2, card)
    _, b = _batch(Gzip, 3, 3, card)
    want_a, want_b = encode(*a), encode(*b)
    got_a = graphs.run(encode, *a)
    got_b = graphs.run(encode, *b)
    got_a2 = graphs.run(encode, *a)
    _same(got_b, want_b)
    _same(got_a, want_a)  # not overwritten by the replays after it
    _same(got_a2, want_a)


def _launches(fn):
    counts = cuda_lib.counts()
    for k in counts:
        k.launches = 0
    fn()
    torch.cuda.synchronize()
    return {k.name: k.launches for k in counts}


@pytest.mark.parametrize("fmt,level", [(Mgzip, 3), (Bgzf, 6), (Snap, 0)],
                         ids=["mgzip-3", "bgzf-6", "snappy"])
def test_launch_counts_equal_an_eager_calls(card, fmt, level):
    encode, inputs = _batch(fmt, level, 4, card, rows=5)  # a shape no other test uses
    eager = _launches(lambda: encode(*inputs))
    assert sum(eager.values()) > 0
    assert _launches(lambda: graphs.run(encode, *inputs)) == eager  # the capture
    assert _launches(lambda: graphs.run(encode, *inputs)) == eager  # a replay


def test_graph_stats_one_capture_then_replays(card):
    encode, inputs = _batch(Mgzip, 3, 5, card, rows=6)  # a shape no other test uses
    graphs.reset_graph_stats()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            graphs.run(encode, *inputs)
    assert graphs.graph_stats == {"captured": 1, "replayed": 3, "eager": 0}
    graphs.run(encode, *inputs)  # no profiler records: nothing counts
    assert graphs.graph_stats == {"captured": 1, "replayed": 3, "eager": 0}
    graphs.reset_graph_stats()


def _stream(fmt, level, blob, device=None, mesh=None, flush_at=None, threads=B):
    buf = io.BytesIO()
    b = ZBuilder(fmt).num_threads(threads).compression_level(level)
    w = (b.mesh(mesh) if mesh is not None else b.device(device)).from_writer(buf)
    if flush_at is None:
        w.write(blob)
    else:
        w.write(blob[:flush_at])
        w.flush()
        w.write(blob[flush_at:])
    w.finish()
    return buf.getvalue()


WRITES = {
    # two whole batches: finish() closes the stream with an empty final block
    "gzip-3-closing-block": (Gzip, 3, 2 * B * N, None),
    "gzip-3-flush-ragged": (Gzip, 3, 2 * B * N + 5 * N + 1234, 3 * N + 77),
    "gzip-6-ragged": (Gzip, 6, B * N + 3 * N + 5, None),
    "mgzip-3-ragged": (Mgzip, 3, B * N + 2 * N + 11, None),
    "mgzip-3-empty": (Mgzip, 3, 0, None),
    "bgzf-6-ragged": (Bgzf, 6, B * 65280 + 1000, None),
    "snappy-ragged": (Snap, 0, B * 65536 + 4097, None),
}


@pytest.mark.parametrize("case", list(WRITES))
def test_writer_equals_eager_writer(card, case, monkeypatch):
    fmt, level, n, flush_at = WRITES[case]
    blob = _text(n, 6).tobytes()
    got = _stream(fmt, level, blob, card, flush_at=flush_at)
    monkeypatch.setattr(graphs, "run", _eager)
    assert got == _stream(fmt, level, blob, card, flush_at=flush_at)


def test_mesh_on_one_card_equals_eager_writer(card, monkeypatch):
    blob = _text(3 * B * N + 777, 7).tobytes()
    got = _stream(Gzip, 3, blob, mesh=[card, card], flush_at=B * N + 5)
    monkeypatch.setattr(graphs, "run", _eager)
    assert got == _stream(Gzip, 3, blob, card, flush_at=B * N + 5)


def test_two_writers_on_two_threads_share_one_graph(card):
    blobs = [_text(6 * B * N + 321 * (i + 1), 8 + i).tobytes() for i in range(2)]
    want = [_stream(Mgzip, 3, blob, card) for blob in blobs]  # captures the graph
    got, errors = [None, None], []

    def write(i):
        try:
            for _ in range(3):
                got[i] = _stream(Mgzip, 3, blobs[i], card)
                assert got[i] == want[i]
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    graphs.reset_graph_stats()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=write, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert got == want
    # 3 streams of 7 batches a writer, every one a replay of the first run's graph
    assert graphs.graph_stats == {"captured": 0, "replayed": 42, "eager": 0}
    graphs.reset_graph_stats()


def test_gzip6_stream_of_64_mib_and_its_halo_stats_equal_the_eager_writers(card, monkeypatch):
    rng = np.random.default_rng(9)
    words = np.frombuffer(b"to be or not to be that is the question whether tis nobler ", np.uint8)
    starts = rng.integers(0, len(words) - 8, (64 << 20) // 8)
    blob = words[(starts[:, None] + np.arange(8)).reshape(-1)].tobytes()

    def counted():
        compress.reset_halo_stats()
        graphs.reset_graph_stats()
        with profile(activities=[ProfilerActivity.CPU]):
            out = _stream(Gzip, 6, blob, card, threads=64)
        return out, dict(compress.halo_stats), dict(graphs.graph_stats)

    got, got_halo, got_graphs = counted()
    assert got_graphs["eager"] == 0 and got_graphs["replayed"] > 0
    monkeypatch.setattr(graphs, "run", _eager)
    want, want_halo, _ = counted()
    assert got == want
    # 8 batches of 64 rows of 128 KiB; a fresh writer's first row has no
    # dictionary, and finish()'s empty closing block no data
    assert got_halo == want_halo == {"blocks": 512, "block_bytes": 64 << 20,
                                     "dict_bytes": 511 * 32768}
    compress.reset_halo_stats()
    graphs.reset_graph_stats()
