"""The port's public API end to end against the JAX package.

``ZBuilder(Mgzip)``/``ZBuilder(Bgzf)`` in ``gzp_tpu`` (on the CPU) and in
``gzp_tpu_torch`` (``device="cpu"``) must write identical bytes, which
``gzip`` must restore; plus the error surface and the docstring examples.
"""

import doctest
import gzip
import io

import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch
import gzp_tpu_torch.parallel.builder
from gzp_tpu_torch import (
    BufferSizeError,
    NumThreadsError,
    ParCompress,
    ParCompressBuilder,
    SyncZ,
    WriterClosedError,
    ZBuilder,
)

BS = 32768


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ",
             b"pack my box with five dozen liquor jugs ", b"0123456789" * 3, b"\n"]
    out, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        out.append(w)
        total += len(w)
    return b"".join(out)[:n]


INPUTS = {
    "empty": b"",
    "one-byte": b"x",
    "under-a-block": _text(1000, 1),
    "batches-and-tail": _text(2 * 3 * BS + 5000, 2),
    "random": np.random.default_rng(3).bytes(70000),  # stored fallback
}

# (format name, threads, buffer size): each is one encoder shape
SETUPS = {
    "mgzip-3x32k": ("Mgzip", 3, BS),
    "bgzf-2x32k": ("Bgzf", 2, BS),
    "mgzip-sync": ("Mgzip", 1, BS),
}


def _compress(pkg, fmt, threads, bs, data, level=3):
    buf = io.BytesIO()
    z = pkg.ZBuilder(getattr(pkg, fmt)).num_threads(threads).compression_level(level)
    if bs:
        z = z.buffer_size(bs)
    if pkg is gzp_tpu_torch:
        z = z.device("cpu")
    w = z.from_writer(buf)
    w.write(data)
    w.finish()
    return buf.getvalue()


@pytest.mark.parametrize("setup", list(SETUPS))
@pytest.mark.parametrize("name", list(INPUTS))
def test_bytes_identical_to_reference(setup, name):
    fmt, threads, bs = SETUPS[setup]
    data = INPUTS[name]
    ours = _compress(gzp_tpu_torch, fmt, threads, bs, data)
    assert gzip.decompress(ours) == data
    assert ours == _compress(gzp_tpu, fmt, threads, bs, data)


def test_bgzf_default_block_identical_to_reference():
    """BGZF's default 65280-byte blocks (not a multiple of 1024)."""
    data = _text(3 * 65280 + 777, 5)
    ours = _compress(gzp_tpu_torch, "Bgzf", 2, None, data)
    assert gzip.decompress(ours) == data
    assert ours == _compress(gzp_tpu, "Bgzf", 2, None, data)


def test_level6_stream_identical_to_reference():
    """Level 6 (the suffix matcher) through ZBuilder(Mgzip): two batches of
    two blocks, the second with a ragged tail."""
    data = _text(3 * BS + 7777, 8)
    ours = _compress(gzp_tpu_torch, "Mgzip", 2, BS, data, level=6)
    assert gzip.decompress(ours) == data
    assert ours == _compress(gzp_tpu, "Mgzip", 2, BS, data, level=6)
    assert len(ours) < len(_compress(gzp_tpu_torch, "Mgzip", 2, BS, data, level=3))


def test_writes_in_pieces_and_flush():
    data = _text(5 * BS + 123, 6)
    buf = io.BytesIO()
    w = ZBuilder(gzp_tpu_torch.Mgzip).num_threads(2).buffer_size(BS).device("cpu").from_writer(buf)
    for i in range(0, len(data), 9999):
        w.write(data[i: i + 9999])
        if i == 3 * 9999:
            w.flush()
    w.finish()
    assert gzip.decompress(buf.getvalue()) == data


def test_builder_picks_writer():
    assert isinstance(ZBuilder(gzp_tpu_torch.Mgzip).num_threads(1).device("cpu")
                      .from_writer(io.BytesIO()), SyncZ)
    w = ZBuilder(gzp_tpu_torch.Bgzf).num_threads(4).device("cpu").from_writer(io.BytesIO())
    assert type(w) is ParCompress and w.batch == 4 and w.block_size == 65280
    assert w.device == torch.device("cpu")


def test_verify_net_checks_and_repairs():
    data = _text(100000, 7)
    buf = io.BytesIO()
    w = (ParCompressBuilder(gzp_tpu_torch.Mgzip).num_threads(2).buffer_size(BS)
         .device("cpu").verify().from_writer(buf))
    w.write(data)
    w.finish()
    assert gzip.decompress(buf.getvalue()) == data
    assert w.verify_stats == {"checked": 4, "repaired": 0}
    blob, chk = w._verify_or_repair(gzip.compress(b"x" * 1000), b"y" * 1000, 1000, True, 123)
    assert w.verify_stats["repaired"] == 1
    assert gzip.decompress(blob) == b"y" * 1000


def test_errors():
    with pytest.raises(NumThreadsError):
        ParCompressBuilder(gzp_tpu_torch.Mgzip).num_threads(0)
    with pytest.raises(NumThreadsError):
        ParCompress(gzp_tpu_torch.Mgzip, io.BytesIO(), num_threads=0, device="cpu")
    with pytest.raises(BufferSizeError):
        ZBuilder(gzp_tpu_torch.Mgzip).num_threads(2).buffer_size(1000).device("cpu").from_writer(
            io.BytesIO())
    w = ZBuilder(gzp_tpu_torch.Mgzip).num_threads(2).device("cpu").from_writer(io.BytesIO())
    w.write(b"abc")
    w.finish()
    with pytest.raises(WriterClosedError):
        w.write(b"more")
    # stream mode is ported: Gzip writes a stream gzip restores
    buf = io.BytesIO()
    w = ZBuilder(gzp_tpu_torch.Gzip).num_threads(2).buffer_size(BS).device("cpu").from_writer(buf)
    w.write(b"abc" * 1000)
    w.finish()
    assert gzip.decompress(buf.getvalue()) == b"abc" * 1000


def test_no_cuda_means_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZBuilder(gzp_tpu_torch.Mgzip).from_writer(io.BytesIO())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZBuilder(gzp_tpu_torch.Mgzip).device("cuda").from_writer(io.BytesIO())


@pytest.mark.parametrize("module", [gzp_tpu_torch, gzp_tpu_torch.parallel.builder],
                         ids=["package", "builder"])
def test_docstring_examples(module):
    results = doctest.testmod(module, verbose=False)
    assert results.attempted > 0
    assert results.failed == 0
