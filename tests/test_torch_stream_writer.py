"""Whole Gzip, Zlib and raw Deflate streams of the port against the JAX
package at level 3: ``ZBuilder`` at 3 threads and sync on the inputs of
``test_torch_roundtrip.py``, and a ``write``/``flush``/``write``
sequence; at levels 3 and 6 also blocks of 40,000 and 33,333 bytes
(longer than the 32 KiB dictionary, no multiple of it), written whole
and with a flush mid-block. Both packages on the CPU; tolerance: exact
equality of bytes.
(The stream encoder, Adler32 and the verify net are in
``test_torch_stream.py``; other levels and the shard knobs in
``test_torch_stream_shards.py``.)
"""

import gzip
import io
import zlib

import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch

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

DECODE = {
    "Gzip": gzip.decompress,
    "Zlib": zlib.decompress,
    "RawDeflate": lambda b: zlib.decompress(b, -15),
}


def _compress(pkg, fmt, threads, data, level=3, flush_at=None, bs=BS):
    buf = io.BytesIO()
    z = pkg.ZBuilder(getattr(pkg, fmt)).num_threads(threads).compression_level(level)
    z = z.buffer_size(bs)
    if pkg is gzp_tpu_torch:
        z = z.device("cpu")
    w = z.from_writer(buf)
    if flush_at is None:
        w.write(data)
    else:
        w.write(data[:flush_at])
        w.flush()
        w.write(data[flush_at:])
    w.finish()
    return buf.getvalue()


# (fmt, input, threads, level, block size, flush offset): every input at
# level 3 and 32 KiB blocks, then blocks longer than the dictionary but not
# a multiple of it at levels 3 and 6, written whole and with a flush at an
# offset that is no multiple of the block (a short row mid-batch, a short
# carry into the next batch)
CASES = [pytest.param(fmt, name, threads, 3, BS, None, id=f"{fmt}-{name}-{tid}")
         for fmt in DECODE for name in INPUTS
         for threads, tid in ((3, "threads3"), (1, "sync"))]
CASES += [pytest.param(fmt, "batches-and-tail", 3, level, bs, flush_at,
                       id=f"{fmt}-batches-and-tail-bs{bs}-level{level}"
                       + ("-flush" if flush_at else ""))
          for fmt in DECODE for level in (3, 6) for bs in (40000, 33333)
          for flush_at in (None, 61234)]


@pytest.mark.parametrize("fmt,name,threads,level,bs,flush_at", CASES)
def test_stream_bytes_identical_to_reference(fmt, name, threads, level, bs, flush_at):
    data = INPUTS[name]
    ours = _compress(gzp_tpu_torch, fmt, threads, data, level, flush_at, bs)
    assert DECODE[fmt](ours) == data
    assert ours == _compress(gzp_tpu, fmt, threads, data, level, flush_at, bs)


def test_write_flush_write_identical_to_reference():
    """A flush mid-block: a partial non-final block with its sync-flush
    trailer, and the halo carried on past it."""
    data = _text(5 * BS + 123, 6)
    ours = _compress(gzp_tpu_torch, "Gzip", 3, data, flush_at=BS + 4321)
    assert gzip.decompress(ours) == data
    assert ours == _compress(gzp_tpu, "Gzip", 3, data, flush_at=BS + 4321)
    assert ours != _compress(gzp_tpu_torch, "Gzip", 3, data)
