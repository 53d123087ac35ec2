"""The port's Snappy encoder, its CRC32C and its frame decoder against the
JAX package.

Same inputs (made with numpy from a seed) through ``gzp_tpu`` on the CPU
and ``gzp_tpu_torch`` with CPU tensors: the hash matcher's plain path at
snappy's limits (distances to 65,535, matches to 256, at least 4), the
frame encoder, whole ``ZBuilder(Snap)`` streams (byte-at-a-time writes
too), the verify net's Snappy branch, CRC32C on the host and the device,
and ``decode_frames``. Tolerance: exact equality of bytes and checksums.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch
from gzp_tpu import check as jcheck
from gzp_tpu.ops import checksum as jck
from gzp_tpu.ops import lz as jlz
from gzp_tpu.ops import snappy_kernel as jsk
from gzp_tpu_torch import check as tcheck
from gzp_tpu_torch.errors import InvalidCheckError
from gzp_tpu_torch.ops import checksum as tck
from gzp_tpu_torch.ops import lz_cuda
from gzp_tpu_torch.ops import snappy_kernel as tsk
from gzp_tpu_torch.utils.snappy_ref import decode_frames


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
    words = [b"the quick brown fox ", b"jumps over the lazy dog ", b"a" * 300,
             b"pack my box with five dozen liquor jugs ", b"0123456789" * 3, b"\n"]
    out, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        out.append(w)
        total += len(w)
    return b"".join(out)[:n]


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _rows(n, seed):
    """Text, random bytes, random bytes that repeat 40,000 bytes back (past
    deflate's window), a run of one byte (copies chained past 64), a short
    row and an empty one."""
    rng = np.random.default_rng(seed)
    data = np.zeros((6, n), np.uint8)
    data[0] = np.frombuffer(_text(n, seed), np.uint8)
    data[1] = rng.integers(0, 256, n, dtype=np.uint8)
    far = 40000 if n > 40000 else n // 2
    data[2, :far] = rng.integers(0, 256, far, dtype=np.uint8)
    data[2, far:] = data[2, : n - far]
    data[3] = ord("z")
    data[4, :100] = np.frombuffer(_text(100, seed + 1), np.uint8)
    lengths = np.array([n, n - 7, n, n, 100, 0], np.int32)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    return data, lengths


@pytest.mark.parametrize("n", [65536])
def test_best_matches_at_snappy_limits(n):
    """The port's hash matcher (plain versions of K1, K2, K6 around the
    sort) against gzp_tpu's ``lz.best_matches`` at snappy's parameters."""
    data, lengths = _rows(n, n)
    kw = dict(max_dist=65535, max_match=256, min_emit=4, payload_words=3, lags=2)
    jl, jd = jlz.best_matches(jnp.asarray(data), jnp.asarray(lengths), **kw)
    tl, td = lz_cuda.best_matches_cuda(torch.from_numpy(data), torch.from_numpy(lengths), **kw)
    _eq(jl, tl)
    _eq(jd, td)
    assert int(td[2].max()) == 40000  # past deflate's 32,768


@pytest.mark.parametrize("n", [16384, 65536])
def test_snappy_encoder_equals_reference(n):
    data, lengths = _rows(n, n + 1)
    b = len(lengths)
    jcfg = jsk.SnappyEncodeConfig(block_len=n, pallas=False)
    rj = jsk.get_snappy_encoder(jcfg)(jnp.asarray(data), jnp.asarray(lengths),
                                      jnp.zeros((b,), bool))
    tcfg = tsk.snappy_config_from_reference(dataclasses.asdict(jcfg))
    assert tcfg.out_bytes == jcfg.out_bytes
    rt = tsk.get_snappy_encoder(tcfg)(
        torch.from_numpy(data), torch.from_numpy(lengths), torch.zeros((b,), dtype=torch.bool))
    _eq(rj["out_len"], rt["out_len"])
    _eq(rj["check"], rt["check"])
    out, ol = rt["out"].numpy(), rt["out_len"].numpy()
    for i in range(b):
        _eq(np.asarray(rj["out"])[i, : ol[i]], out[i, : ol[i]])
        assert decode_frames(out[i, : ol[i]].tobytes()) == data[i, : lengths[i]].tobytes()
    assert ol[5] == 10  # an empty block is the stream identifier alone


def test_snappy_config_rejects_other_formulations():
    jcfg = jsk.SnappyEncodeConfig(block_len=65536)
    for knob, value in (("parse", "window"), ("sample_step", 2), ("window", 512)):
        with pytest.raises(ValueError, match=knob):
            tsk.snappy_config_from_reference(
                dataclasses.asdict(dataclasses.replace(jcfg, **{knob: value})))


INPUTS = {
    "empty": b"",
    "one-byte": b"x",
    "random": np.random.default_rng(3).bytes(70000),  # uncompressed chunks
    "batches-and-tail": _text(2 * 3 * 65536 + 5000, 2),
}


def _compress(pkg, data, threads=3, pieces=None):
    buf = io.BytesIO()
    z = pkg.ZBuilder(pkg.Snap).num_threads(threads)
    if pkg is gzp_tpu_torch:
        z = z.device("cpu")
    w = z.from_writer(buf)
    for piece in pieces or [data]:
        w.write(piece)
    w.finish()
    return buf.getvalue()


@pytest.mark.parametrize("threads", [3, 1], ids=["threads3", "sync"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_snap_bytes_identical_to_reference(name, threads):
    data = INPUTS[name]
    ours = _compress(gzp_tpu_torch, data, threads)
    assert decode_frames(ours) == data
    assert ours == _compress(gzp_tpu, data, threads)


def test_snap_fragmented_writes_identical_to_reference():
    """Byte-at-a-time and odd-sized writes (as gzp_tpu's
    ``test_snappy_fragmented_writes``)."""
    rng = np.random.default_rng(12)
    data = _text(90000, 12)
    pieces, off = [], 0
    while off < len(data):
        step = int(rng.choice([1, 2, 7, 333, 65536]))
        pieces.append(data[off: off + step])
        off += step
    ours = _compress(gzp_tpu_torch, data, 3, pieces)
    assert decode_frames(ours) == data
    assert ours == _compress(gzp_tpu, data, 3, pieces)


def test_snappy_verify_net(monkeypatch):
    """Every frame is decoded; a corrupted one becomes an uncompressed chunk
    carrying the device's masked CRC32C."""
    data = _text(3 * 65536 + 99, 5)
    buf = io.BytesIO()
    w = gzp_tpu_torch.ParCompress(gzp_tpu_torch.Snap, buf, num_threads=2, device="cpu",
                                  verify=True)
    w.write(data)
    w.finish()
    assert w.verify_stats == {"checked": 4, "repaired": 0}
    good = buf.getvalue()

    target = data[65536: 2 * 65536]
    fallback = gzp_tpu_torch.ParCompress._maybe_fallback

    def corrupt(self, blob, raw, ln, final, chk):
        blob = fallback(self, blob, raw, ln, final, chk)
        return blob[:50] + bytes([blob[50] ^ 0x01]) + blob[51:] if raw == target else blob

    monkeypatch.setattr(gzp_tpu_torch.ParCompress, "_maybe_fallback", corrupt)
    buf = io.BytesIO()
    w = gzp_tpu_torch.ParCompress(gzp_tpu_torch.Snap, buf, num_threads=2, device="cpu",
                                  verify=True)
    w.write(data)
    w.finish()
    assert w.verify_stats == {"checked": 4, "repaired": 1}
    assert decode_frames(buf.getvalue()) == data
    assert len(buf.getvalue()) > len(good)
    crc = tcheck.snappy_mask_crc(tcheck.crc32c(target))
    assert b"\x01" + (len(target) + 4).to_bytes(3, "little") + crc.to_bytes(4, "little") \
        in buf.getvalue()


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 5000, 65536])
def test_crc32c_host(n):
    data = np.random.default_rng(n).bytes(n)
    assert tcheck.crc32c(data) == jcheck.crc32c(data)
    assert tcheck.crc32c(data, 0x12345678) == jcheck.crc32c(data, 0x12345678)
    assert tcheck.snappy_mask_crc(tcheck.crc32c(data)) == jcheck.snappy_mask_crc(
        jcheck.crc32c(data))
    assert tcheck.crc32c(b"123456789") == 0xE3069283  # the standard check value


def test_crc32c_check_class():
    a, b = b"first range " * 50, b"second range " * 70
    t, j = tcheck.Crc32C(), jcheck.Crc32C()
    t.update(a)
    j.update(a)
    t.combine(tcheck.Crc32C.from_sum(tcheck.crc32c(b), len(b)))
    j.combine(jcheck.Crc32C.from_sum(jcheck.crc32c(b), len(b)))
    assert (t.sum(), t.amount()) == (j.sum(), j.amount()) == (tcheck.crc32c(a + b), len(a + b))
    assert gzp_tpu_torch.Crc32C is tcheck.Crc32C


@pytest.mark.parametrize("n", [16384, 65536])
def test_crc32c_masked_device(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (4, n), dtype=np.uint8)
    lengths = np.array([n, n - 1, 1000, 0], np.int32)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    got = tck.crc32c_masked_device(torch.from_numpy(data), torch.from_numpy(lengths))
    _eq(jck.crc32c_masked_device(jnp.asarray(data), jnp.asarray(lengths)), got)
    _eq([tcheck.snappy_mask_crc(tcheck.crc32c(data[i, :ln].tobytes()))
         for i, ln in enumerate(lengths)], got)
    _eq(jck.crc32c_masked_device(jnp.asarray(data)),
        tck.crc32c_masked_device(torch.from_numpy(data)))


def test_decode_frames_rejects_a_bad_crc():
    blob = bytearray(_compress(gzp_tpu_torch, _text(1000, 1)))
    blob[14] ^= 1  # the chunk's masked CRC32C
    with pytest.raises(InvalidCheckError):
        decode_frames(bytes(blob))
    assert decode_frames(bytes(blob), verify_crc=False) == _text(1000, 1)
