"""Stream mode (Gzip, Zlib, raw Deflate with the 32 KiB halo) of the port
against the JAX package.

Same inputs (made with numpy from a seed) through ``gzp_tpu`` on the CPU
and ``gzp_tpu_torch`` with CPU tensors: the stream encoder on halo'd
batches with mixed finals, its config, Adler32, and the verify net's
stream oracle. Tolerance: exact equality of bytes and checksums
everywhere. (Whole streams through ``ZBuilder`` and ``ParCompress`` are in
``test_torch_stream_writer.py``.)
"""

import dataclasses
import gzip
import io
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gzp_tpu_torch
from gzp_tpu.ops import checksum as jck
from gzp_tpu.ops import deflate_kernel as jdk
from gzp_tpu_torch.ops import checksum as tck
from gzp_tpu_torch.ops import deflate_kernel as tdk
from gzp_tpu_torch.ops import host_codec

BS = 32768
D = 32768  # the dictionary (halo) size


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


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("level,checksum,subblocks", [
    (1, "none", 0), (3, "crc32", 0), (6, "adler32", 0), (9, "crc32", 0),
    (6, "crc32", 4),  # sub-block boundaries offset by the halo
])
def test_stream_encoder_equals_reference(level, checksum, subblocks):
    """``get_encoder`` in stream mode on [halo, data]: dict_lens 0, full and
    partial, a ragged row, and finals mixed (the sync-flush trailer on the
    non-final rows, BFINAL on the final one)."""
    n = 16384
    rng = np.random.default_rng(level)
    data = np.frombuffer(_text(3 * n, level), np.uint8).reshape(3, n).copy()
    lengths = np.array([n, n - 11, 5000], np.int32)
    data[2, :5000] = rng.integers(0, 256, 5000, dtype=np.uint8)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    # row 1's halo is the text its block continues: matches reach into it
    halo = np.frombuffer(_text(3 * D, level), np.uint8).reshape(3, D).copy()
    halo[1] = np.frombuffer(_text(D + 3 * n, level), np.uint8)[:D]
    dict_lens = np.array([0, D, 1000], np.int32)
    for i, dl in enumerate(dict_lens):
        halo[i, : D - dl] = 0
    finals = np.array([False, False, True])
    jcfg = jdk.DeflateEncodeConfig.for_level(n, "stream", checksum, level, dict_size=D)
    if subblocks:
        jcfg = dataclasses.replace(jcfg, subblocks=subblocks)
    args = (data, lengths, finals, halo, dict_lens)
    rj = jdk.get_encoder(jcfg, compact=True)(*map(jnp.asarray, args))
    tcfg = tdk.config_from_reference(dataclasses.asdict(jcfg))
    assert (tcfg.mode, tcfg.dict_size, tcfg.subblocks) == ("stream", D, subblocks or 1)
    rt = tdk.get_encoder(tcfg)(*map(torch.from_numpy, args))
    for k in ("out_len", "check", "flat"):
        _eq(rj[k], rt[k])
    out, ol = rt["out"].numpy(), rt["out_len"].numpy()
    for i in range(3):
        _eq(np.asarray(rj["out"])[i, : ol[i]], out[i, : ol[i]])
    # each chunk inflates after its dictionary; the non-final ones end with
    # the empty stored block
    for i in range(3):
        d = zlib.decompressobj(-15, zdict=halo[i, D - dict_lens[i]:].tobytes())
        assert d.decompress(out[i, : ol[i]].tobytes()) == data[i, : lengths[i]].tobytes()
        assert d.eof == finals[i]
        assert finals[i] or out[i, ol[i] - 4: ol[i]].tobytes() == b"\x00\x00\xff\xff"


@pytest.mark.parametrize("level", range(10))
def test_stream_config_carried_over(level):
    jcfg = jdk.DeflateEncodeConfig.for_level(131072, "stream", "adler32", level, dict_size=D)
    tcfg = tdk.config_from_reference(dataclasses.asdict(jcfg))
    assert tcfg == tdk.DeflateEncodeConfig.for_level(131072, "stream", "adler32", level,
                                                     dict_size=D)
    assert (tcfg.out_bytes, tcfg.header_len) == (jcfg.out_bytes, 0)


@pytest.mark.parametrize("n", [16384, 32640])
def test_adler32_full_and_ragged(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (4, n), dtype=np.uint8)
    data[3] = 255  # the largest sums
    lengths = np.array([n, n - 1, 1000, 0], np.int32)
    for i, ln in enumerate(lengths[:3]):
        data[i, ln:] = 0
    lengths[3] = n
    want = [zlib.adler32(data[i, :ln].tobytes()) for i, ln in enumerate(lengths)]
    got = tck.adler32_device(torch.from_numpy(data), torch.from_numpy(lengths))
    _eq(want, got)
    _eq(jck.adler32_device(jnp.asarray(data), jnp.asarray(lengths)), got)
    _eq([zlib.adler32(r.tobytes()) for r in data], tck.adler32_device(torch.from_numpy(data)))


DECODE = {"Gzip": gzip.decompress, "Zlib": zlib.decompress}


@pytest.mark.parametrize("fmt", ["Gzip", "Zlib"])
def test_stream_verify_net_repairs_and_resyncs(fmt, monkeypatch):
    """The verify net inflates the stream block by block; a corrupted
    block becomes a stored chunk with a host checksum, the oracle starts
    anew on it, and the blocks after it (whose matches reach into it) pass."""
    data = _text(4 * BS + 777, 11)
    spec = getattr(gzp_tpu_torch, fmt)
    buf = io.BytesIO()
    w = gzp_tpu_torch.ParCompress(spec, buf, num_threads=2, buffer_size=BS, device="cpu",
                                  verify=True)
    w.write(data)
    w.finish()
    assert DECODE[fmt](buf.getvalue()) == data
    assert w.verify_stats == {"checked": 5, "repaired": 0}

    target = data[2 * BS: 3 * BS]
    fallback = gzp_tpu_torch.ParCompress._maybe_fallback

    def corrupt(self, blob, raw, ln, final, chk):
        blob = fallback(self, blob, raw, ln, final, chk)
        return blob[:100] + bytes([blob[100] ^ 0x10]) + blob[101:] if raw == target else blob

    monkeypatch.setattr(gzp_tpu_torch.ParCompress, "_maybe_fallback", corrupt)
    buf = io.BytesIO()
    w = gzp_tpu_torch.ParCompress(spec, buf, num_threads=2, buffer_size=BS, device="cpu",
                                  verify=True)
    w.write(data)
    w.finish()
    assert w.verify_stats == {"checked": 5, "repaired": 1}
    assert DECODE[fmt](buf.getvalue()) == data  # the footer's checksum holds too
    assert host_codec.stored_deflate(target, final=False) in buf.getvalue()
