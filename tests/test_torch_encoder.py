"""The port's emit, checksum and encoder stages against the JAX package.

Same inputs (made with numpy from a seed) through ``gzp_tpu`` on the CPU
and ``gzp_tpu_torch`` with CPU tensors: Huffman stages on random and
degenerate histograms, CRC32 on full and ragged blocks, the whole member
encoder, and the carried-over config and constant tables. Tolerance:
exact equality everywhere (integer code).
"""

import dataclasses
import gzip
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops import checksum as jck
from gzp_tpu.ops import deflate_kernel as jdk
from gzp_tpu.ops import huffman as jhf
from gzp_tpu.ops import tables as jtb
from gzp_tpu_torch.formats import Mgzip
from gzp_tpu_torch.ops import checksum as tck
from gzp_tpu_torch.ops import deflate_kernel as tdk
from gzp_tpu_torch.ops import huffman as thf
from gzp_tpu_torch.ops import tables as ttb


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _freqs(seed, s):
    """Rows: dense random, sparse random, 0, 1 and 2 used symbols."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 5000, (5, s)).astype(np.int32)
    f[1][rng.random(s) < 0.9] = 0
    f[2] = 0
    f[3] = 0
    f[3, s // 2] = 7
    f[4] = 0
    f[4, [0, s - 1]] = [1, 100000]
    return f


@pytest.mark.parametrize("s,max_len", [(286, 15), (30, 15), (19, 7)])
def test_code_lengths_and_canonical_codes(s, max_len):
    f = _freqs(s, s)
    l1, ok1 = jhf.code_lengths(jnp.asarray(f), max_len=max_len)
    l2, ok2 = thf.code_lengths(torch.from_numpy(f), max_len=max_len)
    _eq(l1, l2)
    _eq(ok1, ok2)
    _eq(jhf.canonical_codes(l1), thf.canonical_codes(l2))


def test_choose_tables_and_rle_header():
    lit = _freqs(7, 286)
    lit[:, 256] += 1  # EOB, as position_histograms adds it
    dist = _freqs(8, 30)
    dist[0] = 0  # a block with no distances
    j = jhf.choose_tables(jnp.asarray(lit), jnp.asarray(dist))
    t = thf.choose_tables(torch.from_numpy(lit), torch.from_numpy(dist))
    for a, b in zip(j, t):
        _eq(a, b)
    final = np.array([True, False, True, False, True])
    hj = jhf.dynamic_header_fields_rle(j[5], j[6], jnp.asarray(final), j[4])
    ht = thf.dynamic_header_fields_rle(t[5], t[6], torch.from_numpy(final), t[4])
    _eq(hj[0], ht[0])
    _eq(hj[1], ht[1])


def test_position_histograms():
    rng = np.random.default_rng(3)
    sym = rng.integers(0, 286, (3, 4096)).astype(np.int32)
    dsym = rng.integers(0, 30, (3, 4096)).astype(np.int32)
    tok = rng.random((3, 4096)) < 0.6
    match = tok & (rng.random((3, 4096)) < 0.3)
    j = jhf.position_histograms(*map(jnp.asarray, (sym, dsym, tok, match)))
    t = thf.position_histograms(*map(torch.from_numpy, (sym.astype(np.int64),
                                                         dsym.astype(np.int64), tok, match)))
    _eq(j[0], t[0])
    _eq(j[1], t[1])


@pytest.mark.parametrize("n", [16384, 32640])
def test_crc32_full_and_ragged(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (4, n), dtype=np.uint8)
    lengths = np.array([n, n - 1, 1000, 0], np.int32)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    want = [zlib.crc32(data[i, :ln].tobytes()) for i, ln in enumerate(lengths)]
    got = tck.crc32_device(torch.from_numpy(data), torch.from_numpy(lengths))
    _eq(want, got)
    _eq(jck.crc32_device(jnp.asarray(data), jnp.asarray(lengths)), got)
    _eq([zlib.crc32(r.tobytes()) for r in data], tck.crc32_device(torch.from_numpy(data)))


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"some deflate test text ", b"with repeated repeated phrases\n",
             b"abcabcabcabc", b"\x00\x01\x02\x03 binary bits "]
    out = b""
    while len(out) < n:
        out += words[rng.integers(0, len(words))]
    return out[:n]


@pytest.mark.parametrize("level,mode,subblocks", [
    (3, "mgzip", 0), (3, "bgzf", 0), (1, "mgzip", 0), (1, "bgzf", 0),
    (6, "mgzip", 0), (6, "bgzf", 0), (9, "mgzip", 0),
    (6, "mgzip", 4),  # per-sub-block tables, as test_subblock_tables_oracle
])
def test_encoder_equals_reference(level, mode, subblocks):
    n = 16384
    data = np.frombuffer(_text(3 * n, level), np.uint8).reshape(3, n).copy()
    lengths = np.array([n, n - 11, 5000], np.int32)
    data[2, :5000] = np.random.default_rng(level).integers(0, 256, 5000, dtype=np.uint8)
    for i, ln in enumerate(lengths):
        data[i, ln:] = 0
    jcfg = jdk.DeflateEncodeConfig.for_level(n, mode, "none", level)
    if subblocks:
        jcfg = dataclasses.replace(jcfg, subblocks=subblocks)
    rj = jdk.get_encoder(jcfg, compact=True)(
        jnp.asarray(data), jnp.asarray(lengths), jnp.zeros((3,), bool))
    tcfg = tdk.config_from_reference(dataclasses.asdict(jcfg))
    assert tcfg.matcher == ("suffix" if level >= 6 else "hash")
    rt = tdk.get_encoder(tcfg)(torch.from_numpy(data), torch.from_numpy(lengths),
                                 torch.zeros((3,), dtype=torch.bool))
    for k in ("out", "out_len", "check", "flat"):
        _eq(rj[k], rt[k])
    out, ol = rt["out"].numpy(), rt["out_len"].numpy()
    for i in range(3):
        assert gzip.decompress(out[i, : ol[i]].tobytes()) == data[i, : lengths[i]].tobytes()


@pytest.mark.parametrize("level", range(10))
def test_config_carried_over(level):
    jcfg = jdk.DeflateEncodeConfig.for_level(131072, "mgzip", "none", level)
    tcfg = tdk.config_from_reference(dataclasses.asdict(jcfg))
    assert tcfg == tdk.DeflateEncodeConfig.for_level(131072, "mgzip", "none", level)
    assert tcfg.out_bytes == jcfg.out_bytes
    assert (np.frombuffer(Mgzip.member_header(level), np.uint8)
            == jdk._member_header_template("mgzip", level)).all()
    assert (tcfg.matcher, tcfg.subblocks) == (jcfg.matcher, jcfg.subblocks)
    if level >= 6:
        assert (tcfg.matcher, tcfg.subblocks) == ("suffix", 2)
        assert callable(tdk.get_encoder(tcfg))


def test_config_rejects_other_formulations():
    jcfg = jdk.DeflateEncodeConfig.for_level(65536, "mgzip", "none", 3)
    for knob, value in (("hash3", True), ("parse", "window"), ("lookup", "int8")):
        with pytest.raises(ValueError, match=knob):
            tdk.config_from_reference(dataclasses.asdict(dataclasses.replace(jcfg, **{knob: value})))
    # stream mode is ported; sub-blocks must divide the block
    assert callable(tdk.get_encoder(tdk.DeflateEncodeConfig.for_level(65536, "stream", "crc32", 3)))
    with pytest.raises(ValueError, match="subblocks"):
        tdk.get_encoder(dataclasses.replace(tdk.config_from_reference(dataclasses.asdict(jcfg)),
                                            subblocks=3))


@pytest.mark.parametrize(
    "name,args",
    [
        ("crc_bit_matrix", (128, jck._check.CRC32_POLY)),
        ("crc_seg_fold_matrix", (256, 128, jck._check.CRC32_POLY)),
        ("crc_shift_ladder", (18, jck._check.CRC32_POLY)),
        ("crc_unshift_ladder", (18, jck._check.CRC32_POLY)),
        ("crc_position_table", (128, jck._check.CRC32_POLY)),
        ("fixed_litlen_codes", ()),
        ("fixed_dist_codes", ()),
    ],
)
def test_tables_carried_over(name, args):
    a, b = getattr(jtb, name)(*args), getattr(ttb, name)(*args)
    assert np.array_equal(np.asarray(a), np.asarray(b))  # tuples of arrays stack
    assert jtb.crc_init_constant(131072, jck._check.CRC32_POLY) == ttb.crc_init_constant(
        131072, jck._check.CRC32_POLY)
