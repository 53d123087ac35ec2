"""Each CUDA kernel against its plain PyTorch version, on the card, at the
main paths' full width (64 blocks of 128 KiB; level 3's config for K1, K2,
K6 and K10, level 6's for K4, K5, K7, K8 and K9), K2 also over 1-3 context
words and lags 1-127 and on rows built for its lags halo, the tails K6 and
K9 on rows built to sit at the edges of their tiles and windows, the pack
pre-scan K10 on rows built for its look-back, the suffix merge K8 on rows
built for its ties, early ends and tile edges at lags 1-127 and on rows
of 2^22 slots and past (its fp32 and int32 keys), and the LCP
ladder K4 over every word count, lags 1-3 and both byte orders at row
lengths that are not a multiple of its tile; the inflate K11 on the rows of
``inflate_case_batch`` (also at caps that are not a multiple of 4) and on
BGZF blocks at levels 0-9 (against the host codec), and
``ParDecompress(backend='device')`` reading BGZF on the card with no block
routed to the host codec; a mesh of ``[cuda:0, cuda:0]`` (and of two
cards where there are two) writing the one-device stream, and two worker
processes of ``parallel/multihost.py`` on the card, stitched, writing the
one-process stream.

Marked ``cuda``; without a CUDA device every test skips (decided in the
fixture, never at import). Run on the card with ``python -m pytest -m
cuda tests/test_torch_cuda.py``. Tolerance: exact equality on every
output (integer code).
"""

import io

import numpy as np
import pytest
import torch

from gzp_tpu_torch import Bgzf, Gzip, Mgzip, ParDecompress, Snap, ZBuilder
from gzp_tpu_torch.ops import deflate_kernel as dk
from gzp_tpu_torch.ops import inflate_kernel as ik
from gzp_tpu_torch.ops import lz_cuda, pack_cuda
from gzp_tpu_torch.ops import snappy_kernel as sk_
from gzp_tpu_torch.ops.lz import _pos_bits
from gzp_tpu_torch.parallel.decompress import stage_blocks
from gzp_tpu_torch.runtime import get_native
from gzp_tpu_torch.utils.inflate_cases import inflate_case_batch
from gzp_tpu_torch.utils.testing import (
    KINDS, NEIGHBOR_KINDS, PACK_KINDS, SUFFIX_KINDS, behind_halo, neighbor_edge_batch,
    pack_edge_batch, suffix_merge_edge_batch, tail_edge_batch,
)

pytestmark = pytest.mark.cuda

B, N = 64, 131072
INFLATE_CAP = 65536  # ParDecompress(backend='device')'s IN_CAP and OUT_CAP


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = np.frombuffer(b"to be or not to be that is the question whether tis nobler ", np.uint8)
    starts = rng.integers(0, len(words) - 8, n // 8)
    return np.concatenate([words[s: s + 8] for s in starts])[:n]


@pytest.fixture(scope="module")
def stages():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows = _text(B * N, 0).reshape(B, N).copy()
    rows[1] = 0
    rows[2] = np.random.default_rng(1).integers(0, 256, N, dtype=np.uint8)
    dev = torch.device("cuda", 0)
    data = torch.from_numpy(rows).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    lengths[3] = N - 999
    halo = torch.zeros((B,), dtype=torch.int32, device=dev)
    cfg = dk.DeflateEncodeConfig.for_level(N, "mgzip", "none", 3)
    key, pays = lz_cuda.build_keys_cuda(data, pos_bits=_pos_bits(N), payload_words=3)
    sk, order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, order.expand(3, -1, -1))
    sp, packed = lz_cuda.neighbor_cuda(sk, spays, halo, pos_bits=_pos_bits(N), lags=2,
                                       max_dist=32768)
    packed_pos = torch.empty_like(packed).scatter_(1, sp.to(torch.int64), packed)
    ml, md = lz_cuda.match_tail_cuda(data, packed_pos, lengths, halo, base=0,
                                     payload_bytes=12, max_match=258, min_emit=3, lazy=True)
    marked, ln = dk.parse_stage(cfg, ml, lengths)
    bits, nbits = dk.block_entries(cfg, data, marked, ln, md)
    return dict(data=data, lengths=lengths, halo=halo, sk=sk, spays=spays,
                packed_pos=packed_pos, bits=bits, nbits=nbits, cfg=cfg)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_build_keys_kernel(stages):
    kw = dict(pos_bits=_pos_bits(N), payload_words=3)
    _same(lz_cuda.build_keys_cuda(stages["data"], **kw),
          lz_cuda.build_keys_plain(stages["data"], **kw))


@pytest.mark.parametrize("lags", [1, 2, 3, 4, 16, 127])
@pytest.mark.parametrize("pw", [1, 2, 3])
def test_neighbor_kernel(stages, pw, lags):
    """K2 on level 3's hash-sorted text at 1-3 context words (the first pw
    planes of level 3's three: K1's words do not depend on pw)."""
    args = (stages["sk"], stages["spays"][:pw].contiguous(), stages["halo"])
    kw = dict(pos_bits=_pos_bits(N), lags=lags, max_dist=32768)
    before = (lz_cuda.NEIGHBOR.launches, lz_cuda.NEIGHBOR_LOOP.launches)
    got = lz_cuda.neighbor_cuda(*args, **kw)
    # one launch of neighbor.cu, counted as K3's function only at lags > 2
    assert (lz_cuda.NEIGHBOR.launches - before[0],
            lz_cuda.NEIGHBOR_LOOP.launches - before[1]) == (1, int(lags > 2))
    _same(got, lz_cuda.neighbor_plain(*args, **kw))


@pytest.mark.parametrize("max_dist", [32768, 37])
@pytest.mark.parametrize("npad", [N - 1000, 5 * lz_cuda.NEIGHBOR_TILE + 123],
                         ids=["ragged", "scalar-loads"])
@pytest.mark.parametrize("lags", [1, 2, 4, 127])
def test_neighbor_at_tile_edges(stages, lags, npad, max_dist):
    """Hash buckets across tile edges whose best candidate is exactly lags
    back, a row's first slots, candidates at halo_start and max_dist and
    one past each, ties, capped pairs and every byte of every word
    (``neighbor_edge_batch``), at a ragged last tile; Np = N - 1000 takes
    16-byte loads, 5T + 123 (not a multiple of 4) scalar ones."""
    for pw in (1, 2, 3):
        x = neighbor_edge_batch(NEIGHBOR_KINDS * 4, npad, tile=lz_cuda.NEIGHBOR_TILE, lags=lags,
                                payload_words=pw, max_dist=max_dist, seed=npad + lags + pw)
        dev = stages["data"].device
        args = [torch.from_numpy(x[k]).to(dev) for k in ("sk", "pays", "halo_start")]
        kw = dict(pos_bits=x["pos_bits"], lags=lags, max_dist=max_dist)
        before = lz_cuda.NEIGHBOR.launches
        got = lz_cuda.neighbor_cuda(*args, **kw)
        assert lz_cuda.NEIGHBOR.launches == before + 1
        _same(got, lz_cuda.neighbor_plain(*args, **kw))


def test_neighbor_refuses_lags_past_its_halo(stages):
    args = (stages["sk"], stages["spays"], stages["halo"])
    before = lz_cuda.NEIGHBOR.launches
    for lags in (0, lz_cuda.NEIGHBOR_MAX_LAGS + 1):
        with pytest.raises(ValueError, match="lags"):
            lz_cuda.neighbor_cuda(*args, pos_bits=_pos_bits(N), lags=lags, max_dist=32768)
    assert lz_cuda.NEIGHBOR.launches == before


def test_match_tail_kernel(stages):
    args = (stages["data"], stages["packed_pos"], stages["lengths"], stages["halo"])
    kw = dict(base=0, payload_bytes=12, max_match=258, min_emit=3, lazy=True)
    _same(lz_cuda.match_tail_cuda(*args, **kw), lz_cuda.match_tail_plain(*args, **kw))


def test_pack_prescan_kernel(stages):
    args = (stages["bits"], stages["nbits"], 160)
    _same(pack_cuda.pack_prescan_cuda(*args), pack_cuda.pack_prescan_plain(*args))


def test_pack_prescan_one_launch(stages):
    """One ``pack_prescan_cuda`` call is one count of K10's launches."""
    args = (stages["bits"], stages["nbits"], 160)
    before = pack_cuda.PACK_PRESCAN.launches
    got = pack_cuda.pack_prescan_cuda(*args)
    assert pack_cuda.PACK_PRESCAN.launches == before + 1
    _same(got, pack_cuda.pack_prescan_plain(*args))


@pytest.mark.parametrize("base_bits", [0, 144, 160])
@pytest.mark.parametrize("tiles,extra", [(5, 123), (4, 0), (0, 4059)],
                         ids=["ragged", "tail-first", "e-lt-T"])
def test_pack_prescan_at_tile_edges(stages, tiles, extra, base_bits):
    """A segment across two whole tiles, zero-width tiles, flushes on a
    tile's last entry, 31-bit entries across tile edges, the tail entry
    first in its tile, and E < T (``pack_edge_batch``), at the kernel's T."""
    t = pack_cuda.PACK_TILE
    e = tiles * t + extra
    bits, nbits = pack_edge_batch(PACK_KINDS * 4, e, tile=t, base_bits=base_bits, seed=e)
    dev = stages["data"].device
    args = (torch.from_numpy(bits.view(np.int32)).to(dev), torch.from_numpy(nbits).to(dev),
            base_bits)
    _same(pack_cuda.pack_prescan_cuda(*args), pack_cuda.pack_prescan_plain(*args))


@pytest.mark.parametrize("level", [3, 6])
def test_members_equal_cpu_run(stages, level):
    blob = stages["data"][[0, 1, 2, 3]].cpu().numpy().tobytes()
    outs = []
    for device in ("cuda", "cpu"):
        buf = io.BytesIO()
        w = ZBuilder(Mgzip).num_threads(4).compression_level(level).device(device).from_writer(buf)
        w.write(blob)
        w.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


PW6 = 7  # level 6's context words


@pytest.fixture(scope="module")
def stages6(stages):
    """The suffix matcher's intermediate tensors at level 6's config."""
    data, halo = stages["data"], stages["halo"]
    keys, pos = lz_cuda.build_suffix_keys_cuda(data, payload_words=PW6)
    order = lz_cuda.suffix_order(keys, pos, 5)
    skeys = torch.gather(keys, 2, order.expand(PW6, -1, -1))
    sp = torch.gather(pos, 1, order)
    adj = lz_cuda.lcp_lags_cuda(skeys, 1, big_endian=True)[0]
    packed_s = lz_cuda.suffix_merge_cuda(sp, adj, halo, lags=16, max_dist=32768,
                                         payload_bytes=4 * PW6)
    key, pays = lz_cuda.build_keys_cuda(data, pos_bits=_pos_bits(N), payload_words=PW6)
    sk, horder = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, horder.expand(PW6, -1, -1))
    lcps = lz_cuda.lcp_lags_cuda(spays, 2, big_endian=False)
    sp_h, packed_h = lz_cuda.hash_merge_cuda(sk, lcps, halo, pos_bits=_pos_bits(N),
                                             max_dist=32768, payload_bytes=4 * PW6)
    return dict(skeys=skeys, sp=sp, adj=adj, sk=sk, spays=spays, lcps=lcps,
                packed_s_pos=lz_cuda.restore_order(sp, packed_s),
                packed_h_pos=lz_cuda.restore_order(sp_h, packed_h))


def test_build_suffix_keys_kernel(stages):
    _same(lz_cuda.build_suffix_keys_cuda(stages["data"], payload_words=PW6),
          lz_cuda.build_suffix_keys_plain(stages["data"], payload_words=PW6))


@pytest.mark.parametrize("big_endian", [True, False], ids=["be-suffix", "le-hash"])
def test_lcp_lags_kernel(stages6, big_endian):
    words, lags = (stages6["skeys"], 1) if big_endian else (stages6["spays"], 2)
    _same([lz_cuda.lcp_lags_cuda(words, lags, big_endian=big_endian)],
          [lz_cuda.lcp_lags_plain(words, lags, big_endian=big_endian)])


def _ladder_rows(pw, npad, seed):
    """[pw, 4, npad] int32: equal words, random words, words equal but for
    the last, and a sorted row of few distinct words."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, (pw, 4, npad), dtype=np.uint64).astype(np.uint32)
    w[:, 0] = w[:, 0, :1]
    w[:, 2] = w[:, 2, :1]
    w[-1, 2] ^= rng.integers(0, 256, npad).astype(np.uint32) << (8 * (npad % 4))
    few = rng.integers(0, 3, (pw, npad)).astype(np.uint32) * np.uint32(0x01010101)
    w[:, 3] = few[:, np.lexsort(few[::-1])]
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("big_endian", [True, False], ids=["be", "le"])
@pytest.mark.parametrize("pw", range(1, 8))
def test_lcp_lags_grid(stages, pw, big_endian):
    """Every word count and lags 1-3 at Np = 3000 (not a multiple of 4:
    scalar loads) and 4100 (a ragged last tile); one launch per call."""
    for npad in (3000, 4100):
        assert npad % lz_cuda.LCP_TILE
        words = _ladder_rows(pw, npad, seed=npad + pw).to(stages["data"].device)
        for lags in (1, 2, 3):
            before = lz_cuda.LCP_LAGS.launches
            got = lz_cuda.lcp_lags_cuda(words, lags, big_endian=big_endian)
            assert lz_cuda.LCP_LAGS.launches == before + 1
            _same([got], [lz_cuda.lcp_lags_plain(words, lags, big_endian=big_endian)])


@pytest.mark.parametrize("lags", [16, 24])
def test_suffix_merge_kernel(stages, stages6, lags):
    args = (stages6["sp"], stages6["adj"], stages["halo"])
    kw = dict(lags=lags, max_dist=32768, payload_bytes=4 * PW6)
    _same([lz_cuda.suffix_merge_cuda(*args, **kw)], [lz_cuda.suffix_merge_plain(*args, **kw)])


@pytest.mark.parametrize("max_dist", [32768, 100])
@pytest.mark.parametrize("lags", [1, 16, 24, 127])
def test_suffix_merge_edge_rows(stages, lags, max_dist):
    """K8 on ``suffix_merge_edge_batch`` rows (all-zero, random, period-3,
    text, halo_start > 0, a best candidate exactly ``lags`` across each
    tile edge) of 3 tiles and 1,000 slots, at Np = 7,168 (3 1/2 tiles:
    16-byte loads and stores) and 7,165 (not a multiple of 4: scalar ones);
    one launch per call."""
    dev = stages["data"].device
    tile = lz_cuda.suffix_merge_plan()["tile"]
    n = 3 * tile + 1000
    for npad in (None, lz_cuda.padded_len(n) - 3):
        x = suffix_merge_edge_batch(SUFFIX_KINDS, n, lags=lags, tile=tile, npad=npad, seed=lags)
        args = tuple(torch.from_numpy(x[k]).to(dev) for k in ("sp", "adj", "halo_start"))
        assert args[0].shape[1] % tile
        kw = dict(lags=lags, max_dist=max_dist, payload_bytes=4 * PW6)
        before = lz_cuda.SUFFIX_MERGE.launches
        got = lz_cuda.suffix_merge_cuda(*args, **kw)
        assert lz_cuda.SUFFIX_MERGE.launches == before + 1
        _same([got], [lz_cuda.suffix_merge_plain(*args, **kw)])


def test_suffix_merge_long_rows(stages):
    """K8 on text and ``zeros_halo`` rows of 2^22 slots, the longest it
    computes on fp32 keys (positions up to 2^22 - 1), and of 2^22 + 5,000
    slots, on int32 keys; lags 16 and 127, max_dist 32768 and 100."""
    dev = stages["data"].device
    plan = lz_cuda.suffix_merge_plan()
    assert plan["f32_rows"] == 1 << 22
    for n in (plan["f32_rows"], plan["f32_rows"] + 5000):
        x = suffix_merge_edge_batch(("text", "zeros_halo"), n, lags=16, tile=plan["tile"],
                                    npad=n)
        args = tuple(torch.from_numpy(x[k]).to(dev) for k in ("sp", "adj", "halo_start"))
        for lags, max_dist in ((16, 32768), (127, 100)):
            kw = dict(lags=lags, max_dist=max_dist, payload_bytes=4 * PW6)
            _same([lz_cuda.suffix_merge_cuda(*args, **kw)],
                  [lz_cuda.suffix_merge_plain(*args, **kw)])


def test_suffix_merge_refuses_outside_its_fields(stages6, stages):
    args = (stages6["sp"], stages6["adj"], stages["halo"])
    for kw in (dict(lags=128, max_dist=32768, payload_bytes=28),
               dict(lags=16, max_dist=1 << 17, payload_bytes=28),
               dict(lags=16, max_dist=32768, payload_bytes=0)):
        with pytest.raises(ValueError):
            lz_cuda.suffix_merge_cuda(*args, **kw)


def test_hash_merge_kernel(stages, stages6):
    args = (stages6["sk"], stages6["lcps"], stages["halo"])
    kw = dict(pos_bits=_pos_bits(N), max_dist=32768, payload_bytes=4 * PW6)
    got = lz_cuda.hash_merge_cuda(*args, **kw)
    _same(got, lz_cuda.hash_merge_plain(*args, **kw))
    # K4 + K5 compute K2's function at 7 context words
    _same(got, lz_cuda.neighbor_plain(stages6["sk"], stages6["spays"], stages["halo"],
                                      pos_bits=_pos_bits(N), lags=2, max_dist=32768))


def test_match_tail2_kernel(stages, stages6):
    args = (stages["data"], stages6["packed_h_pos"], stages6["packed_s_pos"],
            stages["lengths"], stages["halo"])
    kw = dict(base=0, payload_bytes=4 * PW6, max_match=258, min_emit=3, lazy=True)
    _same(lz_cuda.match_tail2_cuda(*args, **kw), lz_cuda.match_tail2_plain(*args, **kw))


@pytest.mark.parametrize("n", [N, N - 1000], ids=["n131072", "n130072"])
@pytest.mark.parametrize("fields,payload_bytes", [(1, 8), (1, 12), (1, 28), (2, 28)],
                         ids=["K6-pb8", "K6-pb12", "K6-pb28", "K9-pb28"])
def test_tails_at_tile_edges(stages, fields, payload_bytes, n):
    """Runs of R - 1 to R + 1 across tile boundaries, periodic rows that
    chain through every round, runs far above R against a long suffix
    extension, halo_start > 0, lengths < n, and an n that is not a multiple
    of T (``tail_edge_batch``; T and R from ``lz_cuda.tail_window``)."""
    x = tail_edge_batch(KINDS * 4, n, payload_bytes=payload_bytes, seed=payload_bytes)
    x = {k: torch.from_numpy(v).to(stages["data"].device) for k, v in x.items()}
    planes = [x["packed_hash"], x["packed_suffix"]][:fields]
    args = (x["data"], *planes, x["lengths"], x["halo_start"])
    kw = dict(base=0, payload_bytes=payload_bytes, max_match=258, min_emit=3,
              lazy=payload_bytes != 8)  # level 1 (8 context bytes) is not lazy
    cuda, plain, lib = ((lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain, lz_cuda.MATCH_TAIL)
                        if fields == 1 else
                        (lz_cuda.match_tail2_cuda, lz_cuda.match_tail2_plain, lz_cuda.MATCH_TAIL2))
    before = lib.launches
    got = cuda(*args, **kw)
    assert lib.launches == before + 1
    _same(got, plain(*args, **kw))


D = 32768  # the stream halo
HALO_STARTS = {"carry": None, "1000": 1000, "base": D}


@pytest.fixture(scope="module")
def stream(stages):
    """Stream rows [halo, data] [B, D + N]: each row's halo is the 32 KiB
    of text before its block, as the writer's halo carries it."""
    text = _text(B * N + D, 5)
    data = torch.from_numpy(text[D:].reshape(B, N).copy()).to(stages["data"].device)
    halo = torch.from_numpy(np.stack([text[i * N: i * N + D] for i in range(B)]))
    ext = torch.cat([halo.to(data.device), data], dim=1)
    lengths = stages["lengths"]
    return dict(data=data, ext=ext, lengths=lengths)


def _halo_start(kind, device):
    """As the writer's ``make_halo`` gives it ("carry": row 0 without a
    carry, so halo_start = D; the other rows 0), or one value for all."""
    hs = torch.zeros((B,), dtype=torch.int32, device=device)
    hs[:] = D if kind == "base" else 1000 if kind == "1000" else 0
    if kind == "carry":
        hs[0] = D
    return hs


def _check(cuda, plain, *args, **kw):
    """Kernel against plain version on the same inputs; the kernel's result."""
    got, want = cuda(*args, **kw), plain(*args, **kw)
    as_tuple = lambda x: (x,) if isinstance(x, torch.Tensor) else x  # noqa: E731
    _same(as_tuple(got), as_tuple(want))
    return got


def _hash_stages(ext, lengths, hs, *, base, pw, lags, max_dist, max_match, min_emit, lazy):
    """K1, sort, K2, order restore, K6, each kernel held against its plain
    version; returns (match_len, match_dist)."""
    pos_bits = _pos_bits(ext.shape[1])
    key, pays = _check(lz_cuda.build_keys_cuda, lz_cuda.build_keys_plain, ext,
                       pos_bits=pos_bits, payload_words=pw)
    sk, order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, order.expand(pw, -1, -1))
    sp, packed = _check(lz_cuda.neighbor_cuda, lz_cuda.neighbor_plain, sk, spays, hs,
                        pos_bits=pos_bits, lags=lags, max_dist=max_dist)
    return _check(lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain, ext,
                  lz_cuda.restore_order(sp, packed), lengths, hs, base=base,
                  payload_bytes=4 * pw, max_match=max_match, min_emit=min_emit, lazy=lazy)


@pytest.mark.parametrize("kind", list(HALO_STARTS))
def test_hash_matcher_at_stream_shape(stream, kind):
    """Level 3's K1 (18 position bits), K2, K6 at base 32768 and K10."""
    ext, lengths = stream["ext"], stream["lengths"]
    hs = _halo_start(kind, ext.device)
    cfg = dk.DeflateEncodeConfig.for_level(N, "stream", "crc32", 3, dict_size=D)
    assert _pos_bits(ext.shape[1]) == 18
    ml, md = _hash_stages(ext, lengths, hs, base=D, pw=3, lags=2, max_dist=32768,
                          max_match=258, min_emit=3, lazy=True)
    assert int(ml[:, :D].abs().sum()) == 0
    marked, ln = dk.parse_stage(cfg, ml, lengths)
    finals = torch.zeros((B,), dtype=torch.bool, device=ext.device)
    bits, nbits = dk.block_entries(cfg, ext, marked, ln, md, finals)
    _check(pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain, bits, nbits, 0)


@pytest.mark.parametrize("kind", list(HALO_STARTS))
def test_suffix_matcher_at_stream_shape(stream, kind):
    """Level 6's K7, K4, K8, K1, K5, K9 at base 32768, and K10."""
    ext, lengths = stream["ext"], stream["lengths"]
    hs = _halo_start(kind, ext.device)
    keys, pos = _check(lz_cuda.build_suffix_keys_cuda, lz_cuda.build_suffix_keys_plain, ext,
                       payload_words=PW6)
    order = lz_cuda.suffix_order(keys, pos, 5)
    skeys = torch.gather(keys, 2, order.expand(PW6, -1, -1))
    sp = torch.gather(pos, 1, order)
    adj = _check(lz_cuda.lcp_lags_cuda, lz_cuda.lcp_lags_plain, skeys, 1, big_endian=True)[0]
    packed_s = _check(lz_cuda.suffix_merge_cuda, lz_cuda.suffix_merge_plain, sp, adj, hs,
                      lags=16, max_dist=32768, payload_bytes=4 * PW6)
    pos_bits = _pos_bits(ext.shape[1])
    key, pays = _check(lz_cuda.build_keys_cuda, lz_cuda.build_keys_plain, ext,
                       pos_bits=pos_bits, payload_words=PW6)
    sk, horder = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, horder.expand(PW6, -1, -1))
    lcps = _check(lz_cuda.lcp_lags_cuda, lz_cuda.lcp_lags_plain, spays, 2, big_endian=False)
    sp_h, packed_h = _check(lz_cuda.hash_merge_cuda, lz_cuda.hash_merge_plain, sk, lcps, hs,
                            pos_bits=pos_bits, max_dist=32768, payload_bytes=4 * PW6)
    ml, md = _check(lz_cuda.match_tail2_cuda, lz_cuda.match_tail2_plain, ext,
                    lz_cuda.restore_order(sp_h, packed_h), lz_cuda.restore_order(sp, packed_s),
                    lengths, hs, base=D, payload_bytes=4 * PW6, max_match=258, min_emit=3,
                    lazy=True)
    cfg = dk.DeflateEncodeConfig.for_level(N, "stream", "crc32", 6, dict_size=D)
    marked, ln = dk.parse_stage(cfg, ml, lengths)
    finals = torch.zeros((B,), dtype=torch.bool, device=ext.device)
    finals[-1] = True
    bits, nbits = dk.block_entries(cfg, ext, marked, ln, md, finals)
    _check(pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain, bits, nbits, 0)


@pytest.mark.parametrize("halo_start", [0, 1000, D])
@pytest.mark.parametrize("fields,payload_bytes", [(1, 12), (1, 8), (2, 28)],
                         ids=["K6-pb12", "K6-pb8", "K9-pb28"])
def test_tails_at_tile_edges_behind_a_halo(stages, fields, payload_bytes, halo_start):
    """``tail_edge_batch`` rows behind a 32 KiB halo, at base 32768: the
    tile window, the staging at the halo's left edge, and the run merge's
    ``i - 1 >= lo``."""
    x = tail_edge_batch(KINDS * 4, N - 1000, payload_bytes=payload_bytes, seed=payload_bytes)
    x = behind_halo(x, D, halo_start, payload_bytes=payload_bytes, seed=halo_start)
    x = {k: torch.from_numpy(v).to(stages["data"].device) for k, v in x.items()}
    planes = [x["packed_hash"], x["packed_suffix"]][:fields]
    kw = dict(base=D, payload_bytes=payload_bytes, max_match=258, min_emit=3,
              lazy=payload_bytes != 8)
    cuda, plain = ((lz_cuda.match_tail_cuda, lz_cuda.match_tail_plain) if fields == 1 else
                   (lz_cuda.match_tail2_cuda, lz_cuda.match_tail2_plain))
    _check(cuda, plain, x["data"], *planes, x["lengths"], x["halo_start"], **kw)


SNAPPY_N = 65536


def test_hash_matcher_at_snappy_limits(stages):
    """K1, K2 at max_dist 65,535, K6 at max_match 256 and min_emit 4 (its
    window R = 2 * 256 + 32), then K10 behind the 144-bit frame header."""
    data = stages["data"][:, :SNAPPY_N].contiguous()
    lengths = torch.full((B,), SNAPPY_N, dtype=torch.int32, device=data.device)
    lengths[3] = SNAPPY_N - 999
    data[3, SNAPPY_N - 999:] = 0
    hs = torch.zeros((B,), dtype=torch.int32, device=data.device)
    ml, md = _hash_stages(data, lengths, hs, base=0, pw=3, lags=2, max_dist=65535,
                          max_match=256, min_emit=4, lazy=False)
    cfg = sk_.SnappyEncodeConfig(block_len=SNAPPY_N)
    bits, nbits = sk_.snappy_entries(cfg, data, lengths, ml, md)
    _check(pack_cuda.pack_prescan_cuda, pack_cuda.pack_prescan_plain, bits, nbits,
           sk_.HEADER_BITS)


@pytest.mark.parametrize("fmt,level", [(Gzip, 3), (Gzip, 6), (Snap, 0)],
                         ids=["gzip-3", "gzip-6", "snappy"])
def test_streams_equal_cpu_run(stages, fmt, level):
    """Eight blocks and a 1,000-byte tail with 4 threads (two batches, so
    the halo crosses a batch boundary): the card's stream is the CPU's."""
    n = SNAPPY_N if fmt is Snap else N
    blob = _text(8 * n + 1000, 7).tobytes()
    outs = []
    for device in ("cuda", "cpu"):
        buf = io.BytesIO()
        w = ZBuilder(fmt).num_threads(4).compression_level(level).device(device).from_writer(buf)
        w.write(blob)
        w.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


# ---- K11: the batched inflate (csrc/inflate.cu) and the device read path


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bgzf(data: bytes, level: int, device) -> bytes:
    buf = io.BytesIO()
    w = ZBuilder(Bgzf).num_threads(B).compression_level(level).device(device).from_writer(buf)
    w.write(data)
    w.finish()
    return buf.getvalue()


def _bgzf_batch(blob: bytes, dev):
    """BGZF members as K11's inputs: payloads [n, 65536], in_lens, out_lens."""
    blocks, pos = [], 0
    while pos < len(blob):
        size = Bgzf.get_block_size(blob[pos: pos + Bgzf.header_size])
        blocks.append(blob[pos: pos + size])
        pos += size
    *inputs, over = stage_blocks(Bgzf, blocks, INFLATE_CAP, INFLATE_CAP)
    assert not over
    return blocks, tuple(torch.from_numpy(x).to(dev) for x in inputs)


def _inflate_same(got, want):
    """ok on every row; out and out_count where ok (a failed row's bytes
    are not part of the function)."""
    ok = want["ok"]
    assert torch.equal(got["ok"], ok)
    assert torch.equal(got["out"][ok], want["out"][ok])
    assert torch.equal(got["out_count"][ok], want["out_count"][ok])


def test_inflate_kernel_case_batch(card):
    c = inflate_case_batch(INFLATE_CAP, INFLATE_CAP, rows=40)
    args = tuple(torch.from_numpy(c[k]).to(card) for k in ("streams", "in_lens", "out_lens"))
    cfg = ik.InflateConfig(INFLATE_CAP, INFLATE_CAP)
    before = ik.INFLATE.launches
    got = ik.inflate_blocks_cuda(cfg, *args)
    assert ik.INFLATE.launches == before + 1
    _inflate_same(got, ik.inflate_blocks_plain(cfg, *args))
    assert np.array_equal(got["ok"].cpu().numpy(), c["expect_ok"])
    # every failed row is zero from its out_len
    for i in np.nonzero(~c["expect_ok"])[0]:
        assert not got["out"][i, c["out_lens"][i]:].any()


def test_inflate_kernel_odd_caps(card):
    """The case batch at in_cap 4,099 and out_cap 4,101 with max_blocks 16:
    rows that do not start on a 4-byte boundary, so the kernel's reader
    loads bytes, not words; the same function as the plain version."""
    c = inflate_case_batch(4099, 4101, rows=40)
    args = tuple(torch.from_numpy(c[k]).to(card) for k in ("streams", "in_lens", "out_lens"))
    cfg = ik.InflateConfig(4099, 4101, max_blocks=16)
    got = ik.inflate_blocks_cuda(cfg, *args)
    _inflate_same(got, ik.inflate_blocks_plain(cfg, *args))
    assert np.array_equal(got["ok"].cpu().numpy(), c["expect_ok"])


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_inflate_kernel_bgzf_blocks_vs_host_codec(card, level):
    """64 BGZF blocks of text (stored blocks of 65,280 B at level 0)
    written on the card, decoded by K11 with the device CRC: every block
    ok, its bytes the host codec's, its CRC the footer's."""
    data = _text(B * 65280 - 777, level).tobytes()
    blocks, args = _bgzf_batch(_bgzf(data, level, "cuda"), card)
    res = ik.get_inflater(ik.InflateConfig(INFLATE_CAP, INFLATE_CAP))(*args)
    native = get_native()
    out, ok, crc = (res[k].cpu().numpy() for k in ("out", "ok", "crc"))
    assert ok.all()
    for i, blk in enumerate(blocks):
        n = int.from_bytes(blk[-4:], "little")
        want = native.inflate(blk[18: len(blk) - 8], n) if n else b""
        assert out[i, :n].tobytes() == want
        assert not out[i, n:].any()
        assert int(crc[i]) == int.from_bytes(blk[-8:-4], "little")
    assert b"".join(out[i, : int(args[2][i])].tobytes() for i in range(len(blocks))) == data


def test_device_backend_reads_bgzf_on_the_card(card):
    data = _text(3 * B * 65280 + 12345, 11).tobytes()
    blob = _bgzf(data, 6, "cuda")
    before = ik.INFLATE.launches
    r = ParDecompress(Bgzf, io.BytesIO(blob), num_threads=16, backend="device")
    assert r.read() == data
    assert r.fallback_stats["native"] == 0 and r.fallback_stats["device"] > 3 * B
    assert ik.INFLATE.launches > before
    r = ParDecompress(Bgzf, io.BytesIO(blob), num_threads=16, backend="device", device=card)
    pieces = []
    while piece := r.read(100_000):
        pieces.append(piece)
    assert b"".join(pieces) == data and r.fallback_stats["native"] == 0


def test_device_backend_raises_on_a_kernel_fault(card, monkeypatch):
    """A row K11 reports ok but gets wrong (one byte flipped in its out
    row, the device CRC taken of the wrong row) raises: the host codec
    restores that block with its footer's CRC, so only K11 can be at
    fault, and the read does not count it as a fallback."""
    blob = _bgzf(_text(B * 65280, 12).tobytes(), 6, "cuda")
    real = ik.get_inflater

    def faulty(cfg):
        run = real(cfg)

        def wrong(streams_u8, in_lens, out_lens):
            res = run(streams_u8, in_lens, out_lens)
            res["out"][3, 7] ^= 1
            res["crc"] = ik.crc32_device(res["out"], out_lens)
            return res

        return wrong

    monkeypatch.setattr(ik, "get_inflater", faulty)
    r = ParDecompress(Bgzf, io.BytesIO(blob), num_threads=16, backend="device", device=card)
    with pytest.raises(RuntimeError, match="device inflate fault: block 3 "):
        r.read()
    r.close()


def test_inflate_wrapper_checks_its_tensors(card):
    cfg = ik.InflateConfig(64, 64)
    streams = torch.zeros((2, 64), dtype=torch.uint8, device=card)
    lens = torch.zeros(2, dtype=torch.int32, device=card)
    before = ik.INFLATE.launches
    with pytest.raises(ValueError):
        ik.inflate_blocks(cfg, streams.to("meta"), lens.to("meta"), lens.to("meta"))
    with pytest.raises(ValueError):
        ik.inflate_blocks_cuda(cfg, streams[:, :32].contiguous(), lens, lens)
    with pytest.raises(ValueError):
        ik.inflate_blocks_cuda(cfg, streams, lens.to(torch.int64), lens)
    assert ik.INFLATE.launches == before
    r = ik.inflate_blocks(cfg, streams, lens.to(torch.int64), lens)  # the wrapper converts
    assert r["ok"].all() and ik.INFLATE.launches == before + 1


# ---- the mesh (parallel/mesh.py) and the multi-process workers
# (parallel/multihost.py) on the card


def _meshes():
    """[cuda:0, cuda:0] on any card; two distinct cards where there are two."""
    return [pytest.param(2, id="cuda0-cuda0"), pytest.param(None, id="two-cards")]


@pytest.mark.parametrize("mesh_of", _meshes())
@pytest.mark.parametrize("fmt,level,cut", [(Mgzip, 3, None), (Gzip, 3, 5 * N + 1234)],
                         ids=["mgzip-3", "gzip-3-flush"])
def test_mesh_equals_one_device(card, mesh_of, fmt, level, cut):
    """A batch split over a mesh writes the one-device stream: 16 blocks
    and a tail at 8 threads (two batches; with Gzip's flush a partial
    block mid-batch, so a device's first row takes the halo of a row on
    the device before it)."""
    if mesh_of is None:
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two CUDA devices")
        mesh = [torch.device("cuda", 0), torch.device("cuda", 1)]
    else:
        mesh = [card] * mesh_of
    blob = _text(16 * N + 777, 11).tobytes()
    outs = []
    for m in (None, mesh):
        buf = io.BytesIO()
        b = ZBuilder(fmt).num_threads(8).compression_level(level)
        w = (b.device(card) if m is None else b.mesh(m)).from_writer(buf)
        if cut is None:
            w.write(blob)
        else:
            w.write(blob[:cut])
            w.flush()
            w.write(blob[cut:])
        w.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def test_two_process_workers_on_the_card(card, tmp_path):
    """Two worker processes on the card (cuda:<rank mod devices>), stitched,
    equal a one-process run; each launched K1, K2, K6 and K10."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from gzp_tpu_torch.parallel import multihost as mh

    data = _text(40 * N + 4321, 12).tobytes()
    inp = tmp_path / "input.bin"
    inp.write_bytes(data)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, outs = [], []
    for rank in range(2):
        outs.append(tmp_path / f"shard{rank}.bin")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gzp_tpu_torch.parallel.multihost",
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--rank", str(rank), "--format", "gzip", "--num-threads", "8",
             "--input", str(inp), "--output", str(outs[-1])],
            cwd=Path(__file__).resolve().parent.parent,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err
    for out, _ in results:
        line = json.loads(out.strip().splitlines()[-1])
        assert line["device"].startswith("cuda")
        for k in ("build_keys", "neighbor", "match_tail", "pack_prescan"):
            assert line["launches"][k] > 0, line
    buf = io.BytesIO()
    mh.stitch_shards(Gzip, [mh.ShardResult.from_bytes(o.read_bytes()) for o in outs], buf)
    one = io.BytesIO()
    w = ZBuilder(Gzip).num_threads(8).device(card).from_writer(one)
    w.write(data)
    w.finish()
    assert buf.getvalue() == one.getvalue()
