"""The sorted-neighbour kernel K2 (and K3's function), on the CPU.

``csrc/neighbor.cu`` computes K2 and the TPU's K3 with one body: CTAs take
tiles of ``lz_cuda.NEIGHBOR_TILE`` slots of a hash-sorted row and stage the
tile with a halo of the ``lags`` slots before it, a sentinel key below the
row start. Three things are held here:

* ``neighbor_plain`` (the CPU route of ``lz_cuda.neighbor_cuda``) against
  ``neighbor_pallas`` in interpret mode (``_neighbor_kernel`` at lags <= 2,
  ``_neighbor_loop_kernel`` above) on hash-sorted text at 1-3 context
  words, lags 3, 16 and 127, ``halo_start`` 0 and > 0, ``max_dist`` 32768
  and 37, and on the edge rows of ``gzp_tpu_torch.utils.testing.
  neighbor_edge_batch``;
* ``tiled_neighbor`` below, a torch emulation of the kernel's tiles (its
  window alone, its candidate rule: skip the invalid, take the longer or
  the equally long and nearer) against ``neighbor_plain`` on the edge rows
  at lags 1, 2, 4 and 127; a halo one slot short of ``lags`` must break
  the equality, so the test can tell;
* that the edge rows hold the cases their kinds name.

Tolerance: exact equality (integer code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops.lz_pallas import neighbor_pallas
from gzp_tpu_torch.ops import lz_cuda
from gzp_tpu_torch.ops.lz import _pos_bits
from gzp_tpu_torch.utils.testing import NEIGHBOR_KINDS, neighbor_edge_batch

M32 = 0xFFFFFFFF
B, N = 2, 4096
TILE = lz_cuda.NEIGHBOR_TILE
# ragged last tiles, in a row not a multiple of 4 (the kernel's scalar
# loads) and in one that is (16-byte loads)
NPADS = [2 * TILE + 1027, 4 * TILE + 2044]
NP_PALLAS = 5 * 1024  # whole (8, 128) tiles, as the Pallas kernels take


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _text(seed):
    """Text of a few repeated phrases: most hash buckets hold matches."""
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ", b"to be or not to be ",
             b"pack my box with five dozen liquor jugs "]
    out = b"".join(words[i] for i in rng.integers(0, len(words), B * N // 10))
    return np.frombuffer(out[: B * N], np.uint8).reshape(B, N).copy()


@pytest.fixture(scope="module", params=[1, 2, 3], ids=lambda p: f"pw{p}")
def sorted_text(request):
    """Hash-sorted keys and payloads of text at ``pw`` words (K1's plain
    version and the hash sort, as ``hash_pass`` makes them)."""
    pw = request.param
    data = torch.from_numpy(_text(pw))
    pos_bits = _pos_bits(N)
    key, pays = lz_cuda.build_keys_plain(data, pos_bits=pos_bits, payload_words=pw)
    sk, order = torch.sort(key.to(torch.int64) & M32, dim=1)
    spays = torch.gather(pays, 2, order.expand(pw, -1, -1))
    return sk, spays, pos_bits


def _pallas(sk, pays, halo, *, pos_bits, lags, max_dist):
    sp, packed = neighbor_pallas(
        jnp.asarray(np.asarray(sk).astype(np.uint32)),
        [jnp.asarray(np.asarray(p).view(np.uint32)) for p in pays], jnp.asarray(halo),
        pos_bits=pos_bits, lags=lags, max_dist=max_dist)
    return np.asarray(sp).view(np.int32), np.asarray(packed).view(np.int32)


@pytest.mark.parametrize("max_dist", [32768, 37])
@pytest.mark.parametrize("halo", [(0, 0), (100, 1500)], ids=["halo0", "halo>0"])
@pytest.mark.parametrize("lags", [3, 16, 127])
def test_neighbor_plain_equals_pallas(sorted_text, lags, halo, max_dist):
    sk, spays, pos_bits = sorted_text
    halo = np.array(halo, np.int32)
    kw = dict(pos_bits=pos_bits, lags=lags, max_dist=max_dist)
    sp, packed = lz_cuda.neighbor_cuda(sk, spays, torch.from_numpy(halo), **kw)  # CPU: plain
    want_sp, want_packed = _pallas(sk.numpy(), spays.numpy(), halo, **kw)
    assert np.array_equal(sp.numpy(), want_sp)
    assert np.array_equal(packed.numpy(), want_packed)
    assert (packed.numpy() != 0).mean() > 0.1  # many slots found a candidate


def tiled_neighbor(sk, pays, halo_start, *, pos_bits, lags, max_dist, tile, halo=None):
    """K2 tile by tile from the window the kernel stages: slots [t0 - halo,
    t0 + tile) of the row (``halo`` defaults to ``lags``), the key ~0 below
    the row start; a lag past the window finds no candidate. Returns (sp,
    packed) [B, Np] int32 as ``neighbor_plain``."""
    halo = lags if halo is None else halo
    b, npad = sk.shape
    pw = pays.shape[0]
    mask = (1 << pos_bits) - 1
    key, words = sk & M32, pays.to(torch.int64) & M32
    lo = halo_start.to(torch.int64)[:, None]
    packed = torch.empty((b, npad), dtype=torch.int64)
    for t0 in range(0, npad, tile):
        t1 = min(t0 + tile, npad)
        # the window [t0 - lags, t1); the first lags - halo slots unstaged
        wk = torch.full((b, lags + t1 - t0), M32, dtype=torch.int64)
        ww = torch.zeros((pw, b, lags + t1 - t0), dtype=torch.int64)
        src = max(t0 - halo, 0)
        wk[:, src - t0 + lags:] = key[:, src:t1]
        ww[:, :, src - t0 + lags:] = words[:, :, src:t1]
        me, mw = wk[:, lags:], ww[:, :, lags:]
        sp, sh = me & mask, me >> pos_bits
        ls = torch.zeros_like(sp)
        ds = torch.zeros_like(sp)
        for lag in range(1, lags + 1):
            kc = wk[:, lags - lag: lags - lag + t1 - t0]
            cpos = kc & mask
            dist = sp - cpos
            valid = ((kc >> pos_bits) == sh) & (cpos >= lo) & (dist >= 1) & (dist <= max_dist)
            ln = torch.full_like(sp, 4 * pw)
            for k in reversed(range(pw)):  # the first differing word wins
                x = mw[k] ^ ww[k, :, lags - lag: lags - lag + t1 - t0]
                ln = torch.where(x != 0, 4 * k + lz_cuda._tz_bytes(x), ln)
            take = valid & ((ln > ls) | ((ln == ls) & (dist < ds)))
            ls, ds = torch.where(take, ln, ls), torch.where(take, dist, ds)
        packed[:, t0:t1] = ds | (ls << 17) | ((ls == 4 * pw).to(torch.int64) << 22)
    return (key & mask).to(torch.int32), packed.to(torch.int32)


def _edge_batch(npad, lags, pw=3, max_dist=32768):
    return neighbor_edge_batch(NEIGHBOR_KINDS, npad, tile=TILE, lags=lags, payload_words=pw,
                               max_dist=max_dist, seed=npad + lags)


def _edge_rows(npad, lags, pw=3, max_dist=32768):
    x = _edge_batch(npad, lags, pw, max_dist)
    return (torch.from_numpy(x["sk"]), torch.from_numpy(x["pays"]),
            torch.from_numpy(x["halo_start"]), x["pos_bits"])


@pytest.mark.parametrize("npad", NPADS, ids=["ragged-odd", "ragged-4"])
@pytest.mark.parametrize("lags", [1, 2, 4, 127])
def test_tiled_neighbor_equals_plain(lags, npad):
    sk, pays, halo, pos_bits = _edge_rows(npad, lags)
    kw = dict(pos_bits=pos_bits, lags=lags, max_dist=32768)
    want = lz_cuda.neighbor_plain(sk, pays, halo, **kw)
    got = tiled_neighbor(sk, pays, halo, tile=TILE, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # at a small max_dist too (the limits row's pairs move with it)
    sk, pays, halo, pos_bits = _edge_rows(npad, lags, pw=2, max_dist=37)
    kw = dict(pos_bits=pos_bits, lags=lags, max_dist=37)
    want = lz_cuda.neighbor_plain(sk, pays, halo, **kw)
    assert torch.equal(tiled_neighbor(sk, pays, halo, tile=TILE, **kw)[1], want[1])


@pytest.mark.parametrize("lags", [1, 2, 4, 127])
def test_short_halo_breaks_equality(lags):
    """Slot e of each tile edge has its only whole-context candidate
    exactly ``lags`` back: a halo of ``lags`` - 1 slots misses it."""
    sk, pays, halo, pos_bits = _edge_rows(NPADS[0], lags)
    row = NEIGHBOR_KINDS.index("bucket_edge")
    kw = dict(pos_bits=pos_bits, lags=lags, max_dist=32768)
    want = lz_cuda.neighbor_plain(sk, pays, halo, **kw)[1][row]
    assert torch.equal(tiled_neighbor(sk, pays, halo, tile=TILE, **kw)[1][row], want)
    short = tiled_neighbor(sk, pays, halo, tile=TILE, halo=lags - 1, **kw)[1][row]
    edges = torch.arange(TILE, NPADS[0], TILE)
    assert not torch.equal(short[edges], want[edges])


@pytest.mark.parametrize("lags", [1, 2, 4, 127])
def test_plain_equals_pallas_on_edge_rows(lags):
    npad = NP_PALLAS
    for pw in (1, 3):
        x = neighbor_edge_batch(NEIGHBOR_KINDS, npad, tile=TILE, lags=lags, payload_words=pw,
                                max_dist=37, seed=lags + pw)
        kw = dict(pos_bits=x["pos_bits"], lags=lags, max_dist=37)
        sp, packed = lz_cuda.neighbor_cuda(torch.from_numpy(x["sk"]), torch.from_numpy(x["pays"]),
                                           torch.from_numpy(x["halo_start"]), **kw)
        want_sp, want_packed = _pallas(x["sk"], x["pays"], x["halo_start"], **kw)
        assert np.array_equal(sp.numpy(), want_sp)
        assert np.array_equal(packed.numpy(), want_packed)


def test_edge_rows_hold_their_cases():
    """Each kind puts the kernel where its name says, at lags 4."""
    lags, npad = 4, NPADS[0]
    x = _edge_batch(npad, lags)
    sk, pays, halo = (torch.from_numpy(x[k]) for k in ("sk", "pays", "halo_start"))
    pos_bits = x["pos_bits"]
    _, packed = lz_cuda.neighbor_plain(sk, pays, halo, pos_bits=pos_bits, lags=lags,
                                       max_dist=32768)
    p = packed.to(torch.int64).numpy() & M32
    ln, dist, capped = (p >> 17) & 0x1F, p & 0x1FFFF, (p >> 22) & 1
    sh, pos = x["sk"] >> pos_bits, x["sk"] & ((1 << pos_bits) - 1)
    k = NEIGHBOR_KINDS.index
    sites = {kind: [(a, n) for r, a, n in x["sites"] if r == k(kind)] for kind in NEIGHBOR_KINDS}
    # hash order in every row; each built bucket is one hash of its own
    assert (np.diff(sh, axis=1) >= 0).all()
    for r, a, n in x["sites"]:
        assert (sh[r, a: a + n] == sh[r, a]).all()
        assert a == 0 or sh[r, a - 1] != sh[r, a]
        assert a + n == npad or sh[r, a + n] != sh[r, a]
    # bucket_edge: slot e's only capped candidate is lags back, across the edge
    row = k("bucket_edge")
    edges = np.array([a + n - 8 for a, n in sites["bucket_edge"]])
    assert (edges % TILE == 0).all()
    assert len(sites["bucket_edge"]) == len(edges) >= 2 and halo[row] == 0
    assert (capped[row, edges] == 1).all()
    assert (dist[row, edges] == pos[row, edges] - pos[row, edges - lags]).all()
    # row_start: a capped bucket whose first slots have fewer than lags
    # candidates, with the hash and context of the row before's last bucket
    row = k("row_start")
    assert (sh[row, : lags + 4] == sh[row - 1, -1]).all() and halo[row] == 0
    assert torch.equal(pays[:, row, 0], pays[:, row - 1, -1])
    assert pos[row, 0] > pos[row - 1, -1]
    assert (ln[row, 1: lags + 4] == 12).all() and ln[row, 0] == 0
    # limits: of each six pairs the ones at halo_start and at max_dist are valid
    row = k("limits")
    assert halo[row] > 0
    second = np.array([a + 1 for a, _ in sites["limits"]])[: 6 * 20]
    assert pos[row, second[0] - 1] == halo[row]
    assert (dist[row, second[2::6]] == 32768).all()
    assert ((ln[row, second] > 0).reshape(-1, 6).sum(axis=0) == [20, 0, 20, 0, 0, 0]).all()
    # ties: one length in each bucket, and nearest-first winners off lag 1
    row, off_lag1 = k("ties"), 0
    for a, n in sites["ties"]:
        assert set(ln[row, a + 1: a + n]) <= {0, 7}
        for j in range(a + 1, a + n):
            off_lag1 += bool(ln[row, j] and dist[row, j] != pos[row, j] - pos[row, j - 1])
    assert off_lag1 > 20
    # capped: whole contexts; byte_diff: the second of each pair stops at the
    # flipped byte, every byte of every word in turn
    row = k("capped")
    assert all((ln[row, a + 1: a + n] == 12).all() for a, n in sites["capped"] if halo[row] == 0)
    row = k("byte_diff")
    hits = [(q % 12, ln[row, a + 1]) for q, (a, _) in enumerate(sites["byte_diff"])
            if pos[row, a] >= halo[row]]
    assert all(b == got for b, got in hits) and {b for b, _ in hits} == set(range(12))
