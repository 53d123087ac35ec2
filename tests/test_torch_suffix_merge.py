"""The suffix merge K8 and its exit rule, on the CPU.

``csrc/suffix_merge.cu`` walks every slot through all ``lags`` in lock
step, on fp32 keys for rows of up to 2^22 slots and on int32 keys past
them; ``chip_smoke.py`` bounds it by the candidate tests these inputs need
under the exit rule, counted by ``lz_cuda.suffix_merge_work``. Held here:

* ``suffix_merge_work``'s counts equal ``_slot_walk`` below, a walk of one
  slot at a time in the reference's own terms (the held length, distance
  and capped bit, the keep rule, the exit rule written on them), whose
  packed words equal ``suffix_merge_plain``'s on the rows of
  ``suffix_merge_edge_batch`` (all-zero, random, period-3 and text rows,
  ``halo_start`` > 0, tile edges) at ``max_dist`` 32768 and 100 and lags
  1, 2, 16, 24 and 127; on longer rows the counts hold what those rows
  need (one test a slot where the source 1 back is the longest);
* ``emulate_kernel`` below, a numpy emulation of the kernel's arithmetic
  on either key type and its tiles, equals ``suffix_merge_plain`` on those
  rows, and a halo one slot short of ``lags`` breaks the equality;
* fp32 keys are exact for positions below 2^22 and not past 2^23, where
  int32 keys still are (positions moved up by a constant);
* on one level-6 block of bench text the needed share is below 1 and the
  plain words equal ``suffix_neighbor_pallas``'s (interpret mode).

Tolerance: exact equality (integer code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops.lz_pallas import build_suffix_keys_pallas, suffix_neighbor_pallas
from gzp_tpu_torch.ops import lz_cuda
from gzp_tpu_torch.utils.testing import SUFFIX_KINDS, suffix_merge_edge_batch

PB = 28  # level 6's context bytes
LAGS = [1, 2, 16, 24, 127]
MAX_DISTS = [32768, 100]
N_EDGE = 5000  # 5,120 slots: 2 1/2 of the kernel's tiles
KEY0 = 1 << 17


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TILE = 512  # the tile_edge rows' edges, and the emulated kernel's small tiles
KERNEL_TILE = 2048  # TILE in csrc/suffix_merge.cu, the emulated kernel's large tiles


def _edge_rows(lags, n=N_EDGE, seed=3):
    x = suffix_merge_edge_batch(SUFFIX_KINDS, n, lags=lags, tile=TILE, seed=seed)
    return x, tuple(torch.from_numpy(x[k]) for k in ("sp", "adj", "halo_start"))


def _slot_walk(sp, adj, lo, s, *, lags, max_dist):
    """Slot ``s`` of one row walked in the reference's terms -> (packed
    word, candidate tests). Up then down at each lag, a direction tested
    while its running minimum m could still win: m >= max(len, 1), and not
    a tie with a held distance of 1."""
    n, me = len(sp), sp[s]
    ls = ds = tests = 0
    cs = False
    m = [None, None]
    alive = [True, True]
    for k in range(1, lags + 1):
        for d, (j, step) in enumerate(((s - k, s - k + 1), (s + k, s + k))):
            if not alive[d]:
                continue
            a = adj[step] if 0 <= step < n else 0
            m[d] = a if k == 1 else min(m[d], a)
            alive[d] = m[d] >= max(ls, 1) and not (m[d] == ls and ds == 1)
            if not alive[d]:
                continue
            tests += 1
            cpos = sp[j] if 0 <= j < n else -1
            dist = me - cpos
            valid = cpos >= lo and 1 <= dist <= max_dist
            ln = m[d] if valid else 0
            if not (ls > ln or (ls == ln and ds < dist)):
                ls, ds, cs = ln, dist, valid and m[d] >= PB
        if not any(alive):
            break
    return (ds if ls > 0 else 0) | ls << 17 | int(cs) << 22, tests


@pytest.mark.parametrize("max_dist", MAX_DISTS)
@pytest.mark.parametrize("lags", LAGS)
def test_work_equals_slot_walk(lags, max_dist):
    """Counts and words of every slot of small rows, one slot at a time."""
    x, (sp, adj, hs) = _edge_rows(lags, n=1200, seed=lags)
    kw = dict(lags=lags, max_dist=max_dist)
    tests = lz_cuda.suffix_merge_work(sp, adj, hs, payload_bytes=PB, **kw).numpy()
    plain = lz_cuda.suffix_merge_plain(sp, adj, hs, payload_bytes=PB, **kw).numpy()
    for r in range(sp.shape[0]):
        row_sp, row_adj, lo = x["sp"][r].tolist(), x["adj"][r].tolist(), int(hs[r])
        got = [_slot_walk(row_sp, row_adj, lo, s, **kw) for s in range(len(row_sp))]
        assert [t for _, t in got] == tests[r].tolist(), SUFFIX_KINDS[r]
        assert [w for w, _ in got] == plain[r].tolist(), SUFFIX_KINDS[r]


@pytest.mark.parametrize("max_dist", MAX_DISTS)
@pytest.mark.parametrize("lags", LAGS)
def test_work_on_edge_rows(lags, max_dist):
    """On longer rows: at most 2 x lags tests a slot; on the all-zero row
    (LCPs of 28 bytes, adj[0] too) slot 0 tests the out-of-row slot above
    it and each down candidate (all later positions: distances below 1),
    and every other slot only the source 1 back, which nothing beats."""
    _, edge_rows = _edge_rows(lags)
    tests = lz_cuda.suffix_merge_work(*edge_rows, lags=lags, max_dist=max_dist,
                                      payload_bytes=PB)
    assert tests.dtype == torch.int64 and tests.shape == edge_rows[0].shape
    assert int(tests.min()) >= 1 and int(tests.max()) <= 2 * lags
    zeros = tests[SUFFIX_KINDS.index("zeros")]
    assert int(zeros[0]) == lags + 1 and torch.equal(zeros[1:], torch.ones_like(zeros[1:]))


@pytest.mark.parametrize("lags", LAGS)
def test_tile_edge_rows_hold_their_case(lags):
    """At every edge of the tile_edge row, the slot's best candidate is the
    one exactly ``lags`` away: distance 1, the full 28 bytes, capped."""
    x, rows = _edge_rows(lags)
    r = SUFFIX_KINDS.index("tile_edge")
    packed = lz_cuda.suffix_merge_plain(*rows, lags=lags, max_dist=32768, payload_bytes=PB)
    npad = packed.shape[1]
    slots = [e if q % 2 == 0 else e - 1
             for q, e in enumerate(range(TILE, npad - lags, TILE)) if e >= lags]
    assert len(slots) >= 8
    assert packed[r, slots].tolist() == [1 | PB << 17 | 1 << 22] * len(slots)


def emulate_kernel(sp, adj, halo_start, *, lags, max_dist, payload_bytes, tile, keys="f32",
                   halo=None):
    """numpy emulation of ``csrc/suffix_merge.cu`` on ``keys`` "f32" or
    "i32": per tile of ``tile`` slots, the staged pairs (position, or MARK
    before halo_start; LCP key) over the tile and ``halo`` slots on each
    side (default ``lags`` rounded up to 32), each slot's walk over every
    lag, then the packed words. fp32: w = a - cpos with a = p - 1 - h, valid
    iff |w| <= h, key G - w, all rounded to fp32; int32: w = a - cpos with
    a = p - 1, valid iff w < max_dist as uint32, key G - w. A read past the
    staged slots finds an out-of-row pair, as a short halo would lose
    it."""
    sp, adj, lo = (np.asarray(t, np.int64) for t in (sp, adj, halo_start))
    b, npad = sp.shape
    halo = -(-lags // 32) * 32 if halo is None else halo
    if keys == "f32":
        f = np.float32
        h = f(0.5) * f(max_dist - 1)
        mark, top, a_none = f(-(1 << 23)), np.finfo(f).max, np.finfo(f).max

        def pair(p, a):
            return (np.where(p >= lo[:, None], p.astype(f), mark).astype(f),
                    ((a + 1).astype(f) * f(KEY0) - (f(1) + h)).astype(f))

        def own(x):
            return np.where(x == mark, a_none, x - (f(1) + h)).astype(f)

        def consider(best, a, g, cpos):
            w = (a - cpos).astype(f)
            return np.where(np.abs(w) <= h, np.maximum(best, (g - w).astype(f)), best)
    else:
        f = np.int64
        mark, top = -(1 << 31), (1 << 31) - 1

        def pair(p, a):
            return np.where(p >= lo[:, None], p, mark), ((a + 1) << 17) - 1

        def own(x):
            return np.where(x == mark, 3 << 29, x - 1)

        def consider(best, a, g, cpos):
            w = (a - cpos) & 0xFFFFFFFF
            return np.where(w < max_dist, np.maximum(best, g - w), best)
    out = np.zeros((b, npad), np.int64)
    for t0 in range(0, npad, tile):
        s = np.arange(t0 - halo, t0 + tile + halo)
        inrow = (s >= 0) & (s < npad)
        at = np.clip(s, 0, npad - 1)
        pos, key = pair(np.where(inrow, sp[:, at], -1),
                        np.where(inrow, np.maximum(adj[:, at], 0), 0))
        pos0, key0 = pair(np.full((b, 1), -1), np.zeros((b, 1), np.int64))

        def staged(i):
            ok = (i >= 0) & (i < len(s))
            j = np.clip(i, 0, len(s) - 1)
            return np.where(ok, pos[:, j], pos0), np.where(ok, key[:, j], key0)

        c = halo + np.arange(min(tile, npad - t0))
        me = own(pos[:, c])
        best = np.full(me.shape, KEY0, f)
        gu = np.full(me.shape, top, f)
        gd = gu.copy()
        for k in range(1, lags + 1):
            for g, (cpos, step) in ((gu, (staged(c - k)[0], staged(c - k + 1)[1])),
                                    (gd, staged(c + k))):
                np.minimum(g, step, out=g)
                best = consider(best, me, g, cpos)
        kk = best.astype(np.int64)
        ln = kk >> 17
        word = (((ln + 1) << 17) - kk) | (ln << 17) | ((ln >= payload_bytes).astype(np.int64) << 22)
        out[:, t0: t0 + len(c)] = np.where(kk == KEY0, 0, word)
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("max_dist", MAX_DISTS)
@pytest.mark.parametrize("lags", LAGS)
def test_emulated_kernel_equals_plain(lags, max_dist):
    _, edge_rows = _edge_rows(lags)
    kw = dict(lags=lags, max_dist=max_dist, payload_bytes=PB)
    want = lz_cuda.suffix_merge_plain(*edge_rows, **kw)
    for keys in ("f32", "i32"):
        # small tiles put many tile edges in the rows
        for tile in (KERNEL_TILE, TILE):
            assert torch.equal(emulate_kernel(*edge_rows, tile=tile, keys=keys, **kw), want)


@pytest.mark.parametrize("lags", [16, 24, 127])
def test_short_halo_breaks_equality(lags):
    _, edge_rows = _edge_rows(lags)
    kw = dict(lags=lags, max_dist=32768, payload_bytes=PB)
    got = emulate_kernel(*edge_rows, tile=TILE, halo=lags - 1, **kw)
    assert not torch.equal(got, lz_cuda.suffix_merge_plain(*edge_rows, **kw))


@pytest.mark.parametrize("max_dist", MAX_DISTS)
@pytest.mark.parametrize("lift, f32_exact", [((1 << 22) - 5120, True),
                                             ((1 << 23) + (1 << 16), False),
                                             ((1 << 30) - 5120, False)])
def test_keys_at_large_positions(lift, f32_exact, max_dist):
    """The edge rows with every position and halo_start moved up by
    ``lift`` (distances unchanged): the plain words stay, int32 keys
    give them at any lift, fp32 keys up to positions below 2^22 (the rows
    the kernel gives them) and not past 2^23."""
    _, (sp, adj, hs) = _edge_rows(16)
    kw = dict(lags=16, max_dist=max_dist, payload_bytes=PB)
    want = lz_cuda.suffix_merge_plain(sp, adj, hs, **kw)
    moved = (torch.where(sp >= 0, sp + lift, sp), adj, hs + lift)
    assert int(moved[0].max()) < (1 << 22 if f32_exact else 1 << 30)
    assert torch.equal(lz_cuda.suffix_merge_plain(*moved, **kw), want)
    assert torch.equal(emulate_kernel(*moved, tile=TILE, keys="i32", **kw), want)
    assert torch.equal(emulate_kernel(*moved, tile=TILE, keys="f32", **kw), want) == f32_exact


def test_level6_block_share_and_pallas():
    """One 128 KiB block of bench text at level 6's config (7 words, 5 sort
    keys, lags 16): fewer tests than lags allow, and the plain words are
    the Pallas path's."""
    from bench import make_corpus

    n, pw, skw, lags = 131072, 7, 5, 16
    data = np.frombuffer(make_corpus(n), np.uint8).reshape(1, n)
    keys, pos = build_suffix_keys_pallas(jnp.asarray(data), payload_words=pw)
    srt = jax.lax.sort((*keys[:skw], pos, *keys[skw:]), dimension=1, num_keys=skw + 1)
    skeys, sp = list(srt[:skw]) + list(srt[skw + 1:]), srt[skw]
    halo = jnp.zeros((1,), jnp.int32)
    _, want = suffix_neighbor_pallas(skeys, sp, halo, lags=lags, max_dist=32768)
    words = torch.from_numpy(np.stack([np.asarray(k) for k in skeys]).view(np.int32))
    adj = lz_cuda.lcp_lags_plain(words, 1, big_endian=True)[0]
    args = (torch.from_numpy(np.array(sp)), adj, torch.zeros(1, dtype=torch.int32))
    kw = dict(lags=lags, max_dist=32768, payload_bytes=4 * pw)
    tests = lz_cuda.suffix_merge_work(*args, **kw)
    share = float(tests.sum()) / (2 * lags * tests.numel())
    assert 0.2 < share < 1
    packed = lz_cuda.suffix_merge_plain(*args, **kw)
    assert np.array_equal(packed.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
