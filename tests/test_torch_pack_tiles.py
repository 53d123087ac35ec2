"""The look-back argument of the tile-parallel pack pre-scan K10, on the CPU.

``csrc/pack_prescan.cu`` splits each row into tiles of T entries and
carries two prefixes into each tile with a decoupled look-back: the width
sum, then the segmented-OR state, which a tile can only compute once its
width prefix gives it the bit phases. ``tiled_prescan`` below emulates that
in torch, tile by tile: local scans, the edge entry t0 - 1 recomputed from
the width prefix, and the combine over the predecessors' status words as
the kernel's warp reads them (32 at a time, ending at an inclusive prefix,
or for the OR state also at an aggregate that holds a segment start). It
must equal the whole-row plain version ``pack_prescan_plain`` at every
index, on rows built for the tile edges (``gzp_tpu_torch.utils.testing.
pack_edge_batch``), at T = 256, whatever the predecessors have published.
A combine that looks back one tile only must break the equality on the
long-segment row, so the test can tell. The same rows also go through
``pack_prescan_pallas`` (interpret mode). Tolerance: exact equality
(integer code); against Pallas, ``val`` where the key names a word, as in
tests/test_torch_pack.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops.pack_pallas import pack_prescan_pallas
from gzp_tpu_torch.ops import pack_cuda
from gzp_tpu_torch.utils.testing import PACK_KINDS, pack_edge_batch

TILE = 256
M32 = 0xFFFFFFFF
RESET = 1 << 32
# E: a ragged last tile; the tail entry E first in its tile; E < T
SIZES = [5 * TILE + 123, 4 * TILE, TILE - 37]
BASES = [0, 144, 160]


def _seg_or(a, b):
    """SegOrOp on packed (value | reset << 32) int64 tensors, a earlier."""
    return torch.where((b & RESET) != 0, b, (a | b) & M32) | ((a | b) & RESET)


def _fold(payload, op):
    """Fold [rows, lanes] in lane order."""
    acc = torch.zeros_like(payload[:, 0])
    for lane in range(payload.shape[1]):
        acc = op(acc, payload[:, lane])
    return acc


def _look_back(status, tile, op, terminal):
    """The exclusive prefix of ``tile`` from ``status`` (a list of (flag,
    payload [rows]) per earlier tile, flag "agg" or "incl"), read 32 tiles
    at a time from the tile before; tiles before the row start read as an
    inclusive identity. Returns (prefix [rows], tiles read back)."""
    rows = status[0][1].shape[0]
    prefix = torch.zeros(rows, dtype=torch.int64)
    done = torch.zeros(rows, dtype=torch.bool)
    end, depth = tile, torch.zeros(rows, dtype=torch.int64)
    while not bool(done.all()):
        lanes = range(end - 32, end)
        pay = torch.stack([status[p][1] if p >= 0 else torch.zeros(rows, dtype=torch.int64)
                           for p in lanes], dim=1)
        term = torch.stack([terminal(*status[p]) if p >= 0 else torch.ones(rows, dtype=torch.bool)
                            for p in lanes], dim=1)
        lane = torch.arange(32)[None, :]
        first = torch.where(term, lane, -1).max(dim=1).values
        win = _fold(torch.where(lane >= first.clamp(min=0)[:, None], pay, 0), op)
        prefix = torch.where(done, prefix, op(win, prefix))
        depth = torch.where(done | (first < 0), depth, tile - (end - 32 + first))
        done |= first >= 0
        end -= 32
    return prefix, depth


def _incl(flag, payload):
    return torch.full(payload.shape, flag == "incl")


def _ends_or(flag, payload):
    return (flag == "incl") | ((payload & RESET) != 0)


def _scan_in_tile(c, start):
    """Inclusive segmented OR-scan of one tile: (value, reset) [rows, T]."""
    val, res = c, start
    s = 1
    while s < c.shape[1]:
        pad = torch.zeros_like(val[:, :s])
        v_l = torch.cat([pad, val[:, :-s]], dim=1)
        r_l = torch.cat([pad.bool(), res[:, :-s]], dim=1)
        val = torch.where(res, val, v_l | val)
        res = res | r_l
        s *= 2
    return val, res


def tiled_prescan(bits, nbits, base_bits, *, tile, published="agg", or_back=None, seed=0):
    """K10 computed tile by tile. ``published``: what the predecessors show
    when a tile looks back ("agg": aggregates only, "incl": inclusive
    prefixes, "mixed": either, at random). ``or_back=1`` takes the OR prefix
    from the tile before alone (the wrong design). Returns (key, val,
    total_bits) as ``pack_prescan_plain`` does, and the deepest OR look-back
    (in tiles)."""
    rng = np.random.default_rng(seed)
    rows, e = bits.shape
    ep = pack_cuda.prescan_len(e)
    v = torch.zeros((rows, ep), dtype=torch.int64)
    nb = torch.zeros((rows, ep), dtype=torch.int64)
    v[:, :e] = bits.to(torch.int64) & M32
    nb[:, :e] = nbits
    key = torch.empty((rows, ep), dtype=torch.int64)
    val = torch.empty((rows, ep), dtype=torch.int64)
    width_status, or_status = [], []  # per tile: (flag seen, payload)
    deepest = 0
    add = lambda a, b: a + b  # noqa: E731
    for t0 in range(0, ep, tile):
        t = t0 // tile
        sl = slice(t0, min(t0 + tile, ep))
        nbt, vt = nb[:, sl], v[:, sl]
        loc = torch.cumsum(nbt, dim=1)
        agg_w = loc[:, -1]
        wp = _look_back(width_status, t, add, _incl)[0] if t else torch.zeros(rows, dtype=torch.int64)
        bitpos = base_bits + wp[:, None] + loc - nbt
        cnt = bitpos & 31
        w = bitpos >> 5
        lo = (vt << cnt) & M32
        hi = (vt >> (31 - cnt)) >> 1
        flush = ((bitpos + nbt) >> 5) > w
        if t0 > 0:  # entry t0 - 1, from the width prefix
            pn, pv = nb[:, t0 - 1], v[:, t0 - 1]
            bp = base_bits + wp - pn
            pf, ph = ((bp + pn) >> 5) > (bp >> 5), (pv >> (31 - (bp & 31))) >> 1
        else:
            pf, ph = torch.ones(rows, dtype=torch.bool), torch.zeros(rows, dtype=torch.int64)
        start = torch.cat([pf[:, None], flush[:, :-1]], dim=1)
        hi_prev = torch.cat([ph[:, None], hi[:, :-1]], dim=1)
        c = lo | torch.where(start, hi_prev, 0)
        sv, sr = _scan_in_tile(c, start)
        agg_or = sv[:, -1] | torch.where(sr[:, -1], RESET, 0)
        if t == 0:
            po = torch.zeros(rows, dtype=torch.int64)
        elif or_back == 1:
            po = or_status[t - 1][1]
        else:
            po, depth = _look_back(or_status, t, _seg_or, _ends_or)
            deepest = max(deepest, int(depth.max()))
        val[:, sl] = torch.where(sr, sv, (po[:, None] & M32) | sv)
        k = torch.where(flush, w, M32)
        idx = torch.arange(t0, sl.stop)[None, :]
        k = torch.where(idx == e, torch.where((bitpos & 31) > 0, w, M32), k)
        key[:, sl] = torch.where(idx > e, M32, k)
        # what a later tile will see: the aggregate, or the inclusive prefix
        show = published if published != "mixed" else ("agg", "incl")[rng.integers(2)]
        width_status.append((show, agg_w if show == "agg" else wp + agg_w))
        or_status.append((show, agg_or if show == "agg" else _seg_or(po, agg_or)))
    total_bits = base_bits + nbits.to(torch.int64).sum(dim=1)
    return (key.to(torch.int32), val.to(torch.int32), total_bits.to(torch.int32)), deepest


def _rows(e, base_bits, seed=0):
    bits, nbits = pack_edge_batch(PACK_KINDS, e, tile=TILE, base_bits=base_bits, seed=seed)
    return torch.from_numpy(bits.view(np.int32)), torch.from_numpy(nbits)


@pytest.mark.parametrize("published", ["agg", "incl", "mixed"])
@pytest.mark.parametrize("base_bits", BASES)
@pytest.mark.parametrize("e", SIZES, ids=["ragged", "tail-first", "e-lt-T"])
def test_tiled_prescan_equals_whole_row(e, base_bits, published):
    bits, nbits = _rows(e, base_bits)
    got, _ = tiled_prescan(bits, nbits, base_bits, tile=TILE, published=published)
    want = pack_cuda.pack_prescan_plain(bits, nbits, base_bits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("base_bits", BASES)
def test_one_tile_look_back_breaks_equality(base_bits):
    """The long segment crosses two whole tiles without a start: an OR
    prefix from the tile before alone misses the bits of the tiles before
    that, while the look-back walks past them."""
    row = PACK_KINDS.index("long_segment")
    bits, nbits = _rows(SIZES[0], base_bits)
    bits, nbits = bits[row: row + 1], nbits[row: row + 1]
    want = pack_cuda.pack_prescan_plain(bits, nbits, base_bits)
    (_, val, _), deepest = tiled_prescan(bits, nbits, base_bits, tile=TILE, published="agg")
    assert torch.equal(val, want[1])
    assert deepest >= 2
    (_, val, _), _ = tiled_prescan(bits, nbits, base_bits, tile=TILE, or_back=1)
    assert not torch.equal(val, want[1])


@pytest.mark.parametrize("base_bits", BASES)
@pytest.mark.parametrize("e", SIZES, ids=["ragged", "tail-first", "e-lt-T"])
def test_plain_equals_pallas_on_edge_rows(e, base_bits):
    bits, nbits = pack_edge_batch(PACK_KINDS, e, tile=TILE, base_bits=base_bits)
    k1, v1, t1 = pack_prescan_pallas(jnp.asarray(bits), jnp.asarray(nbits), base_bits)
    k2, v2, t2 = pack_cuda.pack_prescan_cuda(  # CPU tensors: the plain version
        torch.from_numpy(bits.view(np.int32)), torch.from_numpy(nbits), base_bits)
    k1, v1 = np.asarray(k1), np.asarray(v1)
    k2, v2 = k2.numpy().view(np.uint32), v2.numpy().view(np.uint32)
    assert np.array_equal(k1, k2)
    named = k1 != 0xFFFFFFFF
    assert np.array_equal(v1[named], v2[named])
    assert np.array_equal(np.asarray(t1), t2.numpy())


def test_edge_rows_hold_their_cases():
    """Each kind puts the pre-scan where its name says, at T and E."""
    e, base = SIZES[0], 144
    bits, nbits = pack_edge_batch(PACK_KINDS, e, tile=TILE, base_bits=base)
    nb = nbits.astype(np.int64)
    bp = base + np.concatenate([np.zeros((len(PACK_KINDS), 1), np.int64), np.cumsum(nb, 1)], 1)
    flush = (bp[:, 1:] >> 5) > (bp[:, :-1] >> 5)
    edges = np.arange(TILE, e, TILE)
    k = PACK_KINDS.index
    # no flush on [T/2, T/2 + 3T): the long segment spans whole tiles
    assert not flush[k("long_segment"), TILE // 2: TILE // 2 + 3 * TILE].any()
    assert (nb[k("long_segment")] == 1).sum() >= 20
    assert not nb[k("zero_tiles"), TILE: 3 * TILE].any()
    assert flush[k("tile_end_flush"), edges - 1].all()
    assert (bp[k("tile_end_flush"), edges] % 32 == 0).all()
    assert (nb[k("straddle31"), edges] == 31).all() and flush[k("straddle31"), edges - 1].any()
    assert (bits.astype(np.int64) < (1 << nb)).all()
    # the pre-scan's row is E + 1 entries padded to Ep: the tail entry of
    # E = 4T sits first in its tile
    assert pack_cuda.prescan_len(4 * TILE) % TILE == 0
