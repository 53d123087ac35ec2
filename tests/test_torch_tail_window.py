"""The window argument of the tile-parallel tails K6 and K9, on the CPU.

``csrc/match_tail.cu`` and ``csrc/match_tail2.cu`` run one CTA per tile of
T positions, with the candidates on [t0, t0 + T + E) and the bytes on
[t0 - 1, t0 + T + E + R), and saturate distance-1 runs at R
(``lz_cuda.tail_window``). ``tiled_tail`` below emulates that tiling in
torch, tile by tile, and must equal the whole-row plain versions
``match_tail_plain`` and ``match_tail2_plain`` on rows built to sit at the
window's edges (``gzp_tpu_torch.utils.testing.tail_edge_batch``), at a
small T, also behind a halo (the stream encoder's ``base`` > 0) and at
Snappy's limits. A smaller saturation must break the equality, so the test can
tell. Tolerance: exact equality (integer code).
"""

import numpy as np
import pytest
import torch

from gzp_tpu_torch.ops import lz_cuda
from gzp_tpu_torch.utils.testing import KINDS, behind_halo, tail_edge_batch

N, TILE = 8192, 1024
KW = dict(max_match=258, min_emit=3, lazy=True)


def _shift_left(x, s, fill):
    """``out[:, p] = x[:, p + s]``, ``fill`` past the window."""
    pad = torch.full((x.shape[0], min(s, x.shape[1])), fill, dtype=x.dtype)
    return torch.cat([x[:, s:], pad], dim=1)


def tiled_tail(data, fields, lengths, halo, *, payload_bytes, max_match, min_emit, lazy,
               tile, sat=None, base=0):
    """The tails computed tile by tile from their windows alone: ``fields``
    is [hash] (K6) or [hash, suffix] (K9), packed [B, Np] int32; ``sat``
    replaces ``tail_window``'s R. Returns (len, dist) [B, n] int32."""
    t, e, r = lz_cuda.tail_window(payload_bytes, max_match, tile)
    r = r if sat is None else sat
    b, n = data.shape
    npad = fields[0].shape[1]
    d = torch.zeros((b, 1 + npad + t + e + r), dtype=torch.int64)
    d[:, 1:1 + n] = data  # d[:, 1 + m] is byte m; 0 outside [0, n)
    end = base + lengths.long()[:, None]
    lo = halo.long()[:, None]
    ln_out = torch.zeros((b, n), dtype=torch.int32)
    dist_out = torch.zeros((b, n), dtype=torch.int32)
    for t0 in range(0, npad, t):
        cand, span = min(t + e, npad - t0), min(t + e + r, npad - t0)
        m = t0 + torch.arange(span)
        eq = (d[:, 1 + t0: 1 + t0 + span] == d[:, t0: t0 + span]) & (m >= 1)
        brk = torch.where(eq, t0 + span, m)  # no break in the window: its end
        nxt = torch.flip(torch.cummin(torch.flip(brk, [1]), 1).values, [1])
        run = torch.clamp(nxt - m, max=r)[:, :cand]
        j = m[:cand]
        out = []
        for k, packed in enumerate(fields):
            p = packed[:, t0: t0 + cand].long() & 0xFFFFFFFF
            ln, dist, capped = (p >> 17) & 0x1F, p & 0x1FFFF, (p >> 22) == 1
            if k == 0:  # the run merges into the hash field
                l3 = torch.where(j - 1 >= lo, run, 0)
                wins = (l3 > ln) | ((l3 == ln) & (dist > 1))
                ln, dist, capped = (torch.where(wins, l3, ln), torch.where(wins, 1, dist),
                                    ~wins & capped)
            cap = payload_bytes
            while cap < max_match:  # chains stop at the window's end
                chain = capped & (_shift_left(dist, cap, -1) == dist)
                ln = torch.where(chain, cap + _shift_left(ln, cap, 0), ln)
                capped = chain & _shift_left(capped, cap, False)
                cap *= 2
            out.append((ln, dist))
        ln, dist = out[0]
        if len(out) == 2:
            ls, ds = out[1]
            wins = (ls > ln) | ((ls == ln) & (ds < dist))
            ln, dist = torch.where(wins, ls, ln), torch.where(wins, ds, dist)
        ln = torch.minimum(ln, torch.clamp(end - j, max=max_match))
        ln = torch.where(ln >= min_emit, ln, 0)
        ln = torch.where((ln == 3) & (dist > 4096), 0, ln)
        ln = torch.where((j >= base) & (j < end), ln, 0)
        if lazy:
            ln = torch.where((ln > 0) & (ln < 32) & (_shift_left(ln, 1, 0) > ln), 0, ln)
        hi = min(t, n - t0)
        ln_out[:, t0: t0 + hi] = ln[:, :hi].int()
        dist_out[:, t0: t0 + hi] = dist[:, :hi].int()
    return ln_out, dist_out


def _batch(kinds, n, payload_bytes, seed=0):
    x = tail_edge_batch(kinds, n, payload_bytes=payload_bytes, max_match=258, tile=TILE,
                        seed=seed)
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _tails(x, payload_bytes, fields, base=0, kw=KW, **extra):
    """(tiled, plain) results of K6 (fields = 1) or K9 (2) on batch x."""
    planes = [x["packed_hash"], x["packed_suffix"]][:fields]
    kw = dict(payload_bytes=payload_bytes, **kw)
    tiled = tiled_tail(x["data"], planes, x["lengths"], x["halo_start"], tile=TILE,
                       base=base, **kw, **extra)
    args = (x["data"], *planes, x["lengths"], x["halo_start"])
    plain = (lz_cuda.match_tail_plain if fields == 1 else lz_cuda.match_tail2_plain)(
        *args, base=base, **kw)
    return tiled, plain


GROUPS = [(KINDS[:3], N), (KINDS[3:], N - 300)]  # the second: n not a multiple of T


@pytest.mark.parametrize("group", range(len(GROUPS)), ids=["edges-n8192", "chains-n7892"])
@pytest.mark.parametrize("fields,payload_bytes", [(1, 8), (1, 12), (1, 28), (2, 28)],
                         ids=["K6-pb8", "K6-pb12", "K6-pb28", "K9-pb28"])
def test_tiled_tail_equals_whole_row(group, fields, payload_bytes):
    kinds, n = GROUPS[group]
    x = _batch(kinds, n, payload_bytes, seed=group)
    (ln, dist), (ln_p, dist_p) = _tails(x, payload_bytes, fields)
    assert torch.equal(ln, ln_p)
    assert torch.equal(dist, dist_p)


@pytest.mark.parametrize("halo_start", [0, 1000, 2048])
@pytest.mark.parametrize("fields,payload_bytes", [(1, 12), (2, 28)], ids=["K6-pb12", "K9-pb28"])
def test_tiled_tail_behind_a_halo(fields, payload_bytes, halo_start):
    """The stream encoder's rows: the edge rows behind a 2,048-byte halo
    (two tiles) at base 2048, with halo_start 0 (the whole halo a source),
    inside the halo, and at base (none of it)."""
    x = tail_edge_batch(KINDS, N - 300, payload_bytes=payload_bytes, max_match=258, tile=TILE,
                        seed=halo_start)
    x = behind_halo(x, 2048, halo_start, payload_bytes=payload_bytes, seed=halo_start)
    x = {k: torch.from_numpy(v) for k, v in x.items()}
    (ln, dist), (ln_p, dist_p) = _tails(x, payload_bytes, fields, base=2048)
    assert torch.equal(ln, ln_p)
    assert torch.equal(dist, dist_p)
    assert int(ln_p[:, :2048].abs().sum()) == 0 and int((ln_p > 0).sum()) > 0


def test_tiled_tail_at_snappy_limits():
    """K6 at Snappy's max_match 256 and min_emit 4, not lazy: R = 544."""
    kw = dict(max_match=256, min_emit=4, lazy=False)
    assert lz_cuda.tail_window(12, 256)[1:] == (373, 544)
    x = tail_edge_batch(KINDS, N - 300, payload_bytes=12, max_match=256, tile=TILE, seed=5)
    x = {k: torch.from_numpy(v) for k, v in x.items()}
    (ln, dist), (ln_p, dist_p) = _tails(x, 12, 1, kw=kw)
    assert torch.equal(ln, ln_p)
    assert torch.equal(dist, dist_p)
    assert int(ln_p.max()) == 256


def test_smaller_saturation_breaks_equality():
    """R = max_match lets a suffix-field extension above 258 beat a longer
    distance-1 run in K9's field choice: the dist differs."""
    x = _batch(("run_vs_suffix",), N, 28)
    (_, dist), (_, dist_p) = _tails(x, 28, 2, sat=258)
    assert not torch.equal(dist, dist_p)
    (_, dist), _ = _tails(x, 28, 2)
    assert torch.equal(dist, dist_p)


@pytest.mark.parametrize("payload_bytes,caps", [(4, 508), (8, 504), (12, 372), (28, 420)])
def test_tail_window_constants(payload_bytes, caps):
    t, e, r = lz_cuda.tail_window(payload_bytes, 258)
    assert (t, e, r) == (lz_cuda.TAIL_TILE, caps + 1, 548)
    # every suffix-field length (at most 31 + the caps) and the clamp stay below R
    assert 31 + caps < r and 258 < r
    # K9's planes at the default tile fit one CTA's shared memory on Hopper
    assert lz_cuda.tail_smem_bytes(2, t, e, r) <= 232448


def test_edge_batch_puts_runs_across_tile_edges():
    """The edge rows hold byte runs of R, R + 1 and R + 2 (distance-1 runs
    of R - 1, R and R + 1) that cross a tile boundary."""
    _, _, r = lz_cuda.tail_window(8, 258, TILE)
    row = tail_edge_batch(("edge_runs",), N, payload_bytes=8, tile=TILE)["data"][0]
    change = np.flatnonzero(np.diff(row.astype(np.int64)) != 0) + 1
    starts = np.concatenate([[0], change])
    stops = np.concatenate([change, [len(row)]])
    crossing = {int(b - a) for a, b in zip(starts, stops)
                if a // TILE != (b - 1) // TILE}
    assert {r, r + 1, r + 2} <= crossing
