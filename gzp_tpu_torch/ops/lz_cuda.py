"""CUDA kernels of the LZ77 match stage (hash matcher), with plain versions.

Counterpart of ``gzp_tpu/ops/lz_pallas.py``. The match stage is

  K1 :func:`build_keys_cuda`   bytes -> hash-sort keys + context payloads
     hash sort                 ``torch.sort`` of int64 keys + payload gather
  K2 :func:`neighbor_cuda`     sorted slots -> best recency candidate
     order restore             scatter ``packed_pos[b, sp] = packed``
  K6 :func:`match_tail_cuda`   runs, extension, clamps, lazy -> (len, dist)

(:func:`best_matches_cuda`). Rows are padded to ``Np`` positions, a
multiple of 1024, exactly as the Pallas kernels pad to whole (8, 128)
tiles, so the port reproduces their output bit for bit.

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch
version (``*_plain``, the same function) for CPU tensors; it raises for a
CUDA tensor it cannot launch on. u32 values live in int32 tensors as bit
patterns where only bitwise ops and equality follow, and in int64 masked
to 32 bits where arithmetic or ordering does.
"""

from __future__ import annotations

import torch

from gzp_tpu_torch.ops.lz import HASH_MUL, _pos_bits
from gzp_tpu_torch.runtime.cuda_lib import (
    CudaKernel, check_cuda, i32, on_cpu, ptr, stream_of,
)

LANES = 128
M32 = 0xFFFFFFFF

BUILD_KEYS = CudaKernel(
    "build_keys.cu", "gzp_build_keys", [ptr, ptr, ptr, i32, i32, i32, i32, i32]
)
NEIGHBOR = CudaKernel(
    "neighbor.cu", "gzp_neighbor",
    [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32],
)
MATCH_TAIL = CudaKernel(
    "match_tail.cu", "gzp_match_tail",
    [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32],
)


def padded_len(n: int) -> int:
    """Row length padded to whole (8, 128) tiles, as the Pallas kernels do."""
    rows = -(-n // LANES)
    return -(-rows // 8) * 8 * LANES


def _shift_right(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """``out[..., i] = x[..., i - s]`` (``fill`` for i < s)."""
    pad = torch.full((*x.shape[:-1], s), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def _shift_left(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """``out[..., i] = x[..., i + s]`` (``fill`` past the end)."""
    if s >= x.shape[-1]:
        return torch.full_like(x, fill)
    pad = torch.full((*x.shape[:-1], s), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def _tz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bytes (0..3) of a nonzero u32 (held in int64)."""
    return torch.where(
        (x & 0xFF) != 0, 0,
        torch.where((x & 0xFFFF) != 0, 1, torch.where((x & 0xFFFFFF) != 0, 2, 3)),
    )


# ---------------------------------------------------------------------------
# K1: key/payload build
# ---------------------------------------------------------------------------


def build_keys_plain(data_u8: torch.Tensor, *, pos_bits: int, payload_words: int):
    """Plain version of K1: bytes [B, N] -> (key [B, Np] int32 holding u32
    bits, payloads [pw, B, Np] int32 holding u32 bits)."""
    b, n = data_u8.shape
    npad = padded_len(n)
    span = npad + 4 * payload_words
    d = torch.zeros((b, span + 3), dtype=torch.int64, device=data_u8.device)
    d[:, :n] = data_u8
    w4 = d[:, :span] | (d[:, 1:span + 1] << 8) | (d[:, 2:span + 2] << 16) | (
        d[:, 3:span + 3] << 24)
    pos = torch.arange(npad, device=data_u8.device)[None, :]
    h = ((w4[:, :npad] * HASH_MUL) & M32) >> pos_bits
    key = (h << pos_bits) | pos
    pays = torch.stack([w4[:, 4 * k: 4 * k + npad] for k in range(payload_words)])
    return key.to(torch.int32), pays.to(torch.int32)


def build_keys_cuda(data_u8: torch.Tensor, *, pos_bits: int, payload_words: int):
    """K1 (see ``csrc/build_keys.cu``); same contract as
    :func:`build_keys_plain`."""
    if on_cpu(data_u8):
        return build_keys_plain(data_u8, pos_bits=pos_bits, payload_words=payload_words)
    b, n = data_u8.shape
    npad = padded_len(n)
    if not 0 < pos_bits < 32 or not 1 <= payload_words <= 7:
        raise ValueError(f"pos_bits={pos_bits}, payload_words={payload_words}")
    check_cuda(data_u8, torch.uint8, (b, n), "data_u8")
    key = torch.empty((b, npad), dtype=torch.int32, device=data_u8.device)
    pays = torch.empty((payload_words, b, npad), dtype=torch.int32, device=data_u8.device)
    BUILD_KEYS.launch(
        data_u8.device,
        ptr(data_u8.data_ptr()), ptr(key.data_ptr()), ptr(pays.data_ptr()),
        b, n, npad, pos_bits, payload_words, stream_of(data_u8),
    )
    return key, pays


# ---------------------------------------------------------------------------
# K2: sorted-neighbour candidates
# ---------------------------------------------------------------------------


def neighbor_plain(sk, pays, halo_start, *, pos_bits: int, lags: int, max_dist: int):
    """Plain version of K2: hash-sorted keys ``sk`` [B, Np] int64 and their
    payloads [pw, B, Np] (u32 bits), ``halo_start`` [B] -> (sp [B, Np]
    int32 sorted positions, packed [B, Np] int32 = dist | len << 17 |
    capped << 22)."""
    pw = pays.shape[0]
    pb = 4 * pw
    npad = sk.shape[1]
    sp = sk & ((1 << pos_bits) - 1)
    sh = sk >> pos_bits
    words = pays.to(torch.int64) & M32
    lo = halo_start.to(torch.int64)[:, None]
    flat = torch.arange(npad, device=sk.device)[None, :]
    ls = ds = cs = None
    for lag in range(1, lags + 1):
        edge = flat < lag
        cpos = _shift_right(sp, lag, -1)
        same = ~edge & (_shift_right(sh, lag, 0) == sh)
        dist = sp - cpos
        valid = same & (cpos >= lo) & (dist >= 1) & (dist <= max_dist)
        lcp = torch.full_like(sp, pb)
        alive = torch.ones_like(valid)
        for k in range(pw):
            x = words[k] ^ _shift_right(words[k], lag, 0)
            hit = alive & (x != 0)
            lcp = torch.where(hit, 4 * k + _tz_bytes(x), lcp)
            alive = alive & (x == 0)
        capped = (valid & (lcp >= pb)).to(torch.int64)
        lcp = torch.where(valid, lcp, 0)
        if ls is None:
            ls, ds, cs = lcp, dist, capped
        else:
            keep = (ls > lcp) | ((ls == lcp) & (ds < dist))
            ls = torch.where(keep, ls, lcp)
            ds = torch.where(keep, ds, dist)
            cs = torch.where(keep, cs, capped)
    ds = torch.where(ls > 0, ds, 0)
    packed = ds | (ls << 17) | (cs << 22)
    return sp.to(torch.int32), packed.to(torch.int32)


def neighbor_cuda(sk, pays, halo_start, *, pos_bits: int, lags: int, max_dist: int):
    """K2 (see ``csrc/neighbor.cu``; ``lags`` > 2 is the TPU's K3); same
    contract as :func:`neighbor_plain`."""
    if on_cpu(sk):
        return neighbor_plain(sk, pays, halo_start, pos_bits=pos_bits, lags=lags,
                              max_dist=max_dist)
    b, npad = sk.shape
    pw = pays.shape[0]
    if lags < 1 or not 1 <= pw <= 7:
        raise ValueError(f"lags={lags}, payload_words={pw}")
    check_cuda(sk, torch.int64, (b, npad), "sk")
    check_cuda(pays, torch.int32, (pw, b, npad), "pays")
    check_cuda(halo_start, torch.int32, (b,), "halo_start")
    sp = torch.empty((b, npad), dtype=torch.int32, device=sk.device)
    packed = torch.empty((b, npad), dtype=torch.int32, device=sk.device)
    NEIGHBOR.launch(
        sk.device,
        ptr(sk.data_ptr()), ptr(pays.data_ptr()), ptr(halo_start.data_ptr()),
        ptr(sp.data_ptr()), ptr(packed.data_ptr()),
        b, npad, pos_bits, pw, lags, max_dist, stream_of(sk),
    )
    return sp, packed


# ---------------------------------------------------------------------------
# K6: position-order tail
# ---------------------------------------------------------------------------


def match_tail_plain(data_u8, packed_pos, lengths, halo_start, *, base: int,
                     payload_bytes: int, max_match: int, min_emit: int, lazy: bool):
    """Plain version of K6: bytes [B, N], position-ordered candidates
    ``packed_pos`` [B, Np] int32, ``lengths``/``halo_start`` [B] ->
    (match_len, match_dist) [B, N] int32."""
    b, n = data_u8.shape
    npad = packed_pos.shape[1]
    dev = data_u8.device
    d = torch.zeros((b, npad), dtype=torch.int64, device=dev)
    d[:, :n] = data_u8
    i_idx = torch.arange(npad, device=dev)[None, :]
    end = base + lengths.to(torch.int64)[:, None]
    lo = halo_start.to(torch.int64)[:, None]
    p = packed_pos.to(torch.int64) & M32
    ln = (p >> 17) & 0x1F
    dist = p & 0x1FFFF
    capped = (p >> 22) == 1

    # distance-1 runs: next index j >= i where d[j] != d[j-1], minus i
    eq = (d == _shift_right(d, 1, 0)) & (i_idx >= 1)
    brk = torch.where(eq, npad, i_idx)
    brk = torch.flip(torch.cummin(torch.flip(brk, [1]), dim=1).values, [1])
    l3 = torch.where(i_idx - 1 >= lo, brk - i_idx, 0)
    run_wins = (l3 > ln) | ((l3 == ln) & (dist > 1))
    dist = torch.where(run_wins, 1, dist)
    capped = ~run_wins & capped
    ln = torch.where(run_wins, l3, ln)

    cap = payload_bytes
    while cap < max_match:
        ln_next = _shift_left(ln, cap, 0)
        dist_next = _shift_left(dist, cap, 0)
        cap_next = _shift_left(capped, cap, False)
        chain = capped & (dist_next == dist)
        ln = torch.where(chain, cap + torch.clamp(ln_next, min=0), ln)
        capped = chain & cap_next
        cap *= 2

    ln = torch.minimum(ln, torch.clamp(end - i_idx, max=max_match))
    ln = torch.where(ln >= min_emit, ln, 0)
    ln = torch.where((ln == 3) & (dist > 4096), 0, ln)
    ln = torch.where((i_idx >= base) & (i_idx < end), ln, 0)
    if lazy:
        ln_next = _shift_left(ln, 1, 0)
        ln = torch.where((ln > 0) & (ln < 32) & (ln_next > ln), 0, ln)
    return ln[:, :n].to(torch.int32), dist[:, :n].to(torch.int32)


def match_tail_cuda(data_u8, packed_pos, lengths, halo_start, *, base: int,
                    payload_bytes: int, max_match: int, min_emit: int, lazy: bool):
    """K6 (see ``csrc/match_tail.cu``); same contract as
    :func:`match_tail_plain`."""
    kw = dict(base=base, payload_bytes=payload_bytes, max_match=max_match,
              min_emit=min_emit, lazy=lazy)
    if on_cpu(data_u8):
        return match_tail_plain(data_u8, packed_pos, lengths, halo_start, **kw)
    b, n = data_u8.shape
    npad = padded_len(n)
    check_cuda(data_u8, torch.uint8, (b, n), "data_u8")
    check_cuda(packed_pos, torch.int32, (b, npad), "packed_pos")
    check_cuda(lengths, torch.int32, (b,), "lengths")
    check_cuda(halo_start, torch.int32, (b,), "halo_start")
    work = torch.empty((3, b, npad), dtype=torch.int32, device=data_u8.device)
    ln = torch.empty((b, n), dtype=torch.int32, device=data_u8.device)
    dist = torch.empty((b, n), dtype=torch.int32, device=data_u8.device)
    MATCH_TAIL.launch(
        data_u8.device,
        ptr(data_u8.data_ptr()), ptr(packed_pos.data_ptr()), ptr(lengths.data_ptr()),
        ptr(halo_start.data_ptr()), ptr(work.data_ptr()), ptr(ln.data_ptr()),
        ptr(dist.data_ptr()), b, n, npad, base, payload_bytes, max_match,
        min_emit, int(lazy), stream_of(data_u8),
    )
    return ln, dist


# ---------------------------------------------------------------------------
# Full matcher
# ---------------------------------------------------------------------------


def best_matches_cuda(
    data_u8: torch.Tensor,
    lengths: torch.Tensor,
    *,
    max_dist: int,
    max_match: int,
    min_emit: int,
    base: int = 0,
    halo_start: torch.Tensor | None = None,
    lazy: bool = False,
    payload_words: int = 3,
    lags: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best match (length, distance) at every position: the flow of
    ``best_matches_pallas`` (gzp_tpu/ops/lz_pallas.py:989) with K1, K2 and
    K6 as CUDA kernels (on CUDA tensors) around a sort and a scatter.

    ``data_u8`` [B, base + N] uint8 (an optional ``base``-byte halo, then
    the block), ``lengths`` [B] valid bytes after the halo, ``halo_start``
    [B] the first position a match source may use. Returns
    ``(match_len, match_dist)`` [B, base + N] int32, ``match_len == 0`` at
    literals.
    """
    b, n_ext = data_u8.shape
    pos_bits = _pos_bits(n_ext)
    lengths = lengths.to(torch.int32).contiguous()
    if halo_start is None:
        halo_start = torch.zeros((b,), dtype=torch.int32, device=data_u8.device)
    halo_start = halo_start.to(torch.int32).contiguous()
    key, pays = build_keys_cuda(data_u8, pos_bits=pos_bits, payload_words=payload_words)
    # the keys hold the position, so they are unique: any sort is exact
    sk, order = torch.sort(key.to(torch.int64) & M32, dim=1)
    spays = torch.gather(pays, 2, order.expand(payload_words, -1, -1))
    sp, packed = neighbor_cuda(sk, spays, halo_start, pos_bits=pos_bits, lags=lags,
                               max_dist=max_dist)
    # back to position order: sp is a permutation of 0..Np-1
    packed_pos = torch.empty_like(packed).scatter_(1, sp.to(torch.int64), packed)
    return match_tail_cuda(
        data_u8, packed_pos, lengths, halo_start, base=base,
        payload_bytes=4 * payload_words, max_match=max_match, min_emit=min_emit,
        lazy=lazy,
    )
