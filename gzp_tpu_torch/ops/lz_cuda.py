"""CUDA kernels of the LZ77 match stage, with plain versions.

Counterpart of ``gzp_tpu/ops/lz_pallas.py``. The hash matcher (levels
0-5, :func:`best_matches_cuda`) is

  K1 :func:`build_keys_cuda`   bytes -> hash-sort keys + context payloads
     hash sort                 ``torch.sort`` of int64 keys + payload gather
  K2 :func:`neighbor_cuda`     sorted slots -> best recency candidate
     order restore             scatter ``packed_pos[b, sp] = packed``
  K6 :func:`match_tail_cuda`   runs, extension, clamps, lazy -> (len, dist)

The suffix matcher (levels 6-9, :func:`best_matches_suffix_cuda`) runs a
content-sorted pass and a shallow hash pass, then merges them:

  K7 :func:`build_suffix_keys_cuda`  bytes -> big-endian context words + pos
     content sort :func:`suffix_order`  LSD passes of ``torch.sort``
  K4 :func:`lcp_lags_cuda`           adjacent LCP of the sorted words
  K8 :func:`suffix_merge_cuda`       ±lags candidates by running-min LCP
  K1, hash sort, then K4 (both lags) + K5 :func:`hash_merge_cuda`
                                     (``neighbor_cuda`` at payload_words > 3)
  K9 :func:`match_tail2_cuda`        K6 with a hash and a suffix field

Rows are padded to ``Np`` positions, a multiple of 1024, exactly as the
Pallas kernels pad to whole (8, 128) tiles, so the port reproduces their
output bit for bit.

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch
version (``*_plain``, the same function) for CPU tensors; it raises for a
CUDA tensor it cannot launch on. u32 values live in int32 tensors as bit
patterns where only bitwise ops and equality follow, and in int64 masked
to 32 bits where arithmetic or ordering does.
"""

from __future__ import annotations

import ctypes

import torch

from gzp_tpu_torch.ops.lz import HASH_MUL, _pos_bits
from gzp_tpu_torch.runtime.cuda_lib import (
    CudaKernel, LaunchCount, check_cuda, i32, on_cpu, ptr, stream_of,
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
# K2's kernel at lags > 2 computes the TPU's K3 (`_neighbor_loop_kernel`)
NEIGHBOR_LOOP = LaunchCount("neighbor_loop")
# slots per CTA of K2: TILE in csrc/neighbor.cu (256 threads x 4 slots), and
# the most lags its halo takes (the reference asserts lags < 128)
NEIGHBOR_TILE = 1024
NEIGHBOR_MAX_LAGS = 127
MATCH_TAIL = CudaKernel(
    "match_tail.cu", "gzp_match_tail",
    [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32],
)
BUILD_SUFFIX_KEYS = CudaKernel(
    "build_suffix_keys.cu", "gzp_build_suffix_keys", [ptr, ptr, ptr, i32, i32, i32, i32]
)
LCP_LAGS = CudaKernel("lcp_lags.cu", "gzp_lcp_lags", [ptr, ptr, i32, i32, i32, i32, i32])
# slots per CTA of K4: TILE in csrc/lcp_lags.cu (256 threads x 4 slots),
# for the grid that reports print and the tests' ragged rows
LCP_TILE = 1024
HASH_MERGE = CudaKernel(
    "hash_merge.cu", "gzp_hash_merge",
    [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32],
)
SUFFIX_MERGE = CudaKernel(
    "suffix_merge.cu", "gzp_suffix_merge", [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32]
)
MATCH_TAIL2 = CudaKernel(
    "match_tail2.cu", "gzp_match_tail2",
    [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32],
)
# positions per CTA of the tails K6 and K9 (a multiple of 1024)
TAIL_TILE = 4096


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


def _lz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bytes (0..3) of a nonzero u32 (held in int64): the
    per-word LCP of big-endian words."""
    return torch.where(
        (x & 0xFF000000) != 0, 0,
        torch.where((x & 0xFFFF0000) != 0, 1, torch.where((x & 0xFFFFFF00) != 0, 2, 3)),
    )


def _pack(ls: torch.Tensor, ds: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """Candidate word ``dist | len << 17 | capped << 22`` (int32 bits),
    with the distance zeroed where len is 0."""
    ds = torch.where(ls > 0, ds, 0)
    return (ds | (ls << 17) | (cs.to(torch.int64) << 22)).to(torch.int32)


def _a_wins(ls, ds, l2, d2):
    """The candidate held so far stays unless the new one is longer, or
    equally long and nearer."""
    return (ls > l2) | ((ls == l2) & (ds < d2))


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
# K2: sorted-neighbour candidates (K4 + K5 for wide context)
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
            keep = _a_wins(ls, ds, lcp, dist)
            ls = torch.where(keep, ls, lcp)
            ds = torch.where(keep, ds, dist)
            cs = torch.where(keep, cs, capped)
    return sp.to(torch.int32), _pack(ls, ds, cs)


def neighbor_smem_bytes(payload_words: int, lags: int) -> int:
    """Dynamic shared memory per CTA of K2, as ``smem_bytes`` in
    ``csrc/neighbor.cu`` computes it: the key plane and ``payload_words``
    word planes over the tile and a halo of ``lags`` rounded up to 4
    slots."""
    return 4 * (-(-lags // 4) * 4 + NEIGHBOR_TILE) * (1 + payload_words)


def neighbor_cuda(sk, pays, halo_start, *, pos_bits: int, lags: int, max_dist: int):
    """Best recency candidate of every hash-sorted slot; same contract as
    :func:`neighbor_plain`. Up to 3 context words it is K2 (see
    ``csrc/neighbor.cu``: tiles of ``NEIGHBOR_TILE`` slots with a halo of
    ``lags`` ≤ 127 slots, grid (ceil(Np / tile), B); ``lags`` > 2 is the
    TPU's K3). Wider context (the suffix matcher's hash pass) takes the
    route ``neighbor_pallas`` takes there: K4 (one launch for every lag),
    then K5."""
    pw = pays.shape[0]
    if pw > 3:
        lcps = lcp_lags_cuda(pays, lags, big_endian=False)
        return hash_merge_cuda(sk, lcps, halo_start, pos_bits=pos_bits, max_dist=max_dist,
                               payload_bytes=4 * pw)
    if on_cpu(sk):
        return neighbor_plain(sk, pays, halo_start, pos_bits=pos_bits, lags=lags,
                              max_dist=max_dist)
    b, npad = sk.shape
    if not 1 <= lags <= NEIGHBOR_MAX_LAGS or pw < 1:
        raise ValueError(f"lags={lags}, payload_words={pw}: the kernel's halo holds "
                         f"{NEIGHBOR_MAX_LAGS} slots")
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
    if lags > 2:
        NEIGHBOR_LOOP.launches += 1
    return sp, packed


# ---------------------------------------------------------------------------
# K4: LCP against the slot `lag` above
# ---------------------------------------------------------------------------


def lcp_lags_plain(words, lags: int, *, big_endian: bool):
    """Plain version of K4: sorted context words [pw, B, Np] (u32 bits) ->
    LCP [lags, B, Np] int32. For lag k, each slot's common prefix in bytes
    with the slot k above (capped at 4*pw; the first k slots compare with
    zero words). Big-endian words count the leading zero bytes of the
    first differing word's XOR, little-endian ones the trailing."""
    pw = words.shape[0]
    w = words.to(torch.int64) & M32
    zero_bytes = _lz_bytes if big_endian else _tz_bytes
    out = []
    for lag in range(1, lags + 1):
        lcp = torch.full(w.shape[1:], 4 * pw, dtype=torch.int64, device=w.device)
        alive = torch.ones(w.shape[1:], dtype=torch.bool, device=w.device)
        for k in range(pw):
            x = w[k] ^ _shift_right(w[k], lag, 0)
            lcp = torch.where(alive & (x != 0), 4 * k + zero_bytes(x), lcp)
            alive = alive & (x == 0)
        out.append(lcp)
    return torch.stack(out).to(torch.int32)


def lcp_lags_cuda(words, lags: int, *, big_endian: bool):
    """K4 (see ``csrc/lcp_lags.cu``), one launch for every lag, grid
    (ceil(Np / ``LCP_TILE``), B); same contract as :func:`lcp_lags_plain`
    for 1 to 7 words."""
    if on_cpu(words):
        return lcp_lags_plain(words, lags, big_endian=big_endian)
    pw, b, npad = words.shape
    if lags < 1 or not 1 <= pw <= 7:
        raise ValueError(f"lags={lags}, payload_words={pw}")
    check_cuda(words, torch.int32, (pw, b, npad), "words")
    out = torch.empty((lags, b, npad), dtype=torch.int32, device=words.device)
    LCP_LAGS.launch(
        words.device, ptr(words.data_ptr()), ptr(out.data_ptr()),
        b, npad, pw, lags, int(big_endian), stream_of(words),
    )
    return out


# ---------------------------------------------------------------------------
# K5: hash-order merge of per-lag LCPs
# ---------------------------------------------------------------------------


def hash_merge_plain(sk, lcps, halo_start, *, pos_bits: int, max_dist: int,
                     payload_bytes: int):
    """Plain version of K5: hash-sorted keys ``sk`` [B, Np] int64 and the
    per-lag LCPs ``lcps`` [lags, B, Np] int32 (K4, little-endian) ->
    (sp, packed) as :func:`neighbor_plain`: K2's validity and choice
    rules, the first lag taken as it is."""
    npad = sk.shape[1]
    sp = sk & ((1 << pos_bits) - 1)
    sh = sk >> pos_bits
    lo = halo_start.to(torch.int64)[:, None]
    flat = torch.arange(npad, device=sk.device)[None, :]
    ls = ds = cs = None
    for lag in range(1, lcps.shape[0] + 1):
        cpos = _shift_right(sp, lag, -1)
        same = (flat >= lag) & (_shift_right(sh, lag, 0) == sh)
        dist = sp - cpos
        valid = same & (cpos >= lo) & (dist >= 1) & (dist <= max_dist)
        lcp = lcps[lag - 1].to(torch.int64)
        capped = valid & (lcp >= payload_bytes)
        lcp = torch.where(valid, lcp, 0)
        if ls is None:
            ls, ds, cs = lcp, dist, capped
        else:
            keep = _a_wins(ls, ds, lcp, dist)
            ls = torch.where(keep, ls, lcp)
            ds = torch.where(keep, ds, dist)
            cs = torch.where(keep, cs, capped)
    return sp.to(torch.int32), _pack(ls, ds, cs)


def hash_merge_cuda(sk, lcps, halo_start, *, pos_bits: int, max_dist: int,
                    payload_bytes: int):
    """K5 (see ``csrc/hash_merge.cu``); same contract as
    :func:`hash_merge_plain`."""
    kw = dict(pos_bits=pos_bits, max_dist=max_dist, payload_bytes=payload_bytes)
    if on_cpu(sk):
        return hash_merge_plain(sk, lcps, halo_start, **kw)
    b, npad = sk.shape
    lags = lcps.shape[0]
    check_cuda(sk, torch.int64, (b, npad), "sk")
    check_cuda(lcps, torch.int32, (lags, b, npad), "lcps")
    check_cuda(halo_start, torch.int32, (b,), "halo_start")
    sp = torch.empty((b, npad), dtype=torch.int32, device=sk.device)
    packed = torch.empty((b, npad), dtype=torch.int32, device=sk.device)
    HASH_MERGE.launch(
        sk.device,
        ptr(sk.data_ptr()), ptr(lcps.data_ptr()), ptr(halo_start.data_ptr()),
        ptr(sp.data_ptr()), ptr(packed.data_ptr()),
        b, npad, pos_bits, lags, max_dist, payload_bytes, stream_of(sk),
    )
    return sp, packed


# ---------------------------------------------------------------------------
# K7: content-sort keys, and the content sort
# ---------------------------------------------------------------------------


def build_suffix_keys_plain(data_u8: torch.Tensor, *, payload_words: int):
    """Plain version of K7: bytes [B, N] -> (keys [pw, B, Np] int32 holding
    u32 bits, key k at slot i the big-endian 4-byte window at i + 4k,
    zero past the row; pos [B, Np] int32, pos[b, i] = i)."""
    b, n = data_u8.shape
    npad = padded_len(n)
    span = npad + 4 * payload_words
    d = torch.zeros((b, span + 3), dtype=torch.int64, device=data_u8.device)
    d[:, :n] = data_u8
    w4 = (d[:, :span] << 24) | (d[:, 1:span + 1] << 16) | (d[:, 2:span + 2] << 8) | (
        d[:, 3:span + 3])
    keys = torch.stack([w4[:, 4 * k: 4 * k + npad] for k in range(payload_words)])
    pos = torch.arange(npad, dtype=torch.int32, device=data_u8.device).expand(b, npad)
    return keys.to(torch.int32), pos.contiguous()


def build_suffix_keys_cuda(data_u8: torch.Tensor, *, payload_words: int):
    """K7 (see ``csrc/build_suffix_keys.cu``); same contract as
    :func:`build_suffix_keys_plain`."""
    if on_cpu(data_u8):
        return build_suffix_keys_plain(data_u8, payload_words=payload_words)
    b, n = data_u8.shape
    npad = padded_len(n)
    if payload_words < 1:
        raise ValueError(f"payload_words={payload_words}")
    check_cuda(data_u8, torch.uint8, (b, n), "data_u8")
    keys = torch.empty((payload_words, b, npad), dtype=torch.int32, device=data_u8.device)
    pos = torch.empty((b, npad), dtype=torch.int32, device=data_u8.device)
    BUILD_SUFFIX_KEYS.launch(
        data_u8.device,
        ptr(data_u8.data_ptr()), ptr(keys.data_ptr()), ptr(pos.data_ptr()),
        b, n, npad, payload_words, stream_of(data_u8),
    )
    return keys, pos


def suffix_order(keys: torch.Tensor, pos: torch.Tensor, suffix_keys: int) -> torch.Tensor:
    """The content sort: the permutation [B, Np] int64 that orders each
    row's slots by ``(keys[0], ..., keys[kw-1], pos)`` compared as unsigned
    words, kw = ``suffix_keys`` (gzp_tpu's ``jax.lax.sort`` with
    ``num_keys=kw + 1``). The position makes every key unique, so any
    correct sort gives exactly this order.

    Least significant first: one sort of ``keys[kw-1] << pbits | pos``,
    then stable sorts of two more words at a time, ``(a - 2**31) * 2**32 +
    b``, which orders the unsigned pair (a, b) and stays in int64's range.
    The words are int64 masked to 32 bits: int32 bit patterns compared as
    signed would put every word >= 0x80000000 first.
    """
    npad = pos.shape[1]
    pbits = max((npad - 1).bit_length(), 1)
    u32 = lambda k: keys[k].to(torch.int64) & M32  # noqa: E731
    k = suffix_keys - 1
    order = torch.sort((u32(k) << pbits) | pos.to(torch.int64), dim=1).indices
    while k > 0:
        if k >= 2:
            key = (u32(k - 2) - (1 << 31)) * (1 << 32) + u32(k - 1)
            k -= 2
        else:
            key = u32(0)
            k = 0
        perm = torch.sort(torch.gather(key, 1, order), dim=1, stable=True).indices
        order = torch.gather(order, 1, perm)
    return order


# ---------------------------------------------------------------------------
# K8: suffix-order merge
# ---------------------------------------------------------------------------


def suffix_merge_plain(sp, adj, halo_start, *, lags: int, max_dist: int,
                       payload_bytes: int):
    """Plain version of K8: suffix-sorted positions ``sp`` [B, Np] int32 and
    adjacent LCPs ``adj`` [B, Np] int32 (K4, big-endian, lag 1) -> packed
    [B, Np] int32, the best of each slot's ±lags neighbours.

    For sorted strings lcp(s_i, s_{i-k}) = min(adj[i-k+1..i]) (zero below
    slot 0); the slot k below has the same running minimum taken at i + k
    (zero past the row). For k = 1..lags the up candidate, then the down
    one, goes through the keep rule from a (0, 0, 0) start."""
    spl = sp.to(torch.int64)
    a = adj.to(torch.int64)
    lo = halo_start.to(torch.int64)[:, None]
    ls = ds = torch.zeros_like(spl)
    cs = torch.zeros_like(spl, dtype=torch.bool)
    m_up = a
    for lag in range(1, lags + 1):
        if lag > 1:
            m_up = torch.minimum(m_up, _shift_right(a, lag - 1, 0))
        for cpos, lcp in ((_shift_right(spl, lag, -1), m_up),
                          (_shift_left(spl, lag, -1), _shift_left(m_up, lag, 0))):
            dist = spl - cpos
            valid = (cpos >= lo) & (dist >= 1) & (dist <= max_dist)
            capped = valid & (lcp >= payload_bytes)
            lcp = torch.where(valid, lcp, 0)
            keep = _a_wins(ls, ds, lcp, dist)
            ls = torch.where(keep, ls, lcp)
            ds = torch.where(keep, ds, dist)
            cs = torch.where(keep, cs, capped)
    return _pack(ls, ds, cs)


def _check_merge_fields(max_dist: int, payload_bytes: int) -> None:
    """K8's packed word holds a 17-bit distance, and ``capped`` needs a
    length of at least 1."""
    if max_dist >= 1 << 17 or payload_bytes < 1:
        raise ValueError(f"max_dist={max_dist}, payload_bytes={payload_bytes}: outside the "
                         "packed word's 17-bit distance or a capped length of at least 1")


def suffix_merge_work(sp, adj, halo_start, *, lags: int, max_dist: int,
                      payload_bytes: int) -> torch.Tensor:
    """Each slot's candidate tests under K8's exit rule, [B, Np] int64: the
    up and down candidates that these inputs need, for K8's bound.

    The walk holds its best candidate as one key K = ((len + 1) << 17) -
    dist, so "longer, then nearer" is the larger key, from a start of 1 <<
    17 (len 1 at distance 2^17): every valid candidate of len >= 1 beats
    it and none of len 0 does. A direction whose running minimum is m can
    give no key above ((m + 1) << 17) - 1 (len m at distance 1), so it is
    tested at lag k while that beats the held key: m > len, or m == len and
    the held distance is over 1 (m >= 1 at the start). Once it does not, m
    only falls and the held key only rises, so no later candidate of that
    direction can change the packed word: the direction is done. An
    invalid candidate counts as a test and does not end the walk. Needs
    ``max_dist`` < 2^17 and ``payload_bytes`` >= 1, the packed word's
    fields."""
    _check_merge_fields(max_dist, payload_bytes)
    spl = sp.to(torch.int64)
    a = adj.to(torch.int64)
    lo = halo_start.to(torch.int64)[:, None]
    best = torch.full_like(spl, 1 << 17)
    tests = torch.zeros_like(spl)
    alive = [torch.ones_like(spl, dtype=torch.bool) for _ in range(2)]
    m_up = a
    for lag in range(1, lags + 1):
        if lag > 1:
            m_up = torch.minimum(m_up, _shift_right(a, lag - 1, 0))
        for d, (cpos, lcp) in enumerate(((_shift_right(spl, lag, -1), m_up),
                                         (_shift_left(spl, lag, -1), _shift_left(m_up, lag, 0)))):
            top = (lcp + 1) << 17  # the key of len lcp at distance 0
            alive[d] &= top - 1 > best
            tests += alive[d]
            dist = spl - cpos
            valid = alive[d] & (cpos >= lo) & (dist >= 1) & (dist <= max_dist)
            best = torch.where(valid, torch.maximum(best, top - dist), best)
    return tests


def suffix_merge_plan() -> dict:
    """K8's launch plan, read from its library (built on first use, so this
    needs the CUDA toolkit): ``tile`` slots per CTA, ``smem_bytes`` of
    dynamic shared memory per CTA whatever the lags, and ``f32_rows``, the
    longest row it computes on fp32 keys (longer ones take int32 keys)."""
    out = [ctypes.c_int() for _ in range(3)]
    SUFFIX_MERGE.loaded().gzp_suffix_merge_plan(*map(ctypes.byref, out))
    return dict(zip(("tile", "smem_bytes", "f32_rows"), (v.value for v in out)))


def suffix_merge_cuda(sp, adj, halo_start, *, lags: int, max_dist: int,
                      payload_bytes: int):
    """K8 (see ``csrc/suffix_merge.cu`` and :func:`suffix_merge_plan`:
    tiles of 2,048 slots with a halo of ``lags`` rounded up to 32, grid
    (ceil(Np / tile), B), any Np up to 2^30); same contract as
    :func:`suffix_merge_plain` for positions ``sp`` in [-1, Np) (slot
    indices), LCPs ``adj`` up to 31 (the packed word's 5-bit length; K4
    gives at most 4 x context words), ``max_dist`` < 2^17 and
    ``payload_bytes`` >= 1 (the packed word's distance and capped fields).
    The kernel computes on fp32 keys on rows of up to 2^22 slots and on
    int32 keys on longer ones, exact on each."""
    kw = dict(lags=lags, max_dist=max_dist, payload_bytes=payload_bytes)
    if on_cpu(sp):
        return suffix_merge_plain(sp, adj, halo_start, **kw)
    b, npad = sp.shape
    if not 1 <= lags < 128:
        raise ValueError(f"lags={lags}: the kernel's halo holds 127 neighbours")
    if npad > 1 << 30:
        raise ValueError(f"Np={npad}: the kernel's int32 keys hold positions below 2^30")
    _check_merge_fields(max_dist, payload_bytes)
    check_cuda(sp, torch.int32, (b, npad), "sp")
    check_cuda(adj, torch.int32, (b, npad), "adj")
    check_cuda(halo_start, torch.int32, (b,), "halo_start")
    packed = torch.empty((b, npad), dtype=torch.int32, device=sp.device)
    SUFFIX_MERGE.launch(
        sp.device,
        ptr(sp.data_ptr()), ptr(adj.data_ptr()), ptr(halo_start.data_ptr()),
        ptr(packed.data_ptr()), b, npad, lags, max_dist, payload_bytes, stream_of(sp),
    )
    return packed


def suffix_neighbor_cuda(skeys, sp, halo_start, *, lags: int, max_dist: int):
    """Suffix-sorted words [pw, B, Np] and positions [B, Np] -> (sp, packed):
    K4 big-endian at lag 1 (the adjacent LCP), then K8 — the flow of
    ``suffix_neighbor_pallas``."""
    adj = lcp_lags_cuda(skeys, 1, big_endian=True)[0]
    packed = suffix_merge_cuda(sp, adj, halo_start, lags=lags, max_dist=max_dist,
                               payload_bytes=4 * skeys.shape[0])
    return sp, packed


# ---------------------------------------------------------------------------
# K6 and K9: position-order tails
# ---------------------------------------------------------------------------


def tail_window(payload_bytes: int, max_match: int, tile: int | None = None):
    """The tile and window of the tails K6 and K9: ``(T, E, R)``, T =
    ``tile`` or, by default, ``TAIL_TILE`` as it stands at the call.

    A CTA writes positions [t0, t0 + T). The extension rounds at cap =
    ``payload_bytes``, 2x, ... < ``max_match`` read position j + cap and
    lazy demotion reads j + 1, so the tile needs candidates on [t0, t0 + T
    + E), E = sum of the caps + 1. The distance-1 run is saturated at R =
    2 * ``max_match`` + 32, which keeps every comparison the tails make
    (every other length is at most 31 + the sum of the caps < R, and the
    clamp is at most ``max_match``), so the tile needs bytes on [t0 - 1, t0
    + T + E + R) (``csrc/match_tail.cuh`` gives the argument)."""
    tile = TAIL_TILE if tile is None else tile
    if payload_bytes < 1 or tile <= 0 or tile % 1024:
        raise ValueError(f"payload_bytes={payload_bytes}, tile={tile}")
    caps, cap = 0, payload_bytes
    while cap < max_match:
        caps += cap
        cap *= 2
    return tile, caps + 1, 2 * max_match + 32


def tail_smem_bytes(fields: int, tile: int, e: int, r: int) -> int:
    """Dynamic shared memory per CTA of K6 (``fields`` = 1) or K9 (2) at
    window (T, E, R), as ``tail::smem_bytes`` in ``csrc/match_tail.cuh``
    computes it: two int32 planes per field over T + E positions (rounded
    up to 4), then one more per field, or the staged bytes if larger."""
    plane = 4 * (-(-(tile + e) // 4) * 4)
    staged = -(-(16 + tile + e + r) // 16) * 16
    return 2 * fields * plane + max(fields * plane, staged)


def _unpack(packed: torch.Tensor):
    """Candidate word -> (len, dist, capped)."""
    p = packed.to(torch.int64) & M32
    return (p >> 17) & 0x1F, p & 0x1FFFF, (p >> 22) == 1


def _merge_runs(d, i_idx, lo, ln, dist, capped):
    """Distance-1 runs into a candidate field: run(i) = (next j >= i where
    d[j] != d[j-1]) - i, counted where i - 1 >= lo; the run wins when
    longer, or equally long with dist > 1."""
    npad = d.shape[1]
    eq = (d == _shift_right(d, 1, 0)) & (i_idx >= 1)
    brk = torch.where(eq, npad, i_idx)
    brk = torch.flip(torch.cummin(torch.flip(brk, [1]), dim=1).values, [1])
    l3 = torch.where(i_idx - 1 >= lo, brk - i_idx, 0)
    run_wins = (l3 > ln) | ((l3 == ln) & (dist > 1))
    return (torch.where(run_wins, l3, ln), torch.where(run_wins, 1, dist),
            ~run_wins & capped)


def _extend(ln, dist, capped, payload_bytes: int, max_match: int):
    """Extension doubling: a capped match whose distance recurs at i + cap
    chains to cap + len[i + cap], for cap = payload_bytes, 2x, ... <
    max_match."""
    cap = payload_bytes
    while cap < max_match:
        ln_next = _shift_left(ln, cap, 0)
        chain = capped & (_shift_left(dist, cap, 0) == dist)
        ln = torch.where(chain, cap + torch.clamp(ln_next, min=0), ln)
        capped = chain & _shift_left(capped, cap, False)
        cap *= 2
    return ln


def _finish(ln, dist, i_idx, base, end, n, *, max_match, min_emit, lazy):
    """Clamps, heuristics and lazy demotion -> (match_len, match_dist)
    [B, n] int32."""
    ln = torch.minimum(ln, torch.clamp(end - i_idx, max=max_match))
    ln = torch.where(ln >= min_emit, ln, 0)
    ln = torch.where((ln == 3) & (dist > 4096), 0, ln)
    ln = torch.where((i_idx >= base) & (i_idx < end), ln, 0)
    if lazy:
        ln_next = _shift_left(ln, 1, 0)
        ln = torch.where((ln > 0) & (ln < 32) & (ln_next > ln), 0, ln)
    return ln[:, :n].to(torch.int32), dist[:, :n].to(torch.int32)


def _tail_rows(data_u8, npad, lengths, halo_start, base):
    """Bytes padded to Np (int64), position index, block end, halo start."""
    b, n = data_u8.shape
    d = torch.zeros((b, npad), dtype=torch.int64, device=data_u8.device)
    d[:, :n] = data_u8
    i_idx = torch.arange(npad, device=data_u8.device)[None, :]
    return d, i_idx, base + lengths.to(torch.int64)[:, None], halo_start.to(torch.int64)[:, None]


def match_tail_plain(data_u8, packed_pos, lengths, halo_start, *, base: int,
                     payload_bytes: int, max_match: int, min_emit: int, lazy: bool):
    """Plain version of K6: bytes [B, N], position-ordered candidates
    ``packed_pos`` [B, Np] int32, ``lengths``/``halo_start`` [B] ->
    (match_len, match_dist) [B, N] int32."""
    n = data_u8.shape[1]
    d, i_idx, end, lo = _tail_rows(data_u8, packed_pos.shape[1], lengths, halo_start, base)
    ln, dist, capped = _merge_runs(d, i_idx, lo, *_unpack(packed_pos))
    ln = _extend(ln, dist, capped, payload_bytes, max_match)
    return _finish(ln, dist, i_idx, base, end, n, max_match=max_match, min_emit=min_emit,
                   lazy=lazy)


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
    ln = torch.empty((b, n), dtype=torch.int32, device=data_u8.device)
    dist = torch.empty((b, n), dtype=torch.int32, device=data_u8.device)
    MATCH_TAIL.launch(
        data_u8.device,
        ptr(data_u8.data_ptr()), ptr(packed_pos.data_ptr()), ptr(lengths.data_ptr()),
        ptr(halo_start.data_ptr()), ptr(ln.data_ptr()), ptr(dist.data_ptr()),
        b, n, npad, base, payload_bytes, max_match, min_emit, int(lazy),
        *tail_window(payload_bytes, max_match), stream_of(data_u8),
    )
    return ln, dist


def match_tail2_plain(data_u8, packed_hash_pos, packed_suffix_pos, lengths, halo_start, *,
                      base: int, payload_bytes: int, max_match: int, min_emit: int,
                      lazy: bool):
    """Plain version of K9: K6 with two candidate fields. Distance-1 runs
    merge into the hash field only; each field extends on its own; the
    suffix field wins when longer, or equally long and nearer; then K6's
    clamps, heuristics and lazy demotion run once."""
    n = data_u8.shape[1]
    d, i_idx, end, lo = _tail_rows(data_u8, packed_hash_pos.shape[1], lengths, halo_start,
                                   base)
    ln, dist, capped = _merge_runs(d, i_idx, lo, *_unpack(packed_hash_pos))
    ln = _extend(ln, dist, capped, payload_bytes, max_match)
    ln_s, dist_s, capped_s = _unpack(packed_suffix_pos)
    ln_s = _extend(ln_s, dist_s, capped_s, payload_bytes, max_match)
    wins = (ln_s > ln) | ((ln_s == ln) & (dist_s < dist))
    ln, dist = torch.where(wins, ln_s, ln), torch.where(wins, dist_s, dist)
    return _finish(ln, dist, i_idx, base, end, n, max_match=max_match, min_emit=min_emit,
                   lazy=lazy)


def match_tail2_cuda(data_u8, packed_hash_pos, packed_suffix_pos, lengths, halo_start, *,
                     base: int, payload_bytes: int, max_match: int, min_emit: int,
                     lazy: bool):
    """K9 (see ``csrc/match_tail2.cu``); same contract as
    :func:`match_tail2_plain`."""
    kw = dict(base=base, payload_bytes=payload_bytes, max_match=max_match,
              min_emit=min_emit, lazy=lazy)
    args = (data_u8, packed_hash_pos, packed_suffix_pos, lengths, halo_start)
    if on_cpu(data_u8):
        return match_tail2_plain(*args, **kw)
    b, n = data_u8.shape
    npad = padded_len(n)
    check_cuda(data_u8, torch.uint8, (b, n), "data_u8")
    check_cuda(packed_hash_pos, torch.int32, (b, npad), "packed_hash_pos")
    check_cuda(packed_suffix_pos, torch.int32, (b, npad), "packed_suffix_pos")
    check_cuda(lengths, torch.int32, (b,), "lengths")
    check_cuda(halo_start, torch.int32, (b,), "halo_start")
    ln = torch.empty((b, n), dtype=torch.int32, device=data_u8.device)
    dist = torch.empty((b, n), dtype=torch.int32, device=data_u8.device)
    MATCH_TAIL2.launch(
        data_u8.device, *(ptr(t.data_ptr()) for t in args + (ln, dist)),
        b, n, npad, base, payload_bytes, max_match, min_emit, int(lazy),
        *tail_window(payload_bytes, max_match), stream_of(data_u8),
    )
    return ln, dist


# ---------------------------------------------------------------------------
# Full matchers
# ---------------------------------------------------------------------------


def restore_order(sp: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """Sorted-order candidates back to position order: sp is a permutation
    of 0..Np-1, so the order-restoring sort is a scatter."""
    return torch.empty_like(packed).scatter_(1, sp.to(torch.int64), packed)


def hash_pass(data_u8, halo_start, *, payload_words: int, lags: int, max_dist: int):
    """K1, the hash sort, K2 (or K4 + K5 at more than 3 words), order
    restore -> position-order candidates [B, Np] int32."""
    pos_bits = _pos_bits(data_u8.shape[1])
    key, pays = build_keys_cuda(data_u8, pos_bits=pos_bits, payload_words=payload_words)
    # the keys hold the position, so they are unique: any sort is exact
    sk, order = torch.sort(key.to(torch.int64) & M32, dim=1)
    spays = torch.gather(pays, 2, order.expand(payload_words, -1, -1))
    sp, packed = neighbor_cuda(sk, spays, halo_start, pos_bits=pos_bits, lags=lags,
                               max_dist=max_dist)
    return restore_order(sp, packed)


def suffix_pass(data_u8, halo_start, *, payload_words: int, lags: int, suffix_keys: int,
                max_dist: int):
    """K7, the content sort on ``suffix_keys`` words, K4 + K8, order restore
    -> position-order candidates [B, Np] int32."""
    keys, pos = build_suffix_keys_cuda(data_u8, payload_words=payload_words)
    order = suffix_order(keys, pos, suffix_keys)
    skeys = torch.gather(keys, 2, order.expand(payload_words, -1, -1))
    sp, packed = suffix_neighbor_cuda(skeys, torch.gather(pos, 1, order), halo_start,
                                      lags=lags, max_dist=max_dist)
    return restore_order(sp, packed)


def _halo_start(halo_start, b: int, device) -> torch.Tensor:
    if halo_start is None:
        return torch.zeros((b,), dtype=torch.int32, device=device)
    return halo_start.to(torch.int32).contiguous()


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
    lengths = lengths.to(torch.int32).contiguous()
    halo_start = _halo_start(halo_start, data_u8.shape[0], data_u8.device)
    packed_pos = hash_pass(data_u8, halo_start, payload_words=payload_words, lags=lags,
                           max_dist=max_dist)
    return match_tail_cuda(
        data_u8, packed_pos, lengths, halo_start, base=base,
        payload_bytes=4 * payload_words, max_match=max_match, min_emit=min_emit,
        lazy=lazy,
    )


def best_matches_suffix_cuda(
    data_u8: torch.Tensor,
    lengths: torch.Tensor,
    *,
    max_dist: int,
    max_match: int,
    min_emit: int,
    base: int = 0,
    halo_start: torch.Tensor | None = None,
    lazy: bool = False,
    payload_words: int = 7,
    lags: int = 16,
    suffix_keys: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The suffix matcher (levels 6-9): the flow of
    ``best_matches_suffix_pallas`` (gzp_tpu/ops/lz_pallas.py:916), same
    arguments and result as :func:`best_matches_cuda`.

    A content-sorted pass (K7, the content sort on the first
    ``suffix_keys`` words, K4 + K8, order restore) finds each position's
    ±``lags`` neighbours by match length; a shallow hash pass at 2 lags
    (K1, hash sort, K4 + K5, order restore) keeps the recency candidates
    that extension chains need; K9 merges the two fields.
    """
    lengths = lengths.to(torch.int32).contiguous()
    halo_start = _halo_start(halo_start, data_u8.shape[0], data_u8.device)
    kw = min(suffix_keys, payload_words) if suffix_keys else payload_words
    packed_s_pos = suffix_pass(data_u8, halo_start, payload_words=payload_words, lags=lags,
                               suffix_keys=kw, max_dist=max_dist)
    packed_h_pos = hash_pass(data_u8, halo_start, payload_words=payload_words, lags=2,
                             max_dist=max_dist)
    return match_tail2_cuda(
        data_u8, packed_h_pos, packed_s_pos, lengths, halo_start, base=base,
        payload_bytes=4 * payload_words, max_match=max_match, min_emit=min_emit,
        lazy=lazy,
    )
