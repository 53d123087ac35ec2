"""CUDA kernel of the sort-scan DEFLATE bit packer, with its plain version.

Counterpart of ``gzp_tpu/ops/pack_pallas.py``. K10
(:func:`pack_prescan_cuda`) turns per-entry (value, width) pairs into
(word index, word value) pairs in one pass: a width prefix sum gives each
entry's bit position, a segmented OR-scan over entries builds each output
word, and the entry that completes a word carries its index as the key.
The kernel splits each row into tiles and carries both prefixes across
them with a decoupled look-back. :func:`pack_entries_sortscan_cuda` then
places every keyed value at its word — the TPU sorts by key; the key is
the destination index, so here it is a scatter with the same result.

The wrapper runs the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors, and raises for a CUDA tensor it cannot launch on.
"""

from __future__ import annotations

import torch

from gzp_tpu_torch.runtime.cuda_lib import (
    CudaKernel, check_cuda, i32, on_cpu, ptr, stream_of,
)

LANES = 128
M32 = 0xFFFFFFFF

PACK_PRESCAN = CudaKernel(
    "pack_prescan.cu", "gzp_pack_prescan",
    [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32],
)
# entries per CTA of K10 (T in csrc/pack_prescan.cu: 512 threads x 8)
PACK_TILE = 4096


def prescan_len(e: int) -> int:
    """Entries + the zero-width tail entry, padded to whole (8, 128) tiles
    (at least 8 rows), as the Pallas kernel pads."""
    rows = max(-(-(e + 1) // LANES), 8)
    return -(-rows // 8) * 8 * LANES


def prescan_plan(rows: int, e: int):
    """K10's launch at ``rows`` x ``e`` entries: ``(tiles per row, scratch
    u64 words)``. The scratch holds a width and an OR status word per tile
    and the tile counter (``csrc/pack_prescan.cu``)."""
    tiles = -(-prescan_len(e) // PACK_TILE)
    return tiles, 2 * rows * tiles + 1


def pack_prescan_plain(bits: torch.Tensor, nbits: torch.Tensor, base_bits: int):
    """Plain version of K10: ``bits`` [B, E] (u32 values < 2^31) and
    ``nbits`` [B, E] int32 widths in [0, 31] -> (key [B, Ep] int32 holding
    u32 bits, -1 = no word; val [B, Ep] int32 holding u32 bits;
    total_bits [B] int32)."""
    b, e = bits.shape
    ep = prescan_len(e)
    dev = bits.device
    v = torch.zeros((b, ep), dtype=torch.int64, device=dev)
    nb = torch.zeros((b, ep), dtype=torch.int64, device=dev)
    v[:, :e] = bits.to(torch.int64) & M32
    nb[:, :e] = nbits

    csum = torch.cumsum(nb, dim=1)
    bitpos = base_bits + csum - nb
    cnt = bitpos & 31
    w = bitpos >> 5
    lo = (v << cnt) & M32
    hi = (v >> (31 - cnt)) >> 1
    flush = ((bitpos + nb) >> 5) > w
    start = torch.cat([torch.ones_like(flush[:, :1]), flush[:, :-1]], dim=1)
    hi_prev = torch.cat([torch.zeros_like(hi[:, :1]), hi[:, :-1]], dim=1)
    c = lo | torch.where(start, hi_prev, 0)

    # segmented inclusive OR-scan of (c, start), log-step
    val, res = c, start
    s = 1
    while s < ep:
        v_l = torch.cat([torch.zeros_like(val[:, :s]), val[:, :-s]], dim=1)
        r_l = torch.cat([torch.zeros_like(res[:, :s]), res[:, :-s]], dim=1)
        val = torch.where(res, val, v_l | val)
        res = res | r_l
        s *= 2

    key = torch.where(flush, w, M32)
    tail_valid = (bitpos[:, e] & 31) > 0
    key[:, e] = torch.where(tail_valid, w[:, e], M32)
    key[:, e + 1:] = M32
    total_bits = base_bits + nbits.to(torch.int64).sum(dim=1)
    return key.to(torch.int32), val.to(torch.int32), total_bits.to(torch.int32)


def pack_prescan_cuda(bits: torch.Tensor, nbits: torch.Tensor, base_bits: int):
    """K10 (see ``csrc/pack_prescan.cu``: tiles of ``PACK_TILE`` entries
    across the row, one pass with a decoupled look-back); same contract as
    :func:`pack_prescan_plain`."""
    if on_cpu(bits):
        return pack_prescan_plain(bits, nbits, base_bits)
    b, e = bits.shape
    ep = prescan_len(e)
    check_cuda(bits, torch.int32, (b, e), "bits")
    check_cuda(nbits, torch.int32, (b, e), "nbits")
    _, words = prescan_plan(b, e)
    key = torch.empty((b, ep), dtype=torch.int32, device=bits.device)
    val = torch.empty((b, ep), dtype=torch.int32, device=bits.device)
    total_bits = torch.empty((b,), dtype=torch.int32, device=bits.device)
    scratch = torch.empty((words,), dtype=torch.int64, device=bits.device)
    PACK_PRESCAN.launch(
        bits.device,
        ptr(bits.data_ptr()), ptr(nbits.data_ptr()), ptr(key.data_ptr()),
        ptr(val.data_ptr()), ptr(total_bits.data_ptr()), ptr(scratch.data_ptr()),
        b, e, ep, base_bits, stream_of(bits),
    )
    return key, val, total_bits


def pack_entries_sortscan_cuda(bits: torch.Tensor, nbits: torch.Tensor,
                               base_bits: int, out_words: int):
    """Assemble each row's bit stream from (value, width) entries: the
    contract of ``pack_entries_sortscan_pallas`` (gzp_tpu/ops/
    pack_pallas.py:229). ``bits`` [B, E] int32 (values < 2^31, ``bits <
    2**nbits``), ``nbits`` [B, E] int32 in [0, 31]; the stream starts at
    bit ``base_bits`` (words before it stay zero). Returns (words
    [B, out_words] int64 holding u32 values, total_bits [B] int32)."""
    b = bits.shape[0]
    key, val, total_bits = pack_prescan_cuda(
        bits.to(torch.int32).contiguous(), nbits.to(torch.int32).contiguous(), base_bits
    )
    k = key.to(torch.int64) & M32
    # every completed word has exactly one keyed entry; keys past the
    # buffer (and the 0xFFFFFFFF "no word" keys) land in a dropped column
    dest = torch.where(k < out_words, k, out_words)
    words = torch.zeros((b, out_words + 1), dtype=torch.int64, device=bits.device)
    words.scatter_(1, dest, val.to(torch.int64) & M32)
    words = words[:, :out_words]
    n_words = (total_bits.to(torch.int64) + 31) >> 5
    keep = torch.arange(out_words, device=bits.device)[None, :] < n_words[:, None]
    return torch.where(keep, words, 0), total_bits
