"""Precomputed numpy lookup tables for the device codecs.

All tables are built on the host with numpy, cached per shape, and moved
to the encoder's device as constant tensors. This replaces the
reference's reliance on zlib-ng/libdeflate internal tables (reference
src/deflate.rs L0 backends) with explicit, testable table construction.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from gzp_tpu_torch import check as _check

# ---------------------------------------------------------------------------
# Bit utilities
# ---------------------------------------------------------------------------


def reverse_bits(value: int, width: int) -> int:
    """Reverse the low ``width`` bits of ``value`` (DEFLATE Huffman codes are
    emitted MSB-first into an LSB-first bitstream, RFC 1951 §3.1.1)."""
    out = 0
    for _ in range(width):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


# ---------------------------------------------------------------------------
# Fixed Huffman tables (RFC 1951 §3.2.6)
# ---------------------------------------------------------------------------


@functools.cache
def fixed_litlen_codes() -> tuple[np.ndarray, np.ndarray]:
    """(codes_reversed[288] uint32, nbits[288] int32) for the fixed
    literal/length alphabet."""
    codes = np.zeros(288, dtype=np.uint32)
    nbits = np.zeros(288, dtype=np.int32)
    for sym in range(288):
        if sym <= 143:
            code, width = 0x30 + sym, 8
        elif sym <= 255:
            code, width = 0x190 + (sym - 144), 9
        elif sym <= 279:
            code, width = sym - 256, 7
        else:
            code, width = 0xC0 + (sym - 280), 8
        codes[sym] = reverse_bits(code, width)
        nbits[sym] = width
    return codes, nbits


@functools.cache
def fixed_dist_codes() -> tuple[np.ndarray, np.ndarray]:
    """(codes_reversed[30] uint32, nbits[30]=5 int32) for fixed distance codes."""
    codes = np.array([reverse_bits(sym, 5) for sym in range(30)], dtype=np.uint32)
    nbits = np.full(30, 5, dtype=np.int32)
    return codes, nbits


# ---------------------------------------------------------------------------
# CRC tables for the device checksum kernels
# ---------------------------------------------------------------------------


@functools.cache
def crc_byte_table(poly: int) -> np.ndarray:
    """Classic 256-entry byte-update table (uint32)."""
    return _check.crc_table(poly)


@functools.cache
def crc_position_table(seg_len: int, poly: int) -> np.ndarray:
    """Flat ``[seg_len * 256]`` uint32 table: entry ``q*256 + v`` is the raw
    CRC register produced by byte ``v`` at offset ``q`` of a ``seg_len``-byte
    segment followed by zeros — i.e. the linear contribution of that byte to
    the segment's raw CRC. A segment's raw CRC is then the XOR of one lookup
    per byte: fully parallel, no byte-serial loop.
    """
    t256 = crc_byte_table(poly)
    out = np.zeros((seg_len, 256), dtype=np.uint32)
    # Row q must equal O_{seg_len-1-q}(t256[v]) where O_k advances the
    # register past k zero bytes; built back-to-front, each row is the next
    # row advanced one more zero byte: r -> (r>>8) ^ t256[r & 0xFF].
    out[seg_len - 1] = t256
    for q in range(seg_len - 2, -1, -1):
        prev = out[q + 1]
        out[q] = (prev >> np.uint32(8)) ^ t256[prev & np.uint32(0xFF)]
    return out.reshape(-1)


@functools.cache
def crc_unshift_ladder(max_log: int, poly: int) -> np.ndarray:
    """``[max_log, 4, 256]`` tables; level k *removes* ``2**k`` trailing zero
    bytes from a raw CRC register (inverse shift operator)."""
    one = _check._zero_bit_operator(poly)
    for _ in range(3):
        one = _check._gf2_matrix_square(one)  # one zero byte
    inv1 = _check.gf2_matrix_invert(one)
    levels = []
    cur = inv1
    for _ in range(max_log):
        levels.append(_check._columns_to_tables(cur))
        cur = _check._gf2_matrix_square(cur)
    return np.stack(levels, axis=0)


@functools.cache
def crc_shift_ladder(max_log: int, poly: int) -> np.ndarray:
    """``[max_log, 4, 256]`` tables; level k advances a register past
    ``2**k`` zero bytes (forward shift operator)."""
    return np.stack([_check.crc_operator_tables(1 << k, poly) for k in range(max_log)])


@functools.cache
def crc_init_constant(total_len: int, poly: int) -> int:
    """Raw register after feeding ``total_len`` zero bytes from init ~0.

    Used to fold the standard pre-conditioning into the linear segment CRC:
    crc32(block) == ~(init_const ^ raw_xor_crc(block)).
    """
    if poly == _check.CRC32_POLY:
        return (zlib.crc32(b"\x00" * total_len) ^ 0xFFFFFFFF) & 0xFFFFFFFF
    # generic: advance ~0 through total_len zero bytes with the table
    t256 = crc_byte_table(poly)
    r = np.uint32(0xFFFFFFFF)
    # O(total_len) python loop would be slow for big N; use operator matrix.
    tabs = _check.crc_operator_tables(total_len, poly)
    return int(_check.apply_operator_tables(tabs, np.array([r], dtype=np.uint32))[0])


@functools.cache
def crc_bit_matrix(seg_len: int, poly: int) -> np.ndarray:
    """``[seg_len*8, 32]`` GF(2) basis matrix: row ``q*8+b`` is the raw CRC
    register contributed by bit ``b`` of the byte at offset ``q`` of a
    ``seg_len``-byte segment, unpacked to 0/1 int8.

    Lets the per-segment raw CRC be computed as ONE matmul mod 2
    (bits[B*S, seg*8] @ M), with no byte-serial loop.
    """
    pos = crc_position_table(seg_len, poly).reshape(seg_len, 256)
    contrib = pos[:, [1 << b for b in range(8)]]  # [seg, 8] uint32
    bits = (
        (contrib[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(np.int8)
    return bits.reshape(seg_len * 8, 32)


@functools.cache
def crc_seg_fold_matrix(nseg: int, seg_len: int, poly: int) -> np.ndarray:
    """``[nseg*32, 32]`` GF(2) matrix folding per-segment raw CRCs into the
    whole-block raw CRC: rows ``s*32 + j`` hold the register produced by
    bit ``j`` of segment ``s``'s CRC after advancing past the
    ``(nseg-1-s)*seg_len`` zero bytes that follow it (pigz-COMB as one
    matmul)."""
    max_log = max(int(nseg * seg_len).bit_length(), 1)
    ladder = crc_shift_ladder(max_log, poly)  # [L, 4, 256] uint32
    regs = np.broadcast_to(
        (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, :], (nseg, 32)
    ).copy()
    m = (nseg - 1 - np.arange(nseg, dtype=np.int64)) * seg_len
    for k in range(max_log):
        mask = ((m >> k) & 1).astype(bool)
        if not mask.any():
            continue
        t = ladder[k]
        r = regs[mask]
        regs[mask] = (
            t[0, r & 0xFF]
            ^ t[1, (r >> 8) & 0xFF]
            ^ t[2, (r >> 16) & 0xFF]
            ^ t[3, (r >> 24) & 0xFF]
        )
    bits = ((regs[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int8)
    return bits.reshape(nseg * 32, 32)


@functools.lru_cache(maxsize=None)
def on_device(fn, args: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``fn(*args)`` (one of the numpy tables above) as a constant tensor on
    ``device``, built and copied once per table, device and dtype."""
    arr = np.asarray(fn(*args)).astype(np.int64)  # every table is integer
    return torch.from_numpy(arr).to(device=device, dtype=dtype)
