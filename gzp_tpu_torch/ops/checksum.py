"""Batched device checksums over ``[B, N]`` blocks: CRC32, masked CRC32C
and Adler32, in plain PyTorch.

Counterpart of ``gzp_tpu/ops/checksum.py`` (``crc_device``,
``crc_device_exact``, ``crc32_device``, ``crc32c_masked_device``,
``adler32_device``), which are XLA there, not Pallas. CRC is linear over GF(2), so each
``seg``-byte segment's raw register is ``bits @ M`` (mod 2) for a constant
basis matrix, and the pigz-COMB fold of the segments into the block's raw
register is a second constant matmul. The products run in float64: the
sums are small integers (at most ``N/seg * 32``), exact in any summation
order, and float64 products never go through TF32. Ragged blocks then
remove their zero padding with a ladder of inverse shift operators.
Adler32 is modular arithmetic over segment sums. u32 values are int64
masked to 32 bits.
"""

from __future__ import annotations

import torch

from gzp_tpu_torch import check as _check
from gzp_tpu_torch.ops import tables as _tables

DEFAULT_SEG_LEN = 128
M32 = 0xFFFFFFFF


def _pick_seg_len(n: int) -> int:
    """Largest power-of-two segment length <= DEFAULT_SEG_LEN dividing n."""
    seg = DEFAULT_SEG_LEN
    while seg > 1 and n % seg != 0:
        seg //= 2
    return seg


def _gf2_matmul(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(x @ m) mod 2 for 0/1 operands; exact in float64."""
    return torch.remainder(x.to(torch.float64) @ m, 2).to(torch.int64)


def crc_device(data_u8: torch.Tensor, poly: int) -> torch.Tensor:
    """Batched CRC over full blocks: ``data_u8`` [B, N] uint8, every block
    exactly N real bytes -> [B] int64 standard (conditioned) CRC values."""
    b, n = data_u8.shape
    seg = _pick_seg_len(n)
    nseg = n // seg
    shifts = torch.arange(8, device=data_u8.device, dtype=torch.uint8)
    bits = ((data_u8.reshape(b * nseg, seg)[:, :, None] >> shifts) & 1).reshape(
        b * nseg, seg * 8)
    dev, f64 = data_u8.device, torch.float64
    bit_m = _tables.on_device(_tables.crc_bit_matrix, (seg, poly), dev, f64)
    fold_m = _tables.on_device(_tables.crc_seg_fold_matrix, (nseg, seg, poly), dev, f64)
    seg_bits = _gf2_matmul(bits, bit_m)  # [B*S, 32]
    raw_bits = _gf2_matmul(seg_bits.reshape(b, nseg * 32), fold_m)  # [B, 32]
    weights = 1 << torch.arange(32, device=data_u8.device, dtype=torch.int64)
    raw = (raw_bits * weights).sum(dim=1)
    init = _tables.crc_init_constant(n, poly)
    return (raw ^ init) ^ M32


def _apply_tables(t: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """Apply a [4, 256] operator-table set to u32 registers (int64)."""
    return (
        t[0][reg & 0xFF] ^ t[1][(reg >> 8) & 0xFF]
        ^ t[2][(reg >> 16) & 0xFF] ^ t[3][(reg >> 24) & 0xFF]
    )


def crc_device_exact(data_u8: torch.Tensor, lengths: torch.Tensor, poly: int) -> torch.Tensor:
    """CRC over ``data[:, :length]`` for zero-padded ``[B, N]`` blocks:
    the padded block's raw register with its ``N - length`` trailing zero
    bytes removed by the inverse shift ladder, conditioned for the true
    length with the forward ladder."""
    b, n = data_u8.shape
    dev = data_u8.device
    init_n = _tables.crc_init_constant(n, poly)
    raw = (crc_device(data_u8, poly) ^ M32) ^ init_n

    max_log = max(n.bit_length(), 1)
    unshift = _tables.on_device(_tables.crc_unshift_ladder, (max_log, poly), dev, torch.int64)
    shift = _tables.on_device(_tables.crc_shift_ladder, (max_log, poly), dev, torch.int64)
    ln = lengths.to(device=dev, dtype=torch.int64)
    pad = n - ln
    init_reg = torch.full((b,), M32, dtype=torch.int64, device=dev)
    for k in range(max_log):
        raw = torch.where(((pad >> k) & 1) == 1, _apply_tables(unshift[k], raw), raw)
    for k in range(max_log):
        init_reg = torch.where(
            ((ln >> k) & 1) == 1, _apply_tables(shift[k], init_reg), init_reg)
    return (raw ^ init_reg) ^ M32


def crc32_device(data_u8: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched CRC32 (gzip/mgzip/bgzf member checksum) as [B] int64. With
    ``lengths``, the exact CRC of each block's first ``length`` bytes."""
    if lengths is None:
        return crc_device(data_u8, _check.CRC32_POLY)
    return crc_device_exact(data_u8, lengths, _check.CRC32_POLY)


def crc32c_masked_device(data_u8: torch.Tensor, lengths: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Batched snappy-frame checksum as [B] int64: CRC32C, then snappy's
    masking (rotate right 15, add 0xA282EAD8, mod 2**32)."""
    if lengths is None:
        crc = crc_device(data_u8, _check.CRC32C_POLY)
    else:
        crc = crc_device_exact(data_u8, lengths, _check.CRC32C_POLY)
    return ((((crc >> 15) | (crc << 17)) & M32) + 0xA282EAD8) & M32


ADLER_MOD = 65521
_ADLER_SEG = 128


def adler32_device(data_u8: torch.Tensor, lengths: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Batched Adler32 as [B] int64; exact for zero-padded blocks when
    ``lengths`` is given.

    Per segment s of length L: S1_s = sum(b_q), Q_s = sum(q * b_q); then
      A = 1 + sum_s S1_s                               (mod 65521)
      B = len + sum_s ((N - s*L) * S1_s - Q_s)
             - (N - len) * sum_s S1_s                  (mod 65521)
    (zero pad bytes add nothing to any byte sum, so only the position
    weights need the length correction).
    """
    b, n = data_u8.shape
    dev = data_u8.device
    seg = _ADLER_SEG
    while n % seg != 0:
        seg //= 2
    nseg = n // seg
    data = data_u8.reshape(b, nseg, seg).to(torch.int64)
    s1 = data.sum(dim=-1) % ADLER_MOD  # [B, S]
    qsum = (data * torch.arange(seg, device=dev)).sum(dim=-1) % ADLER_MOD
    weight = (n - torch.arange(nseg, device=dev) * seg) % ADLER_MOD
    term = ((weight * s1) % ADLER_MOD + ADLER_MOD - qsum) % ADLER_MOD
    s1_total = s1.sum(dim=-1) % ADLER_MOD
    a = (1 + s1_total) % ADLER_MOD
    bsum = term.sum(dim=-1) % ADLER_MOD
    if lengths is None:
        ln = torch.full((b,), n, dtype=torch.int64, device=dev)
    else:
        ln = lengths.to(device=dev, dtype=torch.int64)
    corr = ((n - ln) % ADLER_MOD) * s1_total % ADLER_MOD
    bsum = (bsum + ln % ADLER_MOD + ADLER_MOD - corr) % ADLER_MOD
    return (bsum << 16) | a
