"""Per-block dynamic Huffman construction (RFC 1951 §3.2.7), batched.

Counterpart of ``gzp_tpu/ops/huffman.py``, in plain PyTorch on any
device: symbol histograms, length-limited code lengths by vectorised
package-merge, canonical codes, the RLE-compressed dynamic header, and
the per-block fixed/dynamic choice. The TPU original computes histograms
and table lookups as one-hot matmuls for its matrix unit; here they are
``scatter_add_`` and ``gather``, which give the same integers.
"""

from __future__ import annotations

import numpy as np
import torch

from gzp_tpu_torch.ops import tables

I64 = torch.int64

NLIT = 286
NDIST = 30
HEADER_BITS = 3 + 5 + 5 + 4 + 19 * 3 + (NLIT + NDIST) * 4  # = 1338

# CL symbols in the header's permuted order (RFC 1951 §3.2.7)
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int64,
)

_INF = 1 << 26  # weight padding (package sums stay below this)


# the dynamic header's constant fields, as tables for ``tables.on_device``
def cl_order() -> np.ndarray:
    """CL symbols in the header's permuted order."""
    return CL_ORDER


def constant_cl_lens() -> np.ndarray:
    """The CL code lengths of the constant 4-bit layout, in header order."""
    return np.array([4 if s <= 15 else 0 for s in CL_ORDER], dtype=np.int64)


def header_counts() -> np.ndarray:
    """HLIT, HDIST and HCLEN: every table is sent whole."""
    return np.array([NLIT - 257, NDIST - 1, 19 - 4], dtype=np.int64)


def header_widths() -> np.ndarray:
    """Bit widths of the header's first 23 fields: block header, HLIT,
    HDIST, HCLEN, and the 19 CL code lengths."""
    return np.array([3, 5, 5, 4] + [3] * 19, dtype=np.int64)


def _histogram(sym: torch.Tensor, weight: torch.Tensor, nsym: int) -> torch.Tensor:
    """Per-row counts of ``sym`` where ``weight`` (0/1) is set."""
    out = torch.zeros((sym.shape[0], nsym), dtype=I64, device=sym.device)
    idx = torch.where(weight, sym.to(I64), 0)
    return out.scatter_add_(1, idx, weight.to(I64))


def position_histograms(sym, dsym, is_tok, is_match):
    """Per-block symbol frequencies from per-position symbol arrays:
    (lit_freq [B, 286], dist_freq [B, 30]) int64, including the
    end-of-block symbol (frequency 1)."""
    lit_freq = _histogram(sym, is_tok, NLIT)
    lit_freq[:, 256] += 1  # EOB
    return lit_freq, _histogram(dsym, is_match, NDIST)


def code_lengths(freq: torch.Tensor, max_len: int = 15):
    """Optimal length-limited code lengths via vectorised package-merge.

    Per table: ``max_len`` - 1 bottom-up rounds of (pairwise package +
    merge by stable sort), then a top-down active-set count. Within every
    level's merged list the singles appear in weight order, so the singles
    chosen at level k are the ``n_k`` lightest symbols and a symbol's code
    length is the number of levels whose ``n_k`` exceeds its weight rank.

    Returns (lens [B, S] int64, ok [B] bool — False for the degenerate
    <2-used-symbols cases the caller special-cases).
    """
    b, s = freq.shape
    dev = freq.device
    freq = freq.to(I64)
    used = freq > 0
    nused = used.sum(dim=1)
    sym_ids = torch.arange(s, device=dev)[None, :]

    # ascending weight order of used symbols (ties by symbol id)
    key = torch.where(used, freq * 512 + sym_ids, _INF)
    order = torch.argsort(key, dim=1, stable=True)
    singles = torch.sort(torch.where(used, freq, _INF), dim=1, stable=True).values

    vals = torch.cat([singles, torch.full_like(singles, _INF)], dim=1)  # [B, 2S]
    merged_flags = torch.cat(
        [torch.zeros_like(singles), torch.ones_like(singles)], dim=1)
    pkg = [torch.zeros((b, 2 * s), dtype=I64, device=dev)]  # level 0: none
    for _ in range(max_len - 1):
        pairs = torch.clamp(vals[:, 0::2] + vals[:, 1::2], max=_INF)
        merged = torch.cat([singles, pairs], dim=1)
        idx = torch.argsort(merged * 2 + merged_flags, dim=1, stable=True)
        vals = torch.gather(merged, 1, idx)
        flags = torch.gather(merged_flags, 1, idx)
        flags = torch.where(vals >= _INF, 0, flags)  # pads are no packages
        pkg.append(torch.cumsum(flags, dim=1))

    # top-down: m_L = 2n - 2; m_{k-1} = 2 * (#packages among the first m_k
    # items of list k); singles chosen n_k = m_k - p_k
    m = torch.clamp(2 * nused - 2, min=0)
    n_ks = [None] * max_len
    for k in reversed(range(max_len)):
        p = torch.gather(pkg[k], 1, torch.clamp(m - 1, min=0)[:, None])[:, 0]
        p = torch.where(m > 0, p, 0)
        n_ks[k] = m - p
        m = 2 * p
    n_ks = torch.stack(n_ks)  # [L, B]

    # lens by rank: l_r = #{k : r < n_k}, scattered back through `order`
    l_by_rank = (sym_ids[None, :, :] < n_ks[:, :, None]).sum(dim=0)
    lens = torch.zeros((b, s), dtype=I64, device=dev).scatter_(1, order, l_by_rank)
    lens = torch.where(used, lens, 0)
    return lens, nused >= 2


def _bit_reverse32(v: torch.Tensor) -> torch.Tensor:
    m32 = 0xFFFFFFFF
    v = (((v & 0x55555555) << 1) | ((v >> 1) & 0x55555555)) & m32
    v = (((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)) & m32
    v = (((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)) & m32
    v = (((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)) & m32
    return ((v << 16) | (v >> 16)) & m32


def canonical_codes(lens: torch.Tensor) -> torch.Tensor:
    """Per-symbol canonical codes from code lengths, bit-reversed for
    LSB-first emission: lens [B, S] (0 = unused) -> codes [B, S] int64."""
    b, s = lens.shape
    dev = lens.device
    lens = lens.to(I64)
    onehot = (lens[:, :, None] == torch.arange(16, device=dev)[None, None, :]).to(I64)
    cnt = onehot.sum(dim=1)  # [B, 16] codes per length
    next_code = [torch.zeros((b,), dtype=I64, device=dev)]
    code = next_code[0]
    for l in range(1, 16):
        code = ((code + cnt[:, l - 1]) << 1) & 0xFFFFFFFF
        next_code.append(code)
    next_code = torch.stack(next_code, dim=1)  # [B, 16]

    rank = torch.cumsum(onehot, dim=1) - onehot  # exclusive, per length
    li = torch.clamp(lens, 0, 15)
    my_rank = torch.gather(rank, 2, li[:, :, None])[:, :, 0]
    code = (torch.gather(next_code, 1, li) + my_rank) & 0xFFFFFFFF
    rev = _bit_reverse32(code) >> (32 - torch.clamp(lens, 1, 15))
    return torch.where(lens > 0, rev, 0)


def _rev4(x: torch.Tensor) -> torch.Tensor:
    """Reverse 4 bits (CL codes of the constant layout: all 16 value
    symbols at length 4, canonical code == symbol value)."""
    return ((x & 1) << 3) | ((x & 2) << 1) | ((x & 4) >> 1) | ((x & 8) >> 3)


def _seg_runs(vals: torch.Tensor):
    """Per-position (offset-in-run, run-length) of maximal equal-value runs
    along dim 1, via cummax/cummin scans."""
    b, s = vals.shape
    idx = torch.arange(s, device=vals.device)[None, :].expand(b, s)
    start = torch.cat(
        [torch.ones_like(vals[:, :1], dtype=torch.bool), vals[:, 1:] != vals[:, :-1]],
        dim=1)
    rs = torch.cummax(torch.where(start, idx, 0), dim=1).values
    nxt = torch.cat(
        [torch.where(start, idx, s)[:, 1:], torch.full_like(vals[:, :1], s)], dim=1)
    re = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    return idx - rs, re - rs


def rle_code_length_symbols(all_lens: torch.Tensor):
    """Per-position RLE encoding of the 316 code lengths (CL symbols
    16/17/18): zero runs become 138-max sym-18 pieces (then one 17/18 for
    the 3..137 remainder, literal zeros below 3); a nonzero run emits its
    value once then 16 pieces of 3..6 repeats. Returns (clsym [B, S] with
    -1 where a piece covers the position, extra, extra_n, emitted)."""
    v = all_lens.to(I64)
    ii, ln = _seg_runs(v)
    is_zero = v == 0

    # zero runs: pieces anchored every 138 positions
    ps = ii - ii % 138
    rem = ln - ps
    size0 = torch.where(rem >= 11, torch.clamp(rem, max=138), torch.where(rem >= 3, rem, 0))
    start0 = (ii == ps) & (size0 > 0)
    tail0 = ii >= ps + size0  # beyond the piece (or size0 == 0): literal 0
    sym0 = torch.where(size0 >= 11, 18, 17)
    extra0 = torch.where(size0 >= 11, size0 - 11, size0 - 3)
    extran0 = torch.where(size0 >= 11, 7, 3)

    # nonzero runs: literal at run start, then 16-pieces every 6
    jj = ii - 1
    cs = jj - torch.remainder(jj, 6)
    remn = (ln - 1) - cs
    size1 = torch.where(remn >= 3, torch.clamp(remn, max=6), 0)
    start1 = (ii > 0) & (jj == cs) & (size1 > 0)
    tail1 = (ii > 0) & (jj >= cs + size1)

    lit = torch.where(is_zero, tail0, (ii == 0) | tail1)
    clsym = torch.where(lit, v, -1)
    zs, ns = is_zero & start0, ~is_zero & start1
    clsym = torch.where(zs, sym0, torch.where(ns, 16, clsym))
    extra = torch.where(zs, extra0, torch.where(ns, size1 - 3, 0))
    extran = torch.where(zs, extran0, torch.where(ns, 2, 0))
    return clsym, extra, extran, clsym >= 0


def dynamic_header_fields_rle(lit_lens, dist_lens, final, use_dyn):
    """RLE-compressed dynamic header as (bits, nbits) [B, 1+3+19+316]
    virtual entries (covered positions are 0-width). Falls back per block
    to the constant 4-bit layout when the CL alphabet is degenerate (< 2
    used symbols); fixed blocks keep only the 3-bit block header."""
    b = lit_lens.shape[0]
    dev = lit_lens.device
    all_lens = torch.cat([lit_lens, dist_lens], dim=1).to(I64)  # [B, 316]
    clsym, extra, extran, emitted = rle_code_length_symbols(all_lens)

    # CL alphabet Huffman, max length 7 (fits HCLEN's 3-bit fields)
    cl_idx = torch.where(emitted, clsym, 0)
    cl_freq = _histogram(cl_idx, emitted, 19)
    cl_lens, cl_ok = code_lengths(cl_freq, max_len=7)
    cl_codes = canonical_codes(cl_lens)
    pc = torch.gather(cl_codes, 1, cl_idx)
    pn = torch.gather(cl_lens, 1, cl_idx)
    rle_bits = torch.where(emitted, pc | (extra << pn), 0)
    rle_n = torch.where(emitted, pn + extran, 0)

    use_rle = cl_ok[:, None]
    lens_bits = torch.where(use_rle, rle_bits, _rev4(torch.clamp(all_lens, 0, 15)))
    lens_n = torch.where(use_rle, rle_n, 4)

    order = tables.on_device(cl_order, (), dev, I64)
    const_cl = tables.on_device(constant_cl_lens, (), dev, I64)
    cl_field = torch.where(use_rle, cl_lens[:, order], const_cl[None, :])

    hdr3 = torch.where(use_dyn, 4, 2) | final.to(I64)  # BFINAL | BTYPE
    consts = tables.on_device(header_counts, (), dev, I64)
    head_bits = torch.cat([hdr3[:, None], consts[None, :].expand(b, 3), cl_field], dim=1)
    head_n = tables.on_device(header_widths, (), dev, I64)[None, :].expand(b, -1)
    bits_all = torch.cat([head_bits, lens_bits], dim=1)
    n_all = torch.cat([head_n, lens_n], dim=1)
    keep = use_dyn[:, None] | (torch.arange(bits_all.shape[1], device=dev) == 0)[None, :]
    return torch.where(keep, bits_all, 0), torch.where(keep, n_all, 0)


def fixed_table_arrays(b: int, device):
    """Fixed-Huffman tables broadcast to [B, S] (codes, lens, dist codes,
    dist lens) int64."""
    lit = tables.on_device(tables.fixed_litlen_codes, (), torch.device(device), I64)
    dist = tables.on_device(tables.fixed_dist_codes, (), torch.device(device), I64)
    return (
        lit[0, :NLIT].expand(b, NLIT), lit[1, :NLIT].expand(b, NLIT),
        dist[0].expand(b, NDIST), dist[1].expand(b, NDIST),
    )


def choose_tables(lit_freq: torch.Tensor, dist_freq: torch.Tensor):
    """Dynamic tables and the per-block fixed/dynamic decision. Returns
    (lit_codes, lit_lens, dist_codes, dist_lens, use_dyn, dlit_lens,
    ddist_lens): the tables already selected per block (fixed where
    dynamic loses or is invalid), and the dynamic lengths for the header."""
    b = lit_freq.shape[0]
    dlit_lens, lit_ok = code_lengths(lit_freq)
    ddist_lens, dist_ok = code_lengths(dist_freq)

    # no distances at all -> a single 1-bit code for symbol 0 (the
    # degenerate incomplete code zlib itself emits)
    no_dist = dist_freq.sum(dim=1) == 0
    one_code = torch.zeros_like(ddist_lens)
    one_code[:, 0] = 1
    ddist_lens = torch.where(no_dist[:, None], one_code, ddist_lens)
    dist_ok = dist_ok | no_dist
    # litlen needs >= 2 used symbols for a complete code (EOB guarantees 1)
    lit_ok = lit_ok & ((lit_freq > 0).sum(dim=1) >= 2)

    fix_lit_c, fix_lit_n, fix_dist_c, fix_dist_n = fixed_table_arrays(b, lit_freq.device)
    # bit-cost comparison (extra bits cancel)
    cost_dyn = HEADER_BITS + (lit_freq * dlit_lens).sum(1) + (dist_freq * ddist_lens).sum(1)
    cost_fix = 3 + (lit_freq * fix_lit_n).sum(1) + (dist_freq * fix_dist_n).sum(1)
    use_dyn = lit_ok & dist_ok & (cost_dyn < cost_fix)

    dyn = use_dyn[:, None]
    lit_codes = torch.where(dyn, canonical_codes(dlit_lens), fix_lit_c)
    lit_lens = torch.where(dyn, dlit_lens, fix_lit_n)
    dist_codes = torch.where(dyn, canonical_codes(ddist_lens), fix_dist_c)
    dist_lens = torch.where(dyn, ddist_lens, fix_dist_n)
    return lit_codes, lit_lens, dist_codes, dist_lens, use_dyn, dlit_lens, ddist_lens
