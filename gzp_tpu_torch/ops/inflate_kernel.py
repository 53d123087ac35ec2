"""Batched DEFLATE decode over independent streams (K11), with its plain
version.

Counterpart of ``gzp_tpu/ops/inflate_kernel.py`` (``inflate_blocks`` :139,
``get_inflater`` :390), which is XLA there, not a Pallas kernel. B raw
Deflate streams, one per Mgzip/BGZF member payload with its ISIZE known
from the footer, decode to ``out [B, out_cap]`` u8 (zero past each
stream's ``out_len``), ``out_count [B]`` and ``ok [B]``. ``ok`` follows
the reference's rules exactly, because it decides which blocks
``ParDecompress(backend='device')`` sends to the host codec; the rules are
listed in ``csrc/inflate.cu``.

:func:`inflate_blocks_plain` is the reference's algorithm in PyTorch:
lockstep symbol decode over B lanes with the table-free canonical decode
(a symbol's code length is the first ``l`` whose 15-bit MSB-first
lookahead prefix falls in ``[first_code[l], first_code[l] + count[l])``),
literals written and match starts marked, then copy resolution by pointer
doubling. :func:`inflate_blocks_cuda` launches ``csrc/inflate.cu``: one
warp per stream, symbols decoded serially by one lane from per-block
lookup tables and a register bit buffer, copies written by the warp. :func:`inflate_blocks` runs the plain version for a CPU tensor
and the kernel for a CUDA tensor, and raises otherwise.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from gzp_tpu_torch.ops.checksum import crc32_device
from gzp_tpu_torch.runtime.cuda_lib import CudaKernel, check_cuda, i32, on_cpu, ptr, stream_of

I64 = torch.int64

INFLATE = CudaKernel(
    "inflate.cu", "gzp_inflate",
    [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32],
)

_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]

_LEN_BASE = np.zeros(288, np.int64)
_LEN_EXTRA = np.zeros(288, np.int64)
for _sym, _eb, _b in [
    (257, 0, 3), (258, 0, 4), (259, 0, 5), (260, 0, 6), (261, 0, 7),
    (262, 0, 8), (263, 0, 9), (264, 0, 10), (265, 1, 11), (266, 1, 13),
    (267, 1, 15), (268, 1, 17), (269, 2, 19), (270, 2, 23), (271, 2, 27),
    (272, 2, 31), (273, 3, 35), (274, 3, 43), (275, 3, 51), (276, 3, 59),
    (277, 4, 67), (278, 4, 83), (279, 4, 99), (280, 4, 115), (281, 5, 131),
    (282, 5, 163), (283, 5, 195), (284, 5, 227), (285, 0, 258),
]:
    _LEN_BASE[_sym] = _b
    _LEN_EXTRA[_sym] = _eb

_DIST_BASE = np.zeros(32, np.int64)
_DIST_EXTRA = np.zeros(32, np.int64)
for _sym, _eb, _b in [
    (0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 0, 4), (4, 1, 5), (5, 1, 7),
    (6, 2, 9), (7, 2, 13), (8, 3, 17), (9, 3, 25), (10, 4, 33), (11, 4, 49),
    (12, 5, 65), (13, 5, 97), (14, 6, 129), (15, 6, 193), (16, 7, 257),
    (17, 7, 385), (18, 8, 513), (19, 8, 769), (20, 9, 1025), (21, 9, 1537),
    (22, 10, 2049), (23, 10, 3073), (24, 11, 4097), (25, 11, 6145),
    (26, 12, 8193), (27, 12, 12289), (28, 13, 16385), (29, 13, 24577),
]:
    _DIST_BASE[_sym] = _b
    _DIST_EXTRA[_sym] = _eb

_FIXED_LIT = np.zeros(288, np.int64)
_FIXED_LIT[:144] = 8
_FIXED_LIT[144:256] = 9
_FIXED_LIT[256:280] = 7
_FIXED_LIT[280:] = 8
_FIXED_DIST = np.full(30, 5, np.int64)


@dataclass(frozen=True)
class InflateConfig:
    in_cap: int  # padded compressed payload width
    out_cap: int  # padded output width (>= max ISIZE)
    max_blocks: int = 16  # max deflate blocks per stream


def inflate_config_from_reference(fields: dict) -> InflateConfig:
    """This package's config from ``dataclasses.asdict()`` of a
    ``gzp_tpu`` ``InflateConfig`` (the fields are the same)."""
    return InflateConfig(**fields)


def _rev_bits15(v: torch.Tensor) -> torch.Tensor:
    x = v & 0x7FFF
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1  # 16-bit reverse -> drop the extra bit


def _canonical_decode_tables(lens: torch.Tensor):
    """Per-lane canonical decode structures from code lengths [B, S]."""
    b, s = lens.shape
    dev = lens.device
    cnt = (lens[:, :, None] == torch.arange(16, device=dev)).sum(dim=1)  # [B, 16]
    fcs = [torch.zeros((b,), dtype=I64, device=dev)]  # fc for l = 1
    for l in range(2, 16):
        fcs.append((fcs[-1] + cnt[:, l - 1]) << 1)
    first_code = torch.stack(fcs, dim=1)  # [B, 15]; index l - 1 -> fc[l]
    # offset[l - 1] = #symbols with length in [1, l)
    offset = torch.cat([torch.zeros((b, 1), dtype=I64, device=dev),
                        torch.cumsum(cnt[:, 1:15], dim=1)], dim=1)[:, :15]
    key = torch.where(lens > 0, lens * 512 + torch.arange(s, device=dev), 1 << 20)
    symlist = torch.argsort(key, dim=1, stable=True)
    return cnt, first_code, offset, symlist


def _decode_symbol(peek15_msb: torch.Tensor, tabs):
    """Canonical decode: the first length l (1-15) whose prefix lies in
    [first_code[l], first_code[l] + count[l]) — the reference's 15
    comparisons, taken side by side. Returns (sym, code_len_bits, found),
    all [B]."""
    cnt, first_code, offset, symlist = tabs
    ls = torch.arange(1, 16, device=peek15_msb.device)
    prefix = peek15_msb[:, None] >> (15 - ls)  # [B, 15]
    c = cnt[:, 1:16]
    hit = (c > 0) & (prefix >= first_code) & (prefix < first_code + c)
    found = hit.any(dim=1)
    first = hit.to(torch.int8).argmax(dim=1, keepdim=True)  # the first hit
    idx = offset.gather(1, first) + prefix.gather(1, first) - first_code.gather(1, first)
    s_l = symlist.gather(1, torch.clamp(idx, 0, symlist.shape[1] - 1))[:, 0]
    sym = torch.where(found, s_l, 0)
    length = torch.where(found, first[:, 0] + 1, 0)
    return sym, length, found


def inflate_blocks_plain(cfg: InflateConfig, streams_u8: torch.Tensor, in_lens: torch.Tensor,
                         out_lens: torch.Tensor) -> dict:
    """Plain version of K11: B raw Deflate streams ``streams_u8`` [B,
    in_cap] u8 with ``in_lens`` and ``out_lens`` [B] -> dict(out [B,
    out_cap] u8, out_count [B] int32, ok [B] bool), and ``symbols`` [B]
    int64: the literal/length codes (end-of-block included) each row
    decoded, a count of the work that the kernel does not return."""
    b, s_cap = streams_u8.shape
    assert s_cap == cfg.in_cap, (s_cap, cfg.in_cap)
    dev = streams_u8.device
    oc = cfg.out_cap
    row = torch.arange(b, device=dev)
    in_lens = in_lens.to(device=dev, dtype=I64)
    out_lens = out_lens.to(device=dev, dtype=I64)

    d = streams_u8.to(I64)
    dp = torch.cat([d, torch.zeros((b, 3), dtype=I64, device=dev)], dim=1)
    w32 = dp[:, :s_cap] | (dp[:, 1:s_cap + 1] << 8) | (dp[:, 2:s_cap + 2] << 16) \
        | (dp[:, 3:s_cap + 3] << 24)

    def window(byte):
        return w32.gather(1, torch.clamp(byte, 0, s_cap - 1)[:, None])[:, 0]

    def peek(bitpos):
        return window(bitpos >> 3) >> (bitpos & 7)  # >= 25 valid bits

    max_in_bits = in_lens * 8
    len_base, len_extra, dist_base, dist_extra = (
        torch.from_numpy(t).to(dev) for t in (_LEN_BASE, _LEN_EXTRA, _DIST_BASE, _DIST_EXTRA))
    flit = torch.from_numpy(_FIXED_LIT).to(dev)
    fdist = torch.from_numpy(_FIXED_DIST).to(dev)
    k_idx = torch.arange(oc, device=dev)[None, :]
    pidx = torch.arange(316, device=dev)[None, :]
    lit_idx = torch.arange(288, device=dev)[None, :]
    didx = torch.arange(30, device=dev)[None, :]

    # column oc of out and marks takes the writes the reference drops
    out = torch.zeros((b, oc + 1), dtype=torch.uint8, device=dev)
    marks = torch.full((b, oc + 1), -1, dtype=I64, device=dev)
    bitpos = torch.zeros((b,), dtype=I64, device=dev)
    opos = torch.zeros((b,), dtype=I64, device=dev)
    done = out_lens == 0
    error = torch.zeros((b,), dtype=torch.bool, device=dev)
    symbols = torch.zeros((b,), dtype=I64, device=dev)
    nblocks = 0

    while nblocks < cfg.max_blocks and bool((~(done | error)).any()):
        active = ~(done | error)

        # ---------------- block header ----------------
        hdr = peek(bitpos)
        bfinal = (hdr & 1) == 1
        btype = (hdr >> 1) & 3
        bitpos = torch.where(active, bitpos + 3, bitpos)
        is_stored = active & (btype == 0)
        is_fixed = active & (btype == 1)
        is_dyn = active & (btype == 2)
        error = error | (active & (btype == 3))

        # ---- stored: byte-align, LEN/NLEN, bulk copy + literal marks ----
        if bool(is_stored.any()):
            sbyte = ((bitpos + 7) & ~7) >> 3
            lenw = window(sbyte)
            st_len = lenw & 0xFFFF
            st_nlen = (lenw >> 16) & 0xFFFF
            error = error | (is_stored & ((st_len ^ 0xFFFF) != st_nlen))
            copy_mask = is_stored[:, None] & (k_idx < st_len[:, None])
            src_idx = torch.clamp(sbyte[:, None] + 4 + k_idx, 0, s_cap - 1)
            vals = streams_u8.gather(1, src_idx)
            dst_idx = torch.clamp(torch.where(copy_mask, opos[:, None] + k_idx, oc), max=oc)
            out.scatter_(1, dst_idx, vals)
            marks.scatter_(1, dst_idx, torch.zeros_like(dst_idx))  # literal marks
            opos = torch.where(is_stored, opos + st_len, opos)
            bitpos = torch.where(is_stored, (sbyte + 4 + st_len) * 8, bitpos)

        # ---------------- dynamic table parse ----------------
        dh = peek(bitpos)
        hlit = (dh & 31) + 257
        hdist = ((dh >> 5) & 31) + 1
        hclen = ((dh >> 10) & 15) + 4
        bitpos = torch.where(is_dyn, bitpos + 14, bitpos)
        error = error | (is_dyn & ((hlit > 286) | (hdist > 30)))

        cl_lens = torch.zeros((b, 19), dtype=I64, device=dev)
        for i in range(19):
            v = peek(bitpos) & 7
            take = is_dyn & (i < hclen)
            col = _CL_ORDER[i]
            cl_lens[:, col] = torch.where(take, v, cl_lens[:, col])
            bitpos = torch.where(take, bitpos + 3, bitpos)
        cl_tabs = _canonical_decode_tables(cl_lens)

        total = torch.where(is_dyn, hlit + hdist, 0)
        all_lens = torch.zeros((b, 316), dtype=I64, device=dev)
        n = torch.zeros((b,), dtype=I64, device=dev)
        while True:
            act = is_dyn & (n < total) & ~error
            if not bool(act.any()):
                break
            pk = peek(bitpos)
            sym, clen, okk = _decode_symbol(_rev_bits15(pk), cl_tabs)
            error = error | (act & ~okk)
            ebits = torch.where(sym == 16, 2, torch.where(sym == 17, 3, torch.where(sym == 18, 7, 0)))
            eval_ = (pk >> clen) & ((1 << ebits) - 1)
            rep = torch.where(sym < 16, 1, torch.where(sym == 18, 11 + eval_, 3 + eval_))
            prev = all_lens.gather(1, torch.clamp(n - 1, 0, 315)[:, None])[:, 0]
            error = error | (act & (sym == 16) & (n == 0))
            val = torch.where(sym < 16, sym, torch.where(sym == 16, prev, 0))
            stop = torch.minimum(n + rep, total)
            wmask = act[:, None] & (pidx >= n[:, None]) & (pidx < stop[:, None])
            all_lens = torch.where(wmask, val[:, None], all_lens)
            n = torch.where(act, stop, n)
            bitpos = torch.where(act, bitpos + clen + ebits, bitpos)
            error = error | (act & (bitpos > max_in_bits))

        # per-lane lit/dist code lengths (fixed or parsed)
        padded = torch.cat([all_lens, torch.zeros((b, 2), dtype=I64, device=dev)], dim=1)
        dyn_lit = torch.where(lit_idx < hlit[:, None],
                              padded.gather(1, torch.clamp(lit_idx, max=315).expand(b, -1)), 0)
        lit_lens = torch.where(is_dyn[:, None], dyn_lit, flit[None, :])
        dyn_dist = torch.where(didx < hdist[:, None],
                               all_lens.gather(1, torch.clamp(hlit[:, None] + didx, 0, 315)), 0)
        dist_lens = torch.where(is_dyn[:, None], dyn_dist, fdist[None, :])
        lit_tabs = _canonical_decode_tables(lit_lens)
        dist_tabs = _canonical_decode_tables(dist_lens)

        # ---------------- symbol decode loop ----------------
        act = (is_fixed | is_dyn) & ~error
        while bool(act.any()):
            symbols = symbols + act.to(I64)
            pk = peek(bitpos)
            sym, clen, okk = _decode_symbol(_rev_bits15(pk), lit_tabs)
            error = error | (act & ~okk)
            bp1 = bitpos + clen
            is_lit = act & (sym < 256)
            is_eob = act & (sym == 256)
            is_match = act & (sym > 256)

            lb = len_base[torch.clamp(sym, 0, 287)]
            le = len_extra[torch.clamp(sym, 0, 287)]
            mlen = lb + (peek(bp1) & ((1 << le) - 1))
            bp2 = bp1 + le
            dsym, dbits, dok = _decode_symbol(_rev_bits15(peek(bp2)), dist_tabs)
            error = error | (is_match & ~dok)
            bp3 = bp2 + dbits
            db_ = dist_base[torch.clamp(dsym, 0, 31)]
            de_ = dist_extra[torch.clamp(dsym, 0, 31)]
            dist = db_ + (peek(bp3) & ((1 << de_) - 1))
            bp4 = bp3 + de_
            error = error | (is_match & (dist > opos))

            # one scatter records both literal marks and match starts
            tpos = torch.clamp(torch.where(is_lit | is_match, opos, oc), max=oc)
            marks.scatter_(1, tpos[:, None], torch.where(is_lit, 0, dist)[:, None])
            lpos = torch.clamp(torch.where(is_lit, opos, oc), max=oc)
            out[row, lpos] = sym.to(torch.uint8)

            op2 = torch.where(is_lit, opos + 1, torch.where(is_match, opos + mlen, opos))
            bpn = torch.where(is_lit, bp1, torch.where(is_match, bp4,
                                                       torch.where(is_eob, bp1, bitpos)))
            error = error | (act & ((op2 > out_lens) | (bpn > max_in_bits)))
            act = act & ~is_eob & ~error
            bitpos, opos = bpn, op2

        done = done | (active & bfinal & ~error)
        nblocks += 1

    error = error | ~done | (opos != out_lens)

    # ---------------- copy resolution ----------------
    out, marks = out[:, :oc], marks[:, :oc]
    pos_idx = k_idx.expand(b, -1)
    start_mark = torch.where(marks >= 0, pos_idx, -1)
    cover_start = torch.cummax(start_mark, dim=1).values
    cover_val = marks.gather(1, torch.clamp(cover_start, 0, oc - 1))
    covered = (cover_start >= 0) & (cover_val > 0)
    src = torch.clamp(torch.where(covered, pos_idx - cover_val, pos_idx), 0, oc - 1)
    # function-squaring pointer doubling: after k rounds the map applies
    # 2^k hops; literals are fixed points, so chains of any length (long
    # RLE runs) converge in log2(out_cap) rounds
    root = src
    for _ in range(int(math.ceil(math.log2(max(oc, 2))))):
        root = root.gather(1, root)
    final_out = out.gather(1, root)
    # zero the tail: copy resolution can smear bytes past out_len, and the
    # device CRC's padding correction needs zero padding
    final_out = torch.where(pos_idx < out_lens[:, None], final_out, 0).to(torch.uint8)
    return {"out": final_out, "out_count": opos.to(torch.int32), "ok": ~error,
            "symbols": symbols}


def inflate_blocks_cuda(cfg: InflateConfig, streams_u8: torch.Tensor, in_lens: torch.Tensor,
                        out_lens: torch.Tensor) -> dict:
    """K11 (``csrc/inflate.cu``): the same function as
    :func:`inflate_blocks_plain` on CUDA tensors (``in_lens``, ``out_lens``
    int32)."""
    b = streams_u8.shape[0]
    check_cuda(streams_u8, torch.uint8, (b, cfg.in_cap), "streams_u8")
    check_cuda(in_lens, torch.int32, (b,), "in_lens")
    check_cuda(out_lens, torch.int32, (b,), "out_lens")
    dev = streams_u8.device
    out = torch.empty((b, cfg.out_cap), dtype=torch.uint8, device=dev)
    out_count = torch.empty((b,), dtype=torch.int32, device=dev)
    ok = torch.empty((b,), dtype=torch.bool, device=dev)
    if b:
        INFLATE.launch(dev, ptr(streams_u8.data_ptr()), ptr(in_lens.data_ptr()),
                       ptr(out_lens.data_ptr()), ptr(out.data_ptr()), ptr(out_count.data_ptr()),
                       ptr(ok.data_ptr()), b, cfg.in_cap, cfg.out_cap, cfg.max_blocks,
                       stream_of(streams_u8))
    return {"out": out, "out_count": out_count, "ok": ok}


def inflate_blocks(cfg: InflateConfig, streams_u8: torch.Tensor, in_lens: torch.Tensor,
                   out_lens: torch.Tensor) -> dict:
    """Decode B raw-deflate streams -> dict(out [B, out_cap] u8, out_count
    [B] int32, ok [B] bool): the plain version for CPU tensors, K11 for
    CUDA tensors."""
    if on_cpu(streams_u8):
        return inflate_blocks_plain(cfg, streams_u8, in_lens, out_lens)
    return inflate_blocks_cuda(cfg, streams_u8, in_lens.to(torch.int32),
                               out_lens.to(torch.int32))


@functools.lru_cache(maxsize=8)
def get_inflater(cfg: InflateConfig):
    """Batch inflater that also returns each block's CRC32 (for footer
    verification on the device): ``run(streams_u8, in_lens, out_lens)`` ->
    dict(out, out_count, ok, crc [B] int64)."""

    def run(streams_u8, in_lens, out_lens):
        res = inflate_blocks(cfg, streams_u8, in_lens, out_lens)
        res["crc"] = crc32_device(res["out"], out_lens)
        return res

    return run
