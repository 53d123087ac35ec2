"""Batched DEFLATE encoder: matching, parse, token emission, bit packing
and framing, for a whole batch of blocks at once.

Counterpart of ``gzp_tpu/ops/deflate_kernel.py``. Modes:

* ``mgzip`` / ``bgzf``: every block becomes a standalone gzip member that
  leaves the device fully framed (header with the per-format size field,
  dynamic-or-fixed Huffman payload, CRC32 + ISIZE footer);
* ``stream`` (Gzip, Zlib, raw Deflate): every block is a chunk of one
  deflate stream whose matches may reach into a halo of the previous
  block's last ``dict_size`` bytes; non-final chunks end with an empty
  stored block (Z_SYNC_FLUSH, the pigz block join; reference
  src/deflate.rs:96-100), the final chunk sets BFINAL and pads to a byte.
  The host writes the stream's header and footer.

The stages are

1. match (:func:`match_stage`): halo concat, then LZ77 candidates; the
   hash matcher (levels 0-5: CUDA kernels K1, K2, K6) or the suffix
   matcher (levels 6-9: K7, K4, K8, K1, K5, K9);
2. parse (:func:`parse_stage`): the greedy parse as a δ-state scan;
3. emit (:func:`block_entries`): symbols, Huffman tables (one set per
   sub-block), per-position (value, width) bit entries;
4. pack: K10 plus a scatter of finished words;
5. finish (:func:`emit_stage`): the sync-flush trailer or member framing,
   the checksum, :func:`compact_outputs`.

Each stage runs inside the span ``gzp.encode.<stage>``
(``runtime/telemetry.py``; ``entries`` for emit), which costs a flag read
unless a profiler records.

Tensors stay on the device the input is on. There is no compile step:
:func:`get_encoder` returns a plain function, which the writer replays as
one CUDA graph a batch on a card (``ops/graphs.py``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from gzp_tpu_torch.constants import (
    BGZF_HEADER_SIZE,
    MAX_DIST,
    MAX_MATCH,
    MGZIP_HEADER_SIZE,
    MIN_MATCH,
)
from gzp_tpu_torch.formats import ALL_FORMATS
from gzp_tpu_torch.ops import huffman, lz, tables
from gzp_tpu_torch.ops.checksum import adler32_device, crc32_device
from gzp_tpu_torch.ops.lz_cuda import best_matches_cuda, best_matches_suffix_cuda
from gzp_tpu_torch.ops.pack_cuda import pack_entries_sortscan_cuda
from gzp_tpu_torch.runtime.telemetry import span

I64 = torch.int64
M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DeflateEncodeConfig:
    block_len: int  # N: padded block size
    mode: str  # 'stream' | 'mgzip' | 'bgzf'
    checksum: str  # 'crc32' | 'adler32' | 'none'  (per-block stream checksum)
    level: int = 6
    lazy: bool = True  # zlib-style lazy matching
    payload_words: int = 3  # context words carried through the hash sort
    lags: int = 2  # sorted-neighbour candidates examined
    # candidate discovery: 'hash' (levels <= 5) or 'suffix' (levels >= 6,
    # content-sorted neighbours plus a shallow hash pass)
    matcher: str = "hash"
    suffix_keys: int = 0  # suffix matcher: context words used as sort keys
    subblocks: int = 1  # deflate blocks (own Huffman tables) per gzp block
    dict_size: int = 0  # halo bytes carried from the previous block

    @classmethod
    def for_level(cls, block_len: int, mode: str, checksum: str, level: int,
                  dict_size: int = 0) -> "DeflateEncodeConfig":
        """Map a zlib-style compression level onto search-effort knobs —
        the values ``gzp_tpu``'s ``for_level`` picks: higher levels carry
        more context through the candidate sort and examine more sorted
        neighbours."""
        skw = 0
        if level <= 1:
            pw, lg, lazy = 2, 1, False
        elif level <= 5:
            pw, lg, lazy = 3, 2, True
        elif level <= 8:
            pw, lg, lazy, skw = 7, 16, True, 5
        else:
            pw, lg, lazy, skw = 7, 24, True, 6
        # levels >= 6 on big blocks: local Huffman tables every >= 64 KiB
        sub = 1
        if level >= 6:
            for cand in (4, 2):
                if block_len % cand == 0 and block_len // cand >= 65536:
                    sub = cand
                    break
        return cls(
            block_len=block_len, mode=mode, checksum=checksum, level=level,
            lazy=lazy, payload_words=pw, lags=lg, dict_size=dict_size,
            suffix_keys=skw, subblocks=sub,
            matcher="suffix" if level >= 6 else "hash",
        )

    @property
    def header_len(self) -> int:
        return {"stream": 0, "mgzip": MGZIP_HEADER_SIZE, "bgzf": BGZF_HEADER_SIZE}[self.mode]

    @property
    def out_words(self) -> int:
        # worst case: all-literal block at 9 bits/byte (the dynamic table
        # is only chosen when it beats fixed, so fixed bounds token bits)
        # + one dynamic header and EOB per sub-block + trailers, + the
        # reference's slack words (the same padded width keeps
        # compact_outputs' layout identical)
        max_bits = (
            8 * self.header_len
            + self.subblocks * (1344 + 9)
            + 9 * self.block_len
            + 7
            + 48
        )
        return (max_bits + 31) // 32 + 10

    @property
    def out_bytes(self) -> int:
        return 4 * self.out_words


def _window_for(level: int) -> int:
    """The reference's parse-window knob per level (used only by its
    windowed parse, which this package does not have)."""
    return 256 if level <= 5 else 512 if level <= 8 else 1024


# knobs of the reference config that only choose between formulations with
# identical output (or TPU work-arounds), with the values its for_level sets
_REFERENCE_ONLY = {
    "max_words": (8,),
    "dynamic": (True,),
    "rle_header": (True,),
    "hash3": (False,),
    "sample_step": (1,),
    "pallas_match": (False, True),
    "pack": ("sortscan", "sortscan_pallas"),
    "placement": ("unroll",),
    "lookup": ("f32",),
    "parse": ("scan",),
}


def config_from_reference(fields: dict) -> DeflateEncodeConfig:
    """This package's config from ``dataclasses.asdict()`` of a
    ``gzp_tpu`` ``DeflateEncodeConfig``: the reference-only knobs are
    dropped after checking that they hold their ``for_level`` values."""
    fields = dict(fields)
    for knob, allowed in _REFERENCE_ONLY.items():
        value = fields.pop(knob)
        if value not in allowed:
            raise ValueError(f"{knob}={value!r}: this package implements {allowed}")
    window = fields.pop("window")
    if window != _window_for(fields["level"]):
        raise ValueError(f"window={window} is not level {fields['level']}'s")
    return DeflateEncodeConfig(**fields)


def _ilog2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for v >= 1 (exact: float64 holds these integers)."""
    return torch.frexp(torch.clamp(v, min=1).to(torch.float64)).exponent.to(I64) - 1


def length_symbols(l: torch.Tensor):
    """DEFLATE length code (sym, extra_bits, extra_value) for lengths in
    [3, 258], computed arithmetically: eb = max(ilog2(l-3)-2, 0), sym =
    257 + 4*eb + ((l-3)>>eb), except 258 -> 285/0."""
    v = torch.clamp(l.to(I64) - 3, min=0)
    eb = torch.where(v < 8, 0, _ilog2(v) - 2)
    sym = 257 + (eb << 2) + (v >> eb)
    extra = v & ((1 << eb) - 1)
    is258 = l == 258
    return (torch.where(is258, 285, sym), torch.where(is258, 0, eb),
            torch.where(is258, 0, extra))


def dist_symbols(d: torch.Tensor):
    """DEFLATE distance code (sym, extra_bits, extra_value) for distances
    in [1, 32768]: eb = max(ilog2(d-1)-1, 0), sym = 2*eb + ((d-1)>>eb)."""
    u = torch.clamp(d.to(I64) - 1, min=0)
    eb = torch.where(u < 4, 0, _ilog2(u) - 1)
    return (eb << 1) + (u >> eb), eb, u & ((1 << eb) - 1)


def compute_symbols(data_ext, marked, l, dist):
    """Per-position DEFLATE symbols: (sym, leb, lextra, dsym, deb, dextra,
    is_match). ``sym`` is the literal byte at literal token positions and
    the length symbol at match starts."""
    is_match = marked & (l > 0)
    lsym, leb, lextra = length_symbols(l)
    sym = torch.where(is_match, lsym, data_ext.to(I64))
    leb = torch.where(is_match, leb, 0)
    lextra = torch.where(is_match, lextra, 0)
    dsym, deb, dextra = dist_symbols(dist)
    return sym, leb, lextra, dsym, deb, dextra, is_match


def emit_token_entries(marked, prev_match, sym, leb, lextra, dsym_s, deb_s, dextra_s,
                       lit_codes, lit_lens, dist_codes, dist_lens):
    """Per-position bit entries (one <= 31-bit entry per position + EOB).

    Position ``i`` emits its token's literal-or-length half; a match's
    distance half arrives pre-stashed at position ``i+1`` (``prev_match``
    and the ``*_s`` fields are the caller's shift of the match fields), so
    the stream is one entry per position. Returns (bits, nbits) [R, M+1]
    int64, the last column the end-of-block symbol.
    """
    code = torch.gather(lit_codes, 1, sym)
    nb = torch.gather(lit_lens, 1, sym)
    even_bits = code | (lextra << nb)
    even_n = nb + leb
    # distance symbols are read only where prev_match; elsewhere clamp
    # whatever the unused distance lanes hold into the table
    di = torch.clamp(dsym_s, 0, huffman.NDIST - 1)
    dcode = torch.gather(dist_codes, 1, di)
    dnb = torch.gather(dist_lens, 1, di)
    odd_bits = dcode | (dextra_s << dnb)
    odd_n = dnb + deb_s

    bits = torch.where(marked, even_bits, torch.where(prev_match, odd_bits, 0))
    nbits = torch.where(marked, even_n, torch.where(prev_match, odd_n, 0))
    bits = torch.cat([bits, lit_codes[:, 256:257]], dim=1)
    nbits = torch.cat([nbits, lit_lens[:, 256:257]], dim=1)
    return bits, nbits


def match_stage(cfg: DeflateEncodeConfig, data_u8: torch.Tensor, lengths: torch.Tensor,
                halo: torch.Tensor | None = None, dict_lens: torch.Tensor | None = None):
    """Stage 1: halo concat + LZ77 match finding -> ``(ext, match_len,
    match_dist)``. With ``cfg.dict_size`` = D > 0, ``ext`` = [halo, data]
    [B, D + N] and match sources may reach back to ``halo_start`` = D -
    ``dict_lens``; the match fields are [B, D + N] int32, zero in the halo."""
    base = cfg.dict_size
    if base:
        if halo is None or dict_lens is None:
            raise ValueError(f"dict_size={base} needs halo and dict_lens")
        ext = torch.cat([halo, data_u8], dim=1)
        halo_start = (base - dict_lens.to(torch.int32)).to(torch.int32)
    else:
        ext, halo_start = data_u8, None
    kw = dict(max_dist=MAX_DIST, max_match=MAX_MATCH, min_emit=MIN_MATCH, base=base,
              halo_start=halo_start, lazy=cfg.lazy, payload_words=cfg.payload_words,
              lags=cfg.lags)
    if cfg.matcher == "suffix":
        return ext, *best_matches_suffix_cuda(ext, lengths, suffix_keys=cfg.suffix_keys, **kw)
    if cfg.matcher == "hash":
        return ext, *best_matches_cuda(ext, lengths, **kw)
    raise ValueError(f"matcher={cfg.matcher!r}")


def parse_stage(cfg: DeflateEncodeConfig, match_len: torch.Tensor, lengths: torch.Tensor):
    """Stage 2: greedy parse of the match field (halo included) into token
    starts. With sub-blocks, no match starts on the last position before a
    sub-block boundary: its distance half (stashed at i+1) would land after
    the next sub-block's end-of-block symbol and header."""
    if cfg.subblocks > 1:
        match_len = match_len.clone()
        match_len[:, subblock_last_positions(cfg)] = 0
    return lz.parse_marks_scan(match_len, lengths, min_emit=MIN_MATCH, base=cfg.dict_size)


def subblock_last_positions(cfg: DeflateEncodeConfig) -> slice:
    """The positions (halo included) that end each sub-block but the last:
    ``dict_size + (s + 1) * ns - 1`` for s < ``subblocks`` - 1, as a slice,
    which indexes without an upload."""
    ns = cfg.block_len // cfg.subblocks
    base = cfg.dict_size
    return slice(base + ns - 1, base + (cfg.subblocks - 1) * ns, ns)


def block_entries(cfg: DeflateEncodeConfig, ext, marked, l, match_dist, is_final=None):
    """Stage 3: per block, the deflate bit entries in stream order. ``ext``
    and the parse fields are [B, D + N] (D = ``cfg.dict_size``; the halo's
    positions carry no tokens and are sliced off). Each of the
    ``cfg.subblocks`` deflate blocks of a block (equal slices of it) has
    its own Huffman tables: its header (with the dynamic table
    description), one entry per position and its end-of-block symbol. A
    member's last sub-block is final; in stream mode the last sub-block of
    a block whose ``is_final`` [B] is set. Returns (bits, nbits) [B, E]
    int32 (bits < 2**nbits, widths in [0, 31])."""
    b = ext.shape[0]
    base = cfg.dict_size
    s_count = cfg.subblocks
    ns = cfg.block_len // s_count
    sym, leb, lextra, dsym, deb, dextra, is_match = compute_symbols(
        ext, marked, l, match_dist)

    def stash(x, fill=0):  # a match's distance half sits at i+1, across sub-blocks
        return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)

    def rows(x):  # [B, D + N] -> [B * S, N / S], one row per sub-block
        return x[:, base:].reshape(b * s_count, ns)

    prev_match = rows(stash(is_match, False))
    dsym_s, deb_s, dextra_s = rows(stash(dsym)), rows(stash(deb)), rows(stash(dextra))
    marked, sym, leb, lextra = rows(marked), rows(sym), rows(leb), rows(lextra)
    lit_freq, dist_freq = huffman.position_histograms(sym, dsym_s, marked, prev_match)
    lit_codes, lit_lens, dist_codes, dist_lens, use_dyn, dlit_lens, ddist_lens = (
        huffman.choose_tables(lit_freq, dist_freq))
    last = (torch.arange(b * s_count, device=ext.device) % s_count) == s_count - 1
    if cfg.mode == "stream":
        final = last & is_final.to(torch.bool).repeat_interleave(s_count)
    else:  # every member ends with its last sub-block
        final = last
    hfield_bits, hfield_n = huffman.dynamic_header_fields_rle(
        dlit_lens, ddist_lens, final, use_dyn)
    bits, nbits = emit_token_entries(
        marked, prev_match, sym, leb, lextra, dsym_s, deb_s, dextra_s,
        lit_codes, lit_lens, dist_codes, dist_lens,
    )
    all_bits = torch.cat([hfield_bits, bits], dim=1).to(torch.int32).reshape(b, -1)
    all_n = torch.cat([hfield_n, nbits], dim=1).to(torch.int32).reshape(b, -1)
    return all_bits, all_n


def _le_bytes(v: torch.Tensor, nbytes: int) -> torch.Tensor:
    """[...] integers -> [..., nbytes] little-endian uint8."""
    shifts = 8 * torch.arange(nbytes, device=v.device)
    return ((v.to(I64)[..., None] >> shifts) & 0xFF).to(torch.uint8)


def _sync_flush_trailer(words, total_bits, final):
    """Z_SYNC_FLUSH after each non-final stream chunk: an empty stored
    block, '000' + pad to a byte + LEN 0x0000 NLEN 0xFFFF. Every bit of it
    is zero but the 32-bit value 0xFFFF0000 at the byte-aligned offset o2,
    which may straddle two words (u32 in int64, masked). Returns (words,
    end_bits)."""
    tb = total_bits.to(I64)
    o2 = (tb + 3 + 7) & ~7
    v = torch.where(final, 0, 0xFFFF0000)
    s = o2 & 31
    w = (o2 >> 5)[:, None]
    words = words.scatter_add(1, w, ((v << s) & M32)[:, None])
    words = words.scatter_add(1, w + 1, ((v >> (31 - s)) >> 1)[:, None])
    return words, torch.where(final, (tb + 7) & ~7, o2 + 32)


def emit_stage(cfg: DeflateEncodeConfig, data_u8, ext, lengths, is_final, marked, l,
               match_dist):
    """Stages 3-5: entries, packing, the stream trailer or member framing,
    and the checksum. Returns dict ``out`` [B, out_bytes] uint8 (a framed
    member, or a bare deflate chunk in stream mode), ``out_len`` [B] int32,
    ``check`` [B] int64 (a member's CRC32; in stream mode the block's
    ``cfg.checksum``: crc32, adler32, or zeros for 'none') and ``flat``
    (:func:`compact_outputs`)."""
    b, n = data_u8.shape
    if n != cfg.block_len:
        raise ValueError(f"block width {n} != config block_len {cfg.block_len}")
    with span("gzp.encode.entries"):
        all_bits, all_n = block_entries(cfg, ext, marked, l, match_dist, is_final)
    with span("gzp.encode.pack"):
        words, total_bits = pack_entries_sortscan_cuda(all_bits, all_n, 8 * cfg.header_len,
                                                       cfg.out_words)
    with span("gzp.encode.finish"):
        res = _finish_stage(cfg, data_u8, lengths, is_final, words, total_bits)
        res["flat"] = compact_outputs(res["out"], res["out_len"])
    return res


def _finish_stage(cfg: DeflateEncodeConfig, data_u8, lengths, is_final, words, total_bits):
    """Stage 5 without the compaction: the sync-flush trailer or member
    framing, and the checksum (see :func:`emit_stage`)."""
    b = data_u8.shape[0]
    member = cfg.mode != "stream"
    hl = cfg.header_len
    if member:
        end_bits = (total_bits.to(I64) + 7) & ~7
    else:
        words, end_bits = _sync_flush_trailer(words, total_bits, is_final.to(torch.bool))
    by = _le_bytes(words, 4).reshape(b, cfg.out_bytes)
    deflate_bytes = (end_bits >> 3) - hl
    if not member:
        if cfg.checksum == "crc32":
            chk = crc32_device(data_u8, lengths)
        elif cfg.checksum == "adler32":
            chk = adler32_device(data_u8, lengths)
        else:
            chk = torch.zeros((b,), dtype=I64, device=data_u8.device)
        return {"out": by, "out_len": deflate_bytes.to(torch.int32), "check": chk}

    fmt = ALL_FORMATS[cfg.mode]  # the header's layout is the format's
    by[:, :hl] = tables.on_device(member_header_bytes, (cfg.mode, cfg.level), by.device,
                                  torch.uint8)
    size = deflate_bytes + hl + 8  # the member's length
    if fmt.size_bias:
        size = size - fmt.size_bias
    by[:, fmt.SIZE_OFFSET: fmt.SIZE_OFFSET + fmt.size_width] = _le_bytes(size, fmt.size_width)
    # footer: crc32 (of the uncompressed block) + ISIZE, little-endian
    mcrc = crc32_device(data_u8, lengths)
    foot = torch.cat([_le_bytes(mcrc, 4), _le_bytes(lengths, 4)], dim=1)
    foot_pos = (hl + deflate_bytes)[:, None] + torch.arange(8, device=by.device)[None, :]
    by.scatter_(1, foot_pos, foot)
    out_len = (hl + deflate_bytes + 8).to(torch.int32)
    return {"out": by, "out_len": out_len, "check": mcrc}


def member_header_bytes(mode: str, level: int) -> np.ndarray:
    """The member header of format ``mode`` at ``level``, its size field
    zero (the encoder writes it), as uint8."""
    return np.frombuffer(ALL_FORMATS[mode].member_header(level), np.uint8)


def compact_outputs(out: torch.Tensor, out_len: torch.Tensor) -> torch.Tensor:
    """Pack per-block framed outputs end to end into one flat buffer.

    ``out`` is [B, M] uint8 with ``out_len[i]`` valid bytes per row;
    returns ``flat`` [B*M] uint8 where block ``i``'s bytes occupy
    ``[sum(out_len[:i]), sum(out_len[:i+1]))`` and the rest is zero, so
    the host fetches ``flat[:sum(out_len)]`` only. The TPU sorts
    (destination word, word) pairs; the key is the destination, so here
    each byte is scattered to it.
    """
    b, m = out.shape
    ln = out_len.to(I64)
    starts = torch.cumsum(ln, 0) - ln
    j = torch.arange(m, device=out.device)[None, :]
    dest = torch.where(j < ln[:, None], starts[:, None] + j, b * m)
    flat = torch.zeros(b * m + 1, dtype=torch.uint8, device=out.device)
    flat.scatter_(0, dest.reshape(-1), out.reshape(-1))
    return flat[: b * m]


@functools.cache
def get_encoder(cfg: DeflateEncodeConfig):
    """Batched encoder for a config, one function per equal config (a key of
    the CUDA graphs of ``ops/graphs.py``): ``encode(data_u8 [B, N] uint8,
    lengths [B] int32, is_final [B] bool, halo=None, dict_lens=None) ->
    dict`` (see :func:`emit_stage`). With ``cfg.dict_size`` = D > 0,
    ``halo`` [B, D] uint8 holds each block's preset dictionary right-aligned
    (the previous block's trailing bytes) and ``dict_lens`` [B] its valid
    bytes; match distances may reach into it, the 32 KiB cross-block
    dictionary carry (reference src/par/compress.rs:417-423). ``is_final``
    matters only in stream mode. Runs on the device of its inputs."""
    if cfg.block_len % cfg.subblocks:
        raise ValueError(f"subblocks={cfg.subblocks} do not divide block_len={cfg.block_len}")

    def encode(data_u8: torch.Tensor, lengths: torch.Tensor, is_final: torch.Tensor,
               halo: torch.Tensor | None = None, dict_lens: torch.Tensor | None = None) -> dict:
        with span("gzp.encode.match"):
            ext, match_len, match_dist = match_stage(cfg, data_u8, lengths, halo, dict_lens)
        with span("gzp.encode.parse"):
            marked, l = parse_stage(cfg, match_len, lengths)
        return emit_stage(cfg, data_u8, ext, lengths, is_final, marked, l, match_dist)

    return encode
