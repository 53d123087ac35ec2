"""Batched snappy-frame encoder.

Counterpart of ``gzp_tpu/ops/snappy_kernel.py``, the device-side
equivalent of the reference's snap-crate backend (reference
src/snap.rs:34-83): each gzp block is encoded as a complete snappy
*frame* — stream identifier + chunks — so concatenated blocks form a valid
framed stream. One lane = one block = one frame with a single chunk
(blocks are capped at snappy's 65536-byte chunk size).

Snappy block format (byte-aligned, google/snappy format_description.txt):
  * preamble: uncompressed length as LE base-128 varint
  * literal elements: tag ``(len-1)<<2 | 0b00`` (len <= 60 tag-only form)
  * copies with 2-byte offset: tag ``(len-1)<<2 | 0b10`` + u16le offset
    (lengths up to 64; longer matches become chains of such copies)

The matcher is the hash matcher of the deflate encoder (K1, ``torch.sort``,
K2, scatter, K6 in ``ops/lz_cuda.py``) at snappy's limits: distances up
to 65,535, matches up to 256 bytes, at least 4. Literal runs are grouped
with cummax/cummin over positions and chunked into <= 60-byte tag-only
literal elements; each position contributes at most one <= 24-bit entry,
and the whole frame body (varint preamble included, as a dynamic-width
head entry) is assembled by the sort-scan packer (K10 plus a scatter,
``ops/pack_cuda.py``) behind the 18-byte frame header.

The stages run inside the Deflate encoder's spans (``runtime/telemetry.py``):
``gzp.encode.match`` (the matcher), ``gzp.encode.entries`` (the parse and
the entries), ``gzp.encode.pack`` (K10 and its scatter) and
``gzp.encode.finish`` (frame header, masked CRC32C, compaction).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from gzp_tpu_torch.constants import SNAPPY_MAX_CHUNK, SNAPPY_MIN_MATCH, SNAPPY_STREAM_IDENTIFIER
from gzp_tpu_torch.ops import lz, tables
from gzp_tpu_torch.ops.checksum import crc32c_masked_device
from gzp_tpu_torch.ops.deflate_kernel import _le_bytes, compact_outputs
from gzp_tpu_torch.ops.lz_cuda import best_matches_cuda
from gzp_tpu_torch.ops.pack_cuda import pack_entries_sortscan_cuda
from gzp_tpu_torch.runtime.telemetry import span

I64 = torch.int64

_HDR = 18  # stream identifier (10) + chunk header (4) + masked crc (4)
HEADER_BITS = 8 * _HDR  # K10's base offset: the entries start after the header
_MAX_LIT_ELEM = 60  # tag-only literal element cap


@dataclass(frozen=True)
class SnappyEncodeConfig:
    block_len: int  # N <= 65536
    # matches longer than 64 are emitted as chains of tag-10 copies
    # (reference snap crate behavior, src/snap.rs:34-83); the scan parse
    # bounds a single token at 255, chains split it into <= 64 pieces
    max_match: int = 256
    max_chain_piece: int = 64  # tag-10 copy length cap (format limit)
    payload_words: int = 3  # context words carried through the hash sort
    lags: int = 2  # sorted-neighbour candidates examined

    @property
    def out_bytes(self) -> int:
        n = self.block_len
        worst = _HDR + 3 + n + (n + _MAX_LIT_ELEM - 1) // _MAX_LIT_ELEM + 8
        return (worst + 3) & ~3


# knobs of the reference config that only choose between formulations with
# identical output, with the values it runs
_REFERENCE_ONLY = {
    "window": (256,),
    "max_words": (8,),
    "sample_step": (1,),
    "parse": ("scan",),
    "pallas": (None, False, True),
}


def snappy_config_from_reference(fields: dict) -> SnappyEncodeConfig:
    """This package's config from ``dataclasses.asdict()`` of a
    ``gzp_tpu`` ``SnappyEncodeConfig``: the reference-only knobs are
    dropped after checking that they hold the values it runs."""
    fields = dict(fields)
    for knob, allowed in _REFERENCE_ONLY.items():
        value = fields.pop(knob)
        if value not in allowed:
            raise ValueError(f"{knob}={value!r}: this package implements {allowed}")
    return SnappyEncodeConfig(**fields)


def _carry_from_match_start(is_match, tok_start, vals):
    """Each position's value of ``vals`` at the last match start at or
    before it (0 before the first): the reference's associative scan of
    (flag, value) pairs, as a gather at the cummax of the start index."""
    got = torch.gather(torch.where(is_match, vals, 0), 1, torch.clamp(tok_start, min=0))
    return torch.where(tok_start >= 0, got, 0)


def _varint_len(ln: torch.Tensor) -> torch.Tensor:
    """Bytes of the varint preamble for uncompressed lengths <= 65536."""
    return torch.where(ln < 128, 1, torch.where(ln < 16384, 2, 3))


def stream_identifier() -> np.ndarray:
    """The 10-byte stream identifier chunk that opens every frame, as uint8."""
    return np.frombuffer(SNAPPY_STREAM_IDENTIFIER, np.uint8)


def snappy_entries(cfg: SnappyEncodeConfig, data_u8, lengths, match_len, match_dist):
    """The frame body's bit entries from the match field: (bits, nbits)
    [B, N + 1] int32, the varint preamble first, then one <= 24-bit entry
    per position (literal byte, tag + byte, or copy tag + offset; all
    byte-aligned widths)."""
    b, n = data_u8.shape
    dev = data_u8.device
    marked, l = lz.parse_marks_scan(match_len, lengths, min_emit=SNAPPY_MIN_MATCH)
    l = l.to(I64)
    is_match = marked & (l > 0)
    is_lit = marked & (l == 0)
    i_idx = torch.arange(n, device=dev).expand(b, n)

    # ----- literal-run grouping over positions -----
    prev_lit = torch.cat([torch.zeros_like(is_lit[:, :1]), is_lit[:, :-1]], dim=1)
    run_start = is_lit & ~prev_lit
    start_idx = torch.cummax(torch.where(run_start, i_idx, -1), dim=1).values
    nonlit_idx = torch.where(is_lit, n, i_idx)
    run_end = torch.flip(torch.cummin(torch.flip(nonlit_idx, [1]), dim=1).values, [1])
    r = i_idx - start_idx  # position within the literal run
    remain = run_end - i_idx  # literals remaining in the run (incl. self)
    has_tag = is_lit & (r % _MAX_LIT_ELEM == 0)

    # ----- chained copies: every 64th covered position of a match token
    # starts a fresh tag-10 element with the same offset -----
    tok_start = torch.cummax(torch.where(is_match, i_idx, -1), dim=1).values
    carried_l = _carry_from_match_start(is_match, tok_start, l)
    carried_d = _carry_from_match_start(is_match, tok_start, match_dist.to(I64))
    rel = i_idx - tok_start
    in_match = (tok_start >= 0) & (rel < carried_l)
    chunk_start = in_match & (rel % cfg.max_chain_piece == 0)
    chunk_len = torch.clamp(carried_l - rel, max=cfg.max_chain_piece)

    # ----- per-position entries -----
    lit_byte = data_u8.to(I64)
    lit_tag = (torch.clamp(remain, max=_MAX_LIT_ELEM) - 1) << 2
    m_tag = 2 | ((chunk_len - 1) << 2)
    entry = torch.where(
        is_lit,
        torch.where(has_tag, lit_tag | (lit_byte << 8), lit_byte),
        torch.where(chunk_start,
                    m_tag | ((carried_d & 0xFF) << 8) | ((carried_d >> 8) << 16), 0),
    )
    width = torch.where(is_lit, 8 * (1 + has_tag.to(I64)), torch.where(chunk_start, 24, 0))

    # varint preamble for the uncompressed length, as one dynamic-width
    # entry at the head of the element stream: the packer's base offset
    # stays the fixed frame header
    ln = lengths.to(I64)
    varint_len = _varint_len(ln)
    b0 = torch.where(varint_len > 1, (ln & 0x7F) | 0x80, ln & 0x7F)
    b1 = torch.where(varint_len > 2, ((ln >> 7) & 0x7F) | 0x80, (ln >> 7) & 0x7F)
    b2 = (ln >> 14) & 0x7F
    ventry = (b0 | torch.where(varint_len >= 2, b1 << 8, 0)
              | torch.where(varint_len >= 3, b2 << 16, 0))
    all_bits = torch.cat([ventry[:, None], entry], dim=1).to(torch.int32)
    all_n = torch.cat([(8 * varint_len)[:, None], width], dim=1).to(torch.int32)
    return all_bits, all_n


def encode_snappy_blocks(cfg: SnappyEncodeConfig, data_u8, lengths, is_final):
    """Compress a batch of blocks into framed snappy. Returns the deflate
    encoder's output contract: ``out`` [B, out_bytes] uint8, ``out_len``
    [B] int32, ``check`` [B] int64 (masked CRC32C of the uncompressed
    chunk, also embedded in the frame), and ``flat``, the frames end to end
    (``deflate_kernel.compact_outputs``). An empty block is the 10-byte
    stream identifier alone."""
    del is_final  # snappy frames need no stream-close marker
    b, n = data_u8.shape
    if n != cfg.block_len or n > SNAPPY_MAX_CHUNK:
        raise ValueError(f"block width {n}: config block_len {cfg.block_len}, "
                         f"at most {SNAPPY_MAX_CHUNK}")
    dev = data_u8.device
    with span("gzp.encode.match"):
        match_len, match_dist = best_matches_cuda(
            data_u8, lengths, max_dist=SNAPPY_MAX_CHUNK - 1, max_match=cfg.max_match,
            min_emit=SNAPPY_MIN_MATCH, payload_words=cfg.payload_words, lags=cfg.lags,
        )
    with span("gzp.encode.entries"):
        all_bits, all_n = snappy_entries(cfg, data_u8, lengths, match_len, match_dist)
    with span("gzp.encode.pack"):
        words, total_bits = pack_entries_sortscan_cuda(all_bits, all_n, HEADER_BITS,
                                                       cfg.out_bytes // 4)
    with span("gzp.encode.finish"):
        ln = lengths.to(I64)
        varint_len = _varint_len(ln)
        elem_total = (total_bits.to(I64) >> 3) - _HDR - varint_len
        out = _le_bytes(words, 4).reshape(b, cfg.out_bytes)

        # ----- frame headers -----
        out[:, :10] = tables.on_device(stream_identifier, (), dev, torch.uint8)
        out[:, 10] = 0  # chunk type 0x00: compressed data
        out[:, 11:14] = _le_bytes(4 + varint_len + elem_total, 3)
        crc = crc32c_masked_device(data_u8, lengths)
        out[:, 14:18] = _le_bytes(crc, 4)
        out_len = torch.where(ln > 0, _HDR + varint_len + elem_total, 10).to(torch.int32)
        flat = compact_outputs(out, out_len)
    return {"out": out, "out_len": out_len, "check": crc, "flat": flat}


@functools.cache
def get_snappy_encoder(cfg: SnappyEncodeConfig):
    """Batched snappy encoder for a config, one function per equal config (a
    key of the CUDA graphs of ``ops/graphs.py``): ``encode(data_u8 [B, N]
    uint8, lengths [B] int32, is_final [B] bool) -> dict`` (see
    :func:`encode_snappy_blocks`). Runs on the device of its inputs."""
    return functools.partial(encode_snappy_blocks, cfg)
