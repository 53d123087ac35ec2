"""Host-side byte builders for rare fallback paths.

The device encoder always produces a fixed-Huffman (or later dynamic)
encoding; for incompressible blocks a DEFLATE *stored* encoding is smaller
(5 bytes overhead per 65535 instead of ~12.5% expansion). The host
pipeline swaps in these stored encodings when they win — the same
stored/fixed/dynamic choice zlib makes per block, applied at block
granularity. Also used to honor BGZF's hard 65536-byte member cap
(reference src/bgzf.rs:218-223).
"""

from __future__ import annotations

import zlib

from gzp_tpu_torch.constants import BGZF_HEADER_SIZE, MGZIP_HEADER_SIZE
from gzp_tpu_torch.utils.serialize import put_le

_STORED_MAX = 65535


def stored_deflate(data: bytes, final: bool) -> bytes:
    """Raw DEFLATE stored-block encoding of ``data``.

    Non-final chunks end byte-aligned (stored blocks always do), so they
    join a sync-flushed stream exactly like a compressed chunk would.
    """
    out = bytearray()
    n = len(data)
    if n == 0:
        # empty stored block (only used when final: an empty stream close)
        out += b"\x01\x00\x00\xff\xff" if final else b"\x00\x00\x00\xff\xff"
        return bytes(out)
    off = 0
    while off < n:
        chunk = data[off : off + _STORED_MAX]
        off += len(chunk)
        is_last = final and off >= n
        out.append(0x01 if is_last else 0x00)  # BFINAL | BTYPE=00
        out += put_le(len(chunk), 2)
        out += put_le(len(chunk) ^ 0xFFFF, 2)
        out += chunk
    return bytes(out)


def stored_size(n: int) -> int:
    """Size of the stored encoding of ``n`` bytes."""
    if n == 0:
        return 5
    blocks = (n + _STORED_MAX - 1) // _STORED_MAX
    return n + 5 * blocks


def _member_header(mode: str, level: int, deflate_len: int) -> bytes:
    if level >= 9:
        xfl = 2
    elif level <= 1:
        xfl = 4
    else:
        xfl = 0
    base = bytes([31, 139, 8, 4, 0, 0, 0, 0, xfl, 255])
    if mode == "mgzip":
        blen = deflate_len + MGZIP_HEADER_SIZE + 8
        return base + bytes([8, 0, ord("I"), ord("G"), 4, 0]) + put_le(blen, 4)
    if mode == "bgzf":
        bsize = deflate_len + BGZF_HEADER_SIZE + 8 - 1
        return base + bytes([6, 0, ord("B"), ord("C"), 2, 0]) + put_le(bsize, 2)
    raise ValueError(mode)


def stored_member(data: bytes, mode: str, level: int) -> bytes:
    """Complete mgzip/bgzf member with a stored deflate payload."""
    payload = stored_deflate(data, final=True)
    hdr = _member_header(mode, level, len(payload))
    footer = put_le(zlib.crc32(data), 4) + put_le(len(data) & 0xFFFFFFFF, 4)
    return hdr + payload + footer
