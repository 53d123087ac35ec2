"""Host-side DEFLATE stored blocks for rare fallback paths.

The device encoder always produces a fixed- or dynamic-Huffman encoding;
for incompressible blocks a DEFLATE *stored* encoding is smaller (5 bytes
overhead per 65535 instead of ~12.5% expansion). The host pipeline swaps
in these stored encodings when they win — the same stored/fixed/dynamic
choice zlib makes per block, applied at block granularity. The formats
(``formats/``) frame them: a stream's chunk, or a member's payload.
"""

from __future__ import annotations

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
