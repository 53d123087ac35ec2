"""Plain reference for pigz's Gzip stream — an independent size oracle.

pigz (and gzp's ``ZBuilder(Gzip)``) cut the input into blocks and deflate
each on its own with the 32 KiB before it as the preset dictionary; every
block but the last ends in a sync flush (an empty stored block, so the
next block starts on a byte), the last ends the deflate stream, and the
gzip header and the CRC32 and ISIZE trailer wrap them. This module writes
that layout on Python's ``zlib`` at any level, so a test can hold the
port's stream to zlib's size in the same layout. It imports nothing of the
port.
"""

from __future__ import annotations

import struct
import zlib

BLOCK = 131072  # pigz's default block (-b 128)
DICT = 32768  # the dictionary each block's matches may reach into
SYNC = b"\x00\x00\xff\xff"  # how a sync flush ends a block


def header(level: int) -> bytes:
    """The 10-byte gzip header pigz writes: no name, no time, XFL from the
    level, OS unknown."""
    xfl = 2 if level >= 9 else 4 if level <= 1 else 0
    return bytes([31, 139, 8, 0, 0, 0, 0, 0, xfl, 255])


def blocks(data: bytes, level: int, block: int = BLOCK) -> list[bytes]:
    """The raw deflate bytes of each ``block``-byte piece of ``data``: each
    deflated with the ``DICT`` bytes before it as its dictionary, ended by
    a sync flush, the last by the end of the stream. Empty input is one
    empty final block."""
    mv = memoryview(data)
    out = []
    starts = range(0, len(data), block) if data else [0]
    for s in starts:
        c = zlib.compressobj(level, zlib.DEFLATED, -15,
                             **({"zdict": bytes(mv[max(0, s - DICT): s])} if s else {}))
        last = s + block >= len(data)
        out.append(c.compress(mv[s: s + block]) + c.flush(zlib.Z_FINISH if last
                                                          else zlib.Z_SYNC_FLUSH))
    return out


def write(data: bytes, level: int, block: int = BLOCK) -> bytes:
    """``data`` as one gzip stream in pigz's layout."""
    trailer = struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)
    return header(level) + b"".join(blocks(data, level, block)) + trailer


def size(data: bytes, level: int, block: int = BLOCK) -> int:
    """Bytes of :func:`write`'s stream of ``data``."""
    return 10 + sum(map(len, blocks(data, level, block))) + 8
