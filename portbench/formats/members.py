"""Plain reference for the block formats, Mgzip and BGZF: a writer and a
checker on Python's ``zlib``, independent of the port.

A member is a gzip member with an extra field: its header (``HEADER``
bytes, the subfield ``SID`` whose value is the member's size), a raw
deflate payload, the CRC32 of the block and its length (ISIZE). Mgzip
(gzp ``src/mgzip.rs``) stores the member's size as a u32 in a 20-byte
header; BGZF (htslib, gzp ``src/bgzf.rs``) stores size - 1 as a u16 in an
18-byte header, caps a member at 65,536 bytes and ends the stream with a
28-byte empty member.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


@dataclass(frozen=True)
class Framing:
    name: str
    header: int  # header bytes
    sid: bytes
    size_bytes: int  # width of the size field: 4 (u32 size) or 2 (u16 size - 1)
    max_member: int | None  # largest member, bytes
    eof: bytes  # the stream's closing member

    def head(self, size: int, level: int) -> bytes:
        xfl = 2 if level >= 9 else 4 if level <= 1 else 0
        xlen = 4 + self.size_bytes
        field = (struct.pack("<I", size) if self.size_bytes == 4
                 else struct.pack("<H", size - 1))
        return (bytes([31, 139, 8, 4, 0, 0, 0, 0, xfl, 255]) + struct.pack("<H", xlen)
                + self.sid + struct.pack("<H", self.size_bytes) + field)

    def size_of(self, head: bytes) -> int:
        if self.size_bytes == 4:
            return struct.unpack_from("<I", head, self.header - 4)[0]
        return struct.unpack_from("<H", head, self.header - 2)[0] + 1

    def head_ok(self, head: bytes) -> bool:
        xlen = 4 + self.size_bytes
        return (head[:4] == bytes([31, 139, 8, 4]) and struct.unpack_from("<H", head, 10)[0] == xlen
                and head[12:14] == self.sid
                and struct.unpack_from("<H", head, 14)[0] == self.size_bytes)


MGZIP = Framing("mgzip", 20, b"IG", 4, None, b"")
BGZF = Framing("bgzf", 18, b"BC", 2, 65536, BGZF_EOF)


def member(fr: Framing, block: bytes, level: int, crc: int | None = None) -> bytes:
    """One member of ``block`` (its CRC32 unless ``crc`` is given)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = c.compress(block) + c.flush()
    size = fr.header + len(payload) + 8
    crc = zlib.crc32(block) if crc is None else crc
    return fr.head(size, level) + payload + struct.pack("<II", crc, len(block) & 0xFFFFFFFF)


def write(fr: Framing, data, level: int, block: int, threads: int = 8) -> list[bytes]:
    """``data`` as members of ``block`` input bytes each, compressed on a
    pool of ``threads`` (``zlib`` releases the GIL), then ``fr.eof``."""
    mv = memoryview(data)
    pieces = [mv[i: i + block] for i in range(0, len(data), block)]
    with ThreadPoolExecutor(threads) as pool:
        out = list(pool.map(lambda p: member(fr, bytes(p), level), pieces))
    return out + ([fr.eof] if fr.eof else [])


class Expected:
    """The input the stream must restore: ``total`` bytes of ``data``
    repeated end to end (the window cycles through its corpus)."""

    def __init__(self, data: bytes, total: int, longest: int = 1 << 20):
        self.data, self.total = data, total
        self._ext = data + data[: min(longest, len(data))] * (-(-longest // len(data)))

    def at(self, off: int, n: int) -> bytes:
        if off >= self.total:
            return b""
        n = min(n, self.total - off)
        s = off % len(self.data)
        return self._ext[s: s + n]


def check(fr: Framing, parts: list[bytes], want: Expected, threads: int = 8) -> dict[str, int]:
    """Decode the stream with ``zlib`` and count what is wrong:
    ``frames_bad`` members (or stream ends) with a wrong header, size field,
    cap or missing closing member; ``data_bad`` members that do not inflate
    to the input's bytes at their place; ``checks_bad`` members whose CRC32
    or ISIZE does not match their bytes; ``length_gap`` bytes between what
    the stream restores and the input's length."""
    stream = b"".join(parts)
    bad = {"frames_bad": 0, "data_bad": 0, "checks_bad": 0, "length_gap": 0}
    spans, pos = [], 0
    while pos < len(stream):
        head = stream[pos: pos + fr.header]
        if len(head) < fr.header or not fr.head_ok(head):
            bad["frames_bad"] += 1
            break
        size = fr.size_of(head)
        if size < fr.header + 8 or pos + size > len(stream) or (
                fr.max_member is not None and size > fr.max_member):
            bad["frames_bad"] += 1
            break
        spans.append((pos, size))
        pos += size
    if fr.eof and (not spans or stream[spans[-1][0]: spans[-1][0] + len(fr.eof)] != fr.eof):
        bad["frames_bad"] += 1  # the closing member is missing

    def inflate(span):
        p, size = span
        try:
            d = zlib.decompressobj(-15)
            out = d.decompress(stream[p + fr.header: p + size - 8]) + d.flush()
            if not d.eof or d.unused_data:
                return None, False
        except zlib.error:
            return None, False
        crc, isize = struct.unpack_from("<II", stream, p + size - 8)
        return out, crc == zlib.crc32(out) and isize == len(out) & 0xFFFFFFFF

    off = 0
    with ThreadPoolExecutor(threads) as pool:
        for g in range(0, len(spans), 1024):  # a group's outputs at a time
            results = list(pool.map(inflate, spans[g: g + 1024]))
            offs = []
            for out, ok in results:
                offs.append(off)
                bad["checks_bad"] += not ok
                off += len(out) if out is not None else 0
            outs = [out for out, _ in results]
            same = pool.map(lambda o, at: o is not None and o == want.at(at, len(o)), outs, offs)
            bad["data_bad"] += sum(not s for s in same)
    bad["length_gap"] = abs(off - want.total)
    return bad


class Writer:
    """The plain reference in the place of ``ParCompress``: ``write`` and
    ``finish`` with the same stream, members compressed ``rows`` at a time
    on a host pool. ``crc`` replaces every member's CRC32 (the control
    writes 0: the checksum left out)."""

    def __init__(self, fr: Framing, sink, level: int, block: int, rows: int,
                 crc: int | None = None, threads: int = 8):
        self.fr, self.sink, self.level, self.block, self.rows = fr, sink, level, block, rows
        self.crc = crc
        self._buf = bytearray()
        self._pool = ThreadPoolExecutor(threads)

    def _emit(self, data: bytes) -> None:
        pieces = [data[i: i + self.block] for i in range(0, len(data), self.block)]
        self.sink.write(b"".join(self._pool.map(
            lambda p: member(self.fr, p, self.level, self.crc), pieces)))

    def write(self, data) -> int:
        self._buf += data
        batch = self.block * self.rows
        while len(self._buf) >= batch:
            self._emit(bytes(self._buf[:batch]))
            del self._buf[:batch]
        return len(data)

    def finish(self):
        if self._buf:
            self._emit(bytes(self._buf))
        self._buf.clear()
        if self.fr.eof:
            self.sink.write(self.fr.eof)
        self._pool.shutdown()
        return self.sink


class Reader:
    """The plain reference in the place of ``ParDecompress``: ``read(n)``
    over the members of ``stream``, ``rows`` inflated at a time on a host
    pool. ``pad`` returns each block's bytes padded with zeros to that width
    (the control: rows not trimmed to their ISIZE)."""

    def __init__(self, fr: Framing, stream: bytes, rows: int, pad: int | None = None,
                 threads: int = 8):
        self.fr, self.stream, self.rows, self.pad = fr, stream, rows, pad
        self.fallback_stats = {"device": 0, "native": 0}
        self._pos = 0
        self._buf = bytearray()
        self._pool = ThreadPoolExecutor(threads)

    def _inflate(self, m: bytes) -> bytes:
        d = zlib.decompressobj(-15)
        out = d.decompress(m[self.fr.header: len(m) - 8]) + d.flush()
        return out.ljust(self.pad, b"\0") if self.pad else out

    def _batch(self) -> bool:
        blocks = []
        while len(blocks) < self.rows and self._pos < len(self.stream):
            size = self.fr.size_of(self.stream[self._pos: self._pos + self.fr.header])
            blocks.append(self.stream[self._pos: self._pos + size])
            self._pos += size
        self._buf += b"".join(self._pool.map(self._inflate, blocks))
        return bool(blocks)

    def read(self, n: int) -> bytes:
        while len(self._buf) < n and self._batch():
            pass
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def close(self) -> None:
        self._pool.shutdown()
