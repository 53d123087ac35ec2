"""Plain reference for one Gzip stream (RFC 1952) in pigz's layout, the
layout of gzp's ``ZBuilder(Gzip)``: each block of input a run of deflate
blocks ended by a sync flush, matches reaching into the 32 KiB before it,
the last block final, the stream's CRC32 and length in the trailer. On
Python's ``zlib``, independent of the port."""

from __future__ import annotations

import struct
import zlib

from portbench.formats.members import Expected

PROGRAM = "Gzip"  # the port's format object
HALO = 32768  # a block's matches reach into the 32 KiB before it
_FTEXT, _FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 1, 2, 4, 8, 16
_WINDOW = 1 << 20  # most bytes of output inflated and compared at a time
_PIECE = 1 << 16  # bytes of the stream fed at a time


def _header_len(stream: bytes) -> int | None:
    """Length of the member header, or None where it is not gzip's."""
    if len(stream) < 10 or stream[:3] != b"\x1f\x8b\x08" or stream[3] & 0xE0:
        return None
    flg, pos = stream[3], 10
    if flg & _FEXTRA:
        pos += 2 + struct.unpack_from("<H", stream, pos)[0]
    for bit in (_FNAME, _FCOMMENT):
        if flg & bit:
            end = stream.find(b"\0", pos)
            if end < 0:
                return None
            pos = end + 1
    if flg & _FHCRC:
        pos += 2
    return pos if pos <= len(stream) else None


def check(parts: list[bytes], want: Expected, threads: int = 8) -> dict[str, int]:
    """Inflate the stream with ``zlib`` and count what is wrong:
    ``frames_bad`` (a bad header, a stream that never ends, bytes after the
    trailer), ``data_bad`` (1 MiB windows of output that differ from the
    input, or an inflate error), ``checks_bad`` (trailer CRC32 or ISIZE
    wrong), ``length_gap`` (bytes between the output's length and the
    input's)."""
    stream = b"".join(parts)
    bad = {"frames_bad": 0, "data_bad": 0, "checks_bad": 0, "length_gap": 0}
    start = _header_len(stream)
    if start is None:
        bad["frames_bad"] += 1
        bad["length_gap"] = want.total
        return bad
    d = zlib.decompressobj(-15)
    off, crc, tail = 0, 0, b""
    try:
        for i in range(start, len(stream), _PIECE):
            piece = stream[i: i + _PIECE]
            while piece and not d.eof:
                out = d.decompress(piece, _WINDOW)
                piece = d.unconsumed_tail
                crc = zlib.crc32(out, crc)
                bad["data_bad"] += out != want.at(off, len(out))
                off += len(out)
            if d.eof:
                tail = d.unused_data + stream[i + _PIECE:]
                break
        else:  # the stream's bytes ran out before its end: what zlib still holds
            out = d.flush()
            crc = zlib.crc32(out, crc)
            bad["data_bad"] += out != want.at(off, len(out))
            off += len(out)
            tail = d.unused_data
    except zlib.error:
        bad["data_bad"] += 1
    if not d.eof or len(tail) != 8:
        bad["frames_bad"] += 1
    if len(tail) >= 8:
        got_crc, isize = struct.unpack_from("<II", tail)
        bad["checks_bad"] += (got_crc != crc) + (isize != off & 0xFFFFFFFF)
    else:
        bad["checks_bad"] += 1
    bad["length_gap"] = abs(off - want.total)
    return bad


class Writer:
    """The plain reference in the place of ``ParCompress``: pigz's layout
    on one ``zlib`` stream (blocks of ``block`` bytes, each ended by a sync
    flush). ``combine=False`` writes the last block's CRC32 in the trailer
    in place of the stream's (the control: the per-block checks never
    combined)."""

    def __init__(self, sink, level: int, block: int, rows: int, combine: bool = True):
        self.sink, self.block, self.combine = sink, block, combine
        self._z = zlib.compressobj(level, zlib.DEFLATED, -15)
        self._buf = bytearray()
        self._crc = self._last = self._n = 0
        xfl = 2 if level >= 9 else 4 if level <= 1 else 0
        sink.write(bytes([31, 139, 8, 0, 0, 0, 0, 0, xfl, 255]))

    def _emit(self, block: bytes, mode: int) -> None:
        self._crc = zlib.crc32(block, self._crc)
        self._last = zlib.crc32(block)
        self._n += len(block)
        self.sink.write(self._z.compress(block) + self._z.flush(mode))

    def write(self, data) -> int:
        self._buf += data
        while len(self._buf) > self.block:  # the last block waits for finish
            self._emit(bytes(self._buf[: self.block]), zlib.Z_SYNC_FLUSH)
            del self._buf[: self.block]
        return len(data)

    def finish(self):
        self._emit(bytes(self._buf), zlib.Z_FINISH)
        self._buf.clear()
        crc = self._crc if self.combine else self._last
        self.sink.write(struct.pack("<II", crc, self._n & 0xFFFFFFFF))
        return self.sink


def control(sink, cfg: dict) -> Writer:
    """The control: the reference writer with the combined check left out."""
    return Writer(sink, cfg["level"], cfg["block_bytes"], cfg["rows"], combine=False)
