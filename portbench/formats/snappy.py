"""Plain reference for Snappy frames (gzp ``src/snap.rs``; google/snappy's
``framing_format.txt`` and ``format_description.txt``): each block of input
one frame, the stream identifier and one chunk, compressed (type 0x00) or
uncompressed (0x01), carrying the masked CRC32C of the block's bytes; the
frames end to end are one framed stream. A from-spec decoder in plain
Python, independent of the port, and a writer of uncompressed chunks for
the control.

The check decodes each distinct frame once. A window cycles through its
corpus, so most frames repeat a frame written earlier at the same place
in the corpus. Decoding is a function of a frame's bytes alone, so a frame
whose bytes equal such an earlier frame's takes that frame's verdict;
every other frame is decoded in full, on a pool of processes when there
are many.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

PROGRAM = "Snap"  # the port's format object
HALO = 0  # frames carry no dictionary
IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"  # the stream identifier chunk
MAX_CHUNK = 65536  # most uncompressed bytes a chunk may carry
POOL_MIN = 64  # fewest frames to decode that are worth a pool of processes


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c_table(blocks: list) -> list[int]:
    """CRC32C (Castagnoli, reflected) of each block by the byte table, the
    blocks in lockstep a byte at a time (numpy), longest first, so that the
    blocks still going are always the first ones."""
    import numpy as np

    order = sorted(range(len(blocks)), key=lambda i: -len(blocks[i]))
    lens = [len(blocks[i]) for i in order]
    cols = np.zeros((lens[0] if lens else 0, len(blocks)), np.uint8)  # byte j of each block in row j
    for k, i in enumerate(order):
        cols[: lens[k], k] = np.frombuffer(bytes(blocks[i]), np.uint8)
    table = np.array(_TABLE, np.uint32)
    crc = np.full(len(blocks), 0xFFFFFFFF, np.uint32)
    going = len(blocks)
    for j in range(len(cols)):
        while lens[going - 1] <= j:
            going -= 1
        c = crc[:going]
        crc[:going] = table[(c ^ cols[j, :going]) & 0xFF] ^ (c >> 8)
    out = [0] * len(blocks)
    for k, i in enumerate(order):
        out[i] = int(crc[k]) ^ 0xFFFFFFFF
    return out


def masked_crcs(blocks: list) -> list[int]:
    """The frame format's masked CRC32C of each block."""
    return [(((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF for c in crc32c_table(blocks)]


def varint(stream, pos: int, end: int) -> tuple[int, int] | None:
    """The little-endian base-128 number at ``pos`` (at most 5 bytes, before
    ``end``) and where it ends, or None."""
    value = shift = 0
    while pos < end and shift <= 28:
        b = stream[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
    return None


def decode_block(body: bytes, pos: int, n: int) -> bytes | None:
    """The ``n`` bytes that the elements of a compressed block from ``pos``
    to its end restore: literals (tag 0b00, lengths of up to 60 in the tag
    or in 1-4 bytes after it) and copies with 1-, 2- and 4-byte offsets
    (tags 0b01, 0b10, 0b11). None where an element runs past the body, a
    copy reaches before the output or the output is not ``n`` bytes."""
    out = bytearray()
    end = len(body)
    try:
        while pos < end and len(out) <= n:
            tag = body[pos]
            kind = tag & 3
            if kind == 0:
                ln = (tag >> 2) + 1
                pos += 1
                if ln > 60:
                    extra = ln - 60
                    ln = int.from_bytes(body[pos: pos + extra], "little") + 1
                    pos += extra
                out += body[pos: pos + ln]
                pos += ln
                continue
            if kind == 2:
                ln = (tag >> 2) + 1
                off = body[pos + 1] | body[pos + 2] << 8
                pos += 3
            elif kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = (tag >> 5) << 8 | body[pos + 1]
                pos += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(body[pos + 1: pos + 5], "little")
                if pos + 5 > end:
                    return None
                pos += 5
            start = len(out) - off
            if off == 0 or start < 0:
                return None
            if off >= ln:
                out += out[start: start + ln]
            else:  # the copy overlaps its own output: its source repeats
                q, r = divmod(ln, off)
                pattern = out[start:]
                out += pattern * q + pattern[:r]
    except IndexError:
        return None
    return bytes(out) if pos == end and len(out) == n else None


def restore(ctype: int, body: bytes) -> bytes | None:
    """The bytes a data chunk's ``body`` (its checksum, then its data)
    restores: an uncompressed chunk's data as it is, a compressed one's
    decoded (its varint length, then its elements). None where the body is
    shorter than its checksum, the length is bad or over 65,536, or the
    elements do not decode to it."""
    if len(body) < 4:
        return None
    if ctype == 1:
        return body[4:] if len(body) - 4 <= MAX_CHUNK else None
    got = varint(body, 4, len(body))
    if got is None or got[0] > MAX_CHUNK:
        return None
    return decode_block(body, got[1], got[0])


def verdicts(work: list) -> list[tuple[bool, bool]]:
    """Whether each data chunk restores its input, and whether its masked
    CRC32C is right: each item of ``work`` is (chunk type, the chunk's
    body, the input bytes it must restore). A chunk that restores nothing
    has no checksum to test."""
    got = [restore(ctype, body) for ctype, body, _ in work]
    sums = iter(masked_crcs([g for g in got if g is not None]))
    return [(False, True) if g is None
            else (g == want, int.from_bytes(body[:4], "little") == next(sums))
            for g, (_, body, want) in zip(got, work)]


def _verdicts_on(work: list, procs: int) -> list[tuple[bool, bool]]:
    """:func:`verdicts` of ``work``; on ``procs`` fresh interpreters
    (``spawn``: nothing of the caller's CUDA state) where there are
    ``POOL_MIN`` items or more."""
    if procs <= 1 or len(work) < POOL_MIN:
        return verdicts(work)
    # by its package name: the harness loads this file under another one,
    # which a fresh interpreter cannot import
    from portbench.formats import snappy

    shares = [work[i::procs] for i in range(procs)]
    with ProcessPoolExecutor(procs, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(snappy.verdicts, shares))
    got = [None] * len(work)
    for i, share in enumerate(done):
        got[i::procs] = share
    return got


def check(parts, want, procs: int = 8) -> dict[str, int]:
    """Decode the framed stream and count what is wrong: ``frames_bad`` (a
    missing or wrong stream identifier before a data chunk, a chunk header
    or length past the stream's end, a chunk too short for its checksum, an
    uncompressed length over 65,536 or a bad varint preamble, a reserved
    chunk type), ``data_bad`` (data chunks that do not restore the input's
    bytes at their place), ``checks_bad`` (data chunks whose masked CRC32C
    is wrong), ``length_gap`` (bytes between what the stream restores and
    the input's length). ``want`` is a ``members.Expected``."""
    stream = b"".join(parts)
    bad = {"frames_bad": 0, "data_bad": 0, "checks_bad": 0, "length_gap": 0}
    period = len(want.data)
    work, weight = [], []  # each distinct frame's (type, body, input) and its count
    seen: dict[int, tuple[bytes, int]] = {}  # place in the corpus -> (frame, its work index)
    pos = off = 0
    opened = -1  # where the identifier of the frame in progress starts
    end = len(stream)
    while pos < end:
        if end - pos < 4:
            bad["frames_bad"] += 1
            break
        ctype = stream[pos]
        nxt = pos + 4 + int.from_bytes(stream[pos + 1: pos + 4], "little")
        if nxt > end:
            bad["frames_bad"] += 1
            break
        if ctype == 0xFF:
            opened = pos if stream[pos: nxt] == IDENTIFIER else -1
            bad["frames_bad"] += opened < 0
        elif ctype in (0, 1):
            n = None
            if nxt - pos >= 8:
                if ctype == 1:
                    n = nxt - pos - 8
                else:
                    got = varint(stream, pos + 8, nxt)
                    n = got[0] if got else None
            if n is not None and n > MAX_CHUNK:
                n = None
            if opened < 0 or n is None:
                bad["frames_bad"] += 1
            if n is not None:
                frame = stream[opened: nxt] if opened >= 0 else None
                key = off % period if frame is not None and off + n <= want.total else None
                first = seen.get(key) if key is not None else None
                if first is not None and first[0] == frame:
                    weight[first[1]] += 1
                else:
                    if key is not None and first is None:
                        seen[key] = (frame, len(work))
                    work.append((ctype, stream[pos + 4: nxt], want.at(off, n)))
                    weight.append(1)
                off += n
            opened = -1  # a frame holds one data chunk
        elif ctype < 0x80:
            bad["frames_bad"] += 1  # reserved, unskippable
        pos = nxt  # skippable chunks and padding (0x80-0xFE) are passed over
    for (data_ok, check_ok), w in zip(_verdicts_on(work, procs), weight):
        bad["data_bad"] += w * (not data_ok)
        bad["checks_bad"] += w * (not check_ok)
    bad["length_gap"] = abs(off - want.total)
    return bad


def frames(blocks: list, crc: int | None = None) -> list[bytes]:
    """One frame of each block: the identifier, then an uncompressed chunk
    with the block's masked CRC32C (or ``crc``). An empty block is the
    identifier alone."""
    sums = masked_crcs(blocks) if crc is None else [crc] * len(blocks)
    out = []
    for block, c in zip(blocks, sums):
        chunk = b"\x01" + (len(block) + 4).to_bytes(3, "little") + c.to_bytes(4, "little")
        out.append(IDENTIFIER + chunk + block if block else IDENTIFIER)
    return out


class Writer:
    """The plain reference in the place of ``ParCompress``: ``write`` and
    ``finish`` with the same stream, ``rows`` frames of ``block`` input
    bytes at a time. ``crc`` replaces every frame's checksum (the control
    writes 0: the checksum left out)."""

    def __init__(self, sink, block: int, rows: int, crc: int | None = None):
        self.sink, self.block, self.rows, self.crc = sink, block, rows, crc
        self._buf = bytearray()
        self._any = False

    def _emit(self, data: bytes) -> None:
        blocks = [data[i: i + self.block] for i in range(0, len(data), self.block)]
        self.sink.write(b"".join(frames(blocks, self.crc)))
        self._any = True

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
        elif not self._any:
            self.sink.write(IDENTIFIER)  # an empty stream: one empty frame
        self._buf.clear()
        return self.sink


def control(sink, cfg: dict) -> Writer:
    """The control: the reference writer with every frame's CRC32C left
    out (written as 0)."""
    return Writer(sink, cfg["block_bytes"], cfg["rows"], crc=0)
