"""Pure-Python snappy frame *decoder* — independent test oracle.

Copy of ``gzp_tpu/utils/snappy_ref.py``: a from-spec decoder that the
tests, the verify net of ``ParCompress`` and ``chip_smoke.py`` use to
restore Snappy streams. It validates chunk CRCs and rejects malformed
streams. Not a hot path; copies that do not overlap their source move as
one slice.
"""

from __future__ import annotations

import struct

from gzp_tpu_torch.check import crc32c, snappy_mask_crc
from gzp_tpu_torch.errors import DecompressError, InvalidCheckError


def decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    shift = 0
    value = 0
    while True:
        if pos >= len(buf):
            raise DecompressError("truncated varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift > 35:
            raise DecompressError("varint too long")


def decode_block(buf: bytes) -> bytes:
    """Decode one raw snappy block (after the frame chunk header)."""
    expected, pos = decode_varint(buf, 0)
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        elem_type = tag & 3
        if elem_type == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                if extra > 4:
                    raise DecompressError("bad literal length")
                ln = int.from_bytes(buf[pos : pos + extra], "little") + 1
                pos += extra
            out += buf[pos : pos + ln]
            pos += ln
        elif elem_type == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
            _copy(out, offset, ln)
        elif elem_type == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            offset = struct.unpack_from("<H", buf, pos)[0]
            pos += 2
            _copy(out, offset, ln)
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            offset = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            _copy(out, offset, ln)
    if len(out) != expected:
        raise DecompressError(
            f"decoded {len(out)} bytes, preamble said {expected}"
        )
    return bytes(out)


def _copy(out: bytearray, offset: int, ln: int) -> None:
    if offset == 0 or offset > len(out):
        raise DecompressError("copy offset out of range")
    start = len(out) - offset
    if offset >= ln:
        out += out[start : start + ln]
        return
    for k in range(ln):  # may overlap (RLE) — byte-at-a-time semantics
        out.append(out[start + k])


def decode_frames(stream: bytes, verify_crc: bool = True) -> bytes:
    """Decode a complete framed stream (possibly many concatenated frames)."""
    pos = 0
    out = bytearray()
    seen_identifier = False
    while pos < len(stream):
        if pos + 4 > len(stream):
            raise DecompressError("truncated chunk header")
        ctype = stream[pos]
        clen = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        pos += 4
        body = stream[pos : pos + clen]
        if len(body) != clen:
            raise DecompressError("truncated chunk body")
        pos += clen
        if ctype == 0xFF:  # stream identifier
            if body != b"sNaPpY":
                raise DecompressError("bad stream identifier")
            seen_identifier = True
        elif ctype == 0x00:  # compressed chunk
            if not seen_identifier:
                raise DecompressError("chunk before stream identifier")
            crc = int.from_bytes(body[:4], "little")
            plain = decode_block(body[4:])
            if verify_crc:
                want = snappy_mask_crc(crc32c(plain))
                if crc != want:
                    raise InvalidCheckError(found=want, expected=crc)
            out += plain
        elif ctype == 0x01:  # uncompressed chunk
            crc = int.from_bytes(body[:4], "little")
            plain = body[4:]
            if verify_crc:
                want = snappy_mask_crc(crc32c(plain))
                if crc != want:
                    raise InvalidCheckError(found=want, expected=crc)
            out += plain
        elif 0x02 <= ctype <= 0x7F:
            raise DecompressError(f"unskippable chunk type {ctype:#x}")
        # 0x80..0xFE: skippable, ignore
    return bytes(out)
