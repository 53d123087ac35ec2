"""Snappy frame format spec.

Mirrors the reference's Snap format (reference src/snap.rs:34-107): each
gzp block is re-framed as a complete snappy frame — stream identifier plus
compressed/uncompressed chunks — so concatenated blocks form a valid
stream (frame decoders skip repeated stream identifiers). Compression
level is ignored; there is no stream header/footer or stream checksum
(per-chunk masked CRC32C lives inside the frames).

Counterpart of ``gzp_tpu/formats/snap.py``: the format spec and the
streaming frame decoder :class:`SnappyFrameDecoder`, the read path over
the host codec's Snappy decompress (``utils/snappy_ref.py`` decodes frames
for the writer's verify net, as the reference's does).
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO

from gzp_tpu_torch import check as _check
from gzp_tpu_torch.constants import BUFSIZE, SNAPPY_MAX_CHUNK, SNAPPY_STREAM_IDENTIFIER
from gzp_tpu_torch.errors import DecompressError, InvalidCheckError, InvalidHeaderError
from gzp_tpu_torch.formats.base import FormatSpec
from gzp_tpu_torch.utils.io import read_exact as _read_exact_io
from gzp_tpu_torch.utils.serialize import put_le
from gzp_tpu_torch.utils.snappy_ref import decode_frames


class _Snap(FormatSpec):
    name = "snappy"
    check_cls = _check.PassThroughCheck
    default_bufsize = BUFSIZE
    # one frame chunk per block lane: cap blocks at the 65536-byte chunk
    # size (the writer clamps larger requested buffer sizes)
    max_input_block = SNAPPY_MAX_CHUNK

    def encoder(self, block_size: int, level: int, use_dict: bool):
        from gzp_tpu_torch.ops.snappy_kernel import SnappyEncodeConfig, get_snappy_encoder

        return get_snappy_encoder(SnappyEncodeConfig(block_len=block_size)), 0

    def stored_len(self, ln: int) -> int:
        return len(SNAPPY_STREAM_IDENTIFIER) + 8 + ln

    def stored_block(self, raw: bytes, final: bool, level: int, chk: int) -> bytes:
        """A frame of one uncompressed chunk; its CRC is ``chk``, the
        device's masked CRC32C, since the checksum reads the input, not the
        encoding."""
        return (SNAPPY_STREAM_IDENTIFIER + b"\x01" + put_le(len(raw) + 4, 3) + put_le(chk, 4)
                + raw)

    def host_check(self, raw: bytes, chk: int) -> int:
        return chk  # the frame carries it (stored_block)

    def oracle(self, seen: bytes = b""):
        return lambda blob, raw: decode_frames(blob) == raw


Snap = _Snap()


class SnappyFrameDecoder(io.RawIOBase):
    """Streaming snappy *frame* decoder — the production decode path.

    Mirrors the reference's snap-crate ``FrameDecoder`` usage (reference
    examples/snap_decode.rs); block decompression runs in the native C++
    codec (``gzptpu_snappy_decompress``) and every chunk's masked CRC32C
    is verified, as the frame spec requires. Accepts concatenated streams
    (repeated stream identifiers), padding and skippable chunks; raises on
    reserved unskippable chunks.
    """

    _STREAM_ID = b"sNaPpY"

    def __init__(self, reader: BinaryIO, verify_crc: bool = True) -> None:
        self.reader = reader
        self.verify_crc = verify_crc
        self._buffer = bytearray()
        self._eof = False
        self._seen_stream_id = False

    def _read_exact(self, n: int) -> bytes:
        # looped read: short returns are legal from pipes/sockets
        # (the reference's snap crate reads via read_exact loops)
        data = _read_exact_io(self.reader, n)
        if len(data) != n:
            raise DecompressError("truncated snappy frame chunk")
        return data

    def _checked(self, plain: bytes, want: int, native) -> bytes:
        if self.verify_crc:
            got = _check.snappy_mask_crc(native.crc32c(plain, 0))
            if got != want:
                raise InvalidCheckError(found=got, expected=want)
        return plain

    def _next_chunk(self) -> bytes | None:
        from gzp_tpu_torch.runtime import get_native

        native = get_native()
        while True:
            hdr = _read_exact_io(self.reader, 4)
            if not hdr:
                self._eof = True
                return None
            if len(hdr) < 4:
                raise DecompressError("truncated snappy chunk header")
            ctype = hdr[0]
            clen = hdr[1] | (hdr[2] << 8) | (hdr[3] << 16)
            if ctype == 0xFF:  # stream identifier
                if clen != 6 or self._read_exact(clen) != self._STREAM_ID:
                    raise InvalidHeaderError("bad snappy stream identifier")
                self._seen_stream_id = True
                continue
            if not self._seen_stream_id:
                raise InvalidHeaderError("snappy frame missing stream identifier")
            if ctype == 0x00:  # compressed data
                body = self._read_exact(clen)
                if clen < 4:
                    raise DecompressError("short compressed chunk")
                (want,) = struct.unpack_from("<I", body, 0)
                plain = native.snappy_decompress(body[4:], SNAPPY_MAX_CHUNK)
                return self._checked(plain, want, native)
            if ctype == 0x01:  # uncompressed data
                body = self._read_exact(clen)
                if clen < 4:
                    raise DecompressError("short uncompressed chunk")
                (want,) = struct.unpack_from("<I", body, 0)
                plain = body[4:]
                if len(plain) > SNAPPY_MAX_CHUNK:
                    raise DecompressError("oversized uncompressed chunk")
                return self._checked(plain, want, native)
            if ctype == 0xFE or 0x80 <= ctype <= 0xFD:  # padding / skippable
                self._read_exact(clen)
                continue
            raise DecompressError(f"unskippable reserved snappy chunk 0x{ctype:02x}")

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            chunks = [bytes(self._buffer)]
            self._buffer.clear()
            while not self._eof:
                c = self._next_chunk()
                if c is None:
                    break
                chunks.append(c)
            return b"".join(chunks)
        while len(self._buffer) < size and not self._eof:
            c = self._next_chunk()
            if c is None:
                break
            self._buffer += c
        out = bytes(self._buffer[:size])
        del self._buffer[:size]
        return out

    def readable(self) -> bool:
        return True
