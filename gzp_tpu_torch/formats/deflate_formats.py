"""The five deflate-family formats: Gzip, Zlib, RawDeflate, Mgzip, Bgzf.

Byte-level framing matches the reference exactly:
  * Gzip header/footer — reference src/deflate.rs:113-143
  * Zlib header (big-endian, mod-31) / Adler footer — src/deflate.rs:221-251
  * RawDeflate — headerless (src/deflate.rs:329-337)
  * Mgzip member framing — src/mgzip.rs:244-285 (20-byte header, 'IG' SID,
    u32 BLEN = total member size)
  * Bgzf member framing — src/bgzf.rs:272-310 (18-byte header, 'BC' SID,
    u16 BSIZE = total member size - 1, 65280-byte input cap, EOF marker)
"""

from __future__ import annotations

import struct

from gzp_tpu_torch import check as _check
from gzp_tpu_torch.constants import (
    BGZF_BLOCK_SIZE,
    BGZF_EOF,
    BGZF_HEADER_SIZE,
    MGZIP_HEADER_SIZE,
)
from gzp_tpu_torch.errors import InvalidHeaderError
from gzp_tpu_torch.formats.base import BlockFormatSpec, FormatSpec
from gzp_tpu_torch.utils.serialize import put_be, put_le


def _gzip_xfl(level: int) -> int:
    """XFL byte: 2 for max compression, 4 for fastest (reference
    src/deflate.rs:113-120)."""
    if level >= 9:
        return 2
    if level <= 1:
        return 4
    return 0


class _Gzip(FormatSpec):
    name = "gzip"
    check_cls = _check.Crc32
    codec = "deflate"
    kernel_mode = "stream"
    needs_dict = True  # reference: cfg!(feature = "any_zlib")

    def header(self, compression_level: int) -> bytes:
        return bytes(
            [31, 139, 8, 0, 0, 0, 0, 0, _gzip_xfl(compression_level), 255]
        )

    def footer(self, check: _check.Check) -> bytes:
        return put_le(check.sum(), 4) + put_le(check.amount(), 4)


class _Zlib(FormatSpec):
    name = "zlib"
    check_cls = _check.Adler32
    codec = "deflate"
    kernel_mode = "stream"
    needs_dict = True

    def header(self, compression_level: int) -> bytes:
        level = compression_level
        if level >= 9:
            comp_value = 3 << 6
        elif level == 1:
            comp_value = 0 << 6
        elif level >= 6:
            comp_value = 1 << 6
        else:
            comp_value = 2 << 6
        head = (0x78 << 8) + comp_value  # deflate, 32K window
        head += 31 - (head % 31)
        return put_be(head, 2)

    def footer(self, check: _check.Check) -> bytes:
        return put_be(check.sum(), 4)


class _RawDeflate(FormatSpec):
    name = "raw_deflate"
    check_cls = _check.PassThroughCheck
    codec = "deflate"
    kernel_mode = "stream"
    needs_dict = True


class _Mgzip(BlockFormatSpec):
    name = "mgzip"
    check_cls = _check.PassThroughCheck
    block_check_cls = _check.Crc32
    codec = "deflate"
    kernel_mode = "mgzip"
    header_size = MGZIP_HEADER_SIZE

    def check_header(self, header: bytes) -> None:
        if len(header) < self.header_size:
            raise InvalidHeaderError("Header truncated")
        if header[0] != 31 or header[1] != 139:
            raise InvalidHeaderError("Bad gzip magic")
        if header[3] & 4 != 4:
            raise InvalidHeaderError("Extra field flag not set")
        if header[12:14] != b"IG":
            raise InvalidHeaderError("Bad SID")

    def get_block_size(self, header: bytes) -> int:
        return struct.unpack("<I", header[16:20])[0]


class _Bgzf(BlockFormatSpec):
    name = "bgzf"
    check_cls = _check.PassThroughCheck
    block_check_cls = _check.Crc32
    codec = "deflate"
    kernel_mode = "bgzf"
    header_size = BGZF_HEADER_SIZE
    default_bufsize = BGZF_BLOCK_SIZE  # reference src/deflate.rs:583
    max_input_block = BGZF_BLOCK_SIZE

    def check_header(self, header: bytes) -> None:
        if len(header) < self.header_size:
            raise InvalidHeaderError("Header truncated")
        if header[0] != 31 or header[1] != 139:
            raise InvalidHeaderError("Bad gzip magic")
        if header[3] & 4 != 4:
            raise InvalidHeaderError("Extra field flag not set")
        if header[12:14] != b"BC":
            raise InvalidHeaderError("Bad SID")

    def get_block_size(self, header: bytes) -> int:
        return struct.unpack("<H", header[16:18])[0] + 1

    def trailer_bytes(self) -> bytes:
        return BGZF_EOF


Gzip = _Gzip()
Zlib = _Zlib()
RawDeflate = _RawDeflate()
Mgzip = _Mgzip()
Bgzf = _Bgzf()
