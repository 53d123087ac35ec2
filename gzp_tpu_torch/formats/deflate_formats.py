"""The five deflate-family formats: Gzip, Zlib, RawDeflate, Mgzip, Bgzf.

Byte-level framing matches the reference exactly:
  * Gzip header/footer — reference src/deflate.rs:113-143
  * Zlib header (big-endian, mod-31) / Adler footer — src/deflate.rs:221-251
  * RawDeflate — headerless (src/deflate.rs:329-337)
  * Mgzip member framing — src/mgzip.rs:244-285 (20-byte header, 'IG' SID,
    u32 BLEN = total member size)
  * Bgzf member framing — src/bgzf.rs:272-310 (18-byte header, 'BC' SID,
    u16 BSIZE = total member size - 1, 65280-byte input cap, EOF marker)

A member's header is written by :meth:`_Member.member_header` and read by
:meth:`_Member.get_block_size`; the device framing
(``ops/deflate_kernel.py``) takes its template and size field from there.
"""

from __future__ import annotations

import zlib

from gzp_tpu_torch import check as _check
from gzp_tpu_torch.constants import (
    BGZF_BLOCK_SIZE,
    BGZF_EOF,
    BGZF_HEADER_SIZE,
    DICT_SIZE,
    MAX_BGZF_BLOCK_SIZE,
    MGZIP_HEADER_SIZE,
)
from gzp_tpu_torch.errors import InvalidHeaderError
from gzp_tpu_torch.formats.base import BlockFormatSpec, FormatSpec
from gzp_tpu_torch.ops import host_codec
from gzp_tpu_torch.utils.serialize import put_be, put_le


def _gzip_xfl(level: int) -> int:
    """XFL byte: 2 for max compression, 4 for fastest (reference
    src/deflate.rs:113-120)."""
    if level >= 9:
        return 2
    if level <= 1:
        return 4
    return 0


class _Deflate(FormatSpec):
    """A format the deflate encoder writes; ``kernel_mode`` is its framing
    (``DeflateEncodeConfig.mode``): ``'stream'`` (chunks of one deflate
    stream joined with sync flushes) or ``'mgzip'``/``'bgzf'`` (a member
    per block)."""

    kernel_mode = "stream"

    def encoder(self, block_size: int, level: int, use_dict: bool):
        # imported here: the kernel module reads the member header from this one
        from gzp_tpu_torch.ops.deflate_kernel import DeflateEncodeConfig, get_encoder

        name = self.check_cls.name
        # stream blocks carry the previous block's last 32 KiB as their
        # dictionary (reference: cfg!(feature = "any_zlib"), src/deflate.rs:79-82)
        dict_size = DICT_SIZE if use_dict and self.kernel_mode == "stream" else 0
        cfg = DeflateEncodeConfig.for_level(
            block_len=block_size, mode=self.kernel_mode,
            checksum=name if name in ("crc32", "adler32") else "none",
            level=level, dict_size=dict_size,
        )
        return get_encoder(cfg), dict_size


class _Stream(_Deflate):
    """Gzip, Zlib, raw Deflate: each block a chunk of one deflate stream."""

    def stored_len(self, ln: int) -> int:
        return host_codec.stored_size(ln)

    def stored_block(self, raw: bytes, final: bool, level: int, chk: int) -> bytes:
        return host_codec.stored_deflate(raw, final)

    def oracle(self, seen: bytes = b""):
        inflate = zlib.decompressobj(-15)  # the whole stream, incrementally
        inflate.decompress(seen)
        return lambda blob, raw: inflate.decompress(blob) == raw


class _Gzip(_Stream):
    name = "gzip"
    check_cls = _check.Crc32

    def header(self, compression_level: int) -> bytes:
        return bytes(
            [31, 139, 8, 0, 0, 0, 0, 0, _gzip_xfl(compression_level), 255]
        )

    def footer(self, check: _check.Check) -> bytes:
        return put_le(check.sum(), 4) + put_le(check.amount(), 4)


class _Zlib(_Stream):
    name = "zlib"
    check_cls = _check.Adler32

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


class _RawDeflate(_Stream):
    name = "raw_deflate"
    check_cls = _check.PassThroughCheck


class _Member(_Deflate, BlockFormatSpec):
    """A gzip member per block. Its extra field, subfield ``sid``, holds
    the member's total length less ``size_bias`` in ``size_width`` bytes,
    little-endian, at byte ``SIZE_OFFSET`` of the header."""

    check_cls = _check.PassThroughCheck
    block_check_cls = _check.Crc32
    SIZE_OFFSET = 16
    sid: bytes
    size_width: int
    size_bias: int

    def member_header(self, level: int, member_len: int | None = None) -> bytes:
        """The header of a member of ``member_len`` bytes (header, payload
        and footer); with none, the size field is zero (the device's
        template, whose size field the encoder writes)."""
        size = 0 if member_len is None else member_len - self.size_bias
        return (bytes([31, 139, 8, 4, 0, 0, 0, 0, _gzip_xfl(level), 255, 4 + self.size_width, 0])
                + self.sid + put_le(self.size_width, 2) + put_le(size, self.size_width))

    def check_header(self, header: bytes) -> None:
        if len(header) < self.header_size:
            raise InvalidHeaderError("Header truncated")
        if header[0] != 31 or header[1] != 139:
            raise InvalidHeaderError("Bad gzip magic")
        if header[3] & 4 != 4:
            raise InvalidHeaderError("Extra field flag not set")
        if header[12:14] != self.sid:
            raise InvalidHeaderError("Bad SID")

    def get_block_size(self, header: bytes) -> int:
        field = header[self.SIZE_OFFSET: self.SIZE_OFFSET + self.size_width]
        return int.from_bytes(field, "little") + self.size_bias

    def stored_len(self, ln: int) -> int:
        return self.header_size + host_codec.stored_size(ln) + 8

    def stored_block(self, raw: bytes, final: bool, level: int, chk: int) -> bytes:
        payload = host_codec.stored_deflate(raw, final=True)
        return (self.member_header(level, self.header_size + len(payload) + 8) + payload
                + put_le(zlib.crc32(raw), 4) + put_le(len(raw) & 0xFFFFFFFF, 4))

    def oracle(self, seen: bytes = b""):
        def ok(blob: bytes, raw: bytes) -> bool:
            d = zlib.decompressobj(-15)
            return d.decompress(blob[self.header_size: len(blob) - 8]) + d.flush() == raw
        return ok


class _Mgzip(_Member):
    name = "mgzip"
    kernel_mode = "mgzip"
    header_size = MGZIP_HEADER_SIZE
    sid, size_width, size_bias = b"IG", 4, 0


class _Bgzf(_Member):
    name = "bgzf"
    kernel_mode = "bgzf"
    header_size = BGZF_HEADER_SIZE
    sid, size_width, size_bias = b"BC", 2, 1
    default_bufsize = BGZF_BLOCK_SIZE  # reference src/deflate.rs:583
    max_input_block = BGZF_BLOCK_SIZE
    max_block_bytes = MAX_BGZF_BLOCK_SIZE  # reference src/bgzf.rs:218-223

    def trailer_bytes(self) -> bytes:
        return BGZF_EOF


Gzip = _Gzip()
Zlib = _Zlib()
RawDeflate = _RawDeflate()
Mgzip = _Mgzip()
Bgzf = _Bgzf()
