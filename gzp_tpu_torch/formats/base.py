"""Format abstraction: how streams and blocks are framed.

Equivalent of the reference's ``FormatSpec`` / ``BlockFormatSpec`` traits
(reference src/lib.rs:324-448), reshaped for the batched device pipeline: a format
declares *static* codec configuration (which device kernel family, which
framing mode, which checksums) plus pure byte-level header/footer logic.
The parallel runtime in :mod:`gzp_tpu_torch.parallel` consumes these specs; the
device kernels in :mod:`gzp_tpu_torch.ops` do the compression.
"""

from __future__ import annotations

from dataclasses import dataclass

from gzp_tpu_torch import check as _check
from gzp_tpu_torch.constants import BUFSIZE


@dataclass(frozen=True)
class FooterValues:
    """Per-block footer (crc, isize) of a block format
    (reference src/lib.rs:403-409)."""

    sum: int
    amount: int


class FormatSpec:
    """Static description of a stream format.

    Class attributes (overridden per format):
      * ``name``: identifier.
      * ``check_cls``: stream-level :class:`gzp_tpu_torch.check.Check` type
        (combined across blocks pigz-COMB style).
      * ``codec``: device codec family — ``'deflate'`` or ``'snappy'``.
      * ``kernel_mode``: framing mode of the device encoder —
        ``'stream'`` (continuous deflate joined with sync flushes),
        ``'mgzip'``/``'bgzf'`` (standalone member per block) or
        ``'snappy'`` (snappy frame per block).
      * ``default_bufsize``: default uncompressed block size
        (reference ``DEFAULT_BUFSIZE``, src/lib.rs:330).
      * ``needs_dict``: whether blocks want the previous block's trailing
        32 KiB as a preset dictionary (zlib family only;
        reference src/deflate.rs:79-82).
    """

    name: str = "abstract"
    check_cls: type[_check.Check] = _check.PassThroughCheck
    codec: str = "deflate"
    kernel_mode: str = "stream"
    default_bufsize: int = BUFSIZE
    needs_dict: bool = False
    # uncompressed block-size cap enforced by the writer (BGZF only)
    max_input_block: int | None = None

    def create_check(self) -> _check.Check:
        return self.check_cls()

    def header(self, compression_level: int) -> bytes:
        """Stream-level header bytes."""
        return b""

    def footer(self, check: _check.Check) -> bytes:
        """Stream-level footer bytes."""
        return b""

    def trailer_bytes(self) -> bytes:
        """Static bytes appended after the last block (BGZF EOF marker)."""
        return b""


class BlockFormatSpec(FormatSpec):
    """A self-framed block format supporting parallel decompression
    (reference src/lib.rs:411-448). Adds per-block header parsing."""

    block_check_cls: type[_check.Check] = _check.Crc32
    header_size: int = 0

    def check_header(self, header: bytes) -> None:
        """Validate magic/SID; raise InvalidHeaderError on mismatch."""
        raise NotImplementedError

    def get_block_size(self, header: bytes) -> int:
        """Total compressed size of the block (header+payload+footer)."""
        raise NotImplementedError

    @staticmethod
    def get_footer_values(block: bytes) -> FooterValues:
        """Read the trailing {crc32:u32, isize:u32} (reference
        src/lib.rs:439-447)."""
        import struct

        crc, isize = struct.unpack("<II", block[-8:])
        return FooterValues(sum=crc, amount=isize)
