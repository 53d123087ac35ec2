"""Format abstraction: how streams and blocks are framed.

Equivalent of the reference's ``FormatSpec`` / ``BlockFormatSpec`` traits
(reference src/lib.rs:324-448), reshaped for the batched device pipeline: a format
owns its byte-level header/footer logic and its block rules (which device
encoder, the uncompressed block, the oracle that decodes a block). The
parallel runtime in :mod:`gzp_tpu_torch.parallel` consumes these specs; the
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
      * ``default_bufsize``: default uncompressed block size
        (reference ``DEFAULT_BUFSIZE``, src/lib.rs:330).
      * ``max_input_block``: uncompressed block-size cap the writer
        enforces (BGZF, Snappy).
      * ``max_block_bytes``: an encoded block must stay under it (BGZF).

    The block rules the writer (``parallel/compress.py``) applies to every
    block, as the reference's ``FormatSpec`` owns its format's encoding:
    :meth:`encoder`, :meth:`stored_len`, :meth:`stored_block`,
    :meth:`host_check` and :meth:`oracle`. A :class:`BlockFormatSpec`'s
    blocks close themselves: a stream of them needs no empty closing block.
    """

    name: str = "abstract"
    check_cls: type[_check.Check] = _check.PassThroughCheck
    default_bufsize: int = BUFSIZE
    max_input_block: int | None = None
    max_block_bytes: int | None = None

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

    def encoder(self, block_size: int, level: int, use_dict: bool):
        """``(encode, dict_size)``: the batched device encoder of blocks of
        ``block_size`` bytes (``encode(data_u8, lengths, is_final[, halo,
        dict_lens]) -> dict`` with ``out_len``, ``check`` and ``flat``) and
        the bytes of the previous block each block takes as its halo (0:
        none)."""
        raise NotImplementedError

    def stored_len(self, ln: int) -> int:
        """Length of :meth:`stored_block` of ``ln`` bytes."""
        raise NotImplementedError

    def stored_block(self, raw: bytes, final: bool, level: int, chk: int) -> bytes:
        """``raw`` encoded on the host without compression (``chk``: the
        device's check of ``raw``)."""
        raise NotImplementedError

    def host_check(self, raw: bytes, chk: int) -> int:
        """The check of a block the host re-encoded, for the stream check."""
        c = self.check_cls()
        c.update(raw)
        return c.sum()

    def oracle(self, seen: bytes = b""):
        """A fresh ``oracle(blob, raw) -> bool``: whether each encoded block,
        handed over in stream order, decodes to its input, after the
        encoded bytes ``seen`` (which only a stream's blocks depend on)."""
        raise NotImplementedError


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
