"""Core constants shared across gzp_tpu_torch.

Values mirror the reference's contract (reference src/lib.rs:104-108,
src/bgzf.rs:20-38) so streams produced here are drop-in compatible.
"""

from __future__ import annotations

# 128 KiB default block/buffer size, same as pigz (reference src/lib.rs:104-105).
BUFSIZE = 64 * (1 << 10) * 2

# 32 KiB dictionary carried between zlib-family blocks (reference src/lib.rs:107-108).
DICT_SIZE = 32768

# Default compression level (reference src/lib.rs:203 — ZBuilder default 3).
DEFAULT_COMPRESSION_LEVEL = 3

# BGZF: input blocks are capped at 65280 bytes (reference src/bgzf.rs:20-21)
BGZF_BLOCK_SIZE = 65280
# ... and a complete compressed BGZF block must stay under 64 KiB
# (reference src/bgzf.rs:22-23).
MAX_BGZF_BLOCK_SIZE = 64 * 1024

BGZF_HEADER_SIZE = 18  # reference src/bgzf.rs:40
BGZF_FOOTER_SIZE = 8  # reference src/bgzf.rs:42
MGZIP_HEADER_SIZE = 20  # reference src/deflate.rs:370
MGZIP_FOOTER_SIZE = 8

# Static 28-byte BGZF EOF marker appended to the last block
# (reference src/bgzf.rs:24-38; byte-for-byte the htslib EOF block).
BGZF_EOF = bytes(
    [
        0x1F, 0x8B,  # ID1, ID2
        0x08,        # CM = DEFLATE
        0x04,        # FLG = FEXTRA
        0x00, 0x00, 0x00, 0x00,  # MTIME = 0
        0x00,        # XFL
        0xFF,        # OS = unknown
        0x06, 0x00,  # XLEN = 6
        0x42, 0x43,  # 'B', 'C'
        0x02, 0x00,  # SLEN = 2
        0x1B, 0x00,  # BSIZE = 27
        0x03, 0x00,  # CDATA: empty final deflate block
        0x00, 0x00, 0x00, 0x00,  # CRC32 = 0
        0x00, 0x00, 0x00, 0x00,  # ISIZE = 0
    ]
)

# DEFLATE limits (RFC 1951).
MIN_MATCH = 3
MAX_MATCH = 258
MAX_DIST = 32768

# Snappy (frame format constants).
SNAPPY_STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"
SNAPPY_MAX_CHUNK = 65536  # max uncompressed bytes per frame chunk
SNAPPY_MIN_MATCH = 4


def clamp_compression_level(level: int) -> int:
    """Clamp to the zlib-compatible 0..9 range (reference uses flate2's
    ``Compression::new(n)`` which accepts 0..9)."""
    return max(0, min(9, int(level)))
