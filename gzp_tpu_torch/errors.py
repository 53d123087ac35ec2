"""Error model for gzp_tpu_torch.

Mirrors the single-enum error surface of the reference (``GzpError``,
reference src/lib.rs:114-163) as a small exception hierarchy rooted at
:class:`GzpError` so callers can catch one type, while still getting
specific classes for programmatic handling.
"""

from __future__ import annotations


class GzpError(Exception):
    """Base error for all gzp_tpu_torch failures (reference src/lib.rs:114)."""


class BufferSizeError(GzpError):
    """Invalid buffer size (reference ``GzpError::BufferSize``, src/lib.rs:116-117)."""

    def __init__(self, got: int, minimum: int):
        self.got = got
        self.minimum = minimum
        super().__init__(f"Invalid buffer size ({got}), must be >= {minimum}")


class NumThreadsError(GzpError):
    """Invalid parallelism degree (reference ``GzpError::NumThreads``, src/lib.rs:158-159)."""

    def __init__(self, got: int):
        self.got = got
        super().__init__(f"Invalid number of threads ({got}) selected.")


class BlockSizeExceededError(GzpError):
    """Compressed block exceeds the format's cap, e.g. BGZF's 65536-byte limit
    (reference ``GzpError::BlockSizeExceeded``, src/lib.rs:119-120)."""

    def __init__(self, got: int, maximum: int):
        self.got = got
        self.maximum = maximum
        super().__init__(
            f"Compressed block size ({got}) exceeds max allowed: ({maximum}), "
            "try increasing compression."
        )


class InvalidBlockSizeError(GzpError):
    """Bad block size encountered while reading (reference src/lib.rs:134-135)."""


class InvalidCheckError(GzpError):
    """Checksum mismatch at decode (reference ``GzpError::InvalidCheck``, src/lib.rs:137-138)."""

    def __init__(self, found: int, expected: int):
        self.found = found
        self.expected = expected
        super().__init__(f"Invalid checksum, found {found}, expected {expected}")


class InvalidHeaderError(GzpError):
    """Malformed or mismatched block header (reference src/lib.rs:140-141)."""


class CompressError(GzpError):
    """Codec-level failure during compression."""


class DecompressError(GzpError):
    """Codec-level failure during decompression (truncated/corrupt stream)."""


class ChannelError(GzpError):
    """Pipeline communication failure: the background stitcher/reader died.

    The reference surfaces ``ChannelSend``/``ChannelReceive`` when its worker
    threads disappear (src/lib.rs:122-126); our equivalent is an error raised
    by the host-side pipeline when the device-dispatch executor has failed.
    The root cause is attached as ``__cause__`` so io-error identity is
    preserved (reference behavior, src/par/compress.rs:428-457).
    """


class WriterClosedError(GzpError):
    """Write/read attempted after finish() (writer already consumed)."""
