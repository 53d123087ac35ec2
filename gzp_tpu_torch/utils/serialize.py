"""Header/footer field serialization.

Equivalent of the reference's ``Pair``/``to_bytes`` helper (reference
src/lib.rs:314-321, 367-400 — itself modeled on pigz's ``put``): integer
fields written little-endian by default, big-endian when requested
(zlib's 2-byte header is the only big-endian consumer).
"""

from __future__ import annotations


def put_le(value: int, nbytes: int) -> bytes:
    """Little-endian unsigned field (positive ``num_bytes`` Pair)."""
    return int(value).to_bytes(nbytes, "little", signed=False)


def put_be(value: int, nbytes: int) -> bytes:
    """Big-endian unsigned field (negative ``num_bytes`` Pair)."""
    return int(value).to_bytes(nbytes, "big", signed=False)
