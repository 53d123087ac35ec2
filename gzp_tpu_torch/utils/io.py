"""Small I/O helpers shared by the streaming readers.

``read_exact`` mirrors the reference's ``read_exact`` loops
(reference src/par/decompress.rs:197-202): a raw file, pipe or socket
may legally return fewer bytes than requested without being at EOF, so
every framed read must loop until the request is satisfied or the
source is truly exhausted.
"""

from __future__ import annotations

from typing import BinaryIO


def read_exact(reader: BinaryIO, n: int) -> bytes:
    """Read exactly ``n`` bytes, looping over short reads.

    Returns fewer than ``n`` bytes only at true end-of-stream (the
    caller decides whether a short result is clean EOF or truncation).
    """
    buf = bytearray()
    while len(buf) < n:
        chunk = reader.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return bytes(buf)
