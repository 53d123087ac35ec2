"""Snappy frame format spec.

Mirrors the reference's Snap format (reference src/snap.rs:34-107): each
gzp block is re-framed as a complete snappy frame — stream identifier plus
compressed/uncompressed chunks — so concatenated blocks form a valid
stream (frame decoders skip repeated stream identifiers). Compression
level is ignored; there is no stream header/footer or stream checksum
(per-chunk masked CRC32C lives inside the frames).

Counterpart of ``gzp_tpu/formats/snap.py``'s write side; its streaming
frame decoder belongs to the read path, which this package does not have
yet (``utils/snappy_ref.py`` decodes frames for tests and the verify net).
"""

from __future__ import annotations

from gzp_tpu_torch import check as _check
from gzp_tpu_torch.constants import BUFSIZE, SNAPPY_MAX_CHUNK
from gzp_tpu_torch.formats.base import FormatSpec


class _Snap(FormatSpec):
    name = "snappy"
    check_cls = _check.PassThroughCheck
    codec = "snappy"
    kernel_mode = "snappy"
    default_bufsize = BUFSIZE
    needs_dict = False
    # one frame chunk per block lane: cap blocks at the 65536-byte chunk
    # size (the writer clamps larger requested buffer sizes)
    max_input_block = SNAPPY_MAX_CHUNK


Snap = _Snap()
