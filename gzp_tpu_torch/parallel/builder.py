"""Unified auto-dispatch builder — the ``ZBuilder`` equivalent
(reference src/lib.rs:181-265): picks the parallel writer when
``num_threads > 1``, else the single-block writer, behind one API.
Counterpart of ``gzp_tpu/parallel/builder.py``, with ``device`` (one
torch device) beside ``mesh`` (a sequence of them).
"""

from __future__ import annotations

from typing import BinaryIO

import torch

from gzp_tpu_torch.constants import DEFAULT_COMPRESSION_LEVEL
from gzp_tpu_torch.formats.base import FormatSpec
from gzp_tpu_torch.parallel.compress import DEFAULT_NUM_THREADS, ParCompressBuilder
from gzp_tpu_torch.parallel.syncz import SyncZBuilder


class ZBuilder:
    """``ZBuilder(Mgzip).num_threads(64).from_writer(f)`` -> writer object.

    ``num_threads`` keeps the reference's contract (0/1 -> single-block
    path, reference src/lib.rs:246-263); for the parallel path it sets the
    number of blocks compressed per device dispatch. ``device`` picks the
    device (default ``cuda:0``; ``"cpu"`` runs on the CPU); ``mesh`` splits
    each batch over a sequence of devices instead (the parallel path only).

    >>> import io, gzip
    >>> from gzp_tpu_torch import ZBuilder, Mgzip
    >>> buf = io.BytesIO()
    >>> w = ZBuilder(Mgzip).num_threads(2).device("cpu").from_writer(buf)
    >>> _ = w.write(b"block framed " * 512)
    >>> _ = w.finish()
    >>> gzip.decompress(buf.getvalue()) == b"block framed " * 512
    True
    """

    def __init__(self, format_spec: FormatSpec):
        self.format_spec = format_spec
        self._num_threads = DEFAULT_NUM_THREADS
        self._level = DEFAULT_COMPRESSION_LEVEL
        self._buffer_size: int | None = None
        self._device: str | torch.device | None = None
        self._mesh = None

    def num_threads(self, n: int) -> "ZBuilder":
        self._num_threads = n
        return self

    def compression_level(self, level: int) -> "ZBuilder":
        self._level = level
        return self

    def buffer_size(self, size: int) -> "ZBuilder":
        self._buffer_size = size
        return self

    def pin_threads(self, pin: int | None) -> "ZBuilder":
        # Kept for API parity; thread pinning is meaningless on a device
        # (the reference also degrades to a no-op, src/lib.rs:221-230).
        return self

    def device(self, device: str | torch.device | None) -> "ZBuilder":
        self._device = device
        return self

    def mesh(self, devices) -> "ZBuilder":
        self._mesh = devices
        return self

    def from_writer(self, writer: BinaryIO):
        if self._num_threads > 1:
            b = (
                ParCompressBuilder(self.format_spec)
                .num_threads(self._num_threads)
                .compression_level(self._level)
                .device(self._device)
                .mesh(self._mesh)
            )
        else:
            b = (
                SyncZBuilder(self.format_spec)
                .compression_level(self._level)
                .device(self._device)
            )
        if self._buffer_size is not None:
            b = b.buffer_size(self._buffer_size)
        return b.from_writer(writer)
