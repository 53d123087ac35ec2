"""Single-block writer — the ``SyncZ`` equivalent.

Counterpart of ``gzp_tpu/parallel/syncz.py``. The reference's SyncZ wraps
each format's native streaming encoder (reference src/syncz.rs:13-88) to
give the 0/1-thread path the same ``ZWriter`` API. Here the device is the
encoder, so SyncZ is the same pipeline at its minimum width: one block per
dispatch, queue depth 1.
"""

from __future__ import annotations

from typing import BinaryIO

import torch

from gzp_tpu_torch.constants import DEFAULT_COMPRESSION_LEVEL
from gzp_tpu_torch.formats.base import FormatSpec
from gzp_tpu_torch.parallel.compress import ParCompress


class SyncZ(ParCompress):
    def __init__(
        self,
        format_spec: FormatSpec,
        writer: BinaryIO,
        *,
        compression_level: int = DEFAULT_COMPRESSION_LEVEL,
        buffer_size: int | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(
            format_spec,
            writer,
            num_threads=1,
            compression_level=compression_level,
            buffer_size=buffer_size,
            queue_depth=1,
            device=device,
        )


class SyncZBuilder:
    """Mirror of the reference's ``SyncZBuilder`` (src/syncz.rs:13-57)."""

    def __init__(self, format_spec: FormatSpec):
        self.format_spec = format_spec
        self._level = DEFAULT_COMPRESSION_LEVEL
        self._buffer_size: int | None = None
        self._device: str | torch.device | None = None

    def compression_level(self, level: int) -> "SyncZBuilder":
        self._level = level
        return self

    def buffer_size(self, size: int) -> "SyncZBuilder":
        self._buffer_size = size
        return self

    def device(self, device: str | torch.device | None) -> "SyncZBuilder":
        self._device = device
        return self

    def from_writer(self, writer: BinaryIO) -> SyncZ:
        return SyncZ(
            self.format_spec,
            writer,
            compression_level=self._level,
            buffer_size=self._buffer_size,
            device=self._device,
        )
