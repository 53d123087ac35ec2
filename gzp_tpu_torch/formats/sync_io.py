"""Named single-threaded block-format readers/writers.

Counterpart of ``gzp_tpu/formats/sync_io.py``: API-parity wrappers over
the generic sync machinery, matching the reference's
``MgzipSyncWriter``/``MgzipSyncReader`` (reference src/mgzip.rs:79-129,
287-376) and ``BgzfSyncWriter``/``BgzfSyncReader`` (reference
src/bgzf.rs:95-146, 315-408). The writers compress on ``cuda:0`` unless
given ``device``.
"""

from __future__ import annotations

from typing import BinaryIO

import torch

from gzp_tpu_torch.constants import DEFAULT_COMPRESSION_LEVEL
from gzp_tpu_torch.formats.deflate_formats import Bgzf, Mgzip
from gzp_tpu_torch.parallel.decompress import SyncBlockReader
from gzp_tpu_torch.parallel.syncz import SyncZ


class MgzipSyncWriter(SyncZ):
    def __init__(self, writer: BinaryIO, compression_level: int = DEFAULT_COMPRESSION_LEVEL,
                 device: str | torch.device | None = None):
        super().__init__(Mgzip, writer, compression_level=compression_level, device=device)


class BgzfSyncWriter(SyncZ):
    """Asserts the BGZF 65280-byte input block cap via the format spec
    (reference src/bgzf.rs:124)."""

    def __init__(self, writer: BinaryIO, compression_level: int = DEFAULT_COMPRESSION_LEVEL,
                 device: str | torch.device | None = None):
        super().__init__(Bgzf, writer, compression_level=compression_level, device=device)


class MgzipSyncReader(SyncBlockReader):
    def __init__(self, reader: BinaryIO):
        super().__init__(Mgzip, reader)


class BgzfSyncReader(SyncBlockReader):
    def __init__(self, reader: BinaryIO):
        super().__init__(Bgzf, reader)
