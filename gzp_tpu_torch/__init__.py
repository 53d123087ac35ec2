"""gzp_tpu_torch — parallel block compression on a CUDA GPU, in PyTorch.

The PyTorch/CUDA port of ``gzp_tpu``: the same builder and writer API and
byte-identical output. Blocks are compressed data-parallel as the batch
dimension of a device encoder whose LZ77 matcher and bit packer are
hand-written CUDA kernels (``csrc/``, built with ``nvcc`` at first use)
and whose other stages are plain PyTorch. Every format ``gzp_tpu``
compresses is written, at every level: Gzip, Zlib and raw Deflate streams
(with the 32 KiB dictionary carried across blocks), Mgzip and BGZF
members, and Snappy frames. The read side is ported too:
``ParDecompress`` decodes Mgzip and BGZF blocks in parallel on the host's
C++ inflate (or, with ``backend='device'``, with the CUDA inflate kernel),
``MultiGzDecoder`` reads any gzip stream, the sync readers read one block
at a time, and ``formats.snap.SnappyFrameDecoder`` reads Snappy frames.
Compression scales out too: ``ZBuilder(...).mesh(devices)`` splits each
batch over several devices (``MeshEncoder`` in ``parallel/mesh.py``), and
``parallel/multihost.py`` splits one stream over processes, each
compressing a contiguous block range, stitched in rank order. Entry
points run on ``cuda:0`` unless given another device; ``device="cpu"``
runs the plain versions on the CPU.

    >>> import io, gzip
    >>> from gzp_tpu_torch import ZBuilder, Mgzip
    >>> buf = io.BytesIO()
    >>> w = ZBuilder(Mgzip).num_threads(4).device("cpu").from_writer(buf)
    >>> _ = w.write(b"hello world " * 1000)
    >>> _ = w.finish()
    >>> gzip.decompress(buf.getvalue()) == b"hello world " * 1000
    True
    >>> from gzp_tpu_torch import ParDecompressBuilder
    >>> blocks = io.BytesIO()
    >>> w = ZBuilder(Mgzip).num_threads(2).device("cpu").from_writer(blocks)
    >>> _ = w.write(b"read me back " * 20000)
    >>> _ = w.finish()
    >>> _ = blocks.seek(0)
    >>> r = ParDecompressBuilder(Mgzip).num_threads(4).from_reader(blocks)
    >>> r.read() == b"read me back " * 20000
    True
"""

from gzp_tpu_torch.check import Adler32, Check, Crc32, Crc32C, PassThroughCheck  # noqa: F401
from gzp_tpu_torch.constants import BGZF_BLOCK_SIZE, BUFSIZE, DICT_SIZE  # noqa: F401
from gzp_tpu_torch.errors import (  # noqa: F401
    BlockSizeExceededError,
    BufferSizeError,
    ChannelError,
    CompressError,
    DecompressError,
    GzpError,
    InvalidCheckError,
    InvalidHeaderError,
    NumThreadsError,
    WriterClosedError,
)
from gzp_tpu_torch.formats import (  # noqa: F401
    ALL_FORMATS,
    Bgzf,
    BlockFormatSpec,
    FormatSpec,
    Gzip,
    Mgzip,
    RawDeflate,
    Snap,
    Zlib,
)
from gzp_tpu_torch.formats.sync_io import (  # noqa: F401
    BgzfSyncReader,
    BgzfSyncWriter,
    MgzipSyncReader,
    MgzipSyncWriter,
)
from gzp_tpu_torch.parallel.builder import ZBuilder  # noqa: F401
from gzp_tpu_torch.parallel.compress import ParCompress, ParCompressBuilder  # noqa: F401
from gzp_tpu_torch.parallel.decompress import (  # noqa: F401
    MultiGzDecoder,
    ParDecompress,
    ParDecompressBuilder,
    SyncBlockReader,
)
from gzp_tpu_torch.parallel.syncz import SyncZ, SyncZBuilder  # noqa: F401

__version__ = "0.1.0"
