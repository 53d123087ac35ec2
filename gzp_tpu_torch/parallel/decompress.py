"""Parallel block decompression — the ``ParDecompress`` equivalent.

Counterpart of ``gzp_tpu/parallel/decompress.py``. Reference architecture
(src/par/decompress.rs): a reader thread parses block headers (magic +
SID + BSIZE), fans complete compressed blocks out to decode workers, and
the caller's ``read()`` drains per-block results in stream order with
every block's CRC verified.

Here the header scan is a serial loop (the reference's reader thread) and
blocks are decoded by the package's own C++ inflate
(``runtime/native/gzptpu_native.cpp``) on a thread pool: ctypes releases
the GIL, so ``num_threads`` scales like the reference's worker pool.
Ordering comes from submission-order futures. ``backend='device'`` decodes
batches of blocks with K11 (``ops/inflate_kernel.py``) on a CUDA device.
"""

from __future__ import annotations

import io
import logging
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO

import numpy as np
import torch

from gzp_tpu_torch.errors import (
    DecompressError,
    InvalidBlockSizeError,
    InvalidCheckError,
    InvalidHeaderError,
    NumThreadsError,
)
from gzp_tpu_torch.formats.base import BlockFormatSpec
from gzp_tpu_torch.parallel.mesh import resolve_device
from gzp_tpu_torch.runtime import get_native
from gzp_tpu_torch.runtime.telemetry import span
from gzp_tpu_torch.utils.io import read_exact

DEFAULT_DECOMPRESS_THREADS = 8


def _decode_block(fmt: BlockFormatSpec, block: bytes) -> bytes:
    """Worker: inflate one framed block and verify its CRC
    (reference src/par/decompress.rs:161-187)."""
    native = get_native()
    fv = fmt.get_footer_values(block)
    payload = block[fmt.header_size : len(block) - 8]
    if fv.amount == 0:
        plain = b""
    else:
        plain = native.inflate(payload, fv.amount)
    crc = native.crc32(plain, 0)
    if crc != fv.sum:
        raise InvalidCheckError(found=crc, expected=fv.sum)
    return plain


class ParDecompress(io.RawIOBase):
    """Streaming reader decompressing a block format in parallel.

    Only block formats (Mgzip, BGZF) support this — plain gzip can't be
    split without decoding (reference: ParDecompress is bound by
    ``BlockFormatSpec``).

    ``backend='native'`` (default) fans blocks over the C++ inflate
    thread pool and needs no device. ``backend='device'`` decodes batches
    of ``max(num_threads, 8)`` blocks with K11 on ``device`` (default
    ``cuda:0``; ``"cpu"`` runs its plain version), each block's CRC32
    computed on the device. A block over the device caps, one that K11
    reports not ok, or one whose CRC does not match goes to the native
    path instead (which also raises the precise error for a corrupt
    block); every such block is counted in :attr:`fallback_stats` and the
    first one logs a warning. A kernel that fails to build or launch
    raises, and so does a block that K11 reports ok with a CRC that does
    not match while the native path restores it with the footer's CRC:
    that is a fault of K11, not of the data.
    """

    def __init__(
        self,
        format_spec: BlockFormatSpec,
        reader: BinaryIO,
        *,
        num_threads: int = DEFAULT_DECOMPRESS_THREADS,
        queue_depth: int | None = None,
        backend: str = "native",
        device: str | torch.device | None = None,
    ) -> None:
        if num_threads < 1:
            raise NumThreadsError(num_threads)
        if not isinstance(format_spec, BlockFormatSpec):
            raise TypeError(
                f"{format_spec.name} is not a block format; parallel "
                "decompression needs self-framed blocks (mgzip/bgzf)"
            )
        self.format = format_spec
        self.reader = reader
        self.backend = backend
        # bounded lookahead = backpressure (reference bounds its channels
        # at 2x num_threads, src/par/decompress.rs:70,142)
        self.queue_depth = queue_depth or num_threads * 2
        self._pending: list = []  # (device batch number or None for a block, future)
        self._seq = 0  # the next device batch's number, for its spans
        self._buffer = bytearray()
        self._eof = False
        self._closed = False
        # public telemetry: device-vs-native routing counts for
        # backend='device'; stays all-zero under backend='native'
        self.fallback_stats = {"device": 0, "native": 0}
        self._warned_fallback = False
        if backend == "device":
            self.device = resolve_device(device)
            self._device_batch = max(num_threads, 8)
            self.queue_depth = queue_depth or 2
        self.pool = ThreadPoolExecutor(max_workers=num_threads)

    # -- block scanning (the reference's reader thread, :194-210) --

    def _scan_one(self) -> bytes | None:
        # read-exact loops: pipes/sockets/raw files legally return short
        # (reference uses read_exact, src/par/decompress.rs:197-202)
        hdr = read_exact(self.reader, self.format.header_size)
        if not hdr:
            return None
        if len(hdr) < self.format.header_size:
            raise InvalidHeaderError("truncated block header")
        self.format.check_header(hdr)
        size = self.format.get_block_size(hdr)
        if size < self.format.header_size + 8:
            raise InvalidBlockSizeError(
                f"invalid block size {size} (< header + footer)"
            )
        rest = read_exact(self.reader, size - self.format.header_size)
        if len(rest) != size - self.format.header_size:
            raise DecompressError("truncated block body")
        return hdr + rest

    def _fill_pipeline(self) -> None:
        while not self._eof and len(self._pending) < self.queue_depth:
            if self.backend == "device":
                seq = self._seq
                with span("gzp.decompress.scan", seq):
                    batch = []
                    while len(batch) < self._device_batch:
                        block = self._scan_one()
                        if block is None:
                            self._eof = True
                            break
                        batch.append(block)
                    if batch:
                        # staging, dispatch and gather on a pool thread, so
                        # the caller's read() overlaps them with the next scan
                        self._seq += 1
                        self._pending.append((seq, self.pool.submit(
                            lambda blocks=batch: _DeviceBatch(self.format, blocks, self,
                                                              seq).result())))
            else:
                block = self._scan_one()
                if block is None:
                    self._eof = True
                    break
                self._pending.append((None, self.pool.submit(_decode_block, self.format, block)))

    def _next_chunk(self) -> bytes | None:
        self._fill_pipeline()
        if not self._pending:
            return None
        seq, fut = self._pending.pop(0)
        self._fill_pipeline()
        if seq is None:  # a block of the native backend: no span a block
            return fut.result()
        with span("gzp.decompress.wait", seq):
            return fut.result()

    # -- read API --

    def read(self, size: int = -1) -> bytes:
        if self._closed:
            raise ValueError("reader closed")
        if size is None or size < 0:
            if self.backend == "native":
                return self._read_all_native()
            chunks = [bytes(self._buffer)]
            self._buffer.clear()
            while True:
                c = self._next_chunk()
                if c is None:
                    break
                chunks.append(c)
            return b"".join(chunks)
        while len(self._buffer) < size:
            c = self._next_chunk()
            if c is None:
                break
            self._buffer += c
        out = bytes(self._buffer[:size])
        del self._buffer[:size]
        return out

    def _read_all_native(self) -> bytes:
        """read(-1): scan every remaining member up front, inflate each
        straight into its slice of one preallocated output buffer
        (``inflate_into``) and checksum the slices in place, so workers
        run GIL-free end to end and reassembly costs no copy. read(-1)
        materializes the whole stream either way, so the bounded queue of
        the streaming path has nothing to bound."""
        chunks = [bytes(self._buffer)]
        self._buffer.clear()
        pending, self._pending = self._pending, []
        chunks.extend(f.result() for _, f in pending)

        fmt = self.format
        blocks: list[bytes] = []
        offs = [0]
        while True:
            blk = self._scan_one()
            if blk is None:
                self._eof = True
                break
            blocks.append(blk)
            offs.append(offs[-1] + fmt.get_footer_values(blk).amount)
        out = bytearray(offs[-1])
        view = memoryview(out)
        native = get_native()

        def work(i: int) -> None:
            blk = blocks[i]
            fv = fmt.get_footer_values(blk)
            seg = view[offs[i] : offs[i + 1]]
            if fv.amount:
                written, _ = native.inflate_into(blk[fmt.header_size : len(blk) - 8], seg)
                if written != fv.amount:
                    raise DecompressError(
                        f"inflate produced {written} bytes, expected {fv.amount}"
                    )
            crc = native.crc32_view(seg)
            if crc != fv.sum:
                raise InvalidCheckError(found=crc, expected=fv.sum)

        futs = [self.pool.submit(work, i) for i in range(len(blocks))]
        for f in futs:
            f.result()
        if len(chunks) == 1 and not chunks[0]:
            return bytes(out)
        chunks.append(bytes(out))
        return b"".join(chunks)

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def finish(self) -> None:
        self.close()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.pool.shutdown(wait=False, cancel_futures=True)
        super().close()


def stage_blocks(fmt: BlockFormatSpec, blocks: list[bytes], in_cap: int, out_cap: int):
    """Framed blocks as the batched inflate's inputs: (payloads [n, in_cap]
    u8, in_lens [n] int32, out_lens [n] int32 (ISIZE), the indices of the
    blocks over either cap, whose rows stay empty)."""
    footers = [fmt.get_footer_values(blk) for blk in blocks]
    payloads = [blk[fmt.header_size : len(blk) - 8] for blk in blocks]
    over = {i for i, (p, fv) in enumerate(zip(payloads, footers))
            if len(p) > in_cap or fv.amount > out_cap}
    streams = np.zeros((len(blocks), in_cap), np.uint8)
    in_lens = np.zeros(len(blocks), np.int32)
    out_lens = np.zeros(len(blocks), np.int32)
    for i, (p, fv) in enumerate(zip(payloads, footers)):
        if i not in over:
            streams[i, : len(p)] = np.frombuffer(p, np.uint8)
            in_lens[i], out_lens[i] = len(p), fv.amount
    return streams, in_lens, out_lens, over


class _DeviceBatch:
    """One device-inflate batch, number ``seq`` of its reader: construction
    stages it and issues K11 (span ``gzp.decompress.stage``); ``result()``
    gathers the outputs, checks each block's CRC and sends each block the
    device did not decode to the native path (span
    ``gzp.decompress.gather``)."""

    # caps sized for BGZF/Mgzip members (a compressed BGZF member is < 64
    # KiB); larger foreign Mgzip blocks go to the native path
    IN_CAP = 65536
    OUT_CAP = 65536

    def __init__(self, fmt: BlockFormatSpec, blocks: list[bytes], owner: ParDecompress,
                 seq: int):
        from gzp_tpu_torch.ops.inflate_kernel import InflateConfig, get_inflater

        self.fmt = fmt
        self.blocks = blocks
        self.owner = owner
        self.seq = seq
        with span("gzp.decompress.stage", seq):
            self.footers = [fmt.get_footer_values(blk) for blk in blocks]
            *inputs, self.native_idx = stage_blocks(fmt, blocks, self.IN_CAP, self.OUT_CAP)
            self.res = None  # a batch wholly over the caps never reaches the device
            if len(self.native_idx) < len(blocks):
                run = get_inflater(InflateConfig(in_cap=self.IN_CAP, out_cap=self.OUT_CAP))
                self.res = run(*(torch.from_numpy(x).to(owner.device) for x in inputs))

    def result(self) -> bytes:
        with span("gzp.decompress.gather", self.seq):
            return self._gather()

    def _gather(self) -> bytes:
        if self.res is not None:
            out, ok, crc = (self.res[k].cpu().numpy() for k in ("out", "ok", "crc"))
        pieces = []
        # per-reader telemetry: the FIRST block routed to native warns
        stats = self.owner.fallback_stats
        batch_fallbacks = 0
        for i, blk in enumerate(self.blocks):
            fv = self.footers[i]
            decoded = i not in self.native_idx and bool(ok[i])
            if decoded and int(crc[i]) == fv.sum:
                stats["device"] += 1
                pieces.append(out[i, : fv.amount].tobytes())
                continue
            # the native path decodes again and raises precise errors
            stats["native"] += 1
            batch_fallbacks += 1
            plain = _decode_block(self.fmt, blk)
            if decoded:
                # ok means the device followed the same bits as the host
                # codec, which has now restored the block with its footer's
                # CRC: only a fault of the device decode gets here
                raise RuntimeError(
                    f"device inflate fault: block {i} of the batch decoded ok on "
                    f"{self.owner.device} with CRC {int(crc[i]):#010x}, but its "
                    f"{len(plain)} bytes have CRC {fv.sum:#010x} on the host codec"
                )
            pieces.append(plain)
        if batch_fallbacks and not self.owner._warned_fallback:
            self.owner._warned_fallback = True
            logging.getLogger("gzp_tpu_torch").warning(
                "backend='device': %d/%d blocks of this batch fell back "
                "to the native decoder (block over the device caps, or "
                "its data not ok for the device decode); totals so far: %r — consider "
                "backend='native'",
                batch_fallbacks, len(self.blocks), stats,
            )
        return b"".join(pieces)


class SyncBlockReader(io.RawIOBase):
    """Single-threaded block reader (``MgzipSyncReader``/``BgzfSyncReader``
    equivalents, reference src/mgzip.rs:327-376, src/bgzf.rs:359-408)."""

    def __init__(self, format_spec: BlockFormatSpec, reader: BinaryIO) -> None:
        self._par = ParDecompress(format_spec, reader, num_threads=1, queue_depth=1)

    def read(self, size: int = -1) -> bytes:
        return self._par.read(size)

    def readable(self) -> bool:
        return True

    def close(self) -> None:
        self._par.close()
        super().close()


class MultiGzDecoder(io.RawIOBase):
    """Streaming multi-member gzip decoder over the native inflate — the
    0-thread reader (reference maybe_par_from_reader returns flate2's
    MultiGzDecoder, src/par/decompress.rs:93-99).

    Handles arbitrary standard gzip streams (FEXTRA/FNAME/FCOMMENT/FHCRC),
    concatenated members included. Decodes one member at a time with
    bounded buffering: memory is O(largest member + read chunk), constant
    for multi-member streams, not O(stream).
    """

    _READ0 = 1 << 20

    def __init__(self, reader: BinaryIO) -> None:
        self.reader = reader
        self._in = bytearray()
        self._eof_in = False
        self._readsize = self._READ0
        self._pending = b""  # decoded bytes not yet handed to the caller

    def _fill(self) -> None:
        # loop to the full chunk size: short-read sources (pipes,
        # sockets) would otherwise add a few bytes per failed decode
        # attempt, turning member decoding quadratic
        want = self._readsize
        got = 0
        while got < want:
            chunk = self.reader.read(want - got)
            if not chunk:
                self._eof_in = True
                break
            self._in += chunk
            got += len(chunk)
        # grow so a large member is retried O(log) times, not O(n)
        self._readsize = min(self._readsize * 2, 1 << 27)

    def _next_member(self) -> bytes | None:
        """Decode the next complete member from the input buffer, reading
        more input as needed. None at clean end-of-stream."""
        native = get_native()
        while True:
            if self._in:
                try:
                    newpos, plain = self._decode_member(bytes(self._in), 0, native,
                                                        complete=self._eof_in)
                    del self._in[:newpos]
                    return plain
                except InvalidCheckError:
                    raise  # complete member, wrong CRC: real corruption
                except (DecompressError, InvalidHeaderError, ValueError, struct.error):
                    if self._eof_in:
                        raise  # truncated/garbage tail with no more input
            elif self._eof_in:
                return None
            self._fill()

    @staticmethod
    def _overflow_is_inside(payload: bytes, out: np.ndarray, native) -> bool:
        """Whether an inflate of ``payload`` that filled ``out`` (zeroed
        first) and overflowed did so inside ``payload``: it decodes again
        with eight 0xFF bytes after it in place of the zeros the codec
        reads past the end. A member that runs past its input decodes
        other garbage from them and writes other bytes; one that ends
        inside it never reads them and writes the same."""
        again = np.zeros_like(out)
        try:
            native.inflate_into(payload + b"\xff" * 8, memoryview(again))
        except DecompressError as e:
            if "overflow" not in str(e):
                return False
        return np.array_equal(out, again)

    @staticmethod
    def _decode_member(blob: bytes, pos: int, native, complete: bool = True
                       ) -> tuple[int, bytes]:
        if len(blob) - pos < 18:
            raise InvalidHeaderError("truncated gzip member")
        if blob[pos] != 0x1F or blob[pos + 1] != 0x8B or blob[pos + 2] != 8:
            raise InvalidHeaderError("bad gzip magic")
        flg = blob[pos + 3]
        p = pos + 10
        if flg & 4:  # FEXTRA
            xlen = struct.unpack_from("<H", blob, p)[0]
            p += 2 + xlen
        if flg & 8:  # FNAME
            p = blob.index(b"\x00", p) + 1
        if flg & 16:  # FCOMMENT
            p = blob.index(b"\x00", p) + 1
        if flg & 2:  # FHCRC
            p += 2
        # inflate with unknown output size: grow the buffer on overflow, up
        # to Deflate's largest output for the input (1032 bytes per input
        # byte) and never past gzp_tpu's limit. The host codec reads zeros
        # past the end of its input, so a member not yet wholly buffered
        # overflows too, on garbage: while more input may come, grow only
        # if the member ends inside the buffer, else the caller reads more
        # input and retries
        room = 1032 * (len(blob) - p) + (1 << 16)
        cap = max(4 * (len(blob) - p), 1 << 16)
        while True:
            out = np.zeros(cap, dtype=np.uint8)
            try:
                n, consumed = native.inflate_into(blob[p:], memoryview(out))
                break
            except DecompressError as e:
                if ("overflow" in str(e) and cap < min(room, 1 << 34)
                        and (complete or MultiGzDecoder._overflow_is_inside(blob[p:], out, native))):
                    cap *= 4
                    continue
                raise
        plain = out[:n].tobytes()
        fpos = p + consumed
        if len(blob) - fpos < 8:
            raise DecompressError("truncated gzip footer")
        crc_want, isize_want = struct.unpack_from("<II", blob, fpos)
        crc = native.crc32(plain, 0)
        if crc != crc_want:
            raise InvalidCheckError(found=crc, expected=crc_want)
        if (len(plain) & 0xFFFFFFFF) != isize_want:
            raise DecompressError("gzip ISIZE mismatch")
        return fpos + 8, plain

    def read(self, size: int = -1) -> bytes:
        parts = []
        have = 0
        if self._pending:
            parts.append(self._pending)
            have = len(self._pending)
            self._pending = b""
        while size < 0 or have < size:
            member = self._next_member()
            if member is None:
                break
            parts.append(member)
            have += len(member)
        out = b"".join(parts)
        if size >= 0 and len(out) > size:
            self._pending = out[size:]
            out = out[:size]
        return out

    def readable(self) -> bool:
        return True


class ParDecompressBuilder:
    """Mirror of the reference's ``ParDecompressBuilder``
    (src/par/decompress.rs:17-109): ``num_threads`` / ``buffer_size`` /
    ``queue_size`` / ``pin_threads`` knobs ahead of ``from_reader``."""

    def __init__(self, format_spec: BlockFormatSpec):
        self.format_spec = format_spec
        self._num_threads = DEFAULT_DECOMPRESS_THREADS
        self._queue_depth: int | None = None

    def num_threads(self, n: int) -> "ParDecompressBuilder":
        if n < 1:
            raise NumThreadsError(n)
        self._num_threads = n
        return self

    def buffer_size(self, size: int) -> "ParDecompressBuilder":
        """Validated for parity (reference src/par/decompress.rs:40-46);
        block reads are sized by each block's own framing, so the knob
        has no effect beyond validation here."""
        from gzp_tpu_torch.constants import DICT_SIZE
        from gzp_tpu_torch.errors import BufferSizeError

        if size < DICT_SIZE:
            raise BufferSizeError(size, DICT_SIZE)
        return self

    def queue_size(self, n: int) -> "ParDecompressBuilder":
        """Bounded lookahead (the reference's channel bound is
        ``2 * num_threads``, src/par/decompress.rs:70)."""
        if n < 1:
            raise ValueError(f"queue_size must be >= 1, got {n}")
        self._queue_depth = n
        return self

    def pin_threads(self, pin: int | None) -> "ParDecompressBuilder":
        # API parity no-op: the reference itself degrades to a warning
        # no-op on unsupported platforms (src/par/decompress.rs:57-66)
        del pin
        return self

    def from_reader(self, reader: BinaryIO) -> ParDecompress:
        return ParDecompress(
            self.format_spec,
            reader,
            num_threads=self._num_threads,
            queue_depth=self._queue_depth,
        )

    def maybe_par_from_reader(self, reader: BinaryIO, num_threads: int | None = None):
        """0 threads -> whole-stream MultiGzDecoder, else ParDecompress
        (reference src/par/decompress.rs:86-99)."""
        n = self._num_threads if num_threads is None else num_threads
        if n == 0:
            return MultiGzDecoder(reader)
        return ParDecompress(
            self.format_spec, reader, num_threads=n, queue_depth=self._queue_depth
        )
