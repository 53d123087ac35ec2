"""Block-parallel compression runtime — the ``ParCompress`` equivalent.

Counterpart of ``gzp_tpu/parallel/compress.py``. Reference architecture
(src/par/compress.rs): caller buffer accumulation, N compressor workers
fed over bounded channels, and an ordered writer stitching results. Here:

* the caller's ``write()`` accumulates bytes and cuts fixed-size blocks
  (reference ``ParCompress::write``, src/par/compress.rs:404-463);
* a *batch* of ``num_threads`` blocks is padded into a ``[B, N]`` uint8
  tensor, copied to the device from pinned memory and encoded there — the
  worker pool becomes the batch dimension of the device encoder; with a
  ``mesh`` of ``n`` devices each gets a contiguous ``B / n`` rows
  (:class:`MeshEncoder`);
* PyTorch queues device work asynchronously, so up to ``queue_depth``
  batches are in flight while the host stitches finished ones in
  submission order; on a card each batch's encoder is one CUDA graph
  replay (``ops/graphs.py``) and its results start for the host as soon
  as it is queued (:func:`start_fetch`);
* in stream mode (Gzip, Zlib, raw Deflate) every block carries the last
  32 KiB of the block before it as a halo its matches may reach into
  (reference src/par/compress.rs:417-423), across batches too;
* per-block checksums come back with each batch and are folded into the
  stream check by combine (pigz COMB, reference
  src/par/compress.rs:302-313), one cached shift operator per block length.

The encoder runs on ``cuda:0`` unless the caller passes another device;
``device="cpu"`` runs the same code on the CPU (the plain versions of the
kernels). There is no silent fallback: with no CUDA device and no
explicit CPU device, construction raises.

Failure semantics mirror the reference: any device/sink error poisons the
writer; later calls surface the root error (src/par/compress.rs:428-457),
and ``close()``/GC finalizes the stream if the user forgets
(src/par/compress.rs:391-402).
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import BinaryIO

import numpy as np
import torch

from gzp_tpu_torch.constants import DEFAULT_COMPRESSION_LEVEL, DICT_SIZE, clamp_compression_level
from gzp_tpu_torch.errors import (
    BlockSizeExceededError,
    BufferSizeError,
    ChannelError,
    NumThreadsError,
    WriterClosedError,
)
from gzp_tpu_torch.formats.base import BlockFormatSpec, FormatSpec
from gzp_tpu_torch.parallel.mesh import MeshEncoder
from gzp_tpu_torch.runtime.telemetry import recording, span

DEFAULT_NUM_THREADS = 16
DEFAULT_QUEUE_DEPTH = 3

# blocks ``ParCompress._stitch_batch`` emitted and those ``_maybe_fallback``
# rewrote stored (a stored Deflate block or member, an uncompressed Snappy
# chunk), counted only while a profiler records, as the spans are
stored_stats = {"blocks": 0, "stored": 0}
_stats_lock = threading.Lock()  # writers on several threads share the counts


def reset_stored_stats() -> None:
    """Zero ``stored_stats``."""
    with _stats_lock:
        stored_stats.update(blocks=0, stored=0)


# rows ``ParCompress._dispatch`` sent with data where blocks carry a
# dictionary, their bytes and their dictionaries' bytes, counted only while a
# profiler records, as the spans are
halo_stats = {"blocks": 0, "block_bytes": 0, "dict_bytes": 0}


def reset_halo_stats() -> None:
    """Zero ``halo_stats``."""
    with _stats_lock:
        halo_stats.update(blocks=0, block_bytes=0, dict_bytes=0)


def make_halo(arr: np.ndarray, lengths: np.ndarray, carry: bytes, dict_size: int):
    """Per-block preset dictionaries of ``dict_size`` bytes: row i gets the
    trailing bytes of row i-1 (right-aligned); row 0 gets ``carry``, the
    tail of the previous batch. Returns (halo [B, D] u8, dict_lens [B]
    i32), or (None, None) with no dictionary."""
    d = dict_size
    if not d:
        return None, None
    b = arr.shape[0]
    halo = np.zeros((b, d), dtype=np.uint8)
    dict_lens = np.zeros(b, dtype=np.int32)
    if carry:
        cl = min(len(carry), d)
        halo[0, d - cl:] = np.frombuffer(carry[-cl:], np.uint8)
        dict_lens[0] = cl
    # row i gets arr[i-1, pl-cl : pl] right-aligned
    for i, pl in enumerate(lengths[:-1].tolist(), 1):
        cl = min(pl, d)
        halo[i, d - cl:] = arr[i - 1, pl - cl: pl]
        dict_lens[i] = cl
    return halo, dict_lens


def start_fetch(res: dict):
    """Start copying an encoded share's ``out_len``, ``check`` and ``flat`` to
    the host; returns ``fetch()``, which waits for them and returns them as
    numpy arrays. On a CUDA device they are copied into pinned memory at
    once, on the stream of the share's work and ahead of any batch queued
    after it, so a fetch waits for its own batch alone (a copy queued at
    fetch time would wait for every batch queued before it, and the batches
    in flight would not overlap the host's work). The whole ``flat`` is
    copied: its used length is not known yet."""
    keys = ("out_len", "check", "flat")
    dev = res["flat"].device
    if dev.type != "cuda":
        return lambda: {k: res[k].numpy() for k in keys}
    host = {}
    for k in keys:
        host[k] = torch.empty(res[k].shape, dtype=res[k].dtype, pin_memory=True)
        host[k].copy_(res[k], non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))

    def fetch() -> dict:
        done.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    return fetch


def update_carry(arr: np.ndarray, lengths: np.ndarray, carry: bytes, dict_size: int,
                 count: int) -> bytes:
    """The carry after a batch of ``count`` real rows: the last ``dict_size``
    bytes of its last row (``carry`` itself with no dictionary, no row or
    an empty last row)."""
    if not dict_size or count == 0:
        return carry
    pl = int(lengths[count - 1])
    cl = min(pl, dict_size)
    return arr[count - 1, pl - cl: pl].tobytes() if cl else carry


class ParCompress:
    """Streaming writer compressing blocks in parallel on a device.

    File-like: ``write``, ``flush``, ``finish``, ``close``, context manager.
    ``finish()`` finalizes the stream and returns the underlying writer
    (reference ``ZWriter::finish``, src/lib.rs:166-170).

    ``mesh`` — a sequence of devices in the place of ``device`` — splits
    each batch over them: ``num_threads`` is rounded up to a multiple of
    their number, and device ``k`` encodes the ``k``-th contiguous share
    of the batch's rows. A device may appear more than once. The bytes
    are those of one device.

    Shard-mode knobs (used by ``parallel/multihost.py``, where one process
    compresses a contiguous mid-stream block range):

    * ``emit_header=False``  — suppress the stream header (rank > 0)
    * ``emit_footer=False``  — suppress trailer+footer (a stitcher emits
      them once with the combined check)
    * ``final_on_finish=False`` — ``finish()`` dispatches the tail as a
      non-final block (the stream continues in the next shard)
    * ``preset_carry``       — preset the 32 KiB dictionary from the
      previous shard's trailing input bytes
    * ``use_dict=False``     — no dictionary carried across blocks

    ``verify=True`` oracle-decodes every emitted block on the host and
    swaps in an uncompressed encoding on any mismatch (``verify_stats``
    counts checks and repairs).
    """

    def __init__(
        self,
        format_spec: FormatSpec,
        writer: BinaryIO,
        *,
        num_threads: int = DEFAULT_NUM_THREADS,
        compression_level: int = DEFAULT_COMPRESSION_LEVEL,
        buffer_size: int | None = None,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        device: str | torch.device | None = None,
        mesh=None,
        use_dict: bool = True,
        emit_header: bool = True,
        emit_footer: bool = True,
        final_on_finish: bool = True,
        preset_carry: bytes = b"",
        verify: bool = False,
    ) -> None:
        if num_threads < 1:
            raise NumThreadsError(num_threads)
        buffer_size = buffer_size or format_spec.default_bufsize
        if buffer_size < DICT_SIZE:
            # reference ParCompressBuilder::buffer_size (src/par/compress.rs:68-74)
            raise BufferSizeError(buffer_size, DICT_SIZE)
        if format_spec.max_input_block is not None:
            buffer_size = min(buffer_size, format_spec.max_input_block)

        self.format = format_spec
        self.writer = writer
        self.level = clamp_compression_level(compression_level)
        self.block_size = buffer_size
        self.batch = num_threads
        self.queue_depth = queue_depth
        self._verify = verify
        self.verify_stats = {"checked": 0, "repaired": 0}
        self._oracle = format_spec.oracle() if verify else None
        self._emit_footer = emit_footer
        self._final_on_finish = final_on_finish
        self._buffer = bytearray()
        self._carry = preset_carry[-DICT_SIZE:] if preset_carry else b""
        self._inflight: collections.deque = collections.deque()
        self._seq = 0  # the next batch's number, for its spans
        self._check = format_spec.create_check()
        self._header_written = not emit_header
        self._finished = False
        self._error: BaseException | None = None
        self._wrote_final_block = False
        self._emitted_any = False

        encoder, self._dict_size = format_spec.encoder(self.block_size, self.level, use_dict)
        if device is not None and mesh is not None:
            raise ValueError("pass a device or a mesh, not both")
        # one device is a mesh of one; the batch rounds up to a multiple of
        # the mesh (gzp_tpu/parallel/compress.py:187-188)
        self._mesh = MeshEncoder(encoder, [device] if mesh is None else mesh)
        self.device = self._mesh.devices[0] if mesh is None else None
        self.batch = -(-self.batch // len(self._mesh)) * len(self._mesh)

    # ------------------------------------------------------------------
    # io.RawIOBase-ish surface
    # ------------------------------------------------------------------

    def write(self, data) -> int:
        self._ensure_open()
        self._buffer += data
        batch_bytes = self.block_size * self.batch
        while len(self._buffer) >= batch_bytes:
            seq, self._seq = self._seq, self._seq + 1
            with span("gzp.compress.dispatch", seq):
                chunk = self._buffer[:batch_bytes]
                del self._buffer[:batch_bytes]
                arr = np.frombuffer(chunk, dtype=np.uint8).reshape(self.batch, self.block_size)
                self._dispatch(seq, arr, np.full(self.batch, self.block_size, dtype=np.int32),
                               np.zeros(self.batch, dtype=bool))
            self._drain(self.queue_depth)
        return len(data)

    def flush(self) -> None:
        """Push all buffered bytes through the device (a partial block is
        emitted as its own non-final block), drain, flush the sink."""
        self._ensure_open()
        if self._buffer:
            self._dispatch_tail(bytes(self._buffer), final=False)
            self._buffer.clear()
        self._drain(0)
        self.writer.flush()

    def finish(self):
        """Finalize the stream; returns the underlying writer."""
        if self._finished:
            return self.writer
        self._ensure_open()
        data = bytes(self._buffer)
        self._buffer.clear()
        self._dispatch_tail(data, final=self._final_on_finish)
        self._drain(0)
        if not self._header_written:
            self._write_header()
        if self._emit_footer:
            trailer = self.format.trailer_bytes()
            if trailer:
                self.writer.write(trailer)
            footer = self.format.footer(self._check)
            if footer:
                self.writer.write(footer)
        self._finished = True
        return self.writer

    @property
    def check(self):
        """The running stream checksum (combined across emitted blocks)."""
        return self._check

    def close(self) -> None:
        if not self._finished and self._error is None:
            self.finish()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.finish()

    def __del__(self):  # drop-implies-finish (reference src/par/compress.rs:391-402)
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    # pipeline internals
    # ------------------------------------------------------------------

    def _ensure_open(self) -> None:
        if self._finished:
            raise WriterClosedError("writer already finished")
        if self._error is not None:
            raise ChannelError("compression pipeline failed") from self._error

    def _write_header(self) -> None:
        hdr = self.format.header(self.level)
        if hdr:
            self.writer.write(hdr)
        self._header_written = True

    def _dispatch_tail(self, data: bytes, final: bool) -> None:
        """Dispatch remaining bytes, padding the batch; marks the last real
        block final when closing the stream. A final call with no data still
        dispatches one empty final block: it closes a deflate stream (BFINAL),
        is a Snappy stream's identifier-only frame, and is the empty member of
        an empty Mgzip/BGZF input (reference flush_last,
        src/par/compress.rs:332-341). A non-empty member stream needs no
        closing block, so none is encoded."""
        n, b = self.block_size, self.batch
        if not data and (not final or self._wrote_final_block):
            return
        if (not data and isinstance(self.format, BlockFormatSpec)
                and (self._emitted_any or self._inflight)):
            return
        while True:
            seq, self._seq = self._seq, self._seq + 1
            with span("gzp.compress.dispatch", seq):
                take, data = data[: n * b], data[n * b:]
                cnt = -(-len(take) // n) if take else 1
                arr = np.zeros((b, n), dtype=np.uint8)
                lengths = np.zeros(b, dtype=np.int32)
                finals = np.zeros(b, dtype=bool)
                for i in range(cnt):
                    piece = take[i * n: (i + 1) * n]
                    arr[i, : len(piece)] = np.frombuffer(piece, dtype=np.uint8)
                    lengths[i] = len(piece)
                if final and not data:
                    finals[cnt - 1] = True
                    self._wrote_final_block = True
                self._dispatch(seq, arr, lengths, finals, count=cnt)
            self._drain(self.queue_depth)
            if not data:
                return

    def _dispatch(self, seq: int, arr, lengths, finals, count: int | None = None) -> None:
        """Launch batch ``seq`` and queue it; the caller drains the queue
        to its depth."""
        # the halo spans the whole batch before a mesh splits it: the first
        # row of a device's share gets the last row of the share before
        halo, dict_lens = make_halo(arr, lengths, self._carry, self._dict_size)
        if halo is not None and recording():
            full = lengths > 0
            with _stats_lock:
                halo_stats["blocks"] += int(full.sum())
                halo_stats["block_bytes"] += int(lengths.sum())
                halo_stats["dict_bytes"] += int(dict_lens[full].sum())
        self._carry = update_carry(arr, lengths, self._carry, self._dict_size,
                                   count or len(lengths))
        args = [arr, lengths, finals] + ([halo, dict_lens] if halo is not None else [])
        try:
            fetches = [start_fetch(res) for res in self._mesh(*args)]
        except Exception as e:  # launch failure
            self._error = e
            raise
        self._inflight.append((seq, fetches, arr, lengths, finals, count or len(lengths)))

    def _drain(self, depth: int) -> None:
        """Stitch the oldest batches until ``depth`` are in flight."""
        while len(self._inflight) > depth:
            self._consume_one()

    def _consume_one(self) -> None:
        seq, fetches, arr, lengths, finals, count = self._inflight.popleft()
        try:
            with span("gzp.compress.fetch", seq):
                # sum(out_len) bytes of each device's share, not the padded
                # rows; the shares end to end in device order
                got = [fetch() for fetch in fetches]
                lens = [g["out_len"] for g in got]
                chks = np.concatenate([g["check"] for g in got])
                flats = [g["flat"][: int(n.sum())] for g, n in zip(got, lens)]
            with span("gzp.compress.stitch", seq):
                out_len = np.concatenate(lens)
                flat = flats[0] if len(flats) == 1 else np.concatenate(flats)
                starts = np.cumsum(out_len) - out_len

                def get_blob(i):
                    s = int(starts[i])
                    return flat[s: s + int(out_len[i])].tobytes()

                if not self._header_written:
                    self._write_header()
                self._stitch_batch(get_blob, chks, arr, lengths, finals, count)
        except Exception as e:
            # poison the writer; the root error is preserved and re-raised
            # (reference error-transparency, src/par/compress.rs:428-457)
            self._error = e
            raise

    def _stitch_batch(self, get_blob, chks, arr, lengths, finals, count) -> None:
        pieces: list[bytes] = []
        sums: list[tuple[int, int]] = []  # each emitted block's (check, length), in order
        stored = 0  # blocks ``_maybe_fallback`` rewrote stored
        for i in range(count):
            ln = int(lengths[i])
            fin = bool(finals[i])
            if ln == 0 and not fin:
                continue  # padding block
            if ln == 0 and isinstance(self.format, BlockFormatSpec) and self._emitted_any:
                # members need no closing block; only an entirely empty
                # stream gets one empty member
                continue
            blob = get_blob(i)
            raw = arr[i, :ln].tobytes()
            chk = int(chks[i])
            fitted = self._maybe_fallback(blob, raw, ln, fin, chk)
            stored += fitted is not blob
            blob = fitted
            if self._verify:
                blob, chk = self._verify_or_repair(blob, raw, ln, fin, chk)
            sums.append((chk, ln))
            pieces.append(blob)
            self._emitted_any = True
        with span("gzp.compress.combine"):
            for chk, ln in sums:
                self._check.combine_sum(chk, ln)
        if recording():
            with _stats_lock:
                stored_stats["blocks"] += len(sums)
                stored_stats["stored"] += stored
        if pieces:
            self.writer.write(b"".join(pieces))

    def _verify_or_repair(self, blob: bytes, raw: bytes, ln: int, final: bool, chk: int
                          ) -> tuple[bytes, int]:
        """Oracle-decode ``blob`` (``FormatSpec.oracle``); on any mismatch
        re-emit the block uncompressed (``FormatSpec.stored_block``) with the
        host's check of it, and start a new oracle on the repaired bytes."""
        self.verify_stats["checked"] += 1
        try:
            ok = self._oracle(blob, raw)
        except Exception:  # noqa: BLE001 - any decode error means repair
            ok = False
        if ok:
            return blob, chk
        self.verify_stats["repaired"] += 1
        logging.getLogger("gzp_tpu_torch").warning(
            "verify: device-encoded block failed oracle decode; "
            "re-emitting stored (totals: %r)", self.verify_stats,
        )
        blob = self.format.stored_block(raw, final, self.level, chk)
        self._oracle = self.format.oracle(blob)
        return blob, self.format.host_check(raw, chk)

    def _maybe_fallback(self, blob: bytes, raw: bytes, ln: int, final: bool, chk: int
                        ) -> bytes:
        """Swap in the uncompressed encoding when it is smaller (the
        per-block stored/compressed choice zlib makes; ``stored_len`` is its
        length); enforce the format's cap on a block (BGZF, reference
        src/bgzf.rs:218-223)."""
        if ln and len(blob) > self.format.stored_len(ln):
            blob = self.format.stored_block(raw, final, self.level, chk)
        cap = self.format.max_block_bytes
        if cap is not None and len(blob) >= cap:
            raise BlockSizeExceededError(len(blob), cap)
        return blob


class ParCompressBuilder:
    """Builder mirroring the reference's ``ParCompressBuilder``
    (src/par/compress.rs:33-204), with ``device`` beside ``mesh`` (a
    sequence of torch devices; see ``ParCompress``)."""

    def __init__(self, format_spec: FormatSpec):
        self.format_spec = format_spec
        self._num_threads = DEFAULT_NUM_THREADS
        self._level = DEFAULT_COMPRESSION_LEVEL
        self._buffer_size: int | None = None
        self._device: str | torch.device | None = None
        self._mesh = None
        self._queue_depth = DEFAULT_QUEUE_DEPTH
        self._verify = False

    def num_threads(self, n: int) -> "ParCompressBuilder":
        if n < 1:
            raise NumThreadsError(n)
        self._num_threads = n
        return self

    def compression_level(self, level: int) -> "ParCompressBuilder":
        self._level = level
        return self

    def buffer_size(self, size: int) -> "ParCompressBuilder":
        if size < DICT_SIZE:
            raise BufferSizeError(size, DICT_SIZE)
        self._buffer_size = size
        return self

    def pin_threads(self, _pin: int | None) -> "ParCompressBuilder":
        # No-op: the device replaces CPU pinning (reference
        # src/lib.rs:221-230 logs and continues).
        return self

    def device(self, device: str | torch.device | None) -> "ParCompressBuilder":
        """Device to compress on (default ``cuda:0``; ``"cpu"`` to run the
        plain versions on the CPU)."""
        self._device = device
        return self

    def mesh(self, devices) -> "ParCompressBuilder":
        """Devices to split each batch over (``None``: one device)."""
        self._mesh = devices
        return self

    def queue_depth(self, depth: int) -> "ParCompressBuilder":
        self._queue_depth = max(1, depth)
        return self

    def verify(self, on: bool = True) -> "ParCompressBuilder":
        """Inflate every block on the host and repair mismatches with
        stored members (see ``ParCompress(verify=...)``)."""
        self._verify = on
        return self

    def from_writer(self, writer: BinaryIO) -> ParCompress:
        return ParCompress(
            self.format_spec,
            writer,
            num_threads=self._num_threads,
            compression_level=self._level,
            buffer_size=self._buffer_size,
            queue_depth=self._queue_depth,
            device=self._device,
            mesh=self._mesh,
            verify=self._verify,
        )
