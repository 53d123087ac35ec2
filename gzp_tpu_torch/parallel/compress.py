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
  submission order;
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
import zlib
from typing import BinaryIO

import numpy as np
import torch

from gzp_tpu_torch.constants import (
    DEFAULT_COMPRESSION_LEVEL,
    DICT_SIZE,
    MAX_BGZF_BLOCK_SIZE,
    SNAPPY_STREAM_IDENTIFIER,
    clamp_compression_level,
)
from gzp_tpu_torch.errors import (
    BlockSizeExceededError,
    BufferSizeError,
    ChannelError,
    NumThreadsError,
    WriterClosedError,
)
from gzp_tpu_torch.formats.base import FormatSpec
from gzp_tpu_torch.ops import host_codec
from gzp_tpu_torch.ops.deflate_kernel import DeflateEncodeConfig, get_encoder
from gzp_tpu_torch.ops.snappy_kernel import SnappyEncodeConfig, get_snappy_encoder
from gzp_tpu_torch.runtime.telemetry import recording, span
from gzp_tpu_torch.utils.serialize import put_le
from gzp_tpu_torch.utils.snappy_ref import decode_frames

DEFAULT_NUM_THREADS = 16
DEFAULT_QUEUE_DEPTH = 3

# blocks ``ParCompress._stitch_batch`` emitted and those ``_maybe_fallback``
# rewrote stored (a stored Deflate block or member, an uncompressed Snappy
# chunk), counted only while a profiler records, as the spans are
stored_stats = {"blocks": 0, "stored": 0}
_stored_lock = threading.Lock()  # writers on several threads share the counts


def reset_stored_stats() -> None:
    """Zero ``stored_stats``."""
    with _stored_lock:
        stored_stats.update(blocks=0, stored=0)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda:0``. A CUDA device with no CUDA available raises:
    the CPU is used only when the caller asks for it."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to compress on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``; to a CUDA device from pinned memory, so the
    copy is asynchronous."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class MeshEncoder:
    """``encoder`` run on each device of ``devices`` over its contiguous
    share of the batch (gzp_tpu shards the batch axis over its mesh,
    ``gzp_tpu/parallel/compress.py:177-188``).

    ``MeshEncoder(encoder, devices)(*host_arrays)`` takes the host arrays
    of one batch (each with the batch as its first axis, whose length
    must be a multiple of the number of devices), copies device ``k``'s
    rows ``[k * B / n, (k + 1) * B / n)`` to it with :func:`to_device`,
    encodes them there, and returns one result dict per device, in device
    order. Outputs stay on their device until the host fetches them; there
    are no copies between devices. A device may appear more than once.
    """

    def __init__(self, encoder, devices):
        self.encoder = encoder
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    def __len__(self) -> int:
        return len(self.devices)

    def __call__(self, *arrays: np.ndarray) -> list[dict]:
        b, n = len(arrays[0]), len(self.devices)
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} devices")
        per = b // n
        return [
            self.encoder(*(to_device(a[k * per: (k + 1) * per], dev) for a in arrays))
            for k, dev in enumerate(self.devices)
        ]


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
        self._verify_stream = None  # incremental inflater of the stream-mode oracle
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

        if format_spec.codec == "deflate":
            checksum = {"crc32": "crc32", "adler32": "adler32"}.get(
                format_spec.check_cls().name, "none")
            stream = format_spec.kernel_mode == "stream"
            dict_size = DICT_SIZE if use_dict and format_spec.needs_dict and stream else 0
            self._cfg = DeflateEncodeConfig.for_level(
                block_len=self.block_size, mode=format_spec.kernel_mode,
                checksum=checksum, level=self.level, dict_size=dict_size,
            )
            self._encoder = get_encoder(self._cfg, compact=True)
        elif format_spec.codec == "snappy":
            self._cfg = SnappyEncodeConfig(block_len=self.block_size)
            self._encoder = get_snappy_encoder(self._cfg)
        else:
            raise ValueError(f"unknown codec {format_spec.codec}")

        if device is not None and mesh is not None:
            raise ValueError("pass a device or a mesh, not both")
        # one device is a mesh of one; the batch rounds up to a multiple of
        # the mesh (gzp_tpu/parallel/compress.py:187-188)
        self._mesh = MeshEncoder(self._encoder, [device] if mesh is None else mesh)
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

    @property
    def _member(self) -> bool:
        return self.format.kernel_mode in ("mgzip", "bgzf")

    def _make_halo(self, arr: np.ndarray, lengths: np.ndarray):
        """Per-block preset dictionaries: row i gets the trailing bytes of
        row i-1 (right-aligned); row 0 gets the carry from the previous
        batch. Returns (halo [B, D] u8, dict_lens [B] i32) or (None, None)."""
        d = getattr(self._cfg, "dict_size", 0)
        if not d:
            return None, None
        b = arr.shape[0]
        halo = np.zeros((b, d), dtype=np.uint8)
        dict_lens = np.zeros(b, dtype=np.int32)
        if self._carry:
            cl = min(len(self._carry), d)
            halo[0, d - cl:] = np.frombuffer(self._carry[-cl:], np.uint8)
            dict_lens[0] = cl
        # row i gets arr[i-1, pl-cl : pl] right-aligned
        for i, pl in enumerate(lengths[:-1].tolist(), 1):
            cl = min(pl, d)
            halo[i, d - cl:] = arr[i - 1, pl - cl: pl]
            dict_lens[i] = cl
        return halo, dict_lens

    def _update_carry(self, arr: np.ndarray, lengths: np.ndarray, count: int) -> None:
        d = getattr(self._cfg, "dict_size", 0)
        if not d or count == 0:
            return
        pl = int(lengths[count - 1])
        cl = min(pl, d)
        if cl:
            self._carry = arr[count - 1, pl - cl: pl].tobytes()

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
        if not data and self._member and (self._emitted_any or self._inflight):
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
        halo, dict_lens = self._make_halo(arr, lengths)
        self._update_carry(arr, lengths, count or len(lengths))
        args = [arr, lengths, finals] + ([halo, dict_lens] if halo is not None else [])
        try:
            res = self._mesh(*args)
        except Exception as e:  # launch failure
            self._error = e
            raise
        self._inflight.append((seq, res, arr, lengths, finals, count or len(lengths)))

    def _drain(self, depth: int) -> None:
        """Stitch the oldest batches until ``depth`` are in flight."""
        while len(self._inflight) > depth:
            self._consume_one()

    def _consume_one(self) -> None:
        seq, res, arr, lengths, finals, count = self._inflight.popleft()
        try:
            with span("gzp.compress.fetch", seq):
                # fetch exactly sum(out_len) bytes of each device's share,
                # not the padded rows; the shares end to end in device order
                lens = [r["out_len"].cpu().numpy() for r in res]
                chks = np.concatenate([r["check"].cpu().numpy() for r in res])
                flats = [r["flat"][: int(n.sum())].cpu().numpy() for r, n in zip(res, lens)]
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
            if ln == 0 and self._member and self._emitted_any:
                # member formats need no closing block; only an entirely
                # empty stream gets one empty member
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
            with _stored_lock:
                stored_stats["blocks"] += len(sums)
                stored_stats["stored"] += stored
        if pieces:
            self.writer.write(b"".join(pieces))

    @staticmethod
    def _snappy_uncompressed(raw: bytes, chk: int) -> bytes:
        """A frame of one uncompressed chunk (its CRC the device-computed
        masked CRC32C: the checksum reads the input, not the encoding)."""
        return (SNAPPY_STREAM_IDENTIFIER + b"\x01" + put_le(len(raw) + 4, 3) + put_le(chk, 4)
                + raw)

    def _verify_or_repair(self, blob: bytes, raw: bytes, ln: int, final: bool, chk: int
                          ) -> tuple[bytes, int]:
        """Oracle-decode ``blob``; on any mismatch re-emit the block
        uncompressed (a stored deflate chunk or member, or an uncompressed
        Snappy chunk) with a host-computed checksum. The stream-mode oracle
        inflates the whole stream incrementally and starts anew on the
        repaired bytes."""
        mode = self.format.kernel_mode
        self.verify_stats["checked"] += 1
        try:
            if mode == "stream":
                if self._verify_stream is None:
                    self._verify_stream = zlib.decompressobj(-15)
                ok = self._verify_stream.decompress(blob) == raw
            elif mode == "snappy":
                ok = decode_frames(blob) == raw
            else:
                d = zlib.decompressobj(-15)
                payload = blob[self._cfg.header_len: len(blob) - 8]
                ok = d.decompress(payload) + d.flush() == raw
        except Exception:  # noqa: BLE001 - any decode error means repair
            ok = False
        if ok:
            return blob, chk
        self.verify_stats["repaired"] += 1
        logging.getLogger("gzp_tpu_torch").warning(
            "verify: device-encoded block failed oracle decode; "
            "re-emitting stored (totals: %r)", self.verify_stats,
        )
        c = self.format.check_cls()
        c.update(raw)
        if mode == "stream":
            blob = host_codec.stored_deflate(raw, final)
            self._verify_stream = zlib.decompressobj(-15)
            self._verify_stream.decompress(blob)
        elif mode == "snappy":
            return self._snappy_uncompressed(raw, chk), chk
        else:
            blob = host_codec.stored_member(raw, mode, self.level)
        return blob, c.sum()

    def _maybe_fallback(self, blob: bytes, raw: bytes, ln: int, final: bool, chk: int
                        ) -> bytes:
        """Swap in a stored encoding when smaller (the per-block
        stored/compressed choice zlib makes); enforce the BGZF cap
        (reference src/bgzf.rs:218-223). For Snappy, switch to an
        uncompressed chunk when compression expanded the block."""
        mode = self.format.kernel_mode
        if mode == "snappy":
            if ln and len(blob) > 10 + 4 + 4 + ln:
                blob = self._snappy_uncompressed(raw, chk)
            return blob
        if mode == "stream":
            if ln and len(blob) > host_codec.stored_size(ln):
                stored = host_codec.stored_deflate(raw, final)
                if len(stored) < len(blob):
                    blob = stored
            return blob
        if ln and len(blob) > self._cfg.header_len + 8 + host_codec.stored_size(ln):
            stored = host_codec.stored_member(raw, mode, self.level)
            if len(stored) < len(blob):
                blob = stored
        if mode == "bgzf" and len(blob) >= MAX_BGZF_BLOCK_SIZE:
            raise BlockSizeExceededError(len(blob), MAX_BGZF_BLOCK_SIZE)
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
