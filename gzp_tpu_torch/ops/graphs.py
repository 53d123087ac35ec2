"""A batched encoder replayed as one CUDA graph per input shape.

An encoder (:func:`~gzp_tpu_torch.ops.deflate_kernel.get_encoder`,
:func:`~gzp_tpu_torch.ops.snappy_kernel.get_snappy_encoder`) launches a
couple of thousand small device operations a batch, one Python call each:
Huffman tables, bit entries, the CRC ladders, framing, compaction, the parse
scan, and the sorts and scatters around the kernels. No stage reads a device value
back to the host, so the work of a call depends only on its inputs' shapes.
:func:`run` captures a call once per key and replays it after that: the host
makes one graph launch a batch.

The key is ``(encoder, device, each input's shape and dtype, None where an
optional input is not given)``: everything in it is observed in the call, so
no caller chooses anything. ``get_encoder`` and ``get_snappy_encoder``
return one function per equal config, so a new writer finds the graph an
earlier one captured. On the CPU the encoder runs eagerly.

First call of a key on a CUDA device: static input buffers; one eager run on
a side stream, which fills ``tables.on_device``'s caches, loads the kernel
libraries and sets up cuBLAS on that stream; then the capture
(``torch.cuda.graph``, ``capture_error_mode="relaxed"``) on the same stream,
into the graph's own memory pool. A call that cannot be captured raises:
there is no eager fallback on a card. At most :data:`MAX_GRAPHS` graphs are
kept; the least recently used goes first.

Each call, under the graph's lock and on the caller's current stream: wait
for the event recorded after the graph's previous replay, copy the inputs
into the static buffers, replay, clone the outputs, record the event. The
clones let several batches (a writer's queue, the shares of a mesh on one
card, writers on other threads) stay in flight while the graph is reused.
The result is the eager encoder's dict, key for key.

Launch counts (``runtime/cuda_lib.py``) count as eager calls do: each call
adds one encode's launches, the ones the capture recorded; the first call's
eager run and capture add none. ``graph_stats`` counts captures, replays and
eager calls while a profiler records (``telemetry.recording``), as
``parallel.compress.stored_stats`` does. A replay runs inside the span
``gzp.encode.replay``; no stage span (``gzp.encode.match`` and the rest)
opens in it.
"""

from __future__ import annotations

import collections
import threading

import torch

from gzp_tpu_torch.runtime import cuda_lib
from gzp_tpu_torch.runtime.telemetry import recording, span

MAX_GRAPHS = 8  # graphs kept (each holds its memory pool), least recently used dropped

# graphs captured, calls replayed and calls run eagerly (on the CPU), counted
# only while a profiler records
graph_stats = {"captured": 0, "replayed": 0, "eager": 0}
_lock = threading.RLock()  # the cache, the counts and every capture
_graphs: collections.OrderedDict = collections.OrderedDict()


def reset_graph_stats() -> None:
    """Zero ``graph_stats``."""
    with _lock:
        graph_stats.update(captured=0, replayed=0, eager=0)


def _count(what: str) -> None:
    if recording():
        with _lock:
            graph_stats[what] += 1


def run(encode, *inputs: torch.Tensor | None) -> dict:
    """``encode(*inputs)``: replayed as a CUDA graph when the inputs are on a
    CUDA device (captured at the key's first call), called eagerly on the
    CPU. ``inputs`` are ``data_u8, lengths, is_final[, halo, dict_lens]``
    on one device."""
    dev = inputs[0].device
    if dev.type != "cuda":
        _count("eager")
        return encode(*inputs)
    key = (encode, dev, tuple(None if t is None else (tuple(t.shape), t.dtype)
                              for t in inputs))
    with torch.cuda.device(dev):
        with _lock:
            graph = _graphs.get(key)
            if graph is None:
                graph = _graphs[key] = _Graph(encode, inputs)
                _count("captured")
                while len(_graphs) > MAX_GRAPHS:
                    _graphs.popitem(last=False)
            else:
                _graphs.move_to_end(key)
        with span("gzp.encode.replay"):
            return graph.replay(inputs)


class _Graph:
    """One captured call: static inputs, the graph, its outputs, the launches
    it holds, and the lock and event that order its replays."""

    def __init__(self, encode, inputs):
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        self.inputs = [None if t is None else torch.empty_like(
            t, memory_format=torch.contiguous_format) for t in inputs]
        self._copy_in(inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        counts = cuda_lib.counts()
        before = [k.launches for k in counts]
        with torch.cuda.stream(side):
            encode(*self.inputs)
        warm = [k.launches for k in counts]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side, capture_error_mode="relaxed"):
            self.outputs = encode(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        # the capture's launches are one call's; the counts then read as
        # before the warm-up, and each replay adds one call's (the caller
        # holds _lock, under which replays add theirs)
        self.launches = [(k, k.launches - w) for k, w in zip(counts, warm) if k.launches > w]
        for k, b in zip(counts, before):
            k.launches = b

    def _copy_in(self, inputs) -> None:
        for s, t in zip(self.inputs, inputs):
            if s is not None:
                s.copy_(t)

    def replay(self, inputs) -> dict:
        cur = torch.cuda.current_stream()
        with self.lock:
            cur.wait_event(self.done)
            self._copy_in(inputs)
            self.graph.replay()
            out = {k: v.clone() for k, v in self.outputs.items()}
            self.done.record(cur)
        with _lock:
            for k, n in self.launches:
                k.launches += n
        _count("replayed")
        return out
