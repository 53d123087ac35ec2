"""Device placement: which device a writer or reader runs on, the split of
a batch over a mesh of devices, and the dry run.

:class:`MeshEncoder` (``ParCompress(mesh=...)``) is the counterpart of the
``mesh`` knob of ``gzp_tpu/parallel/compress.py`` (:177-188): each of a
mesh's ``n`` devices encodes a contiguous ``B / n`` rows of every batch.
Here a mesh is a sequence of torch devices; one device is a mesh of one.
``dryrun_multichip`` is the counterpart of the one in ``__graft_entry__.py``.

A device may appear more than once: ``[cuda:0, cuda:0]`` runs the split
and the ordered gather on one card.
"""

from __future__ import annotations

import gzip
from collections.abc import Sequence

import numpy as np
import torch

from gzp_tpu_torch.ops import graphs
from gzp_tpu_torch.ops.deflate_kernel import DeflateEncodeConfig, get_encoder


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
    encodes them there (``graphs.run``: one CUDA graph replay on a card),
    and returns one result dict per device, in device order. Outputs stay
    on their device until the host fetches them; there are no copies
    between devices. A device may appear more than once.
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
            graphs.run(self.encoder, *(to_device(a[k * per: (k + 1) * per], dev) for a in arrays))
            for k, dev in enumerate(self.devices)
        ]


def mesh_devices(n: int) -> list[torch.device]:
    """``n`` devices: every CUDA device, repeated in turn up to ``n``. With
    no CUDA device it raises: the CPU runs only where the caller names it
    (``["cpu"] * n``)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    resolve_device(None)  # raises with no CUDA device
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multichip(n_devices: int, devices: Sequence | None = None) -> list[int]:
    """Encode ``2 * n_devices`` Mgzip blocks of 2,048 B over a mesh of
    ``n_devices`` (``devices``, default :func:`mesh_devices`) and check the
    ordered gather: every member must decompress to its block, and the
    members must equal a one-device encode of the same batch. Returns each
    member's length."""
    devices = mesh_devices(n_devices) if devices is None else list(devices)
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    cfg = DeflateEncodeConfig(block_len=2048, mode="mgzip", checksum="none")
    encoder = get_encoder(cfg)
    data, lengths, finals = _example_batch(2 * n_devices, cfg.block_len)

    def members(results: list[dict]) -> list[bytes]:
        out = []
        for res in results:
            out_len = res["out_len"].cpu().numpy()
            rows = res["out"].cpu().numpy()
            out += [rows[i, : out_len[i]].tobytes() for i in range(len(out_len))]
        return out

    mesh = MeshEncoder(encoder, devices)
    got = members(mesh(data, lengths, finals))
    lens = [len(m) for m in got]
    if not all(0 < n <= cfg.out_bytes for n in lens):
        raise AssertionError(f"member lengths out of range: {lens}")
    for i, m in enumerate(got):
        if gzip.decompress(m) != data[i].tobytes():
            raise AssertionError(f"block {i} does not decompress to its input")
    if got != members(MeshEncoder(encoder, mesh.devices[:1])(data, lengths, finals)):
        raise AssertionError("the mesh's members differ from a one-device encode")
    print(f"dryrun_multichip OK on {n_devices} devices "
          f"({', '.join(map(str, mesh.devices))}): out_len={lens}")
    return lens


def _example_batch(batch: int, block_len: int):
    """``batch`` rows of ``block_len`` bytes of repetitive text, from a seed
    (the dry run's input in ``__graft_entry__.py``)."""
    rng = np.random.default_rng(0)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ", b"mgzip "]
    chunks = []
    total = 0
    while total < batch * block_len:
        w = words[rng.integers(0, len(words))]
        chunks.append(w)
        total += len(w)
    blob = b"".join(chunks)[: batch * block_len]
    data = np.frombuffer(blob, np.uint8).reshape(batch, block_len).copy()
    lengths = np.full(batch, block_len, np.int32)
    finals = np.zeros(batch, bool)
    return data, lengths, finals
