"""Multi-host (multi-process) compression of one stream.

Counterpart of ``gzp_tpu/parallel/multihost.py``, with
``torch.distributed`` in the place of ``jax.distributed``. Each process
compresses a *contiguous range of blocks* on its own device (or mesh) and
the partial streams are stitched in rank order — the reference's
ordered-writer contract (src/par/compress.rs:248-323) lifted one level up:

* ``shard_ranges(total_len, block_size, num_shards)`` — contiguous
  block-aligned byte ranges, one per rank;
* ``compress_shard(...)`` — the normal ``ParCompress`` pipeline over one
  range, with no stream header (rank > 0) and no footer (every rank):
  a zlib-family shard ends in a Z_SYNC_FLUSH block join, the dictionary
  carry is preset from the previous shard's trailing ``DICT_SIZE`` input
  bytes, and the shard's running checksum and its length are returned;
* ``stitch_shards(...)`` — the payloads in rank order, the per-shard
  checksums folded with the O(1) combine (pigz COMB across processes)
  over each shard's length as given (64 bits on the wire, so a shard of
  4 GiB or more folds right), header, trailer and footer written once.

The process group is only the rendezvous: shards travel as files, in the
16-byte ``<IIQ`` header format of gzp_tpu's ``ShardResult``, so either
package reads the other's. The group uses gloo, which needs no GPU and
also takes two ranks on one card, where NCCL refuses a repeated device.

    python -m gzp_tpu_torch.parallel.multihost --coordinator localhost:29500 \\
        --num-processes 2 --rank 0 --input data --output shard0

runs one rank (``--device cpu`` on a machine with no CUDA device).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from datetime import timedelta
from typing import BinaryIO

from gzp_tpu_torch.constants import DICT_SIZE
from gzp_tpu_torch.formats.base import FormatSpec
from gzp_tpu_torch.parallel.compress import ParCompress

_HEADER = struct.Struct("<IIQ")  # rank, check sum, the shard's length in bytes
RENDEZVOUS_TIMEOUT = timedelta(seconds=300)


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> tuple[int, int]:
    """Join a gloo process group of ``num_processes`` at
    ``coordinator_address`` (``host:port``, rank 0 listens there) as rank
    ``process_id``; idempotent. Returns (rank, world size)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        dist.init_process_group("gloo", init_method=addr, world_size=num_processes,
                                rank=process_id, timeout=RENDEZVOUS_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def shard_ranges(total_len: int, block_size: int, num_shards: int) -> list[tuple[int, int]]:
    """Contiguous block-aligned [start, end) byte ranges per rank.

    Every shard gets a whole number of blocks; the final shard takes the
    ragged tail. Block alignment keeps the stitched stream identical to
    the one-process stream (same block boundaries, same dictionary carry).
    """
    nblocks = max(-(-total_len // block_size), 1)
    per = -(-nblocks // num_shards)
    out = []
    for r in range(num_shards):
        s = min(r * per * block_size, total_len)
        e = min((r + 1) * per * block_size, total_len)
        out.append((s, e))
    return out


@dataclass
class ShardResult:
    """One rank's partial stream and checksum state, for the stitch."""

    rank: int
    payload: bytes
    check_sum: int
    check_amount: int

    def to_bytes(self) -> bytes:
        """Serialize for transport between processes (files, sockets)."""
        return _HEADER.pack(self.rank, self.check_sum, self.check_amount) + self.payload

    @classmethod
    def from_bytes(cls, blob: bytes) -> "ShardResult":
        rank, csum, amount = _HEADER.unpack_from(blob, 0)
        return cls(rank, blob[_HEADER.size:], csum, amount)


def compress_shard(
    format_spec: FormatSpec,
    data: bytes,
    rank: int,
    num_shards: int,
    *,
    compression_level: int = 3,
    buffer_size: int | None = None,
    num_threads: int = 16,
    device=None,
    mesh=None,
) -> ShardResult:
    """Compress this rank's contiguous block range of ``data``.

    ``data`` is the whole input: each rank reads its range and the 32 KiB
    dictionary halo before it (reference src/par/compress.rs:417-423).
    """
    buffer_size = buffer_size or format_spec.default_bufsize
    if format_spec.max_input_block is not None:
        buffer_size = min(buffer_size, format_spec.max_input_block)
    start, end = shard_ranges(len(data), buffer_size, num_shards)[rank]
    last = rank == num_shards - 1
    sink = io.BytesIO()
    # header, footer and trailer are the stitcher's; a shard before the
    # last ends mid-stream (Z_SYNC_FLUSH block join), the last closes it
    pc = ParCompress(
        format_spec,
        sink,
        num_threads=num_threads,
        compression_level=compression_level,
        buffer_size=buffer_size,
        device=device,
        mesh=mesh,
        emit_header=False,
        emit_footer=False,
        final_on_finish=last,
        preset_carry=data[max(0, start - DICT_SIZE): start] if rank > 0 else b"",
    )
    pc.write(data[start:end])
    pc.finish()
    # the shard's true length, not check.amount() (modulo 2^32): the stitch
    # folds the check over it, and a shard may hold 4 GiB or more
    return ShardResult(rank, sink.getvalue(), pc.check.sum(), end - start)


def stitch_shards(format_spec: FormatSpec, shards: list[ShardResult], writer: BinaryIO, *,
                  compression_level: int = 3) -> None:
    """Rank-ordered stitch: header, payloads, format trailer (e.g. the BGZF
    EOF marker), footer with the combined check."""
    shards = sorted(shards, key=lambda s: s.rank)
    for i, s in enumerate(shards):
        if s.rank != i:
            raise ValueError(f"missing shard rank {i}")
    hdr = format_spec.header(compression_level)
    if hdr:
        writer.write(hdr)
    running = format_spec.create_check()
    for s in shards:
        writer.write(s.payload)
        running.combine_sum(s.check_sum, s.check_amount)
    trailer = format_spec.trailer_bytes()
    if trailer:
        writer.write(trailer)
    footer = format_spec.footer(running)
    if footer:
        writer.write(footer)


def _worker_main(argv: list[str] | None = None) -> None:
    """One rank of an N-process run: join the group, compress this rank's
    shard on its device, write the serialized ShardResult, and print one
    JSON line with the rank, the device, the seconds of the compression
    and each kernel's launches (all 0 on the CPU)."""
    import argparse
    import json
    import time

    import torch
    import torch.distributed as dist

    p = argparse.ArgumentParser(description="compress one rank's shard of a stream")
    p.add_argument("--coordinator", required=True, help="host:port of rank 0")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--format", default="mgzip")
    p.add_argument("--level", type=int, default=3)
    p.add_argument("--buffer-size", type=int, default=None)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--device", default=None,
                   help="default cuda:<rank mod the number of CUDA devices>")
    p.add_argument("--num-threads", type=int, default=4)
    args = p.parse_args(argv)

    if args.device is not None:
        device = torch.device(args.device)
    elif torch.cuda.is_available():
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    else:
        raise RuntimeError("no CUDA device available; pass --device cpu to compress on the CPU")

    rank, nproc = init_distributed(args.coordinator, args.num_processes, args.rank)
    if (rank, nproc) != (args.rank, args.num_processes):
        raise RuntimeError(f"joined as rank {rank} of {nproc}, "
                           f"asked for {args.rank} of {args.num_processes}")

    from gzp_tpu_torch.formats import ALL_FORMATS
    from gzp_tpu_torch.runtime import cuda_lib

    fmt = ALL_FORMATS[args.format]
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    res = compress_shard(fmt, data, rank, nproc, compression_level=args.level,
                         buffer_size=args.buffer_size, num_threads=args.num_threads,
                         device=device)
    secs = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(res.to_bytes())
    print(json.dumps({"rank": rank, "device": str(device), "seconds": secs,
                      "launches": {k.name: k.launches for k in cuda_lib.counts()}}), flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main()
