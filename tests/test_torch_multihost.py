"""The port's multi-process compression (``gzp_tpu_torch/parallel/
multihost.py``) held against gzp_tpu's (``gzp_tpu/parallel/multihost.py``):
the same shard ranges, the same shard wire format, stitched streams equal
byte for byte to gzp_tpu's and to the port's one-process stream, and a
real two-process run over a gloo process group on the CPU. Analogs of
``tests/test_multihost.py``. Tolerance: exact bytes.
"""

import gzip
import io
import json
import os
import socket
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch
from gzp_tpu.parallel import multihost as ref_mh
from gzp_tpu_torch.constants import BGZF_EOF
from gzp_tpu_torch.parallel import multihost as mh

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 120  # seconds for each process of the two-process run


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"multi host stitching test ", b"rank ordered payloads ", b"01234567"]
    reps, total = [], 0
    while total < n:
        reps.append(words[rng.integers(0, len(words))])
        total += len(reps[-1])
    return b"".join(reps)[:n]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("total,bs,k", [
    (1000, 100, 3), (5, 100, 2), (0, 64, 2), (1 << 20, 32768, 4),
    (300_000, 32768, 3), (300_000, 65280, 3), (32768 * 3, 32768, 5), (100, 100, 1),
    (65280 * 5 + 1, 65280, 4),
])
def test_shard_ranges_match_reference(total, bs, k):
    rng = mh.shard_ranges(total, bs, k)
    assert rng == ref_mh.shard_ranges(total, bs, k)
    assert len(rng) == k and rng[0][0] == 0 and rng[-1][1] == total
    for (s0, e0), (s1, _) in zip(rng, rng[1:]):
        assert e0 == s1 and s0 % bs == 0


# (format name, buffer size, decoder): as tests/test_multihost.py, 32 KiB
# blocks but for BGZF, which takes its own (65,280 B)
FORMATS = [
    ("mgzip", 32768, gzip.decompress),
    ("gzip", 32768, gzip.decompress),
    ("zlib", 32768, zlib.decompress),
    ("bgzf", None, gzip.decompress),
]


def _stitch(pkg, fmt, shards) -> bytes:
    buf = io.BytesIO()
    pkg.stitch_shards(fmt, shards, buf)
    return buf.getvalue()


@pytest.mark.parametrize("name,bs,decode", FORMATS, ids=[f[0] for f in FORMATS])
def test_inprocess_shard_stitch(name, bs, decode):
    """Three ranks in one process: the port's stitched stream equals
    gzp_tpu's and the port's one-process stream, across every shard
    boundary (for Gzip and Zlib the 32 KiB dictionary carry too)."""
    data = make_text(300_000, seed=1)
    fmt, ref_fmt = gzp_tpu_torch.ALL_FORMATS[name], gzp_tpu.ALL_FORMATS[name]
    port = _stitch(mh, fmt, [
        mh.compress_shard(fmt, data, r, 3, buffer_size=bs, num_threads=2, device="cpu")
        for r in range(3)
    ])
    ref = _stitch(ref_mh, ref_fmt, [
        ref_mh.compress_shard(ref_fmt, data, r, 3, buffer_size=bs, num_threads=2)
        for r in range(3)
    ])
    assert decode(port) == data
    assert port == ref
    b = gzp_tpu_torch.ZBuilder(fmt).num_threads(2).device("cpu")
    if bs is not None:
        b = b.buffer_size(bs)
    one = io.BytesIO()
    w = b.from_writer(one)
    w.write(data)
    w.finish()
    assert port == one.getvalue()
    if name == "bgzf":
        assert port.endswith(BGZF_EOF)


def test_batch_aligned_stream_keeps_the_reference_close():
    """Four whole blocks at 4 threads: one process writes one full batch and
    closes the stream with an empty final block, while two ranks of half a
    batch each mark the last real block final. Both packages do so, so the
    stitched bytes equal gzp_tpu's but not the one-process stream's; both
    streams decode to the input."""
    data = make_text(4 * 32768, seed=6)
    fmt, ref_fmt = gzp_tpu_torch.Gzip, gzp_tpu.Gzip
    port = _stitch(mh, fmt, [
        mh.compress_shard(fmt, data, r, 2, buffer_size=32768, num_threads=4, device="cpu")
        for r in range(2)
    ])
    ref = _stitch(ref_mh, ref_fmt, [
        ref_mh.compress_shard(ref_fmt, data, r, 2, buffer_size=32768, num_threads=4)
        for r in range(2)
    ])
    one = io.BytesIO()
    w = gzp_tpu_torch.ZBuilder(fmt).num_threads(4).buffer_size(32768).device("cpu").from_writer(one)
    w.write(data)
    w.finish()
    assert port == ref
    assert gzip.decompress(port) == gzip.decompress(one.getvalue()) == data
    assert port != one.getvalue()


def test_shard_over_a_mesh():
    """A rank may split its shard over a mesh: the same shard bytes."""
    data = make_text(200_000, seed=4)
    fmt = gzp_tpu_torch.Gzip
    for r in range(2):
        one = mh.compress_shard(fmt, data, r, 2, buffer_size=32768, num_threads=3, device="cpu")
        two = mh.compress_shard(fmt, data, r, 2, buffer_size=32768, num_threads=3,
                                mesh=["cpu", "cpu"])
        assert one == two


def test_shard_result_wire_format():
    """Both packages write the same 16-byte ``<IIQ`` header and read each
    other's shard files."""
    args = (3, b"payload", 0xDEADBEEF, 12345)
    blob = mh.ShardResult(*args).to_bytes()
    assert blob == ref_mh.ShardResult(*args).to_bytes()
    assert len(blob) == 16 + len(b"payload")
    for reader, writer in ((mh, ref_mh), (ref_mh, mh)):
        s = reader.ShardResult.from_bytes(writer.ShardResult(*args).to_bytes())
        assert (s.rank, s.payload, s.check_sum, s.check_amount) == args


def test_stitch_needs_every_rank():
    s = mh.ShardResult(1, b"", 0, 0)
    with pytest.raises(ValueError, match="missing shard rank 0"):
        mh.stitch_shards(gzp_tpu_torch.Gzip, [s], io.BytesIO())


@pytest.mark.parametrize("name", ["gzip", "zlib"])
def test_stitch_folds_a_shard_of_4_gib_or_more(name):
    """A middle shard of 2^32 + k bytes, given by its check and its 64-bit
    length (no 4 GiB of data: its check is gzp_tpu's combine of two pieces
    under 2^32 each, and any 32-bit CRC, or any Adler32 halves below 65521,
    is the check of some piece that long). The stitched footer must hold
    the check of the whole range, folded piece by piece with gzp_tpu's
    combine, and Gzip's ISIZE the total modulo 2^32."""
    from gzp_tpu import check as ref_check

    fmt = gzp_tpu_torch.ALL_FORMATS[name]
    rng = np.random.default_rng(11)
    head, tail = make_text(5000, seed=7), make_text(3000, seed=8)
    k = 12345
    lens = [1 << 31, (1 << 31) + k]  # the middle shard's pieces, each under 2^32
    if name == "gzip":
        crc, combine = zlib.crc32, ref_check.crc32_combine
        pieces = [int(v) for v in rng.integers(0, 1 << 32, 2)]
    else:
        crc, combine = zlib.adler32, ref_check.adler32_combine
        pieces = [int(a) | int(b) << 16 for a, b in rng.integers(1, 65521, (2, 2))]
    middle = combine(pieces[0], pieces[1], lens[1])
    shards = [mh.ShardResult(0, b"", crc(head), len(head)),
              mh.ShardResult(1, b"", middle, sum(lens)),
              mh.ShardResult(2, b"", crc(tail), len(tail))]
    assert mh.ShardResult.from_bytes(shards[1].to_bytes()) == shards[1]  # 64 bits on the wire
    want = crc(head)
    for value, n in zip([*pieces, crc(tail)], [*lens, len(tail)]):
        want = combine(want, value, n)
    got = _stitch(mh, fmt, shards)
    total = len(head) + sum(lens) + len(tail)
    if name == "gzip":
        assert int.from_bytes(got[-8:-4], "little") == want
        assert int.from_bytes(got[-4:], "little") == total % (1 << 32)
    else:
        assert int.from_bytes(got[-4:], "big") == want


def test_two_process_gloo(tmp_path):
    """The real multi-process path: two OS processes in a gloo process
    group on the CPU, each writing its shard file; the parent stitches.
    Both must exit 0 within WORKER_TIMEOUT, or both are killed."""
    data = make_text(260_000, seed=3)
    inp = tmp_path / "input.bin"
    inp.write_bytes(data)
    coord = f"localhost:{free_port()}"
    # one intra-op thread each: the two ranks share this host's cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs, outs = [], []
    for rank in range(2):
        out = tmp_path / f"shard{rank}.bin"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gzp_tpu_torch.parallel.multihost",
             "--coordinator", coord, "--num-processes", "2", "--rank", str(rank),
             "--format", "gzip", "--buffer-size", "32768", "--device", "cpu",
             "--input", str(inp), "--output", str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    try:
        results = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err
    lines = [json.loads(out.strip().splitlines()[-1]) for out, _ in results]
    assert [(x["rank"], x["device"]) for x in lines] == [(0, "cpu"), (1, "cpu")]
    assert not any(lines[0]["launches"].values())  # the plain versions ran

    shards = [mh.ShardResult.from_bytes(o.read_bytes()) for o in outs]
    got = _stitch(mh, gzp_tpu_torch.Gzip, shards)
    assert gzip.decompress(got) == data
    want = _stitch(mh, gzp_tpu_torch.Gzip, [
        mh.compress_shard(gzp_tpu_torch.Gzip, data, r, 2, buffer_size=32768, num_threads=4,
                          device="cpu")
        for r in range(2)
    ])
    assert got == want


def test_worker_without_cuda_needs_device_cpu(monkeypatch, tmp_path):
    """With no CUDA device and no ``--device``, a worker raises before it
    joins the group: there is no silent move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        mh._worker_main(["--coordinator", f"localhost:{free_port()}", "--num-processes", "1",
                         "--rank", "0", "--input", str(tmp_path / "in"),
                         "--output", str(tmp_path / "out")])


def test_init_distributed_is_idempotent():
    import torch.distributed as dist

    addr = f"localhost:{free_port()}"
    try:
        assert mh.init_distributed(addr, 1, 0) == (0, 1)
        assert mh.init_distributed(addr, 1, 0) == (0, 1)
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
