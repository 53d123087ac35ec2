"""The port's multi-device compression (``ZBuilder(...).mesh(devices)``,
``MeshEncoder`` in ``gzp_tpu_torch/parallel/mesh.py``) on meshes of ``"cpu"`` entries, held
byte for byte against the port's one-device stream and against gzp_tpu's
stream on a mesh of the virtual CPU devices (``tests/conftest.py``).
Analogs of ``tests/test_multidevice.py``. Tolerance: exact bytes.
"""

import gzip
import io
import zlib

import jax
import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch
from gzp_tpu_torch.constants import DICT_SIZE
from gzp_tpu_torch.parallel.mesh import MeshEncoder, dryrun_multichip, mesh_devices
from gzp_tpu_torch.utils.snappy_ref import decode_frames

DECODE = {
    "gzip": gzip.decompress,
    "mgzip": gzip.decompress,
    "bgzf": gzip.decompress,
    "zlib": zlib.decompress,
    "raw_deflate": lambda b: zlib.decompress(b, -15),
    "snappy": decode_frames,
}


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
    words = [b"lorem ipsum dolor sit amet ", b"consectetur adipiscing elit "]
    reps, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        reps.append(w)
        total += len(w)
    return b"".join(reps)[:n]


def _write(w, data, cut):
    if cut is None:
        w.write(data)
    else:  # a partial block mid-batch, then more data
        w.write(data[:cut])
        w.flush()
        w.write(data[cut:])
    w.finish()


def port_stream(name, data, threads, mesh=None, cut=None, buffer_size=DICT_SIZE):
    buf = io.BytesIO()
    b = gzp_tpu_torch.ZBuilder(gzp_tpu_torch.ALL_FORMATS[name]).num_threads(threads)
    b = b.buffer_size(buffer_size)
    b = b.device("cpu") if mesh is None else b.mesh(mesh)
    _write(b.from_writer(buf), data, cut)
    return buf.getvalue()


def ref_stream(name, data, threads, devices, cut=None, buffer_size=DICT_SIZE):
    buf = io.BytesIO()
    mesh = jax.sharding.Mesh(np.array(devices), ("blocks",))
    w = (gzp_tpu.ZBuilder(gzp_tpu.ALL_FORMATS[name]).num_threads(threads)
         .buffer_size(buffer_size).mesh(mesh).from_writer(buf))
    _write(w, data, cut)
    return buf.getvalue()


@pytest.mark.parametrize("ndev", [2, 8])
def test_mesh_sharded_compress(ndev):
    data = make_text(DICT_SIZE * 3 * ndev + 1234, seed=ndev)
    threads = min(2 * ndev, 8)
    out = port_stream("mgzip", data, threads, mesh=["cpu"] * ndev)
    assert gzip.decompress(out) == data
    assert out == port_stream("mgzip", data, threads)


# (format, flush point): Gzip's flush leaves a partial block as row 1 of a
# 4-row batch, so each device's first row needs the halo of the row before
# it on another device, not the carry from the batch before
CASES = [
    ("gzip", DICT_SIZE * 5 + 1234),
    ("gzip", None),
    ("mgzip", None),
    ("snappy", None),
]


@pytest.mark.parametrize("name,cut", CASES, ids=["gzip-flush", "gzip", "mgzip", "snappy"])
def test_mesh_output_matches_single_device(cpu_devices, name, cut):
    """Sharding must not change the bytes: the port's mesh stream equals
    its one-device stream and gzp_tpu's stream on a 4-device mesh."""
    data = make_text(DICT_SIZE * 7 + 999, seed=42)
    mesh = port_stream(name, data, 4, mesh=["cpu"] * 4, cut=cut)
    assert DECODE[name](mesh) == data
    assert mesh == port_stream(name, data, 4, cut=cut)
    assert mesh == ref_stream(name, data, 4, cpu_devices[:4], cut=cut)


@pytest.mark.parametrize("name", sorted(DECODE))
def test_mesh_of_three_matches_single_device(name):
    """Every format over a mesh of 3 (batch 4 rounded up to 6, two rows a
    device) with a flush mid-batch: the one-device stream's bytes."""
    bs = 65280 if name == "bgzf" else DICT_SIZE
    data = make_text(bs * 9 + 4321, seed=9)
    cut = bs * 7 + 100
    mesh = port_stream(name, data, 4, mesh=["cpu"] * 3, cut=cut, buffer_size=bs)
    assert DECODE[name](mesh) == data
    assert mesh == port_stream(name, data, 4, cut=cut, buffer_size=bs)


def test_batch_rounds_up_to_the_mesh(cpu_devices):
    """num_threads(3) over a mesh of 2 gives batches of 4 in both packages,
    with equal bytes."""
    data = make_text(DICT_SIZE * 5 + 77, seed=5)
    port = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Mgzip).num_threads(3).buffer_size(DICT_SIZE)
            .mesh(["cpu", "cpu"]).from_writer(io.BytesIO()))
    ref = (gzp_tpu.ZBuilder(gzp_tpu.Mgzip).num_threads(3).buffer_size(DICT_SIZE)
           .mesh(jax.sharding.Mesh(np.array(cpu_devices[:2]), ("blocks",)))
           .from_writer(io.BytesIO()))
    assert port.batch == ref.batch == 4
    out = port_stream("mgzip", data, 3, mesh=["cpu", "cpu"])
    assert out == ref_stream("mgzip", data, 3, cpu_devices[:2])
    assert out == port_stream("mgzip", data, 3)


def test_device_and_mesh_together_raise():
    with pytest.raises(ValueError, match="not both"):
        gzp_tpu_torch.ParCompress(gzp_tpu_torch.Mgzip, io.BytesIO(), device="cpu", mesh=["cpu"])
    with pytest.raises(ValueError, match="not both"):
        (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Gzip).num_threads(4).device("cpu")
         .mesh(["cpu", "cpu"]).from_writer(io.BytesIO()))


def test_empty_mesh_raises():
    with pytest.raises(ValueError, match="at least one device"):
        gzp_tpu_torch.ParCompress(gzp_tpu_torch.Mgzip, io.BytesIO(), mesh=[])
    with pytest.raises(ValueError, match="at least one device"):
        mesh_devices(0)


def test_mesh_without_cuda_raises(monkeypatch):
    """A mesh of CUDA devices with no CUDA raises, and so does the default
    mesh of the dry run; the CPU runs only when the mesh names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Mgzip).num_threads(4)
         .mesh(["cuda:0", "cuda:0"]).from_writer(io.BytesIO()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_devices(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


def test_mesh_encoder_split_and_order():
    """MeshEncoder hands device k the k-th contiguous share of every array
    and returns the results in device order; a batch that does not split
    evenly raises."""
    seen = []

    def enc(*arrays):
        seen.append([a.clone() for a in arrays])
        return {"rows": arrays[0]}

    rows = np.arange(12, dtype=np.int32).reshape(6, 2)
    lens = np.arange(6, dtype=np.int32)
    res = MeshEncoder(enc, ["cpu"] * 3)(rows, lens)
    assert [r["rows"].tolist() for r in res] == [rows[k * 2: k * 2 + 2].tolist() for k in range(3)]
    assert [s[1].tolist() for s in seen] == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="does not split"):
        MeshEncoder(enc, ["cpu"] * 4)(rows, lens)


def test_one_thread_ignores_the_mesh():
    """num_threads(1) is the single-block writer, as in gzp_tpu's builder."""
    w = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Mgzip).num_threads(1).device("cpu")
         .mesh(["cpu", "cpu"]).from_writer(io.BytesIO()))
    assert type(w).__name__ == "SyncZ"


def test_dryrun_multichip():
    lens = dryrun_multichip(4, ["cpu"] * 4)
    assert len(lens) == 8 and all(n > 0 for n in lens)
