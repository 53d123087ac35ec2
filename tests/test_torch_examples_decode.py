"""The port's decode examples (``examples/block_decompress_torch.py``,
``examples/snap_decode_torch.py``) held against the JAX package's on the
same stdin: the same bytes on stdout, the input restored. The streams are
``pigz_clone``'s output on ``test_torch_examples.py``'s input, written by
the port's ``ZBuilder`` in this process (``test_torch_examples.py`` holds
them equal to the JAX example's). Tolerance: exact bytes.
"""

import io

import pytest

import gzp_tpu_torch
from test_torch_examples import DATA, THREADS, run_jax_example, run_port_example


def compressed(name: str, level: int) -> bytes:
    """``pigz_clone_torch.py --format <name> --level <level> --threads
    THREADS --device cpu``'s output on DATA, in this process."""
    buf = io.BytesIO()
    w = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.ALL_FORMATS[name]).num_threads(THREADS)
         .compression_level(level).device("cpu").from_writer(buf))
    for i in range(0, len(DATA), 1 << 20):
        w.write(DATA[i: i + (1 << 20)])
    w.finish()
    return buf.getvalue()


@pytest.mark.parametrize("name,level", [("bgzf", 6), ("mgzip", 3)])
def test_block_decompress_matches_jax(name, level, monkeypatch):
    """The default backend (the native host codec, no device)."""
    blob = compressed(name, level)
    args = ["--format", name, "--threads", str(THREADS)]
    port = run_port_example("block_decompress_torch", args, blob)
    assert port.returncode == 0, port.stderr.decode()
    assert port.stdout == run_jax_example("block_decompress", args, blob, monkeypatch) == DATA


def test_block_decompress_device_backend_writes_the_same_bytes():
    """``--backend device --device cpu`` (the inflate kernel's plain
    version) writes what the native backend writes."""
    blob = compressed("bgzf", 6)
    args = ["--format", "bgzf", "--threads", str(THREADS)]
    native = run_port_example("block_decompress_torch", args, blob)
    device = run_port_example("block_decompress_torch",
                              [*args, "--backend", "device", "--device", "cpu"], blob)
    assert native.returncode == 0, native.stderr.decode()
    assert device.returncode == 0, device.stderr.decode()
    assert device.stdout == native.stdout == DATA


def test_block_decompress_device_backend_without_cuda_exits_nonzero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    r = run_port_example("block_decompress_torch", ["--backend", "device"],
                         compressed("bgzf", 6))
    assert r.returncode != 0
    assert r.stdout == b""
    assert b"no CUDA device available; pass device='cpu'" in r.stderr


def test_snap_decode_matches_jax(monkeypatch):
    blob = compressed("snappy", 3)
    port = run_port_example("snap_decode_torch", [], blob)
    assert port.returncode == 0, port.stderr.decode()
    assert port.stdout == run_jax_example("snap_decode", [], blob, monkeypatch) == DATA
