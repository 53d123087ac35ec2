"""The port's shell entry points (``examples/*_torch.py``) held against the
JAX package's (``examples/pigz_clone.py`` and friends): the same input on
stdin gives the same bytes on stdout. Each port example runs in a fresh
process with ``--device cpu``; the JAX example runs in this process,
loaded from its file, with ``sys.argv``, stdin and stdout patched, under
the suite's CPU setup and compile cache. Tolerance: exact bytes.

This file holds ``pigz_clone`` (Gzip level 3, BGZF level 6, Snappy) and
its refusal to run without CUDA; ``test_torch_examples_decode.py`` holds
the decode examples.
"""

import gzip
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
TIMEOUT = 120  # seconds for each example process
THREADS = 3


def make_text(n: int, seed: int = 0) -> bytes:
    """Seeded English-like lines: enough matches for every matcher stage."""
    rng = np.random.default_rng(seed)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ", b"lazy ",
             b"dog ", b"to be or not to be ", b"that is the question ", b"\n"]
    out, total = [], 0
    while total < n:
        out.append(words[rng.integers(0, len(words))])
        total += len(out[-1])
    return b"".join(out)[:n]


# two Gzip blocks of 128 KiB in one batch; four BGZF blocks in two batches
# of 3; four Snappy chunks of 64 KiB
DATA = make_text(200_000, seed=5)


class _Stdio:
    """A stand-in for sys.stdin / sys.stdout: the example reads and writes
    ``.buffer``."""

    def __init__(self, data: bytes = b"") -> None:
        self.buffer = io.BytesIO(data)


def run_jax_example(name: str, args: list[str], stdin: bytes, monkeypatch) -> bytes:
    """``examples/<name>.py``'s ``main()`` in this process: argv, stdin and
    stdout patched; returns what it wrote to stdout."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = _Stdio()
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [name, *args])
        m.setattr(sys, "stdin", _Stdio(stdin))
        m.setattr(sys, "stdout", out)
        mod.main()
    return out.buffer.getvalue()


def run_port_example(name: str, args: list[str], stdin: bytes) -> subprocess.CompletedProcess:
    """``examples/<name>.py`` in a fresh process (two intra-op threads: the
    other test workers share the cores)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"), *args], input=stdin,
                          cwd=REPO, env=env, capture_output=True, timeout=TIMEOUT)


# (case, pigz_clone's arguments, decoder of the output)
CASES = [
    ("gzip-3", [], gzip.decompress),
    ("bgzf-6", ["--format", "bgzf", "--level", "6"], gzip.decompress),
    ("snappy", ["--format", "snappy"], None),
]


@pytest.mark.parametrize("args,decode", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_pigz_clone_matches_jax(args, decode, monkeypatch):
    args = [*args, "--threads", str(THREADS)]
    port = run_port_example("pigz_clone_torch", [*args, "--device", "cpu"], DATA)
    assert port.returncode == 0, port.stderr.decode()
    want = run_jax_example("pigz_clone", args, DATA, monkeypatch)
    assert port.stdout == want
    if decode is None:
        from gzp_tpu_torch.utils.snappy_ref import decode_frames as decode
    assert decode(port.stdout) == DATA


def test_pigz_clone_without_cuda_exits_nonzero():
    """No ``--device`` and no CUDA device: the example exits non-zero with
    ``resolve_device``'s message and writes nothing; it never falls back
    to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    r = run_port_example("pigz_clone_torch", ["--threads", str(THREADS)], DATA[:1000])
    assert r.returncode != 0
    assert r.stdout == b""
    assert b"no CUDA device available; pass device='cpu'" in r.stderr
