"""Build and load the hand-written CUDA kernels in ``gzp_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface,
``gzp_tpu_torch/_build/<name>-<digest>.so``, at first use, and loaded with
``ctypes``. The digest covers the source, every ``csrc/*.cuh`` header and
the flags, so an edited source or header builds anew. The first launch of
any kernel builds every library still missing, one ``nvcc`` process each,
all started together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises if that is not 0
and otherwise adds one to the kernel's ``launches`` count. Nothing here
runs at import: the package imports on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_REGISTRY: list["CudaKernel"] = []
_COUNTS: list["LaunchCount"] = []
_LOCK = threading.Lock()

ptr = ctypes.c_void_p
i32 = ctypes.c_int


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaKernel:
    """One kernel library: its source, its C entry point and its count of
    launches (a plain integer that callers may reset)."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._lib: ctypes.CDLL | None = None
        _REGISTRY.append(self)

    @property
    def name(self) -> str:
        return Path(self.source).stem

    @property
    def library(self) -> Path:
        # every header, not only the ones this source includes: an edit to
        # a shared header must rebuild each kernel that uses it
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (CSRC / self.source, *sorted(CSRC.glob("*.cuh"))):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:12]}.so"

    def launch(self, device: torch.device, *args) -> None:
        """Call the entry point with ``device`` current (the runtime
        launches on the current device); raise on a CUDA error, else
        count the launch."""
        lib = self.loaded()
        with torch.cuda.device(device):
            err = getattr(lib, self.symbol)(*args)
        if err != 0:
            msg = lib.gzp_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1

    def loaded(self) -> ctypes.CDLL:
        """The library, built (with every other one still missing) and
        loaded at first use; for its other plain-C functions."""
        if self._lib is None:
            build()
            self._load()
        return self._lib

    def _load(self) -> None:
        with _LOCK:
            if self._lib is not None:
                return
            lib = ctypes.CDLL(str(self.library))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [ptr]  # + stream
            fn.restype = ctypes.c_int
            lib.gzp_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gzp_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib


class LaunchCount:
    """Launches of one library's kernel at some of its arguments: where one
    kernel computes several Pallas kernels' functions, its wrapper adds one
    here next to the library's launch for the function that this counts."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        _COUNTS.append(self)


def registered() -> list[CudaKernel]:
    """Every kernel library of the package, in the order they were defined."""
    return list(_REGISTRY)


def counts() -> list[CudaKernel | LaunchCount]:
    """Every launch count of the package: each library's, then each
    :class:`LaunchCount`."""
    return [*_REGISTRY, *_COUNTS]


def build(kernels: list[CudaKernel] | None = None, *, force: bool = False,
          ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile the given kernels (default: every registered one) whose
    library is missing, or all of them with ``force``; one ``nvcc`` each,
    run together. Returns each compiled kernel's compiler output (with
    ``ptxas_verbose``: registers, shared memory and spills per function).
    Raises with the compiler's output if any build fails."""
    kernels = list(_REGISTRY if kernels is None else kernels)
    with _LOCK:
        todo = [k for k in kernels if force or not k.library.is_file()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd0 = [nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if ptxas_verbose else [])
        procs = []
        for k in todo:
            # processes that build at once (the workers of parallel/multihost.py)
            # each write their own temporary file and rename it into place,
            # so a loader never sees a partial library
            tmp = k.library.with_suffix(f".{os.getpid()}.tmp")
            p = subprocess.Popen(
                cmd0 + ["-o", str(tmp), str(CSRC / k.source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            procs.append((k, tmp, p))
        logs, failed = {}, []
        for k, tmp, p in procs:
            out, _ = p.communicate()
            logs[k.name] = out
            if p.returncode != 0:
                failed.append(f"{k.source}:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, k.library)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return logs


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, for a kernel launch."""
    return ptr(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cpu(t: torch.Tensor) -> bool:
    """Route of a wrapper: True for a CPU tensor (the plain version), False
    for a CUDA tensor (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"no kernel for device {t.device}")
