"""Loader for the C++ host codec (built with ``g++`` at first use).

Counterpart of ``gzp_tpu/runtime/native_lib.py``. ``native/gzptpu_native.cpp``
is this package's own copy of the reference's host codec: RFC 1951
inflate, raw Snappy decompress, slice-by-8 CRC32 and CRC32C, and Adler32,
behind a plain C interface. It is compiled into
``gzp_tpu_torch/_build/gzptpu_native-<digest>.so``, where the digest covers
the source and the flags, so an edited source builds anew; the library is
built for the host it is built on (``-march=native``) and stays in the
checkout's ``_build/``.

ctypes releases the GIL during calls, so the parallel block decompressor
fans ``gzptpu_inflate`` out over a Python thread pool the way the reference
fans libdeflate calls out over worker threads (reference
src/par/decompress.rs:161-187).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from gzp_tpu_torch.errors import DecompressError

SOURCE = Path(__file__).resolve().parent / "native" / "gzptpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_ERROR_NAMES = {
    -2: "bad block type",
    -3: "bad huffman code",
    -4: "output overflow",
    -5: "bad stored block",
    -6: "distance out of range",
    -7: "truncated input",
    -8: "bad dynamic header",
}


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"gzptpu_native-{h.hexdigest()[:12]}.so"


def _build_library() -> Path:
    so_path = library_path()
    if so_path.is_file():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({r.returncode}) building {SOURCE}:\n{r.stderr}{r.stdout}")
    os.replace(tmp, so_path)
    return so_path


class NativeCodec:
    """ctypes facade over the native library."""

    def __init__(self) -> None:
        lib = ctypes.CDLL(str(_build_library()))
        lib.gzptpu_inflate.restype = ctypes.c_int
        lib.gzptpu_inflate.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.gzptpu_snappy_decompress.restype = ctypes.c_int
        lib.gzptpu_snappy_decompress.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        for name in ("gzptpu_crc32", "gzptpu_crc32c", "gzptpu_adler32"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint32
            fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
        self._lib = lib

    def inflate(self, data: bytes, out_size: int) -> bytes:
        """Inflate a raw deflate stream into exactly ``out_size`` bytes
        (sizes come from block footers — reference decode_block,
        src/deflate.rs:384-404)."""
        out = np.empty(out_size, dtype=np.uint8)
        written = ctypes.c_size_t(0)
        rc = self._lib.gzptpu_inflate(
            data,
            len(data),
            out.ctypes.data_as(ctypes.c_void_p),
            out_size,
            ctypes.byref(written),
            None,
        )
        if rc != 0:
            raise DecompressError(f"inflate failed: {_ERROR_NAMES.get(rc, rc)}")
        if written.value != out_size:
            raise DecompressError(
                f"inflate produced {written.value} bytes, expected {out_size}"
            )
        return out.tobytes()

    def inflate_into(self, data: bytes, out: memoryview) -> tuple[int, int]:
        """Inflate into a caller buffer; returns (bytes_written,
        input_bytes_consumed)."""
        buf = np.frombuffer(out, dtype=np.uint8)
        written = ctypes.c_size_t(0)
        consumed = ctypes.c_size_t(0)
        rc = self._lib.gzptpu_inflate(
            data,
            len(data),
            buf.ctypes.data_as(ctypes.c_void_p),
            len(buf),
            ctypes.byref(written),
            ctypes.byref(consumed),
        )
        if rc != 0:
            raise DecompressError(f"inflate failed: {_ERROR_NAMES.get(rc, rc)}")
        return written.value, consumed.value

    def snappy_decompress(self, data: bytes, max_out: int) -> bytes:
        """Decompress one raw snappy block (<= ``max_out`` plain bytes):
        the frame decoder's block codec (the reference gets it from the
        snap crate, reference examples/snap_decode.rs)."""
        out = np.empty(max_out, dtype=np.uint8)
        written = ctypes.c_size_t(0)
        rc = self._lib.gzptpu_snappy_decompress(
            data,
            len(data),
            out.ctypes.data_as(ctypes.c_void_p),
            max_out,
            ctypes.byref(written),
        )
        if rc != 0:
            raise DecompressError(
                f"snappy decompress failed: {_ERROR_NAMES.get(rc, rc)}"
            )
        return out[: written.value].tobytes()

    def crc32(self, data: bytes, value: int = 0) -> int:
        return self._lib.gzptpu_crc32(data, len(data), value)

    def crc32_view(self, view: memoryview, value: int = 0) -> int:
        """CRC32 over a writable buffer view without copying (the
        read-all path checksums slices of one preallocated output
        buffer)."""
        n = len(view)
        arr = (ctypes.c_char * n).from_buffer(view)
        return self._lib.gzptpu_crc32(arr, n, value)

    def crc32c(self, data: bytes, value: int = 0) -> int:
        return self._lib.gzptpu_crc32c(data, len(data), value)

    def adler32(self, data: bytes, value: int = 1) -> int:
        return self._lib.gzptpu_adler32(data, len(data), value)


_native: NativeCodec | None = None
_native_lock = threading.Lock()


def get_native() -> NativeCodec:
    global _native
    if _native is None:
        with _native_lock:
            if _native is None:
                _native = NativeCodec()
    return _native
