"""gzp_tpu_torch stands alone: it imports with jax and gzp_tpu blocked, and
no file of it, nor ``chip_smoke.py`` or ``tools/``, names either.

tests/conftest.py imports jax into every test process, so the import
check runs in a fresh interpreter.
"""

import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "gzp_tpu_torch"
PATTERN = re.compile(r"import jax|from jax|gzp_tpu\.")

_BLOCKED_IMPORT = """
import pkgutil, sys
sys.modules["jax"] = None
sys.modules["gzp_tpu"] = None
import gzp_tpu_torch
for m in pkgutil.walk_packages(gzp_tpu_torch.__path__, "gzp_tpu_torch."):
    __import__(m.name)
print("ok", len([m for m in sys.modules if m.startswith("gzp_tpu_torch")]))
"""


def test_imports_without_jax_or_gzp_tpu():
    r = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=PKG.parent, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    assert not any(m == "jax" or m.startswith("jax.") for m in r.stdout.split())


def _offenders(files):
    out = []
    for f in files:
        if f.is_file() and f.suffix in (".py", ".cu", ".cuh"):
            for i, line in enumerate(f.read_text().splitlines(), 1):
                if PATTERN.search(line):
                    out.append(f"{f.relative_to(PKG.parent)}:{i}: {line.strip()}")
    return out


def test_no_file_names_jax_or_gzp_tpu():
    offenders = _offenders(PKG.rglob("*"))
    assert not offenders, "\n".join(offenders)


def test_chip_smoke_and_tools_name_neither():
    root = PKG.parent
    files = [root / "chip_smoke.py", *sorted((root / "tools").glob("*"))]
    assert len(files) > 1
    offenders = _offenders(files)
    assert not offenders, "\n".join(offenders)


def test_native_codec_is_the_ports_own():
    """The host codec is built from the port's own copy of the C++ source
    (verbatim), into the port's ``_build/``, never from or into gzp_tpu's
    runtime directory."""
    from gzp_tpu_torch.runtime import get_native, native_lib

    assert PKG in native_lib.SOURCE.parents and native_lib.SOURCE.is_file()
    ref = PKG.parent / "gzp_tpu" / "runtime" / "native" / "gzptpu_native.cpp"
    assert native_lib.SOURCE.read_bytes() == ref.read_bytes()
    assert native_lib.library_path().parent == PKG / "_build"
    assert pathlib.Path(get_native()._lib._name) == native_lib.library_path()
