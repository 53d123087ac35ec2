"""gzp_tpu_torch stands alone: it imports with jax and gzp_tpu blocked, and
no file of it, nor ``chip_smoke.py``, ``tools/`` or the port's examples,
names either; an installed copy ships every source it builds.

tests/conftest.py imports jax into every test process, so the import
check runs in a fresh interpreter.
"""

import pathlib
import re
import subprocess
import sys
import tomllib

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


PORT_EXAMPLES = ("pigz_clone_torch.py", "block_decompress_torch.py", "snap_decode_torch.py")


def test_chip_smoke_and_tools_name_neither():
    """``chip_smoke.py``, ``tools/`` and the port's examples name neither."""
    root = PKG.parent
    examples = [root / "examples" / name for name in PORT_EXAMPLES]
    files = [root / "chip_smoke.py", *sorted((root / "tools").glob("*")), *examples]
    assert len(files) > 1
    assert all(f.is_file() for f in examples)
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


def test_package_data_ships_the_ports_sources():
    """``[tool.setuptools.package-data]`` in pyproject.toml names the port's
    C++ host codec and every CUDA source: an installed (not editable) copy
    builds both at first use."""
    root = PKG.parent
    with open(root / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = set()
    for package, patterns in data.items():
        pkg_dir = root.joinpath(*package.split("."))
        for pattern in patterns:
            shipped.update(p.resolve() for p in pkg_dir.glob(pattern))
    want = [PKG / "runtime" / "native" / "gzptpu_native.cpp",
            *sorted(p for p in (PKG / "csrc").iterdir() if p.is_file())]
    assert len(want) > 10
    missing = [str(p.relative_to(root)) for p in want if p.resolve() not in shipped]
    assert not missing, missing
