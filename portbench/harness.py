"""What every cell shares: finding a cell's pieces by the names in
``BENCHMARK.json``, the shapes its kernels see, the sink, and the checks
around a run. Nothing here imports the port or torch at import time."""

from __future__ import annotations

import bisect
import importlib.util
import json
import mmap
import os
import re
import sys
import threading
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "gzp_tpu")  # top-level module names


def load_module(path: Path) -> ModuleType:
    """Import one file of the benchmark by its path (names may hold dots)."""
    name = "portbench_" + re.sub(r"\W", "_", str(Path(path).resolve().with_suffix("")))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def plugin(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """``portbench/<kind>/<name>.py``."""
    path = base / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return load_module(path)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    format: ModuleType
    end_to_end: list[dict]
    per_layer: list[dict]
    base: Path = HERE

    def metric_readers(self) -> dict[str, ModuleType]:
        return {m["name"]: plugin("metrics", m["name"], self.base) for m in self.per_layer}


def load_cell(name: str, bench: Path = BENCHMARK, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench``: its configuration file, its traffic
    mix (``portbench/traffic/<traffic>.json``), its format's plain reference
    (``portbench/formats/<format>.py``) and the metrics it reports."""
    spec = json.loads(Path(bench).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench}; there are {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((Path(bench).parent / conf["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if here(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if here(m) and m["moves"] in reported]
    fmt = plugin("formats", config["format"], base)
    return Cell(name, w["chips"], config, traffic, fmt, e2e, layer, base)


def shapes(config: dict, halo: int) -> dict:
    """What a cell's kernels see in one batch: ``rows`` blocks of ``block``
    bytes, rows of ``row`` bytes (the block and its halo) padded to
    ``npad`` (whole tiles of 8 x 128), and the search-effort knobs the port
    picks for the level (``DeflateEncodeConfig.for_level``, its
    configuration only)."""
    from gzp_tpu_torch.ops.deflate_kernel import DeflateEncodeConfig

    block = config["block_bytes"]
    row = block + halo
    knobs = DeflateEncodeConfig.for_level(block, "stream", "none", config["level"])
    return {"rows": config["rows"], "block": block, "row": row,
            "npad": -(-row // 1024) * 1024, "level": config["level"],
            **{k: getattr(knobs, k)
               for k in ("payload_words", "lags", "suffix_keys", "subblocks", "matcher")}}


def kernel_bounds(summary: dict, shape: dict, base: Path = HERE) -> None:
    """Add to each package kernel of ``summary["kernels"]`` its ``bound_s``
    over the span: ``portbench/work/<kernel>.py``'s bound of one batch's
    launches, spread evenly over them, times the launches traced. A kernel
    that ran with no work file gets ``None`` and is named in
    ``summary["unbounded"]``."""
    from portbench import peaks

    summary["unbounded"] = []
    for name, k in summary["kernels"].items():
        if not k["launches"]:
            k["bound_s"] = 0.0
            continue
        path = base / "work" / f"{name}.py"
        if not path.is_file():
            k["bound_s"] = None
            summary["unbounded"].append(name)
            continue
        per_batch = load_module(path).per_batch(shape)
        each = sum(peaks.bound_s(*w) for w in per_batch) / len(per_batch)
        k["bound_s"] = each * k["launches"]


class Arena:
    """Where a window keeps what it will check: ``size`` bytes mapped and
    faulted in during set-up, so that keeping the output costs the window
    a copy and no page faults. The mapping is made on a thread of its own,
    so that it overlaps the rest of set-up; the first use waits for it.
    Bytes past ``size`` are kept as objects of their own (``overflow``),
    each with where it ends in the stream, so that ``at`` finds any range
    in time linear in its length."""

    def __init__(self, size: int):
        self._size = max(size, 1)
        self._mapped: memoryview | None = None
        self._mapping = threading.Thread(target=self._map_in, daemon=True)
        self._mapping.start()
        self.nbytes = 0
        self._inside = 0  # bytes kept in the mapping
        self.overflow: list[bytes] = []
        self._ends: list[int] = []  # where each overflow part ends

    def _map_in(self) -> None:
        flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | getattr(mmap, "MAP_POPULATE", 0)
        self._mapped = memoryview(mmap.mmap(-1, self._size, flags=flags))

    @property
    def _view(self) -> memoryview:
        if self._mapped is None:
            self._mapping.join()
        return self._mapped

    def keep(self, b) -> None:
        n = len(b)
        if not self.overflow and n <= len(self._view) - self._inside:
            self._view[self._inside: self._inside + n] = b
            self._inside += n
        else:
            self.overflow.append(bytes(b))
            self._ends.append(self.nbytes + n)
        self.nbytes += n

    def at(self, pos: int, n: int) -> bytes:
        """``n`` bytes kept from ``pos`` on."""
        end = min(pos + n, self.nbytes)
        if end <= self._inside:
            return bytes(self._view[pos: end])
        out = [self._view[pos: self._inside]] if pos < self._inside else []
        i = bisect.bisect_right(self._ends, pos)
        while i < len(self._ends) and self._ends[i] - len(self.overflow[i]) < end:
            start = self._ends[i] - len(self.overflow[i])
            out.append(memoryview(self.overflow[i])[max(pos - start, 0): end - start])
            i += 1
        return b"".join(out)

    def parts(self) -> list:
        """The bytes kept, in order."""
        return [self._view[: self._inside], *self.overflow]


class Sink:
    """The stream's destination: keeps every byte written, in order, in
    ``arena``."""

    def __init__(self, arena: Arena):
        self.arena = arena

    @property
    def nbytes(self) -> int:
        return self.arena.nbytes

    @property
    def parts(self) -> list:
        return self.arena.parts()

    def write(self, b) -> int:
        self.arena.keep(b)
        return len(b)

    def flush(self) -> None:
        pass


class NullSink:
    """A destination that counts what it is given and keeps nothing."""

    def __init__(self):
        self.nbytes = 0

    def write(self, b) -> int:
        self.nbytes += len(b)
        return len(b)

    def flush(self) -> None:
        pass


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})
