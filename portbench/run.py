#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on a CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's pieces by name (``portbench/configs``, ``traffic``,
``corpus``, ``formats``, ``drivers``, ``metrics``, ``work``), makes its
data from ``--seed``, warms up, measures for ``--seconds`` (``--trace 1``:
profiles a fixed span of batches instead), checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output, each compared number beside its limit last on standard
error. Exits non-zero, printing no result, without a CUDA card (or
with fewer than the cell asks for), or when a module of JAX or of the JAX
package ``gzp_tpu`` was loaded. ``--control 1`` puts the format's control
(the plain reference with one guarantee broken) in the port's place.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # the checkout's root

from portbench import harness  # noqa: E402

AGE0 = harness.process_age_s()  # the interpreter's start, before T0


class Ctx:
    """What a driver needs of the run: the cell, the seed and window, the
    device, and the set-up clock."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: str,
                 control: bool = False, t0: float = T0, age0: float = AGE0):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.control = device, control
        self._t0, self._age0 = t0, age0
        self.setup_s: float | None = None
        # what the window keeps for the check, mapped while the rest sets up
        self.arena = harness.Arena(cell.traffic["keep_bytes"])

    def corpus(self) -> bytes:
        tr = self.cell.traffic
        return harness.plugin("corpus", tr["corpus"], self.cell.base).make(
            tr["corpus_bytes"], self.seed)

    def synchronize(self) -> None:
        import torch

        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        import torch

        if str(self.device).startswith("cuda"):
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self._t0 + self._age0


def run(ctx: Ctx) -> dict:
    """Drive the cell once and return its result line (a dict, keys in the
    order printed) and the compared numbers."""
    driver = harness.plugin("drivers", ctx.cell.traffic["driver"], ctx.cell.base)
    out = driver.run(ctx)
    compared = {k: {"value": v, "limit": lim} for k, (v, lim) in out["compared"].items()}
    line = {"correct": all(c["value"] <= c["limit"] for c in compared.values()),
            "attempted": out["attempted"], "failed": out["failed"], "metrics": {}}
    if ctx.trace:
        summary = out["summary"]
        for m, reader in ctx.cell.metric_readers().items():
            value = reader.read(summary)
            if value is not None:
                unit = next(s["unit"] for s in ctx.cell.per_layer if s["name"] == m)
                line["metrics"][m] = {"value": value, "unit": unit}
    else:
        values = {**out["end_to_end"], "setup_s": ctx.setup_s}
        for m in ctx.cell.end_to_end:
            line["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    line["device"] = {"memory_peak_bytes": out["memory_peak_bytes"]}
    if ctx.trace:
        line["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        line["breakdown"] = summary["breakdown"]
    line["compared"] = compared
    return line


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload)
    chips = cell.chips
    ctx = None
    if Path("/dev/nvidiactl").exists():  # a card is likely: set up while torch imports
        ctx = Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", bool(args.control))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    ctx = ctx or Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                     bool(args.control))
    line = run(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of gzp_tpu were loaded: {found}", file=sys.stderr)
        return 3
    line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                      **line["device"]}
    print(f"portbench: {args.workload} seed {args.seed} on {card()}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
