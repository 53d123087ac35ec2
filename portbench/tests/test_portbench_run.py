"""The command itself: no card, no result; nothing of JAX loaded."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def test_exits_non_zero_without_a_card():
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mgzip-l3.text", "--seed",
         str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_no_module_of_jax_or_gzp_tpu_after_every_harness_module():
    """Import every module of the harness and every plug-in, and the port
    with its kernels' modules, in a fresh interpreter."""
    code = f"""
import importlib, json, sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench import harness, trace, peaks, run
from portbench.drivers import read, write
from portbench.formats import members, gzip, mgzip, bgzf
from portbench.corpus import text
for kind in ("metrics", "work", "formats", "drivers", "corpus"):
    for p in sorted((harness.HERE / kind).glob("*.py")):
        harness.load_module(p)
import gzp_tpu_torch
from gzp_tpu_torch.ops import inflate_kernel, lz_cuda, pack_cuda
from gzp_tpu_torch.parallel import decompress
print(json.dumps(harness.forbidden_modules()))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    found, tops = (json.loads(x) for x in p.stdout.strip().splitlines()[-2:])
    assert found == []
    assert "gzp_tpu_torch" in tops and not {"jax", "jaxlib", "flax", "gzp_tpu"} & set(tops)


def test_forbidden_compares_whole_top_level_names():
    sys.modules.setdefault("gzp_tpu_torch_probe_x", sys)
    try:
        assert "gzp_tpu_torch_probe_x" not in harness.forbidden_modules()
    finally:
        del sys.modules["gzp_tpu_torch_probe_x"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_on_the_card(cuda, trace):
    """On a card: one short run of the flagship cell prints a correct result
    with its metrics, the compared numbers last."""
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mgzip-l3.text", "--seed",
         str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "compared"
    want = {"host_ms_per_batch.compress", "launches_per_batch.compress",
            "kernel_roofline.compress", "idle_share.compress"} if trace else {
        "compress_GBps", "out_per_in", "setup_s"}
    assert set(line["metrics"]) == want
    assert p.stderr.strip().splitlines()[-1].startswith("compared ")
