"""BENCHMARK.json against the benchmark's contract, and a configuration,
a traffic mix and a metric added as new files only."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = harness.ROOT
SPEC = json.loads(harness.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_units_and_lines():
    assert set(SPEC) == TOP
    assert len(json.dumps(SPEC)) <= 64 * 1024
    for part, keys in KEYS.items():
        names = [e["name"] for e in SPEC[part]]
        assert len(names) == len(set(names)), part
        for e in SPEC[part]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and part in ("configs", "workloads", "per_layer"):
                    assert _line(e[k]), (e["name"], k)
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and (ROOT / p).is_dir()
        assert not p.startswith("/") and ".." not in p.split("/")


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert {w["config"] for w in cells.values()} == set(configs)  # every config keeps a cell
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for c in configs.values():
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith(tuple(SPEC["paths"]))
        conf = json.loads(path.read_text())
        assert _line(conf["source"]) and conf["reduced"] == c["reduced"]
        assert (harness.HERE / "formats" / f"{conf['format']}.py").is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in cells.values():
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        traffic = json.loads((harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (harness.HERE / "corpus" / f"{traffic['corpus']}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= set(cells), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    moves = {m["name"]: m["moves"] for m in SPEC["per_layer"]}
    assert all(moves[m["name"]] in names for m in c.per_layer)
    assert set(c.metric_readers()) == {m["name"] for m in c.per_layer}


def test_a_config_traffic_and_metric_added_as_files(tmp_path):
    """A later change adds a deployment, a mix and a metric as new files
    and entries only: the harness finds and runs them by name."""
    base = tmp_path / "portbench"
    shutil.copytree(harness.HERE, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    conf = json.loads((base / "configs" / "gzp-mgzip-l3.json").read_text())
    conf.update(level=1, source="https://github.com/sstadick/gzp (a level-1 deployment)")
    (base / "configs" / "gzp-mgzip-l1.json").write_text(json.dumps(conf))
    mix = json.loads((base / "traffic" / "write-64k.json").read_text())
    mix.update(write_bytes=32768, corpus_bytes=1 << 19, warmup_batches=1, trace_batches=2,
               keep_bytes=1 << 24)
    (base / "traffic" / "write-32k.json").write_text(json.dumps(mix))
    (base / "metrics" / "batches.compress.py").write_text(
        "def read(s):\n    return float(s['batches'])\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "gzp-mgzip-l1", "source": conf["source"],
                            "file": "portbench/configs/gzp-mgzip-l1.json", "reduced": [],
                            "why": "level 1"})
    spec["workloads"].append({"name": "mgzip-l1.text", "config": "gzp-mgzip-l1",
                              "traffic": "write-32k", "chips": 1, "why": "level 1"})
    for m in spec["end_to_end"]:
        m.get("workloads", []).append("mgzip-l1.text")
    spec["per_layer"].append({"name": "batches.compress", "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "Encoder stages",
                              "moves": "compress_GBps", "workloads": ["mgzip-l1.text"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    from portbench import run as runner

    cell = harness.load_cell("mgzip-l1.text", tmp_path / "BENCHMARK.json", base)
    assert cell.config["level"] == 1 and cell.traffic["write_bytes"] == 32768
    cell.config["rows"] = 2
    line = runner.run(runner.Ctx(cell, 2**31 + 99, 1.0, True, "cpu"))
    assert line["correct"]
    assert line["metrics"]["batches.compress"] == {"value": 2.0, "unit": "batches"}
