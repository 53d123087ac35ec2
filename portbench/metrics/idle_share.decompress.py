"""The device's idle share on the decompress path (see ``idle.py``)."""

from pathlib import Path

from portbench.harness import load_module

_share = load_module(Path(__file__).with_name("idle.py")).share


def read(s: dict) -> float | None:
    return _share(s, "decompress")
