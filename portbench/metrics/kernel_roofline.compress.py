"""The package kernels' share of their roofline on the compress path (see
``roofline.py``)."""

from pathlib import Path

from portbench.harness import load_module

_share = load_module(Path(__file__).with_name("roofline.py")).share


def read(s: dict) -> float | None:
    return _share(s, "compress")
