"""The package kernels' share of their roofline in a traced span: the sum
of their bounds (``portbench/work/<kernel>.py``, each launch's bytes at
HBM bandwidth or its operations at the integer ALU rate) over the sum of
their device time. A kernel with no work file adds its time and no bound.
None where no package kernel ran."""


def share(s: dict, direction: str) -> float | None:
    if s.get("direction") != direction:
        return None
    ran = [k for k in s["kernels"].values() if k["launches"]]
    device = sum(k["device_s"] for k in ran)
    if not device:
        return None
    return 100 * sum(k["bound_s"] or 0.0 for k in ran) / device
