"""The device's idle share of a traced span: 1 - the union of its kernel,
copy and memset intervals over the span's wall time, in percent."""


def share(s: dict, direction: str) -> float | None:
    if s.get("direction") != direction or not s["window_s"]:
        return None
    return 100 * (1 - s["busy_s"] / s["window_s"])
