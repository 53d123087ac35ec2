"""Host milliseconds per batch of the write path: the traced span's wall
time less the time its thread spent inside CUDA runtime calls that wait on
the device, over the span's batches of input."""


def read(s: dict) -> float | None:
    if s.get("direction") != "compress" or not s["batches"]:
        return None
    return (s["window_s"] - s["wait_s"]) / s["batches"] * 1e3
