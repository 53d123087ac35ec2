"""Device operations (kernels, copies, memsets) per batch of the write
path in the traced span: what CUDA graphs or fusion would cut."""


def read(s: dict) -> float | None:
    if s.get("direction") != "compress" or not s["batches"]:
        return None
    return s["device_ops"] / s["batches"]
