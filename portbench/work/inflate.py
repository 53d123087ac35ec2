"""K11 (``csrc/inflate.cu``): one launch per device batch of the read
path. Reads each block's compressed payload once and its two lengths,
writes each output row whole (its zero tail too), the count and ``ok``:
bound by bytes. ``inflate_in_bytes`` is the batch's payload, from the
stream the benchmark wrote."""

OUT_CAP = 65536  # the device read's row, ``_DeviceBatch.OUT_CAP``


def per_batch(s: dict) -> list[tuple[int, int]]:
    b = s["rows"]
    return [(int(s["inflate_in_bytes"]) + 8 * b + b * OUT_CAP + 5 * b, 0)]
