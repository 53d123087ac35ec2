"""K5 (``csrc/hash_merge.cu``): one launch per batch at levels 6-9 (K2's
function at 7 payload words, after K4). Reads each hash-sorted slot's key,
its common prefixes at lags 1-2 and the halo starts, writes a position and
a packed candidate per slot. Bound by bytes."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, slots = s["rows"], s["rows"] * s["npad"]
    return [(slots * 8 + 2 * slots * 4 + 4 * b + 2 * slots * 4, 0)]
