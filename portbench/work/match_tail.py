"""K6 (``csrc/match_tail.cu``): one launch per batch at levels 0-5. Reads
the rows' bytes, a packed candidate per slot, lengths and halo starts,
writes a length and a distance per position; about 90 integer operations
per slot, which bound it."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, n, slots = s["rows"], s["row"], s["rows"] * s["npad"]
    return [(b * n + slots * 4 + 8 * b + 2 * b * n * 4, slots * 90)]
