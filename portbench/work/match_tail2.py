"""K9 (``csrc/match_tail2.cu``): one launch per batch at levels 6-9. Reads
the rows' bytes, two packed candidates per slot, lengths and halo starts,
writes a length and a distance per position; about 140 integer operations
per slot, which bound it."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, n, slots = s["rows"], s["row"], s["rows"] * s["npad"]
    return [(b * n + 2 * slots * 4 + 8 * b + 2 * b * n * 4, slots * 140)]
