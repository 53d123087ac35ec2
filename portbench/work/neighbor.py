"""K2 (``csrc/neighbor.cu``): one launch per batch at levels 0-5. Reads
each sorted slot's key and payload words and the halo starts, writes a
position and a packed candidate per slot. Bound by bytes."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, slots, pw = s["rows"], s["rows"] * s["npad"], s["payload_words"]
    return [(slots * (8 + 4 * pw) + 4 * b + 2 * slots * 4, 0)]
