"""K1 (``csrc/build_keys.cu``): one launch per batch (the hash pass), at
the level's payload words. Reads each row's bytes, writes a key and
``payload_words`` words per padded slot. Bound by bytes."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, pw = s["rows"], s["payload_words"]
    return [(b * s["row"] + (1 + pw) * b * s["npad"] * 4, 0)]
