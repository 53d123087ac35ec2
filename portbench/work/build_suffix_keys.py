"""K7 (``csrc/build_suffix_keys.cu``): one launch per batch at levels 6-9.
Reads each row's bytes, writes ``payload_words`` key words and a position
per padded slot. Bound by bytes."""


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, slots, pw = s["rows"], s["rows"] * s["npad"], s["payload_words"]
    return [(b * s["row"] + (pw + 1) * slots * 4, 0)]
