"""K10 (``csrc/pack_prescan.cu``): one launch per batch. Reads each row's
E bit entries (value and width), writes the scanned offsets over the
entries padded to whole tiles, and one length per row. A row's entries
are, per deflate sub-block, 339 header fields, one entry per position and
the end-of-block symbol. Bound by bytes."""

LANES = 128
HEADER_FIELDS = 1 + 3 + 19 + 316


def per_batch(s: dict) -> list[tuple[int, int]]:
    b, sub = s["rows"], s["subblocks"]
    e = sub * (HEADER_FIELDS + s["block"] // sub + 1)
    ep = -(-max(-(-(e + 1) // LANES), 8) // 8) * 8 * LANES
    return [(2 * b * e * 4 + 2 * b * ep * 4 + 4 * b, 0)]
