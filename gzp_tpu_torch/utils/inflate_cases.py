"""Raw Deflate streams that put the batched inflate (K11,
``ops/inflate_kernel.py``) at each of its rules: every block type, block
counts at and past ``max_blocks``, streams that end exactly at ``in_cap``
(literals, and matches), each condition that makes a row not ok, the
reference's quirks that zlib would refuse (a fixed-code length symbol
286, a code-length repeat cut at HLIT + HDIST), and the edges of a
table-driven decode's lookup tables (codes of 1-15 bits used on both
sides of the table's bits, an over-subscribed code, a code missing only
past the table's bits). Streams come from zlib or from a small bit
writer; inputs are made from a numpy seed.
"""

from __future__ import annotations

import zlib

import numpy as np

_FIXED_LIT = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8


def _canonical_codes(lens) -> dict[int, tuple[int, int]]:
    """symbol -> (code, length) of a canonical Huffman code (RFC 1951 3.2.2)."""
    count = [0] * 16
    for n in lens:
        count[n] += 1
    count[0] = 0
    code, nxt = 0, [0] * 16
    for bits in range(1, 16):
        code = (code + count[bits - 1]) << 1
        nxt[bits] = code
    out = {}
    for s, n in enumerate(lens):
        if n:
            out[s] = (nxt[n], n)
            nxt[n] += 1
    return out


class _Bits:
    """LSB-first bit writer; Huffman codes go in MSB-first."""

    def __init__(self):
        self.acc, self.n = 0, 0

    def put(self, value: int, nbits: int) -> "_Bits":
        self.acc |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        return self

    def code(self, c: tuple[int, int]) -> "_Bits":
        v, n = c
        return self.put(int(f"{v:0{n}b}"[::-1], 2), n)

    def bytes(self) -> bytes:
        return self.acc.to_bytes((self.n + 7) // 8, "little")


def _stored(data: bytes, final: bool) -> bytes:
    n = len(data)
    return bytes([int(final)]) + n.to_bytes(2, "little") + (n ^ 0xFFFF).to_bytes(2, "little") + data


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ", b"lazy ", b"dog. ",
             b"0123456789", b"\n"]
    return b"".join(words[i] for i in rng.integers(0, len(words), n))[:n]


def _raw(data: bytes, level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    return co.compress(data) + co.flush()


def _sync_flushed(data: bytes) -> bytes:
    """``data`` as a raw stream that ends in a sync flush, with no final
    block."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush(zlib.Z_SYNC_FLUSH)


def _dynamic_header(bits: _Bits, hlit: int, hdist: int, cl_lens: dict[int, int]) -> dict:
    """BFINAL=1, BTYPE=2 and the code-length code with ``cl_lens``
    (symbol -> length); returns the code-length code."""
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
    hclen = max(order.index(s) for s in cl_lens) + 1
    bits.put(1, 1).put(2, 2).put(hlit - 257, 5).put(hdist - 1, 5).put(hclen - 4, 4)
    for s in order[:hclen]:
        bits.put(cl_lens.get(s, 0), 3)
    return _canonical_codes([cl_lens.get(s, 0) for s in range(19)])


def _zeros(bits: _Bits, cl: dict, n: int) -> None:
    """``n`` zero code lengths with repeat code 18 (11-138 each)."""
    while n > 0:
        k = min(n, 138)
        bits.code(cl[18]).put(k - 11, 7)
        n -= k


def _lit_a_eob(repeat_cut: bool) -> tuple[bytes, bytes]:
    """A dynamic block whose literal code holds 'A' and end-of-block (1 bit
    each). With ``repeat_cut`` the one distance length is written as a
    138-zero repeat, which the reference cuts at HLIT + HDIST; without it
    the code is 'A' alone and the stream's first code is missing."""
    bits = _Bits()
    cl = _dynamic_header(bits, 257, 1, {0: 2, 1: 2, 17: 2, 18: 2})
    _zeros(bits, cl, 65)
    bits.code(cl[1])  # 'A'
    if repeat_cut:
        _zeros(bits, cl, 190)
        bits.code(cl[1])  # end of block
        bits.code(cl[18]).put(127, 7)  # 138 zeros for the 1 distance length
        lit = _canonical_codes([1 if s in (65, 256) else 0 for s in range(257)])
        bits.code(lit[65]).code(lit[65]).code(lit[256])
        return bits.bytes(), b"AA"
    _zeros(bits, cl, 191)
    bits.code(cl[1])  # one distance code
    bits.put(1, 1)  # a literal/length code that is not in the code
    return bits.bytes(), b""


def _code_lengths_block(lit_lens: list[int], dist_lens: list[int]) -> tuple[_Bits, dict, dict]:
    """BFINAL=1, BTYPE=2 and the header of these literal/length and
    distance code lengths, each sent as itself under a complete
    code-length code (lengths 0-15 at 4 bits); returns the bit writer and
    the two codes."""
    bits = _Bits()
    cl = _dynamic_header(bits, len(lit_lens), len(dist_lens), {s: 4 for s in range(16)})
    for n in (*lit_lens, *dist_lens):
        bits.code(cl[n])
    return bits, _canonical_codes(lit_lens), _canonical_codes(dist_lens)


def _letters_block(lens: dict[int, int], used: list[int], end: bool = True) -> tuple[bytes, bytes]:
    """A dynamic block whose literal/length code is ``lens`` (symbol ->
    length) with one 1-bit distance code: the literals ``used``, then the
    end of block (or, without ``end``, 15 one bits, a code the code may
    lack) -> (stream, its literals)."""
    lit_lens = [lens.get(s, 0) for s in range(257)]
    bits, lit, _ = _code_lengths_block(lit_lens, [1])
    for s in used:
        bits.code(lit[s])
    if end:
        bits.code(lit[256])
    else:
        bits.put(0x7FFF, 15)
    return bits.bytes(), bytes(used)


def _table_edge_rows(seed: int) -> list[tuple[str, bytes, int, bool]]:
    """Rows at the edges of the lookup tables a table-driven decode builds
    (9-11 bits): codes of 1-15 bits used on both sides, over- and
    under-subscribed codes -> (name, stream, out_len, ok)."""
    rng = np.random.default_rng(seed)
    rows = []
    # literal/length code of lengths 1..15 (letter i at i + 1 bits, the end
    # of block at 15): complete, every letter used
    letters = list(range(65, 80))
    used = letters + [int(x) for x in rng.choice(letters, 200)]
    stream, plain = _letters_block({**{s: i + 1 for i, s in enumerate(letters)}, 256: 15}, used)
    assert zlib.decompressobj(-15).decompress(stream) == plain
    rows.append(("lit_code_15_bits", stream, len(plain), True))

    # distance code of lengths 1..15 over symbols 0-15 (symbol i at i + 1
    # bits; 14 and 15 at 15 bits, bases 129 and 193 with 6 extra bits),
    # every distance code used, the long ones twice
    lit_lens = [9] * 256 + [2, 3, 3]  # literals, end of block, lengths 3 and 4
    dist_lens = [min(i + 1, 15) for i in range(16)]
    bits, lit, dcode = _code_lengths_block(lit_lens, dist_lens)
    dist_base = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193]
    dist_extra = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6]
    out = bytearray(rng.integers(0, 256, 400, dtype=np.uint8).tobytes())
    for c in out:
        bits.code(lit[c])
    for d in [*rng.permutation(16), 14, 15, 15, 14]:
        length = int(rng.integers(3, 5))
        ext = int(rng.integers(0, 1 << dist_extra[d]))
        dist = dist_base[d] + ext
        bits.code(lit[254 + length]).code(dcode[int(d)]).put(ext, dist_extra[d])
        for _ in range(length):
            out.append(out[-dist])
        c = int(rng.integers(0, 256))
        bits.code(lit[c])
        out.append(c)
    stream = bits.code(lit[256]).bytes()
    assert zlib.decompressobj(-15).decompress(stream) == bytes(out)
    rows.append(("dist_code_15_bits", stream, len(out), True))

    # over-subscribed: letters at 1..13 bits, the end of block at 14 and
    # three letters at 15, the last of them past 2^15 codes (never
    # decoded); the first length that fits still decodes the others
    over = {**{s: i + 1 for i, s in enumerate(letters[:13])}, 256: 14, 78: 15, 79: 15, 80: 15}
    used = letters + [int(x) for x in rng.choice(letters, 100)]
    stream, plain = _letters_block(over, used)
    rows.append(("lit_code_oversubscribed", stream, len(plain), True))

    # incomplete: letters at 1..14 bits and the end of block at 15 leave
    # the 15-bit code of all ones out; its first 10 bits are those of the
    # 11-15-bit codes, so it is missing only past the table's bits
    under = {**{s: i + 1 for i, s in enumerate(letters[:14])}, 256: 15}
    used = [int(x) for x in rng.choice(letters[:14], 60)]
    stream, plain = _letters_block(under, used, end=False)
    rows.append(("lit_code_incomplete_past_table", stream, len(plain) + 1, False))
    return rows


def inflate_case_batch(in_cap: int = 65536, out_cap: int = 65536, *, seed: int = 0,
                       rows: int | None = None) -> dict:
    """One row per case -> dict(names [R], streams [R, in_cap] u8, in_lens
    and out_lens [R] int32, expect_ok [R] bool: what the reference's rules
    give). ``rows`` pads the batch with more dynamic-text rows (a multiple
    of a batch size keeps one compiled shape). Needs in_cap, out_cap >=
    4096."""
    rng = np.random.default_rng(seed)
    cases: list[tuple[str, bytes, int, int, bool]] = []

    def add(name, stream, out_len, ok, in_len=None):
        cases.append((name, stream, len(stream) if in_len is None else in_len, out_len, ok))

    rand = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    add("stored", _raw(rand, 0), len(rand), True)
    full = rng.integers(0, 256, in_cap - 5, dtype=np.uint8).tobytes()[:out_cap]
    add("stored_to_in_cap", _stored(full, True)[:in_cap], len(full),
        len(full) + 5 <= in_cap)
    text = _text(3000, seed + 1)
    add("fixed", _raw(text, 6, zlib.Z_FIXED), len(text), True)
    add("dynamic", _raw(text, 9), len(text), True)
    add("dynamic_level1", _raw(_text(2500, seed + 2), 1), 2500, True)
    add("rle_dist1", _raw(b"a" * 2500, 6), 2500, True)
    add("tiny", _raw(b"hi", 6), 2, True)

    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    parts = [_text(700, seed + 3), _text(900, seed + 4), _text(500, seed + 5)]
    multi = (co.compress(parts[0]) + co.flush(zlib.Z_SYNC_FLUSH) + co.compress(parts[1])
             + co.flush(zlib.Z_FULL_FLUSH) + co.compress(parts[2]) + co.flush())
    add("multi_block", multi, sum(map(len, parts)), True)
    chunk = _text(40, seed + 6)
    add("blocks_16", b"".join(_stored(chunk, i == 15) for i in range(16)), 16 * 40, True)
    add("blocks_17", b"".join(_stored(chunk, i == 16) for i in range(17)), 17 * 40, False)

    # a fixed-code block of random literals whose last byte is the row's
    # last: the peeks near its end read past in_cap
    fixed = _canonical_codes(_FIXED_LIT)
    lits = rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
    b = _Bits().put(1, 1).put(1, 2)
    for c in lits:
        b.code(fixed[c])
    tail = b.code(fixed[256]).bytes()
    lead = rng.integers(0, 256, in_cap - len(tail) - 5, dtype=np.uint8).tobytes()
    add("huffman_to_in_cap", _stored(lead, False) + tail, len(lead) + len(lits), True)
    # the same with a dynamic block of text, so the symbols read in the
    # last bytes before in_cap include matches with their distances
    text = _text(3000, seed + 10)
    tail = _raw(text, 6)
    lead = _text(in_cap - len(tail) - 5, seed + 11)
    matches_to_in_cap = (_stored(lead, False) + tail, len(lead) + len(text))
    add("garbage_full_row", rng.integers(0, 256, in_cap, dtype=np.uint8).tobytes(), 4000, False)
    for name, first in (("garbage_fixed", 0b011), ("garbage_dynamic", 0b101)):
        g = bytearray(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
        g[0] = (g[0] & ~7) | first
        add(name, bytes(g), 3000, False)

    add("empty", b"\x03\x00", 0, True)
    add("empty_out_len_garbage", rng.integers(0, 256, 64, dtype=np.uint8).tobytes(), 0, True)
    add("btype3", b"\x07" + bytes(8), 10, False)
    bad = bytearray(_stored(b"abcdef", True))
    bad[3] ^= 1
    add("stored_nlen", bytes(bad), 6, False)
    add("hlit_287", _Bits().put(1, 1).put(2, 2).put(30, 5).put(0, 5).put(0, 4).bytes() + bytes(8),
        10, False)
    add("hdist_31", _Bits().put(1, 1).put(2, 2).put(0, 5).put(30, 5).put(0, 4).bytes() + bytes(8),
        10, False)
    bits = _Bits()
    _dynamic_header(bits, 257, 1, {0: 1})
    add("cl_code_missing", bits.put(1, 1).bytes() + bytes(4), 10, False)
    bits = _Bits()
    cl = _dynamic_header(bits, 257, 1, {0: 1, 16: 1})
    add("cl_repeat_first", bits.code(cl[16]).put(0, 2).bytes() + bytes(4), 10, False)
    stream, _ = _lit_a_eob(repeat_cut=False)
    add("lit_code_missing", stream, 1, False)
    stream, plain = _lit_a_eob(repeat_cut=True)
    add("cl_repeat_cut", stream, len(plain), True)

    fixed_dist = _canonical_codes([5] * 30)
    b = _Bits().put(1, 1).put(1, 2).code(fixed[ord("x")]).code(fixed[257])
    add("dist_code_missing", b.code((30, 5)).code(fixed[256]).bytes(), 4, False)
    b = _Bits().put(1, 1).put(1, 2).code(fixed[ord("x")]).code(fixed[257]).code(fixed_dist[1])
    add("dist_past_output", b.code(fixed[256]).bytes(), 4, False)
    b = _Bits().put(1, 1).put(1, 2).code(fixed[ord("x")]).code(fixed[286]).code(fixed_dist[0])
    add("fixed_286_zero_match", b.code(fixed[256]).bytes(), 1, True)

    dyn = _raw(_text(2000, seed + 8), 6)
    add("out_len_short", dyn, 1999, False)
    add("out_len_long", dyn, 2001, False)
    add("in_len_short", dyn, 2000, False, in_len=len(dyn) - 1)
    add("in_len_in_header", dyn, 2000, False, in_len=4)
    add("no_final_block", _sync_flushed(_text(800, seed + 9)), 800, False)
    add("garbage", rng.integers(0, 256, 512, dtype=np.uint8).tobytes(), 100, False)
    for name, stream, out_len, ok in _table_edge_rows(seed + 200):
        add(name, stream, out_len, ok)
    add("matches_to_in_cap", *matches_to_in_cap, True)

    k = 0
    while rows is not None and len(cases) < rows:
        t = _text(int(rng.integers(200, 3000)), seed + 100 + k)
        add(f"pad_dynamic_{k}", _raw(t, int(rng.integers(1, 10))), len(t), True)
        k += 1
    r = len(cases)
    streams = np.zeros((r, in_cap), np.uint8)
    in_lens = np.zeros(r, np.int32)
    out_lens = np.zeros(r, np.int32)
    for i, (_, s, il, ol, _) in enumerate(cases):
        s = s[:in_cap]
        streams[i, : len(s)] = np.frombuffer(s, np.uint8)
        in_lens[i], out_lens[i] = min(il, in_cap), ol
    return dict(names=[c[0] for c in cases], streams=streams, in_lens=in_lens,
                out_lens=out_lens, expect_ok=np.array([c[4] for c in cases]))
