import gzip
import io
import struct

import pytest

from portbench.corpus import text
from portbench.formats import bgzf, gzip as gzip_ref, members, mgzip


@pytest.fixture(scope="module")
def data():
    return text.make(400_000, 2**31 + 17)


def test_bgzf_writer_round_trips_and_caps_members(data):
    ms = bgzf.write(data, 6, 65280)
    stream = b"".join(ms)
    assert gzip.decompress(stream) == data
    assert all(len(m) <= 65536 for m in ms)
    assert ms[-1] == members.BGZF_EOF
    assert all(members.BGZF.size_of(m[:18]) == len(m) for m in ms)


def test_mgzip_writer_round_trips(data):
    ms = mgzip.write(data, 3, 131072)
    assert gzip.decompress(b"".join(ms)) == data
    assert all(struct.unpack_from("<I", m, 16)[0] == len(m) for m in ms)


@pytest.mark.parametrize("fmt", [mgzip, bgzf])
def test_member_check_passes_good_and_counts_each_fault(fmt, data):
    block = 65280 if fmt is bgzf else 131072
    want = members.Expected(data, len(data))
    ms = fmt.write(data, 3, block)
    assert fmt.check(ms, want) == {"frames_bad": 0, "data_bad": 0, "checks_bad": 0,
                                   "length_gap": 0}
    no_crc = [members.member(fmt.FRAMING, data[i: i + block], 3, crc=0)
              for i in range(0, len(data), block)] + ms[len(ms) - (fmt is bgzf):]
    assert fmt.check(no_crc, want)["checks_bad"] == -(-len(data) // block)
    dropped = ms[:1] + ms[2:]
    bad = fmt.check(dropped, want)
    assert bad["data_bad"] > 0 and bad["length_gap"] == block
    flipped = bytearray(ms[1])
    flipped[40] ^= 1
    assert sum(fmt.check([ms[0], bytes(flipped), *ms[2:]], want).values()) > 0


def test_bgzf_check_wants_eof(data):
    ms = bgzf.write(data, 6, 65280)
    assert bgzf.check(ms[:-1], members.Expected(data, len(data)))["frames_bad"] == 1


def _gzip_stream(data, combine=True):
    sink = io.BytesIO()
    w = gzip_ref.Writer(sink, 3, 131072, 2, combine=combine)
    for i in range(0, len(data), 65536):
        w.write(data[i: i + 65536])
    w.finish()
    return sink.getvalue()


def test_gzip_reference_stream_and_its_control(data):
    want = members.Expected(data, len(data))
    good = _gzip_stream(data)
    assert gzip.decompress(good) == data
    assert gzip_ref.check([good], want) == {"frames_bad": 0, "data_bad": 0, "checks_bad": 0,
                                            "length_gap": 0}
    assert gzip_ref.check([_gzip_stream(data, combine=False)], want)["checks_bad"] == 1
    assert gzip_ref.check([good[:-20]], want)["frames_bad"] == 1
    # a cycled input: the expected bytes wrap round the corpus
    twice = members.Expected(data, 2 * len(data))
    assert sum(gzip_ref.check([gzip.compress(data + data)], twice).values()) == 0


def test_reference_reader_and_its_control(data):
    stream = b"".join(bgzf.write(data, 6, 65280))
    r = members.Reader(members.BGZF, stream, 8)
    got = b"".join(iter(lambda: r.read(1 << 20), b""))
    assert got == data
    c = bgzf.control_reader(stream, {"rows": 8})
    assert b"".join(iter(lambda: c.read(1 << 20), b"")) != data


def test_arena_keeps_bytes_in_order_past_its_size():
    from portbench.harness import Arena, Sink

    a = Arena(10)
    for piece in (b"abcd", b"efgh", b"ijkl", b"mn"):
        a.keep(piece)
    assert a.nbytes == 14 and b"".join(a.parts()) == b"abcdefghijklmn"
    assert a.at(2, 4) == b"cdef" and a.at(6, 6) == b"ghijkl"
    s = Sink(Arena(1 << 12))
    s.write(b"x" * 100)
    assert s.nbytes == 100 and b"".join(s.parts) == b"x" * 100


def test_arena_finds_reads_in_a_long_overflow_in_linear_time():
    """A run that outgrows its arena keeps thousands of reads past it; the
    check reads each back, and must not copy the whole arena each time."""
    import random
    import time

    from portbench.harness import Arena

    rng = random.Random(7)
    a = Arena(1 << 16)
    pieces = [rng.randbytes(rng.choice((0, 1, 4096, 8191, 8192))) for _ in range(4000)]
    stream = b"".join(pieces)
    t = time.perf_counter()
    for p in pieces:
        a.keep(p)
    assert len(a.overflow) > 3900 and a.nbytes == len(stream)
    pos = 0
    for p in pieces:  # every read as kept, as the read driver checks them
        assert a.at(pos, len(p)) == p
        pos += len(p)
    for _ in range(500):  # and ranges across the mapping's end and many parts
        lo = rng.randrange(len(stream))
        n = rng.randrange(1, 40000)
        assert a.at(lo, n) == stream[lo: lo + n]
    assert a.at(0, 1 << 16) == stream[: 1 << 16]
    assert a.at(len(stream) - 5, 10) == stream[-5:]
    # a copy of the whole stream per read would be some 100 GB of copies here
    assert time.perf_counter() - t < 30
