"""The port's read path against the JAX package's: ``ParDecompress``,
``SyncBlockReader``, the sync readers and writers, ``MultiGzDecoder`` and
``SnappyFrameDecoder``.

Analogs of ``tests/test_decompress.py``. Every stream is written once per
module by the port's ``ZBuilder(...).device("cpu")`` (one by gzp_tpu's
``BgzfSyncWriter``, for the port's reader), from inputs made with numpy
from a seed, and read by both packages: each read must give the same
bytes, and on a corrupt CRC, a bad header, or a truncated block, footer or
chunk, both packages must raise errors of the same class.
"""

import gzip
import io
import struct
import zlib

import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch
from gzp_tpu.formats import snap as jsnap
from gzp_tpu.formats import sync_io as jsync
from gzp_tpu_torch.formats import snap as tsnap
from gzp_tpu_torch.formats import sync_io as tsync
from gzp_tpu_torch.utils.snappy_ref import decode_frames

BS = 32768
PKGS = (gzp_tpu, gzp_tpu_torch)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"end to end decompress test ", b"round and round it goes ",
             b"0123456789abcdef"]
    reps, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        reps.append(w)
        total += len(w)
    return b"".join(reps)[:n]


_STREAMS: dict = {}


def compress(fmt_name, n, seed, nt=2, bs=BS):
    """(input, the port's stream of it), written once per module."""
    key = (fmt_name, n, seed, nt, bs)
    if key not in _STREAMS:
        data = make_text(n, seed)
        buf = io.BytesIO()
        fmt = getattr(gzp_tpu_torch, fmt_name)
        w = gzp_tpu_torch.ZBuilder(fmt).num_threads(nt).buffer_size(bs).device("cpu").from_writer(
            buf)
        w.write(data)
        w.finish()
        _STREAMS[key] = data, buf.getvalue()
    return _STREAMS[key]


def outcome(fn):
    """What a read gives: its bytes, or the class name of its error."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the class name is the result
        assert isinstance(e, (gzp_tpu.GzpError, gzp_tpu_torch.GzpError, ValueError, TypeError,
                              struct.error)), repr(e)
        return type(e).__name__


def both(read):
    """``read(pkg)`` under each package; the outcomes must agree."""
    j, t = (outcome(lambda p=p: read(p)) for p in PKGS)
    assert t == j
    return t


def zlib_bgzf_member(data: bytes) -> bytes:
    """Independent BGZF member built with stdlib zlib (foreign stream)."""
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    bsize = len(payload) + 18 + 8 - 1
    hdr = (bytes([31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 6, 0]) + b"BC" + struct.pack("<H", 2)
           + struct.pack("<H", bsize))
    return hdr + payload + struct.pack("<II", zlib.crc32(data), len(data))


@pytest.mark.parametrize("fmt_name", ["Mgzip", "Bgzf"])
@pytest.mark.parametrize("nt", [1, 4])
def test_etoe_roundtrip(fmt_name, nt):
    data, blob = compress(fmt_name, 200_000, nt)
    got = both(lambda p: p.ParDecompressBuilder(getattr(p, fmt_name)).num_threads(nt)
               .from_reader(io.BytesIO(blob)).read())
    assert got == data


def test_read_in_small_pieces():
    data, blob = compress("Bgzf", 150_000, 5)

    def pieces(p):
        r = p.ParDecompress(p.Bgzf, io.BytesIO(blob), num_threads=2)
        out = bytearray()
        while piece := r.read(1000):
            out += piece
        return bytes(out)

    def readinto(p):
        r = p.ParDecompress(p.Bgzf, io.BytesIO(blob), num_threads=2)
        buf, out = bytearray(4097), bytearray()
        while n := r.readinto(buf):
            out += buf[:n]
        r.finish()
        return bytes(out)

    assert both(pieces) == data
    assert both(readinto) == data


def test_sync_block_reader_and_sync_classes():
    data, blob = compress("Mgzip", 100_000, 6)
    assert both(lambda p: p.SyncBlockReader(p.Mgzip, io.BytesIO(blob)).read()) == data
    assert both(lambda p: p.MgzipSyncReader(io.BytesIO(blob)).read()) == data
    _, bblob = compress("Bgzf", 100_000, 6)
    assert both(lambda p: p.BgzfSyncReader(io.BytesIO(bblob)).read()) == data

    # the port's sync writers, read by both packages' sync readers
    small = data[:40_000]
    for writer, reader in ((tsync.MgzipSyncWriter, "MgzipSyncReader"),
                           (tsync.BgzfSyncWriter, "BgzfSyncReader")):
        buf = io.BytesIO()
        w = writer(buf, device="cpu")
        w.write(small)
        w.finish()
        out = buf.getvalue()
        assert both(lambda p: getattr(p, reader)(io.BytesIO(out)).read()) == small
    # gzp_tpu's BGZF sync writer: the same bytes, read by the port
    jbuf = io.BytesIO()
    jw = jsync.BgzfSyncWriter(jbuf)
    jw.write(small)
    jw.finish()
    assert jbuf.getvalue() == out
    assert tsync.BgzfSyncReader(io.BytesIO(jbuf.getvalue())).read() == small


def test_foreign_bgzf_stream():
    parts = [make_text(60_000, seed=7), make_text(65280, seed=8), b"tail"]
    blob = b"".join(zlib_bgzf_member(p) for p in parts)
    assert both(lambda p: p.ParDecompress(p.Bgzf, io.BytesIO(blob), num_threads=3).read()) \
        == b"".join(parts)


def _damage(blob, kind, fmt_name):
    b = bytearray(blob)
    first = (int.from_bytes(b[16:18], "little") + 1 if fmt_name == "Bgzf"
             else int.from_bytes(b[16:20], "little"))
    if kind == "payload":
        b[30] ^= 0xFF
    elif kind == "crc":
        b[first - 8] ^= 0x01
    elif kind == "isize":
        b[first - 4] ^= 0x01
    elif kind == "header":
        b[12] = ord("X")
    elif kind == "truncated_body":
        del b[-5:]
    elif kind == "truncated_header":
        b += b"\x1f\x8b\x08"
    elif kind == "block_size":
        if fmt_name == "Bgzf":
            b[16:18] = (10).to_bytes(2, "little")
        else:
            b[16:20] = (10).to_bytes(4, "little")
    return bytes(b)


@pytest.mark.parametrize("fmt_name", ["Mgzip", "Bgzf"])
@pytest.mark.parametrize("kind", ["payload", "crc", "isize", "header", "truncated_body",
                                  "truncated_header", "block_size"])
def test_corrupt_block_stream(fmt_name, kind):
    """A damaged stream raises an error of the same class in both
    packages, through read(-1) and through sized reads."""
    _, blob = compress(fmt_name, 50_000, 9)
    bad = _damage(blob, kind, fmt_name)
    fmt = fmt_name
    got = both(lambda p: p.ParDecompress(getattr(p, fmt), io.BytesIO(bad), num_threads=2).read())
    assert isinstance(got, str), kind
    got_sized = both(lambda p: p.ParDecompress(getattr(p, fmt), io.BytesIO(bad),
                                               num_threads=1).read(70_000))
    if kind not in ("truncated_body", "truncated_header"):
        assert got_sized == got  # the damage is in the first block


def _member(data: bytes, flags: int = 0, level: int = 6) -> bytes:
    """One gzip member with the optional header fields of ``flags``."""
    hdr = bytearray([0x1F, 0x8B, 8, flags, 0, 0, 0, 0, 0, 255])
    if flags & 4:
        hdr += struct.pack("<H", 6) + b"ab\x02\x00xy"
    if flags & 8:
        hdr += b"name.txt\x00"
    if flags & 16:
        hdr += b"a comment\x00"
    if flags & 2:
        hdr += struct.pack("<H", zlib.crc32(bytes(hdr)) & 0xFFFF)
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return (bytes(hdr) + co.compress(data) + co.flush()
            + struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF))


def test_multigz_fallback_reader():
    data, blob = compress("Mgzip", 80_000, 10)
    assert both(lambda p: type(p.ParDecompressBuilder(p.Mgzip).maybe_par_from_reader(
        io.BytesIO(blob), num_threads=0)).__name__) == "MultiGzDecoder"
    assert both(lambda p: p.ParDecompressBuilder(p.Mgzip).maybe_par_from_reader(
        io.BytesIO(blob), num_threads=0).read()) == data
    buf = io.BytesIO()
    with gzip.GzipFile(filename="name.txt", fileobj=buf, mode="wb") as g:
        g.write(data)
    assert both(lambda p: p.MultiGzDecoder(io.BytesIO(buf.getvalue())).read()) == data


def test_multigz_header_fields_and_members():
    parts = [make_text(n, s) for n, s in ((30_000, 11), (0, 0), (5_000, 12), (20_000, 13),
                                          (1, 14))]
    blob = b"".join(_member(p, f) for p, f in zip(parts, (4, 8, 16, 2, 4 | 8 | 16 | 2)))
    assert both(lambda p: p.MultiGzDecoder(io.BytesIO(blob)).read()) == b"".join(parts)
    sized = both(lambda p: [r.read(7_000) for r in [p.MultiGzDecoder(io.BytesIO(blob))]
                            for _ in range(9)])
    assert b"".join(sized) == b"".join(parts)


@pytest.mark.parametrize("kind", ["crc", "isize", "magic", "truncated_footer",
                                  "truncated_header", "trailing_garbage"])
def test_multigz_damaged(kind):
    good = _member(make_text(10_000, 15), 8)
    b = bytearray(good + good)
    if kind == "crc":
        b[len(good) - 8] ^= 1
    elif kind == "isize":
        b[len(good) - 4] ^= 1
    elif kind == "magic":
        b[len(good) + 1] = 0
    elif kind == "truncated_footer":
        del b[-3:]
    elif kind == "truncated_header":
        del b[len(good) + 9:]
    else:
        b += b"\x1f\x8b\x08\x00junk"
    bad = bytes(b)
    got = both(lambda p: p.MultiGzDecoder(io.BytesIO(bad)).read())
    assert isinstance(got, str), kind


@pytest.mark.parametrize("n, cut", [(3 << 20, 0), (60_000, 1000)], ids=["whole", "truncated"])
def test_multigz_member_larger_than_a_read(monkeypatch, n, cut):
    """A member larger than the first 1 MiB read: the port reads more input
    instead of growing its output buffer on an input that is not all there
    (gzp_tpu grows it toward 64 GiB, inflating the zeros its codec reads
    past the end), and at the end of the input grows it no further than
    Deflate's largest output for that input (1032 bytes per byte). A member
    cut short still raises DecompressError, as gzp_tpu's does once its
    buffer is large enough."""
    from gzp_tpu_torch.runtime import native_lib

    data = np.random.default_rng(16).integers(0, 40, n, dtype=np.uint8).tobytes()
    blob = gzip.compress(data, 1)
    blob = blob[: len(blob) - cut]
    sizes = []
    inflate_into = native_lib.NativeCodec.inflate_into

    def recording(self, payload, out):
        sizes.append((len(payload), len(out)))
        return inflate_into(self, payload, out)

    monkeypatch.setattr(native_lib.NativeCodec, "inflate_into", recording)
    got = outcome(lambda: gzp_tpu_torch.MultiGzDecoder(io.BytesIO(blob)).read())
    assert got == (data if cut == 0 else "DecompressError")
    if cut == 0:
        assert len(blob) > 1 << 21 and len(sizes) > 1
        assert max(out for _, out in sizes) <= 4 * len(blob)
    else:
        assert max(out for _, out in sizes) <= 4 * (1032 * len(blob) + (1 << 16))


def test_multigz_member_compressing_past_four_to_one(monkeypatch):
    """A member of zeros (about 1000:1) followed by more input: the port
    grows its output buffer in place once the member is seen to end inside
    the buffered input, and does not read the next member to size it
    (4 output bytes per buffered input byte would need 512 KiB here)."""
    monkeypatch.setattr(gzp_tpu_torch.MultiGzDecoder, "_READ0", 4096)
    zeros = bytes(2 << 20)
    rest = np.random.default_rng(17).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    first = gzip.compress(zeros, 6)
    assert len(first) < 4096
    src = MeteredReader(first + gzip.compress(rest, 1))
    dec = gzp_tpu_torch.MultiGzDecoder(src)
    assert dec.read(len(zeros)) == zeros
    assert src.pos <= 4096
    assert dec.read() == rest


class MeteredReader(io.RawIOBase):
    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.max_request = 0

    def read(self, size=-1):
        assert size is not None and size >= 0, "streaming reader must bound reads"
        self.max_request = max(self.max_request, size)
        out = self.data[self.pos: self.pos + size]
        self.pos += len(out)
        return out


@pytest.mark.parametrize("pkg", PKGS, ids=["gzp_tpu", "gzp_tpu_torch"])
def test_multigz_streams_bounded_memory(pkg):
    """Member-at-a-time input: never more than a few members read ahead."""
    member_plain = make_text(65536, seed=3)
    one = _member(member_plain, 0, 1)
    src = MeteredReader(one * 64)
    dec = pkg.MultiGzDecoder(src)
    out = bytearray()
    while chunk := dec.read(1 << 16):
        out += chunk
        assert src.pos <= len(one) * (len(out) // len(member_plain) + 3) + (1 << 21)
    assert bytes(out) == member_plain * 64
    assert src.max_request <= 1 << 27


def test_mgzip_blen_roundtrip_field():
    _, blob = compress("Mgzip", 40_000, 11)
    blen = struct.unpack("<I", blob[16:20])[0]
    for p in PKGS:
        p.Mgzip.check_header(blob[:20])
        assert p.Mgzip.get_block_size(blob[:20]) == blen


def _snappy_decoder(p):
    return (jsnap if p is gzp_tpu else tsnap).SnappyFrameDecoder


def test_snappy_frame_decoder_roundtrip_and_oracle():
    data, blob = compress("Snap", 200_000, 12, nt=4)
    assert both(lambda p: _snappy_decoder(p)(io.BytesIO(blob)).read()) == data
    assert decode_frames(blob) == data

    def sized(p):
        r = _snappy_decoder(p)(io.BytesIO(blob))
        chunks = []
        while c := r.read(7777):
            chunks.append(c)
        return b"".join(chunks)

    assert both(sized) == data


@pytest.mark.parametrize("kind", ["padding_and_skippable", "repeated_stream_id",
                                  "uncompressed_chunk", "chunk_crc", "reserved_chunk",
                                  "no_stream_id", "bad_stream_id", "truncated_chunk",
                                  "truncated_chunk_header", "short_chunk"])
def test_snappy_frame_decoder_chunks(kind):
    data, blob = compress("Snap", 30_000, 14)
    want = data
    if kind == "padding_and_skippable":
        bad = blob[:10] + bytes([0xFE, 3, 0, 0]) + b"xyz" + bytes([0x80, 2, 0, 0]) + b"ab" \
            + blob[10:]
    elif kind == "repeated_stream_id":
        bad, want = blob + blob, data + data
    elif kind == "uncompressed_chunk":
        raw = b"plain bytes"
        crc = gzp_tpu_torch.check.snappy_mask_crc(gzp_tpu_torch.check.crc32c(raw))
        body = struct.pack("<I", crc) + raw
        bad, want = blob + bytes([0x01]) + len(body).to_bytes(3, "little") + body, data + raw
    elif kind == "chunk_crc":
        bad = bytearray(blob)
        bad[14] ^= 0x55
    elif kind == "reserved_chunk":
        bad = blob[:10] + bytes([0x02, 1, 0, 0, 0]) + blob[10:]
    elif kind == "no_stream_id":
        bad = blob[10:]
    elif kind == "bad_stream_id":
        bad = bytearray(blob)
        bad[5] ^= 1
    elif kind == "truncated_chunk":
        bad = blob[:-7]
    elif kind == "truncated_chunk_header":
        bad = blob + b"\x00\x05"
    else:
        bad = blob + bytes([0x00, 2, 0, 0]) + b"ab"
    got = both(lambda p: _snappy_decoder(p)(io.BytesIO(bytes(bad))).read())
    if kind in ("padding_and_skippable", "repeated_stream_id", "uncompressed_chunk"):
        assert got == want
    else:
        assert isinstance(got, str), kind


class DribbleReader(io.RawIOBase):
    """At most a few bytes per read(): pipes, sockets and raw files return
    short without being at end of stream."""

    def __init__(self, data: bytes, max_chunk: int = 7):
        self.data = data
        self.pos = 0
        self.max_chunk = max_chunk
        self.calls = 0

    def readable(self):
        return True

    def read(self, size=-1):
        self.calls += 1
        if self.pos >= len(self.data):
            return b""
        n = min(size if size >= 0 else self.max_chunk, 1 + (self.calls * 3) % self.max_chunk)
        out = self.data[self.pos: self.pos + n]
        self.pos += len(out)
        return out


@pytest.mark.parametrize("fmt_name", ["Mgzip", "Bgzf"])
def test_short_read_sources_block_reader(fmt_name):
    data, blob = compress(fmt_name, 150_000, 21)
    assert both(lambda p: p.ParDecompress(getattr(p, fmt_name), DribbleReader(blob),
                                          num_threads=2).read()) == data


def test_short_read_sources_snappy():
    data, blob = compress("Snap", 90_000, 22)
    assert both(lambda p: _snappy_decoder(p)(DribbleReader(blob)).read()) == data


def test_short_read_sources_multigz():
    data = make_text(80_000, seed=23)
    blob = b"".join(gzip.compress(data[i: i + 20_000]) for i in range(0, len(data), 20_000))
    assert both(lambda p: p.MultiGzDecoder(DribbleReader(blob)).read()) == data


def test_decompress_builder_knobs():
    data, blob = compress("Mgzip", 100_000, 24)

    def knobs(p):
        r = (p.ParDecompressBuilder(p.Mgzip).num_threads(2).buffer_size(1 << 16).queue_size(3)
             .pin_threads(0).from_reader(io.BytesIO(blob)))
        assert r.queue_depth == 3
        out = r.read()
        r.close()
        return out

    assert both(knobs) == data
    assert both(lambda p: p.ParDecompressBuilder(p.Mgzip).buffer_size(100)) == "BufferSizeError"
    assert both(lambda p: p.ParDecompressBuilder(p.Mgzip).queue_size(0)) == "ValueError"
    assert both(lambda p: p.ParDecompressBuilder(p.Mgzip).num_threads(0)) == "NumThreadsError"
    assert both(lambda p: p.ParDecompress(p.Gzip, io.BytesIO(b""))) == "TypeError"
