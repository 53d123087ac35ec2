"""The plain Snappy reference (``portbench/formats/snappy.py``) against the
port's frames and against the port's own decoder, each fault it must
count, its memo of repeated frames against a full decode, its CRC32C, and
the cell ``snappy.text`` driven on the CPU at a size a test can hold."""

import io
import random
import subprocess
import sys

import pytest

from portbench import harness
from portbench import run as runner
from portbench.corpus import text
from portbench.formats import members, snappy

BLOCK = 65536
CLEAN = {"frames_bad": 0, "data_bad": 0, "checks_bad": 0, "length_gap": 0}


def _port(data, rows=2):
    import gzp_tpu_torch

    buf = io.BytesIO()
    w = (gzp_tpu_torch.ZBuilder(gzp_tpu_torch.Snap).num_threads(rows).compression_level(3)
         .buffer_size(BLOCK).device("cpu").from_writer(buf))
    w.write(data)
    w.finish()
    return buf.getvalue()


def _frames(stream):
    """The stream cut before each stream identifier."""
    cuts, i = [], stream.find(snappy.IDENTIFIER)
    while i >= 0:
        cuts.append(i)
        i = stream.find(snappy.IDENTIFIER, i + 1)
    return [stream[a: b] for a, b in zip(cuts, cuts[1:] + [len(stream)])]


@pytest.fixture(scope="module")
def corpus():
    return text.make(4 * BLOCK, 2**31 + 21)


@pytest.fixture(scope="module")
def port_stream(corpus):
    return _port(corpus)


INPUTS = {
    "text": lambda c: c,
    "random": lambda c: random.Random(3).randbytes(BLOCK + 4464),
    "empty": lambda c: b"",
    "tail": lambda c: c[: 2 * BLOCK + 777],
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_port_frames_decode_to_the_input(name, corpus, port_stream):
    data = INPUTS[name](corpus)
    stream = port_stream if name == "text" else _port(data)
    assert snappy.check([stream], members.Expected(data or b"\0", len(data))) == CLEAN


def test_decode_equals_the_ports_decoder(corpus, port_stream):
    """Each stream restores, by the reference, exactly what the port's own
    decoder reads from it."""
    from gzp_tpu_torch.utils.snappy_ref import decode_frames

    data = corpus[: 3 * BLOCK + 5]
    plain = b"".join(snappy.frames([data[i: i + BLOCK] for i in range(0, len(data), BLOCK)]))
    # a block of every element: long literals, copies with 1-, 2- and 4-byte
    # offsets, an overlapping copy; then a skippable chunk and padding
    block = bytes(range(61)) + bytes([199])
    body = bytearray([len(block) + 15 + 30])  # varint length (< 128)
    body += bytes([60 << 2, 61]) + block  # literal of 62 in one extra byte
    body += bytes([(11 - 4) << 2 | 1, 50])  # 11 bytes from 50 back, 1-byte offset
    body += bytes([(4 - 1) << 2 | 3]) + (7).to_bytes(4, "little")  # 4 from 7 back, 4-byte offset
    body += bytes([(30 - 1) << 2 | 2, 1, 0])  # 30 copies of the last byte, overlapping
    want = block + block[-50:-39]
    want += want[-7:-3]
    want += want[-1:] * 30
    crc = snappy.masked_crcs([want])[0].to_bytes(4, "little")
    assert snappy.restore(0, crc + bytes(body)) == want
    hand = (snappy.IDENTIFIER + b"\x00" + (len(body) + 4).to_bytes(3, "little") + crc
            + bytes(body) + b"\x80\x02\x00\x00ab" + b"\xfe\x01\x00\x00z")
    assert decode_frames(hand) == want and decode_frames(plain) == data
    for stream in (port_stream, plain, hand, port_stream + hand + plain):
        got = decode_frames(stream)
        assert _counts(stream, got) == CLEAN


def _counts(stream, data, **kw):
    return snappy.check([stream], members.Expected(data, len(data)), **kw)


def test_each_fault_is_counted(corpus, port_stream):
    # a stream that ends on a block's end ends with an empty frame
    *frames, last = _frames(port_stream)
    assert len(frames) == 4 and all(f[10] == 0 for f in frames) and last == snappy.IDENTIFIER
    assert _counts(port_stream, corpus) == CLEAN

    flipped = bytearray(frames[1])
    flipped[len(flipped) // 2] ^= 0x40  # a body byte
    got = _counts(b"".join([frames[0], bytes(flipped), *frames[2:]]), corpus)
    assert got["data_bad"] == 1 and got["frames_bad"] == 0

    crc = bytearray(frames[2])
    crc[14] ^= 1  # the masked CRC32C
    assert _counts(b"".join([*frames[:2], bytes(crc), frames[3]]), corpus) == {
        **CLEAN, "checks_bad": 1}

    no_id = b"".join([*frames[:3], frames[3][len(snappy.IDENTIFIER):]])
    assert _counts(no_id, corpus) == {**CLEAN, "frames_bad": 1}

    cut = port_stream[:-100]
    got = _counts(cut, corpus)
    assert got["frames_bad"] == 1 and got["length_gap"] == BLOCK

    reserved = port_stream + b"\x02\x01\x00\x00x"
    assert _counts(reserved, corpus) == {**CLEAN, "frames_bad": 1}


def test_memo_counts_as_a_full_decode(corpus, port_stream, monkeypatch):
    """Three passes over a four-block ring, a tail, and faults in repeated
    frames: the memo keyed by the place in the corpus against an input
    that never repeats (every frame decoded), and each distinct frame
    decoded once."""
    frames = _frames(port_stream)[:4]
    bad_crc = bytearray(frames[1])
    bad_crc[15] ^= 2
    bad_data = bytearray(frames[3])
    bad_data[-3] ^= 1
    passes = [frames, [frames[0], bytes(bad_crc), frames[2], bytes(bad_data)],
              [frames[0], bytes(bad_crc), frames[2], frames[3]]]
    tail = _frames(_port(corpus[:5000]))
    stream = b"".join(f for p in passes for f in p) + b"".join(tail)
    total = 3 * len(corpus) + 5000

    calls = []
    verdicts = snappy.verdicts
    monkeypatch.setattr(snappy, "verdicts", lambda work: calls.extend(work) or verdicts(work))
    memo = snappy.check([stream], members.Expected(corpus, total), procs=1)
    # the ring, the faulty frames (a faulty frame is no memo: its repeat is
    # decoded again), the tail
    assert len(calls) == 4 + 3 + 1
    calls.clear()
    whole = corpus * 3 + corpus[:5000]
    full = snappy.check([stream], members.Expected(whole, total), procs=1)
    assert len(calls) == 13
    assert memo == full
    assert (memo["frames_bad"], memo["data_bad"], memo["length_gap"]) == (0, 1, 0)
    assert memo["checks_bad"] >= 2


def test_pool_gives_the_in_process_counts(corpus, port_stream, monkeypatch):
    monkeypatch.setattr(snappy, "POOL_MIN", 2)
    want = members.Expected(corpus, len(corpus))
    crc = bytearray(port_stream)
    crc[14] ^= 1
    for stream in (port_stream, bytes(crc)):
        assert snappy.check([stream], want, procs=3) == snappy.check([stream], want, procs=1)


def test_plain_writer_and_its_control(corpus):
    data = corpus[: 2 * BLOCK + 1234]
    want = members.Expected(data, len(data))
    for crc in (None, 0):
        sink = harness.Sink(harness.Arena(1 << 20))
        w = snappy.Writer(sink, BLOCK, 2, crc=crc)
        for i in range(0, len(data), 4096):
            w.write(data[i: i + 4096])
        w.finish()
        got = snappy.check(sink.parts, want)
        assert got == (CLEAN if crc is None else {**CLEAN, "checks_bad": 3})


def test_crc32c_table_equals_google_crc32c():
    google_crc32c = pytest.importorskip("google_crc32c")
    rng = random.Random(11)
    assert snappy.crc32c_table([b"123456789"]) == [0xE3069283]  # the check value
    blocks = [rng.randbytes(n) for n in (1000, 0, 65536, 7, 1, 64, 1000)]
    assert snappy.crc32c_table(blocks) == [google_crc32c.value(b) for b in blocks]


def test_module_imports_nothing_of_the_port_or_jax():
    code = ("import sys; import portbench.formats.snappy; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'gzp_tpu_torch', 'gzp_tpu', 'jax', 'jaxlib', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_the_config_takes_the_encoders_knobs():
    from gzp_tpu_torch.ops.snappy_kernel import SnappyEncodeConfig

    cell = harness.load_cell("snappy.text")
    assert cell.format is harness.plugin("formats", "snappy")
    s = harness.shapes(cell.config, cell.format.HALO)
    k = SnappyEncodeConfig(block_len=cell.config["block_bytes"])
    assert (s["payload_words"], s["lags"], s["matcher"], s["row"], s["npad"]) == (
        k.payload_words, k.lags, "hash", BLOCK, BLOCK)


def test_k10_count_is_within_a_percent_of_snappys_entries():
    """K10's work file counts a Deflate row's 339 header fields and its
    end-of-block symbol; a Snappy row has its varint and one entry a
    position (N + 1 entries)."""
    cell = harness.load_cell("snappy.text")
    s = harness.shapes(cell.config, 0)
    work = harness.plugin("work", "pack_prescan")
    counted = work.per_batch(s)[0][0]
    b, e = s["rows"], s["block"] + 1
    ep = -(-max(-(-(e + 1) // work.LANES), 8) // 8) * 8 * work.LANES
    actual = 2 * b * e * 4 + 2 * b * ep * 4 + 4 * b
    assert actual < counted < 1.01 * actual


def _run(control=False, trace=False):
    cell = harness.load_cell("snappy.text")
    cell.config["rows"] = 2
    cell.traffic.update(corpus_bytes=1 << 19, warmup_batches=1, trace_batches=2,
                        keep_bytes=1 << 24)
    return runner.run(runner.Ctx(cell, 2**31 + 4321, 0.5, trace, "cpu", control))


def test_sound_cell_run_is_correct_and_the_control_is_not():
    line = _run()
    assert line["correct"] and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["compared"].values())
    assert set(line["metrics"]) == {"compress_GBps", "out_per_in", "setup_s"}
    control = _run(control=True)
    assert not control["correct"] and control["compared"]["checks_bad"]["value"] > 0


def test_traced_cell_run_reads_the_snappy_spans_and_the_stored_share():
    from gzp_tpu_torch.parallel import compress
    from gzp_tpu_torch.runtime import telemetry

    telemetry.reset()
    compress.reset_stored_stats()
    line = _run(trace=True)
    assert line["correct"]
    m = line["metrics"]
    for step in ("dispatch", "match", "entries", "pack", "finish", "fetch", "stitch"):
        assert m[f"{step}_ms_per_batch.compress"]["value"] > 0, step
    assert "parse_ms_per_batch.compress" not in m and "combine_ms_per_batch.compress" not in m
    assert m["stored_share.compress"] == {"value": 0.0, "unit": "%"}
    # 2 batches of 2 blocks, and the empty frame that finish() writes
    assert compress.stored_stats == {"blocks": 5, "stored": 0}
