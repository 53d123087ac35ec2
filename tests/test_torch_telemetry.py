"""The port's spans (``gzp_tpu_torch/runtime/telemetry.py``) on the CPU:
off without a profiler, each write and read step recorded once a batch
under ``torch.profiler``, the caller's spans in the exported chrome trace
as ``<span>#<batch>``, and the same output bytes with the spans on and
off (the stream check's combine runs after each batch's stitch loop)."""

import gzip
import io
import json
import os
import struct
import sys
import tempfile
import threading
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import gzp_tpu_torch
from gzp_tpu_torch.constants import BGZF_EOF
from gzp_tpu_torch.runtime import telemetry

BS = 32768
THREADS = 2  # a batch is 2 blocks of 32 KiB
BATCHES = 3  # 2 full batches and a tail
WRITE_SPANS = ["gzp.compress.dispatch", "gzp.encode.match", "gzp.encode.parse",
               "gzp.encode.entries", "gzp.encode.pack", "gzp.encode.finish",
               "gzp.compress.fetch", "gzp.compress.stitch", "gzp.compress.combine"]
READ_SPANS = ["gzp.decompress.scan", "gzp.decompress.stage", "gzp.decompress.gather",
              "gzp.decompress.wait"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_totals():
    telemetry.reset()
    yield
    telemetry.reset()


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ",
             b"pack my box with five dozen liquor jugs ", b"0123456789" * 3, b"\n"]
    out = [words[i] for i in rng.integers(0, len(words), n // 8 + 1)]
    return b"".join(out)[:n]


DATA = _text(2 * THREADS * BS + 5000, 3)


def _write(fmt, data=DATA, **kw):
    buf = io.BytesIO()
    w = gzp_tpu_torch.ParCompress(getattr(gzp_tpu_torch, fmt), buf, num_threads=THREADS,
                                  buffer_size=BS, device="cpu", **kw)
    w.write(data)
    w.finish()
    return buf.getvalue(), w


def _traced(fn):
    """``fn()`` under the profiler inside the range ``caller``; its result
    and the trace's events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            got = fn()
    return got, _events(prof)


def _events(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _annotations(events):
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(telemetry, "record_function", refuse)
    assert telemetry.span("gzp.compress.fetch", 0) is telemetry.OFF
    assert telemetry.span("gzp.encode.match") is telemetry.span("gzp.decompress.wait", 7)
    out, _ = _write("Gzip")
    assert gzip.decompress(out) == DATA
    assert telemetry.totals() == {}


@pytest.mark.parametrize("fmt", ["Mgzip", "Bgzf", "Gzip"])
def test_write_spans_once_a_batch(fmt):
    (out, _), events = _traced(lambda: _write(fmt))
    assert gzip.decompress(out) == DATA
    t = telemetry.totals()
    assert sorted(t) == sorted(WRITE_SPANS)
    for name in WRITE_SPANS:
        assert t[name]["count"] == BATCHES, name
        assert 0 <= t[name]["self_s"] <= t[name]["total_s"], name
    # combine runs inside stitch, the encoder's stages inside dispatch
    stitch, combine = t["gzp.compress.stitch"], t["gzp.compress.combine"]
    assert stitch["total_s"] >= combine["total_s"]
    assert stitch["self_s"] == pytest.approx(stitch["total_s"] - combine["total_s"], abs=1e-6)
    stages = sum(t[n]["total_s"] for n in WRITE_SPANS if n.startswith("gzp.encode."))
    dispatch = t["gzp.compress.dispatch"]
    assert dispatch["self_s"] == pytest.approx(dispatch["total_s"] - stages, abs=1e-6)

    ann = _annotations(events)
    caller = next(e for e in ann if e["name"] == "caller")
    c0, c1 = float(caller["ts"]), float(caller["ts"]) + float(caller["dur"])
    for name in WRITE_SPANS:
        for batch in range(BATCHES):
            hits = [e for e in ann if e["name"] == f"{name}#{batch}"]
            assert len(hits) == 1, (name, batch)
            e = hits[0]
            assert e["tid"] == caller["tid"]
            assert c0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= c1


def _bgzf(blocks):
    """A BGZF stream of ``blocks`` (zlib level 6 members) and the EOF
    member."""
    out = []
    for raw in blocks:
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        payload = c.compress(raw) + c.flush()
        size = 18 + len(payload) + 8
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
                   + struct.pack("<H", size - 1) + payload
                   + struct.pack("<II", zlib.crc32(raw), len(raw)))
    return b"".join(out) + BGZF_EOF


def test_read_spans_once_a_batch():
    # 18 members and the EOF member: device batches of 8, 8 and 3
    blocks = [_text(512, 100 + i) for i in range(18)]
    stream = _bgzf(blocks)
    assert len(stream) <= 16384

    def read():
        r = gzp_tpu_torch.ParDecompress(gzp_tpu_torch.Bgzf, io.BytesIO(stream),
                                        num_threads=2, backend="device", device="cpu")
        parts = []
        while c := r.read(4096):
            parts.append(c)
        r.close()
        return b"".join(parts), r.fallback_stats

    (got, stats), events = _traced(read)
    assert got == b"".join(blocks) and stats == {"device": 19, "native": 0}
    t = telemetry.totals()
    assert sorted(t) == sorted(READ_SPANS)
    for name in READ_SPANS:
        assert t[name]["count"] == 3, name
        assert 0 <= t[name]["self_s"] <= t[name]["total_s"], name
    names = {e["name"] for e in _annotations(events)}
    for name in ("gzp.decompress.scan", "gzp.decompress.wait"):  # the caller's thread
        assert {f"{name}#{b}" for b in range(3)} <= names, name


def _repair_third_block(monkeypatch):
    """The verify net finds the third block's encoding corrupt and
    re-emits it stored, with a check computed on the host."""
    target = DATA[2 * BS: 3 * BS]
    fallback = gzp_tpu_torch.ParCompress._maybe_fallback

    def corrupt(self, blob, raw, ln, final, chk):
        blob = fallback(self, blob, raw, ln, final, chk)
        return blob[:100] + bytes([blob[100] ^ 0x10]) + blob[101:] if raw == target else blob

    monkeypatch.setattr(gzp_tpu_torch.ParCompress, "_maybe_fallback", corrupt)
    return {"verify": True}


DECODE = {"Mgzip": gzip.decompress, "Bgzf": gzip.decompress, "Gzip": gzip.decompress,
          "Zlib": zlib.decompress}


@pytest.mark.parametrize("fmt, repair", [("Mgzip", False), ("Bgzf", False), ("Gzip", False),
                                         ("Zlib", False), ("Gzip", True)])
def test_same_bytes_with_spans_on_and_off(fmt, repair, monkeypatch):
    kw = _repair_third_block(monkeypatch) if repair else {}
    off, w_off = _write(fmt, **kw)
    assert telemetry.totals() == {}
    (on, w_on), _ = _traced(lambda: _write(fmt, **kw))
    assert telemetry.totals()["gzp.compress.combine"]["count"] == BATCHES
    assert on == off
    assert DECODE[fmt](on) == DATA  # the combined stream check holds
    if repair:
        assert w_on.verify_stats == w_off.verify_stats == {"checked": 5, "repaired": 1}
        assert w_on.check.sum() == zlib.crc32(DATA)


def test_threads_lose_no_update_and_keep_their_own_parents():
    """More threads than cores open nested spans at once, with a short
    switch interval: every span is counted, and each thread's child takes
    its own parent's batch, never another thread's."""
    threads, each = 4 * (os.cpu_count() or 1), 200
    seen = []

    def work(k):
        for _ in range(each):
            with telemetry.span("outer", k):
                with telemetry.span("inner") as s:
                    seen.append(s.batch == k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    t = telemetry.totals()
    assert t["outer"]["count"] == t["inner"]["count"] == threads * each
    assert len(seen) == threads * each and all(seen)
    assert 0 <= t["outer"]["self_s"] <= t["outer"]["total_s"]
