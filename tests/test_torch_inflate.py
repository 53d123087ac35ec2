"""The port's batched inflate (K11's plain version) and
``ParDecompress(backend='device')`` against the JAX package.

The same inputs go through ``gzp_tpu.ops.inflate_kernel.get_inflater`` on
JAX's CPU backend and ``gzp_tpu_torch.ops.inflate_kernel.get_inflater``
with CPU tensors: one row per case of ``utils/inflate_cases.py`` (every
block type, 16 and 17 blocks, streams that end at ``in_cap``, each rule
that makes a row not ok, garbage, quirks zlib refuses). Tolerance: exact.
``ok`` and the CRC are compared on every row, ``out`` and ``out_count``
where ``ok`` is true (a failed row's bytes are not part of the contract).
Then whole streams written by the port's ``ZBuilder(...).device("cpu")``
are read with ``backend='device'`` by both packages: the same bytes, the
same ``fallback_stats`` and, on corrupt input, errors of the same class.

Every call runs at gzp_tpu's device shape, [8, 65536] (the device batch
at ``num_threads`` <= 8), so JAX compiles its inflater once per module.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch
from gzp_tpu.ops import inflate_kernel as jik
from gzp_tpu_torch.ops import inflate_kernel as tik
from gzp_tpu_torch.utils.inflate_cases import inflate_case_batch

BATCH = 8
CAP = 65536
ROWS = 40  # the case batch, padded to whole batches


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [b"end to end decompress test ", b"round and round it goes ",
             b"0123456789abcdef", b"the quick brown fox\n"]
    return b"".join(words[i] for i in rng.integers(0, len(words), n // 16 + 1))[:n]


def _write(fmt, data, bs):
    buf = io.BytesIO()
    w = gzp_tpu_torch.ZBuilder(fmt).num_threads(2).buffer_size(bs).device("cpu").from_writer(buf)
    w.write(data)
    w.finish()
    return buf.getvalue()


@pytest.fixture(scope="module")
def cases():
    c = inflate_case_batch(CAP, CAP, rows=ROWS)
    assert len(c["names"]) == ROWS
    jrun = jik.get_inflater(jik.InflateConfig(in_cap=CAP, out_cap=CAP))
    trun = tik.get_inflater(tik.InflateConfig(in_cap=CAP, out_cap=CAP))
    want = {k: [] for k in ("out", "out_count", "ok", "crc")}
    for s in range(0, ROWS, BATCH):
        part = [c[k][s: s + BATCH] for k in ("streams", "in_lens", "out_lens")]
        r = jrun(*(jnp.asarray(x) for x in part))
        for k in want:
            want[k].append(np.asarray(r[k]))
    want = {k: np.concatenate(v) for k, v in want.items()}
    got = trun(*(torch.from_numpy(c[k]) for k in ("streams", "in_lens", "out_lens")))
    return c, want, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("row", range(ROWS))
def test_plain_matches_reference(cases, row):
    c, want, got = cases
    name = c["names"][row]
    assert bool(got["ok"][row]) == bool(want["ok"][row]), name
    assert bool(want["ok"][row]) == bool(c["expect_ok"][row]), name
    assert int(got["crc"][row]) == int(want["crc"][row]), name
    if want["ok"][row]:
        n = c["out_lens"][row]
        assert np.array_equal(got["out"][row], want["out"][row]), name
        assert int(got["out_count"][row]) == int(want["out_count"][row]) == n, name
        assert not got["out"][row, n:].any(), name


def test_get_inflater_is_plain_and_crc(cases):
    """``get_inflater`` on CPU tensors is the plain version plus
    ``crc32_device``; the plain version's symbol count of a row that is ok
    lies between one and its output bytes plus one end-of-block code for
    each of its Deflate blocks."""
    c, _, got = cases
    part = [torch.from_numpy(c[k][:BATCH]) for k in ("streams", "in_lens", "out_lens")]
    plain = tik.inflate_blocks_plain(tik.InflateConfig(CAP, CAP), *part)
    for k in ("out", "out_count", "ok"):
        assert np.array_equal(plain[k].numpy(), got[k][:BATCH]), k
    assert np.array_equal(tik.crc32_device(plain["out"], part[2]).numpy(), got["crc"][:BATCH])
    ok = plain["ok"].numpy()
    symbols = plain["symbols"].numpy()[ok]
    assert symbols.sum() > 0 and (symbols <= c["out_lens"][:BATCH][ok] + 16).all()


def test_config_from_reference():
    jcfg = jik.InflateConfig(in_cap=4096, out_cap=8192, max_blocks=7)
    assert tik.inflate_config_from_reference(dataclasses.asdict(jcfg)) == tik.InflateConfig(
        4096, 8192, 7)
    assert tik.InflateConfig(CAP, CAP).max_blocks == jik.InflateConfig(CAP, CAP).max_blocks


def test_wrapper_routes_by_device():
    cfg = tik.InflateConfig(64, 64)
    streams = torch.zeros((1, 64), dtype=torch.uint8)
    streams[0, :2] = torch.tensor([3, 0])
    lens = torch.tensor([2], dtype=torch.int32), torch.tensor([0], dtype=torch.int32)
    r = tik.inflate_blocks(cfg, streams, *lens)
    assert bool(r["ok"][0]) and int(r["out_count"][0]) == 0
    with pytest.raises(ValueError):
        tik.inflate_blocks(cfg, streams.to("meta"), *(x.to("meta") for x in lens))


@pytest.fixture(scope="module")
def streams():
    """A BGZF stream of 7 blocks + the EOF block (one batch of 8, every
    block under the device caps) and an Mgzip stream of 8 blocks of 128
    KiB (every block over OUT_CAP)."""
    bgzf = _write(gzp_tpu_torch.Bgzf, _text(7 * 32768 - 100, 1), 32768)
    mgzip = _write(gzp_tpu_torch.Mgzip, _text(8 * 131072 - 5000, 2), 131072)
    return {"bgzf": bgzf, "mgzip": mgzip}


def _device_read(pkg, fmt_name, blob, **kw):
    fmt = getattr(pkg, fmt_name)
    r = pkg.ParDecompress(fmt, io.BytesIO(blob), num_threads=2, backend="device", **kw)
    try:
        return r.read(), dict(r.fallback_stats)
    except Exception as e:  # noqa: BLE001 — the class name is the result
        return type(e).__name__, dict(r.fallback_stats)
    finally:
        r.close()


@pytest.mark.parametrize("fmt_name, stream, want_stats", [
    ("Bgzf", "bgzf", {"device": 8, "native": 0}),
    ("Mgzip", "mgzip", {"device": 0, "native": 8}),
])
def test_device_backend_matches_reference(streams, fmt_name, stream, want_stats):
    blob = streams[stream]
    jgot, jstats = _device_read(gzp_tpu, fmt_name, blob)
    tgot, tstats = _device_read(gzp_tpu_torch, fmt_name, blob, device="cpu")
    assert isinstance(tgot, bytes) and tgot == jgot
    assert tstats == jstats == want_stats
    assert tgot == gzp_tpu_torch.ParDecompress(getattr(gzp_tpu_torch, fmt_name),
                                               io.BytesIO(blob)).read()


def _corrupt(blob, where):
    """The BGZF stream with its first block's CRC or a payload byte
    changed."""
    b = bytearray(blob)
    bsize = int.from_bytes(b[16:18], "little") + 1
    if where == "crc":
        b[bsize - 8] ^= 0xFF
    else:
        b[40] ^= 0x5A
    return bytes(b)


@pytest.mark.parametrize("where", ["crc", "payload"])
def test_device_backend_corrupt_block_matches_reference(streams, where):
    """A corrupt block goes to the native path in both packages (CRC
    mismatch, or not ok) and raises the same error class there."""
    blob = _corrupt(streams["bgzf"], where)
    jgot, jstats = _device_read(gzp_tpu, "Bgzf", blob)
    tgot, tstats = _device_read(gzp_tpu_torch, "Bgzf", blob, device="cpu")
    assert isinstance(jgot, str) and tgot == jgot
    assert tstats == jstats


def test_device_backend_raises_on_a_device_decode_fault(streams, monkeypatch):
    """A block the device decode reports ok but gets wrong (here one byte
    of its row flipped, the CRC taken of the wrong row) is a fault of the
    decode, not of the data: the host codec restores it with its footer's
    CRC, so the read raises instead of counting a fallback."""
    real = tik.get_inflater

    def faulty(cfg):
        run = real(cfg)

        def wrong(streams_u8, in_lens, out_lens):
            res = run(streams_u8, in_lens, out_lens)
            res["out"][1, 5] ^= 1
            res["crc"] = tik.crc32_device(res["out"], out_lens)
            return res

        return wrong

    monkeypatch.setattr(tik, "get_inflater", faulty)
    r = gzp_tpu_torch.ParDecompress(gzp_tpu_torch.Bgzf, io.BytesIO(streams["bgzf"]),
                                    num_threads=2, backend="device", device="cpu")
    with pytest.raises(RuntimeError, match="device inflate fault: block 1 "):
        r.read()
    r.close()


def test_device_backend_skips_batches_wholly_over_the_caps(streams, monkeypatch):
    """Every block of the 128 KiB Mgzip stream is over OUT_CAP, so no
    batch of it reaches the device decode; the bytes and the stats stay
    gzp_tpu's."""
    def unused(cfg):
        raise AssertionError("the device decode ran on a batch wholly over the caps")

    monkeypatch.setattr(tik, "get_inflater", unused)
    got, stats = _device_read(gzp_tpu_torch, "Mgzip", streams["mgzip"], device="cpu")
    assert isinstance(got, bytes) and stats == {"device": 0, "native": 8}


def test_device_backend_needs_a_device_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        gzp_tpu_torch.ParDecompress(gzp_tpu_torch.Bgzf, io.BytesIO(b""), backend="device")
    r = gzp_tpu_torch.ParDecompress(gzp_tpu_torch.Bgzf, io.BytesIO(b""), backend="native")
    assert r.read() == b""
