"""Gzip streams of the port against the JAX package beyond level 3's
``ZBuilder`` runs: levels 1, 6 and 9, and ``ParCompress``'s shard knobs
(``emit_header``, ``emit_footer``, ``final_on_finish``, ``preset_carry``,
``use_dict``). Both packages on the CPU; tolerance: exact equality of
bytes.
"""

import gzip
import io
import zlib

import numpy as np
import pytest
import torch

import gzp_tpu
import gzp_tpu_torch

BS = 32768


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """These small CPU shapes run faster on 2 torch threads than on every
    core, and leave the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ",
             b"pack my box with five dozen liquor jugs ", b"0123456789" * 3, b"\n"]
    out, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        out.append(w)
        total += len(w)
    return b"".join(out)[:n]


def _gzip(pkg, data, level):
    buf = io.BytesIO()
    z = pkg.ZBuilder(pkg.Gzip).num_threads(3).compression_level(level).buffer_size(BS)
    if pkg is gzp_tpu_torch:
        z = z.device("cpu")
    w = z.from_writer(buf)
    w.write(data)
    w.finish()
    return buf.getvalue()


@pytest.mark.parametrize("level", [1, 6, 9])
def test_gzip_levels_identical_to_reference(level):
    data = _text(2 * BS + 3333, 4)
    ours = _gzip(gzp_tpu_torch, data, level)
    assert gzip.decompress(ours) == data
    assert ours == _gzip(gzp_tpu, data, level)


KNOBS = {
    "no-header": dict(emit_header=False),
    "no-footer": dict(emit_footer=False),
    "not-final": dict(final_on_finish=False),
    "preset-carry": dict(preset_carry=_text(40000, 9)),
    "no-dict": dict(use_dict=False),
}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_shard_knobs_identical_to_reference(knob):
    data = _text(4 * BS + 999, 10)
    outs = []
    for pkg, extra in ((gzp_tpu_torch, dict(device="cpu")), (gzp_tpu, {})):
        buf = io.BytesIO()
        w = pkg.ParCompress(pkg.Gzip, buf, num_threads=3, buffer_size=BS, compression_level=3,
                            **KNOBS[knob], **extra)
        w.write(data)
        w.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    if knob in ("no-dict", "no-header"):  # still a whole deflate stream
        d = zlib.decompressobj(-15)
        assert d.decompress(outs[0][10 if knob == "no-dict" else 0:]) == data
