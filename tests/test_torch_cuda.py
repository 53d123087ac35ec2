"""Each CUDA kernel against its plain PyTorch version, on the card, at the
main path's full width (64 blocks of 128 KiB, level 3).

Marked ``cuda``; without a CUDA device every test skips (decided in the
fixture, never at import). Run on the card with ``python -m pytest -m
cuda tests/test_torch_cuda.py``. Tolerance: exact equality on every
output (integer code).
"""

import io

import numpy as np
import pytest
import torch

from gzp_tpu_torch import Mgzip, ZBuilder
from gzp_tpu_torch.ops import deflate_kernel as dk
from gzp_tpu_torch.ops import lz_cuda, pack_cuda
from gzp_tpu_torch.ops.lz import _pos_bits

pytestmark = pytest.mark.cuda

B, N = 64, 131072


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = np.frombuffer(b"to be or not to be that is the question whether tis nobler ", np.uint8)
    starts = rng.integers(0, len(words) - 8, n // 8)
    return np.concatenate([words[s: s + 8] for s in starts])[:n]


@pytest.fixture(scope="module")
def stages():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows = _text(B * N, 0).reshape(B, N).copy()
    rows[1] = 0
    rows[2] = np.random.default_rng(1).integers(0, 256, N, dtype=np.uint8)
    dev = torch.device("cuda", 0)
    data = torch.from_numpy(rows).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    lengths[3] = N - 999
    halo = torch.zeros((B,), dtype=torch.int32, device=dev)
    cfg = dk.DeflateEncodeConfig.for_level(N, "mgzip", "none", 3)
    key, pays = lz_cuda.build_keys_cuda(data, pos_bits=_pos_bits(N), payload_words=3)
    sk, order = torch.sort(key.to(torch.int64) & 0xFFFFFFFF, dim=1)
    spays = torch.gather(pays, 2, order.expand(3, -1, -1))
    sp, packed = lz_cuda.neighbor_cuda(sk, spays, halo, pos_bits=_pos_bits(N), lags=2,
                                       max_dist=32768)
    packed_pos = torch.empty_like(packed).scatter_(1, sp.to(torch.int64), packed)
    ml, md = lz_cuda.match_tail_cuda(data, packed_pos, lengths, halo, base=0,
                                     payload_bytes=12, max_match=258, min_emit=3, lazy=True)
    marked, ln = dk.parse_stage(cfg, ml, lengths)
    bits, nbits = dk.block_entries(cfg, data, marked, ln, md)
    return dict(data=data, lengths=lengths, halo=halo, sk=sk, spays=spays,
                packed_pos=packed_pos, bits=bits, nbits=nbits, cfg=cfg)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_build_keys_kernel(stages):
    kw = dict(pos_bits=_pos_bits(N), payload_words=3)
    _same(lz_cuda.build_keys_cuda(stages["data"], **kw),
          lz_cuda.build_keys_plain(stages["data"], **kw))


@pytest.mark.parametrize("lags", [2, 4])
def test_neighbor_kernel(stages, lags):
    args = (stages["sk"], stages["spays"], stages["halo"])
    kw = dict(pos_bits=_pos_bits(N), lags=lags, max_dist=32768)
    _same(lz_cuda.neighbor_cuda(*args, **kw), lz_cuda.neighbor_plain(*args, **kw))


def test_match_tail_kernel(stages):
    args = (stages["data"], stages["packed_pos"], stages["lengths"], stages["halo"])
    kw = dict(base=0, payload_bytes=12, max_match=258, min_emit=3, lazy=True)
    _same(lz_cuda.match_tail_cuda(*args, **kw), lz_cuda.match_tail_plain(*args, **kw))


def test_pack_prescan_kernel(stages):
    args = (stages["bits"], stages["nbits"], 160)
    _same(pack_cuda.pack_prescan_cuda(*args), pack_cuda.pack_prescan_plain(*args))


def test_members_equal_cpu_run(stages):
    blob = stages["data"][[0, 1, 2, 3]].cpu().numpy().tobytes()
    outs = []
    for device in ("cuda", "cpu"):
        buf = io.BytesIO()
        w = ZBuilder(Mgzip).num_threads(4).device(device).from_writer(buf)
        w.write(blob)
        w.finish()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
