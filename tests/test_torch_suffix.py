"""The port's suffix matcher (levels 6-9) against the JAX package.

Every stage of ``best_matches_suffix_pallas`` runs once per config in
interpret mode (auto-selected on the CPU); the plain PyTorch versions of
K7, K4, K8, K5 and K9 (the CPU route of the CUDA wrappers in
gzp_tpu_torch/ops/lz_cuda.py) and the content sort take the same inputs
stage by stage. The whole matcher is held against
``lz.best_matches(suffix=True)`` (XLA) and, with a halo, against
``best_matches_suffix_pallas``. Tolerance: exact equality (integer code);
against ``lz.best_matches`` distances are compared only where len > 0, as
tests/test_pallas_kernels.py:183-184 does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops import lz as jlz
from gzp_tpu.ops.lz_pallas import (
    LANES,
    best_matches_suffix_pallas,
    build_keys_pallas,
    build_suffix_keys_pallas,
    lcp_lags_pallas,
    match_tail2_pallas,
    neighbor_pallas,
    suffix_neighbor_pallas,
)
from gzp_tpu_torch.ops import lz_cuda

from test_torch_lz import KW, B, N, _corpus, _rows, _u32

MAX_DIST = 32768
# (payload_words, lags, suffix_keys): level 6's config, and a narrow one
CONFIGS = [(7, 16, 5), (3, 4, 1)]


def _t(x, dtype=np.int32):
    """u32 bit patterns (numpy or jax) -> a CPU tensor of ``dtype``."""
    return torch.from_numpy(_u32(np.asarray(x)).astype(np.int64).astype(dtype))


def _i32(x):
    return torch.from_numpy(_u32(np.asarray(x)).view(np.int32))


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "pw%d-lags%d-keys%d" % c)
def stages(request):
    """Every stage of ``best_matches_suffix_pallas``, run in interpret mode."""
    pw, lags, skw = request.param
    data, lengths = _rows(seed=2)
    halo = jnp.zeros((B,), jnp.int32)
    d = jnp.asarray(data)
    rows = N // LANES
    keys, pos = build_suffix_keys_pallas(d, payload_words=pw)
    srt = jax.lax.sort((*keys[:skw], pos, *keys[skw:]), dimension=1, num_keys=skw + 1)
    skeys = list(srt[:skw]) + list(srt[skw + 1:])
    sp_s = srt[skw]
    adj = lcp_lags_pallas([k.reshape(B, rows, LANES) for k in skeys], 1, big_endian=True,
                          interpret=True)[0]
    _, packed_s = suffix_neighbor_pallas(skeys, sp_s, halo, lags=lags, max_dist=MAX_DIST)
    _, packed_s_pos = jax.lax.sort((sp_s, packed_s), dimension=1, num_keys=1)

    pos_bits = jlz._pos_bits(N)
    key, pays = build_keys_pallas(d, pos_bits=pos_bits, payload_words=pw)
    srt_h = jax.lax.sort((key, *pays), dimension=1, num_keys=1)
    lcp_le = lcp_lags_pallas([p.reshape(B, rows, LANES) for p in srt_h[1:]], 2,
                             big_endian=False, interpret=True)
    sp_h, packed_h = neighbor_pallas(srt_h[0], list(srt_h[1:]), halo, pos_bits=pos_bits,
                                     lags=2, max_dist=MAX_DIST)
    _, packed_h_pos = jax.lax.sort((sp_h, packed_h), dimension=1, num_keys=1)
    ln, dist = match_tail2_pallas(d, packed_h_pos, packed_s_pos, jnp.asarray(lengths), halo,
                                  base=0, payload_bytes=4 * pw, max_match=258, min_emit=3,
                                  lazy=True)
    a = np.asarray
    return dict(
        pw=pw, lags=lags, skw=skw, pos_bits=pos_bits, data=data, lengths=lengths,
        halo=torch.zeros(B, dtype=torch.int32), keys=np.stack([a(k) for k in keys]),
        pos=a(pos), skeys=np.stack([a(k) for k in skeys]), sp_s=a(sp_s),
        adj=a(adj).reshape(B, N), packed_s=a(packed_s), packed_s_pos=a(packed_s_pos),
        sk=a(srt_h[0]), spays=np.stack([a(p) for p in srt_h[1:]]),
        lcp_le=np.stack([a(x).reshape(B, N) for x in lcp_le]), sp_h=a(sp_h),
        packed_h=a(packed_h), packed_h_pos=a(packed_h_pos), ln=a(ln), dist=a(dist),
    )


def test_build_suffix_keys_plain_equals_pallas(stages):
    s = stages
    keys, pos = lz_cuda.build_suffix_keys_cuda(  # CPU tensor -> the plain version
        torch.from_numpy(s["data"]), payload_words=s["pw"])
    assert np.array_equal(_u32(keys), _u32(s["keys"]))
    assert np.array_equal(_u32(pos), _u32(s["pos"]))


def test_suffix_order_equals_lax_sort(stages):
    s = stages
    keys, pos = _i32(s["keys"]), _i32(s["pos"])
    order = lz_cuda.suffix_order(keys, pos, s["skw"])
    skeys = torch.gather(keys, 2, order.expand(s["pw"], -1, -1))
    assert np.array_equal(_u32(torch.gather(pos, 1, order)), _u32(s["sp_s"]))
    assert np.array_equal(_u32(skeys), _u32(s["skeys"]))


@pytest.mark.parametrize("big_endian", [True, False], ids=["be-suffix", "le-hash"])
def test_lcp_lags_plain_equals_pallas(stages, big_endian):
    s = stages
    if big_endian:
        got = lz_cuda.lcp_lags_cuda(_i32(s["skeys"]), 1, big_endian=True)
        want = s["adj"][None]
    else:
        got = lz_cuda.lcp_lags_cuda(_i32(s["spays"]), 2, big_endian=False)
        want = s["lcp_le"]
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_suffix_neighbor_plain_equals_pallas(stages):
    """K4 big-endian at lag 1, then K8."""
    s = stages
    sp, packed = lz_cuda.suffix_neighbor_cuda(
        _i32(s["skeys"]), _i32(s["sp_s"]), s["halo"], lags=s["lags"], max_dist=MAX_DIST)
    assert np.array_equal(_u32(sp), _u32(s["sp_s"]))
    assert np.array_equal(_u32(packed), _u32(s["packed_s"]))


def test_hash_merge_plain_equals_pallas(stages):
    """K4 little-endian per lag, then K5, equals the Pallas hash pass (K4 +
    K5 at pw = 7, K2 at pw = 3) and K2's plain version on the same input."""
    s = stages
    sk = _t(s["sk"], np.int64)
    spays = _i32(s["spays"])
    lcps = lz_cuda.lcp_lags_cuda(spays, 2, big_endian=False)
    sp, packed = lz_cuda.hash_merge_cuda(sk, lcps, s["halo"], pos_bits=s["pos_bits"],
                                         max_dist=MAX_DIST, payload_bytes=4 * s["pw"])
    assert np.array_equal(_u32(sp), _u32(s["sp_h"]))
    assert np.array_equal(_u32(packed), _u32(s["packed_h"]))
    kw = dict(pos_bits=s["pos_bits"], lags=2, max_dist=MAX_DIST)
    for got in (lz_cuda.neighbor_cuda(sk, spays, s["halo"], **kw),
                lz_cuda.neighbor_plain(sk, spays, s["halo"], **kw)):
        assert np.array_equal(_u32(got[1]), _u32(s["packed_h"]))


def test_match_tail2_plain_equals_pallas(stages):
    s = stages
    ln, dist = lz_cuda.match_tail2_cuda(
        torch.from_numpy(s["data"]), _i32(s["packed_h_pos"]), _i32(s["packed_s_pos"]),
        torch.from_numpy(s["lengths"]), s["halo"], base=0, payload_bytes=4 * s["pw"],
        max_match=258, min_emit=3, lazy=True)
    assert np.array_equal(ln.numpy(), s["ln"])
    assert np.array_equal(dist.numpy(), s["dist"])


def test_best_matches_suffix_cuda_equals_xla(stages):
    s = stages
    kw = dict(KW, payload_words=s["pw"], lags=s["lags"], suffix_keys=s["skw"])
    lengths = s["lengths"]
    ln1, d1 = jax.jit(
        lambda d: jlz.best_matches(d, jnp.asarray(lengths), suffix=True, **kw))(s["data"])
    ln2, d2 = lz_cuda.best_matches_suffix_cuda(
        torch.from_numpy(s["data"]), torch.from_numpy(lengths), **kw)
    ln1, d1 = np.asarray(ln1), np.asarray(d1)
    assert np.array_equal(ln1, ln2.numpy())
    assert np.array_equal(d1[ln1 > 0], d2.numpy()[ln1 > 0])
    assert np.array_equal(ln2.numpy(), s["ln"])
    assert np.array_equal(d2.numpy(), s["dist"])


def test_best_matches_suffix_cuda_halo_equals_pallas():
    """The halo case of test_match_suffix_pallas_halo: a 2048-byte halo
    whose first 1024 bytes are off limits in row 1."""
    n, base = 6144, 2048
    blob = np.frombuffer(_corpus(2 * (n + base), seed=11), np.uint8).reshape(2, n + base).copy()
    lengths = np.array([n, n - 55], np.int32)
    hs = np.array([0, 1024], np.int32)
    kw = dict(KW, payload_words=3, lags=4, base=base)
    ln1, d1 = best_matches_suffix_pallas(jnp.asarray(blob), jnp.asarray(lengths),
                                         halo_start=jnp.asarray(hs), **kw)
    ln2, d2 = lz_cuda.best_matches_suffix_cuda(
        torch.from_numpy(blob), torch.from_numpy(lengths), halo_start=torch.from_numpy(hs),
        **kw)
    assert np.array_equal(np.asarray(ln1), ln2.numpy())
    assert np.array_equal(np.asarray(d1), d2.numpy())
    assert (ln2.numpy() > 0).sum() > 1000
