"""The port's match stage against the JAX package on the same inputs.

The plain PyTorch versions of K1, K2 and K6 (the CPU route of the CUDA
wrappers in gzp_tpu_torch/ops/lz_cuda.py) against the Pallas kernels run
in interpret mode (auto-selected on the CPU), stage by stage on the same
inputs; the whole matcher against ``lz.best_matches``; and the parse
against ``lz.parse_marks_scan`` and a serial greedy walk. Rows are
multiples of 1024 bytes, where the Pallas kernels equal the XLA
formulation. Tolerance: exact equality (integer code); distances are
compared only where len > 0 against ``lz.best_matches``, whose invalid
lanes differ from the Pallas kernels' (gzp_tpu/ops/lz_pallas.py:712-714).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops import lz as jlz
from gzp_tpu.ops.lz_pallas import (
    best_matches_pallas,
    build_keys_pallas,
    match_tail_pallas,
    neighbor_pallas,
)
from gzp_tpu_torch.ops import lz as tlz
from gzp_tpu_torch.ops import lz_cuda

B, N = 3, 8192
KW = dict(max_dist=32768, max_match=258, min_emit=3, lazy=True)


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [b"the quick brown fox ", b"jumps over the lazy dog ",
             b"pack my box with five dozen liquor jugs "]
    out, total = [], 0
    while total < n:
        w = words[rng.integers(0, len(words))]
        out.append(w)
        total += len(w)
    return b"".join(out)[:n]


def _rows(seed=0):
    """Text; text with a ragged length; random bytes, a zero run, text."""
    data = np.frombuffer(_corpus(B * N, seed), np.uint8).reshape(B, N).copy()
    rng = np.random.default_rng(seed + 100)
    data[2, :2048] = rng.integers(0, 256, 2048, dtype=np.uint8)
    data[2, 2048:5000] = 0
    lengths = np.array([N, N - 321, N], np.int32)
    data[1, N - 321:] = 0
    return data, lengths


def _u32(x):
    """Any tensor/array of u32 bit patterns -> uint32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


@pytest.fixture(scope="module", params=[(3, 2), (2, 1), (2, 4)], ids=lambda p: f"pw{p[0]}-lags{p[1]}")
def pallas_stages(request):
    """Every stage of ``best_matches_pallas``, run in interpret mode."""
    pw, lags = request.param
    data, lengths = _rows()
    halo = np.zeros(B, np.int32)
    pos_bits = jlz._pos_bits(N)
    key, pays = build_keys_pallas(jnp.asarray(data), pos_bits=pos_bits, payload_words=pw)
    srt = jax.lax.sort((key, *pays), dimension=1, num_keys=1)
    sp, packed = neighbor_pallas(srt[0], list(srt[1:]), jnp.asarray(halo),
                                 pos_bits=pos_bits, lags=lags, max_dist=32768)
    _, packed_pos = jax.lax.sort((sp, packed), dimension=1, num_keys=1)
    ln, dist = match_tail_pallas(
        jnp.asarray(data), packed_pos, jnp.asarray(lengths), jnp.asarray(halo), base=0,
        payload_bytes=4 * pw, max_match=258, min_emit=3, lazy=True)
    as_np = lambda *xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(pw=pw, lags=lags, pos_bits=pos_bits, data=data, lengths=lengths, halo=halo,
                key=np.asarray(key), pays=as_np(*pays), sk=np.asarray(srt[0]),
                spays=as_np(*srt[1:]), sp=np.asarray(sp), packed=np.asarray(packed),
                packed_pos=np.asarray(packed_pos), ln=np.asarray(ln), dist=np.asarray(dist))


def test_build_keys_plain_equals_pallas(pallas_stages):
    s = pallas_stages
    key, pays = lz_cuda.build_keys_cuda(  # CPU tensor -> the plain version
        torch.from_numpy(s["data"]), pos_bits=s["pos_bits"], payload_words=s["pw"])
    assert np.array_equal(_u32(key), _u32(s["key"]))
    assert np.array_equal(_u32(pays), _u32(np.stack(s["pays"])))


def test_neighbor_plain_equals_pallas(pallas_stages):
    s = pallas_stages
    sk = torch.from_numpy(_u32(s["sk"]).astype(np.int64))
    spays = torch.from_numpy(_u32(np.stack(s["spays"])).view(np.int32))
    sp, packed = lz_cuda.neighbor_cuda(
        sk, spays, torch.from_numpy(s["halo"]), pos_bits=s["pos_bits"], lags=s["lags"],
        max_dist=32768)
    assert np.array_equal(_u32(sp), _u32(s["sp"]))
    assert np.array_equal(_u32(packed), _u32(s["packed"]))


def test_match_tail_plain_equals_pallas(pallas_stages):
    s = pallas_stages
    ln, dist = lz_cuda.match_tail_cuda(
        torch.from_numpy(s["data"]), torch.from_numpy(_u32(s["packed_pos"]).view(np.int32)),
        torch.from_numpy(s["lengths"]), torch.from_numpy(s["halo"]), base=0,
        payload_bytes=4 * s["pw"], max_match=258, min_emit=3, lazy=True)
    assert np.array_equal(ln.numpy(), s["ln"])
    assert np.array_equal(dist.numpy(), s["dist"])


@pytest.mark.parametrize("pw,lags", [(3, 2), (2, 1), (2, 4)])
def test_best_matches_cuda_equals_xla(pw, lags):
    data, lengths = _rows(seed=4)
    kw = dict(KW, payload_words=pw, lags=lags)
    ln1, d1 = jax.jit(lambda d: jlz.best_matches(d, jnp.asarray(lengths), **kw))(data)
    ln2, d2 = lz_cuda.best_matches_cuda(torch.from_numpy(data), torch.from_numpy(lengths), **kw)
    ln1, d1 = np.asarray(ln1), np.asarray(d1)
    assert np.array_equal(ln1, ln2.numpy())
    assert np.array_equal(d1[ln1 > 0], d2.numpy()[ln1 > 0])


def test_best_matches_cuda_halo_equals_pallas():
    """The halo case of test_match_pallas_halo: a 2048-byte halo whose
    first 1024 bytes are off limits in row 1."""
    n, base = 6144, 2048
    blob = np.frombuffer(_corpus(2 * (n + base), seed=3), np.uint8).reshape(2, n + base).copy()
    lengths = np.array([n, n - 55], np.int32)
    hs = np.array([0, 1024], np.int32)
    kw = dict(KW, payload_words=3, lags=2, base=base)
    ln1, d1 = best_matches_pallas(jnp.asarray(blob), jnp.asarray(lengths),
                                  halo_start=jnp.asarray(hs), **kw)
    ln2, d2 = lz_cuda.best_matches_cuda(torch.from_numpy(blob), torch.from_numpy(lengths),
                                        halo_start=torch.from_numpy(hs), **kw)
    assert np.array_equal(np.asarray(ln1), ln2.numpy())
    assert np.array_equal(np.asarray(d1), d2.numpy())


def _greedy_walk(match_len, lengths, min_emit, base, max_step=255):
    """The parse's definition: from position 0, step max(1, l) where l is
    capped at 255 and at the block end, and dropped below min_emit."""
    b, m = match_len.shape
    marked = np.zeros((b, m), bool)
    for r in range(b):
        end = base + int(lengths[r])
        i = 0
        while i < m:
            l = min(int(match_len[r, i]), max_step, max(end - i, 0))
            l = l if l >= min_emit else 0
            marked[r, i] = base <= i < end
            i += max(1, l)
    return marked


@pytest.mark.parametrize("base", [0, 1024])
def test_parse_marks_scan_equals_jax_and_greedy_walk(base):
    rng = np.random.default_rng(base + 11)
    m = 8192 + base
    ml = rng.integers(0, 300, (B, m)).astype(np.int32)
    ml[rng.random((B, m)) < 0.7] = 0
    lengths = np.array([8192, 8000, 7], np.int32)
    marked1, l1 = jlz.parse_marks_scan(jnp.asarray(ml), jnp.asarray(lengths), min_emit=3, base=base)
    marked2, l2 = tlz.parse_marks_scan(torch.from_numpy(ml), torch.from_numpy(lengths),
                                       min_emit=3, base=base)
    assert np.array_equal(np.asarray(marked1), marked2.numpy())
    assert np.array_equal(np.asarray(l1), l2.numpy())
    assert np.array_equal(_greedy_walk(ml, lengths, 3, base), marked2.numpy())
