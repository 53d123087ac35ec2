"""The LCP ladder K4's plain version against the JAX package, on the CPU.

``lcp_lags_plain`` (the CPU route of ``lz_cuda.lcp_lags_cuda``, whose
kernel computes every lag in one launch) against ``lcp_lags_pallas`` in
interpret mode, for 1, 3 and 7 context words, lags 1 to 3 and both byte
orders, on rows built for the ladder's cases: every slot's words equal
(LCP 4 * pw past the first ``lag`` slots, which compare with zero words),
distinct words, words equal but for the last, and a sorted row of few
distinct words. Tolerance: exact equality (integer code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops.lz_pallas import LANES, lcp_lags_pallas
from gzp_tpu_torch.ops import lz_cuda

B, NP = 4, 2048
LAGS = 3


def _words(pw, seed=0):
    """[pw, B, Np] uint32: the four kinds of row above."""
    rng = np.random.default_rng(seed)
    w = np.empty((pw, B, NP), np.uint32)
    word = rng.integers(1, 1 << 32, pw, dtype=np.uint64).astype(np.uint32)
    w[:, 0] = word[:, None]  # every slot equal
    w[:, 1] = rng.integers(0, 1 << 32, (pw, NP), dtype=np.uint64).astype(np.uint32)
    w[:, 2] = word[:, None]  # equal but for one byte of the last word
    byte = rng.integers(0, 4, NP).astype(np.uint32)
    w[-1, 2] ^= (rng.integers(1, 256, NP).astype(np.uint32) << (8 * byte)) * (
        rng.random(NP) < 0.7)
    # few distinct words, sorted lexicographically (slots of equal prefixes)
    few = rng.integers(0, 3, (pw, NP)).astype(np.uint32) * np.uint32(0x01010101)
    w[:, 3] = few[:, np.lexsort(few[::-1])]
    return w


@pytest.fixture(scope="module", params=[1, 3, 7], ids=lambda p: f"pw{p}")
def ladder(request):
    """Words and the Pallas LCPs at lags 1..LAGS, both byte orders."""
    pw = request.param
    w = _words(pw, seed=pw)
    pays3 = [jnp.asarray(w[k].reshape(B, NP // LANES, LANES)) for k in range(pw)]
    want = {be: np.stack([np.asarray(x).reshape(B, NP)
                          for x in lcp_lags_pallas(pays3, LAGS, big_endian=be, interpret=True)])
            for be in (True, False)}
    return w, want


@pytest.mark.parametrize("lags", [1, 2, 3])
@pytest.mark.parametrize("big_endian", [True, False], ids=["be", "le"])
def test_lcp_lags_plain_equals_pallas(ladder, lags, big_endian):
    w, want = ladder
    got = lz_cuda.lcp_lags_cuda(torch.from_numpy(w.view(np.int32)), lags,  # CPU: plain
                                big_endian=big_endian)
    assert got.dtype == torch.int32 and tuple(got.shape) == (lags, B, NP)
    assert np.array_equal(got.numpy(), want[big_endian][:lags])


def test_ladder_rows_hold_their_cases(ladder):
    """Equal rows reach 4 * pw past the first lags; distinct rows stop in
    word 0; the third row stops in the last word or reaches 4 * pw."""
    w, want = ladder
    pw = w.shape[0]
    for be in (True, False):
        lcp = want[be]
        for lag in range(1, LAGS + 1):
            assert (lcp[lag - 1, 0, lag:] == 4 * pw).all()
            assert (lcp[lag - 1, 2, lag:] >= 4 * (pw - 1)).all()
            assert (lcp[lag - 1, 2, lag:] < 4 * pw).any()
        assert (lcp[0, 1] < 4).mean() > 0.99
