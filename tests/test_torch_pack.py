"""The port's bit packer against the JAX package on the same inputs.

K10's plain version (the CPU route of gzp_tpu_torch/ops/pack_cuda.py)
against ``pack_prescan_pallas`` in interpret mode, and the whole packer
against ``pack_entries_sortscan_pallas`` and the XLA
``pack_entries_sortscan``, plus the packer's edge shapes. Tolerance:
exact equality (integer code); K10's ``val`` is compared where its key
names a word (elsewhere it is scan state nothing reads).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gzp_tpu.ops.deflate_kernel import pack_entries_sortscan
from gzp_tpu.ops.pack_pallas import pack_entries_sortscan_pallas, pack_prescan_pallas
from gzp_tpu_torch.ops import pack_cuda


def _entries(seed, b=3, e=5000):
    """Random (value, width) entries obeying value < 2**width, half zero-width."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 32, (b, e)).astype(np.int32)
    nb[rng.random((b, e)) < 0.5] = 0
    bits = rng.integers(0, 1 << 31, (b, e), dtype=np.int64).astype(np.uint32)
    bits = np.where(nb > 0, bits & ((1 << np.minimum(nb, 31)) - 1).astype(np.uint32), 0)
    return bits.astype(np.uint32), nb


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32) if x.dtype == np.uint32 else x)


@pytest.mark.parametrize("base_bits", [0, 144, 160])
def test_pack_prescan_plain_equals_pallas(base_bits):
    bits, nb = _entries(1)
    k1, v1, t1 = pack_prescan_pallas(jnp.asarray(bits), jnp.asarray(nb), base_bits)
    k2, v2, t2 = pack_cuda.pack_prescan_cuda(_t(bits), _t(nb), base_bits)  # CPU: plain
    k1, v1 = np.asarray(k1), np.asarray(v1)
    k2, v2 = k2.numpy().view(np.uint32), v2.numpy().view(np.uint32)
    assert np.array_equal(k1, k2)
    named = k1 != 0xFFFFFFFF
    assert np.array_equal(v1[named], v2[named])
    assert np.array_equal(np.asarray(t1), t2.numpy())


@pytest.mark.parametrize("base_bits", [0, 160])
@pytest.mark.parametrize("seed", [1, 2])
def test_pack_entries_equals_pallas_and_xla(base_bits, seed):
    bits, nb = _entries(seed)
    ow = (int(nb.sum(1).max()) + base_bits + 31) // 32 + 8
    w1, t1 = pack_entries_sortscan_pallas(jnp.asarray(bits), jnp.asarray(nb), base_bits, ow)
    w0, t0 = pack_entries_sortscan(jnp.asarray(bits), jnp.asarray(nb), base_bits, ow)
    w2, t2 = pack_cuda.pack_entries_sortscan_cuda(_t(bits), _t(nb), base_bits, ow)
    w2 = w2.numpy().astype(np.uint32)
    assert np.array_equal(np.asarray(w1), w2)
    assert np.array_equal(np.asarray(w0), w2)
    assert np.array_equal(np.asarray(t1), t2.numpy())


@pytest.mark.parametrize(
    "nb_case",
    [
        np.zeros((2, 5), np.int32),  # all zero-width
        np.full((1, 1), 31, np.int32),  # single max-width entry
        np.array([[16, 16, 16, 16]], np.int32),  # exact word boundaries
        np.array([[31, 31, 31, 31, 2]], np.int32),  # every entry crosses
    ],
    ids=["zero-width", "one-31", "boundaries", "all-cross"],
)
def test_pack_entries_edges(nb_case):
    bits = ((np.uint32(1) << nb_case.astype(np.uint32)) - 1) & np.uint32(0x5A5A5A5A)
    ow = (31 * nb_case.shape[1] + 64) // 32 + 12
    w1, t1 = pack_entries_sortscan(jnp.asarray(bits), jnp.asarray(nb_case), 0, ow)
    w2, t2 = pack_cuda.pack_entries_sortscan_cuda(_t(bits), _t(nb_case), 0, ow)
    assert np.array_equal(np.asarray(w1), w2.numpy().astype(np.uint32))
    assert np.array_equal(np.asarray(t1), t2.numpy())
