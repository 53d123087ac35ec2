"""``make_halo`` of ``parallel/compress.py``, the stream's per-row preset dictionaries,
against an index-plane gather of the same bytes (the reference, below):
block sizes at, just over, well over and four times the 32 KiB
dictionary; predecessor lengths 0, 1, d-1, d, d+1 and a full row, mixed
within a batch; no carry, a short carry and a full one; B = 1 and 4.
Numpy only; tolerance: exact equality of the halo and ``dict_lens``.
A batch's one ragged row is its last real row, so whole streams never
show a short predecessor's halo in their bytes: only this test holds it.
"""

import numpy as np
import pytest

from gzp_tpu_torch.constants import DICT_SIZE
from gzp_tpu_torch.parallel.compress import make_halo

D = DICT_SIZE


def _halo_gather(arr, lengths, carry, d):
    """Row i gets arr[i-1, pl-cl : pl] right-aligned, by gathering through a
    [B-1, d] int64 index plane and masking; row 0 gets the carry."""
    b, n = arr.shape
    halo = np.zeros((b, d), dtype=np.uint8)
    dict_lens = np.zeros(b, dtype=np.int32)
    if carry:
        cl = min(len(carry), d)
        halo[0, d - cl:] = np.frombuffer(carry[-cl:], np.uint8)
        dict_lens[0] = cl
    if b > 1:
        pl = lengths[:-1].astype(np.int64)
        cl = np.minimum(pl, d)
        src = pl[:, None] - d + np.arange(d, dtype=np.int64)[None, :]
        vals = np.take_along_axis(arr[:-1], np.clip(src, 0, n - 1), axis=1)
        halo[1:] = np.where(src >= (pl - cl)[:, None], vals, 0)
        dict_lens[1:] = cl
    return halo, dict_lens


# predecessor lengths of rows 0-2 of a batch of 4 (capped at the row);
# the last row's own length is nobody's predecessor
ROWS = {
    "B1": [None],
    "B4-0-dm1-full": [0, D - 1, None, 1],
    "B4-1-d-dp1": [1, D, D + 1, None],
}
CARRIES = {"no-carry": 0, "short-carry": 1234, "full-carry": D + 5}


@pytest.mark.parametrize("carry", list(CARRIES))
@pytest.mark.parametrize("rows", list(ROWS))
@pytest.mark.parametrize("n", [32768, 33333, 40000, 131072])
def test_make_halo_equals_index_gather(n, rows, carry):
    rng = np.random.default_rng(n + len(rows) + CARRIES[carry])
    lengths = np.array([n if x is None else min(x, n) for x in ROWS[rows]], dtype=np.int32)
    arr = rng.integers(1, 256, (len(lengths), n), dtype=np.uint8)
    for i, ln in enumerate(lengths):
        arr[i, ln:] = 0  # a padded row is zero past its length, as dispatched
    carry_bytes = rng.integers(0, 256, CARRIES[carry], dtype=np.uint8).tobytes()
    halo, dict_lens = make_halo(arr, lengths, carry_bytes[-D:] if carry_bytes else b"", D)
    want_halo, want_lens = _halo_gather(arr, lengths, carry_bytes, D)
    assert halo.dtype == np.uint8 and halo.shape == (len(lengths), D)
    assert dict_lens.dtype == np.int32
    np.testing.assert_array_equal(dict_lens, want_lens)
    np.testing.assert_array_equal(halo, want_halo)
