"""Each format's uncompressed block (``FormatSpec.stored_block``), the one
the writer swaps in when the device's encoding is larger or fails verify:
it decodes back to its input with a decoder that is not the package's
(``zlib``, or ``utils/snappy_ref.decode_frames`` for Snappy), its length
is ``stored_len``, and a member's header, written by ``member_header``,
reads back through ``get_block_size`` as the member's length. Lengths 0,
1, 65,535, 65,536 and the format's default block, each capped at the
block the writer hands the format. Then the writer's verify net on each
format: a repair and the block after it. Tolerance: exact bytes, lengths
and checks.
"""

import io
import zlib

import numpy as np
import pytest

from gzp_tpu_torch.check import crc32c, snappy_mask_crc
from gzp_tpu_torch.constants import DICT_SIZE
from gzp_tpu_torch.formats import ALL_FORMATS, BlockFormatSpec, Snap
from gzp_tpu_torch.parallel.compress import ParCompress
from gzp_tpu_torch.utils.snappy_ref import decode_frames


def _lengths(fmt):
    cap = fmt.max_input_block or fmt.default_bufsize
    return sorted({min(n, cap) for n in (0, 1, 65535, 65536, fmt.default_bufsize)})


CASES = [(name, n) for name, fmt in ALL_FORMATS.items() for n in _lengths(fmt)]


@pytest.mark.parametrize("name,n", CASES, ids=[f"{name}-{n}" for name, n in CASES])
def test_stored_block_decodes_and_frames(name, n):
    fmt = ALL_FORMATS[name]
    raw = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    chk = snappy_mask_crc(crc32c(raw, 0)) if fmt is Snap else zlib.crc32(raw)
    blob = fmt.stored_block(raw, True, 3, chk)
    assert len(blob) == fmt.stored_len(n)
    if fmt is Snap:
        assert decode_frames(blob) == raw
    elif isinstance(fmt, BlockFormatSpec):
        assert zlib.decompress(blob, 31) == raw
        fmt.check_header(blob[: fmt.header_size])
        assert fmt.get_block_size(blob[: fmt.header_size]) == len(blob)
    else:
        assert zlib.decompress(blob, -15) == raw


@pytest.mark.parametrize("name", list(ALL_FORMATS))
def test_verify_repairs_then_reads_on(name):
    """A block the oracle rejects is re-emitted as the format's stored block
    with the host's check of it (Snappy: the device's, which its frame
    carries, even a wrong one); the oracle then reads the next block after
    the repaired bytes: a stream's next chunk may copy from them."""
    fmt = ALL_FORMATS[name]
    w = ParCompress(fmt, io.BytesIO(), num_threads=2, device="cpu", verify=True,
                    buffer_size=DICT_SIZE)
    raw = np.random.default_rng(7).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    blob, chk = w._verify_or_repair(b"garbage" * 10, raw, len(raw), False, 123)
    assert blob == fmt.stored_block(raw, False, w.level, 123)
    host = fmt.check_cls()
    host.update(raw)
    assert chk == (123 if fmt is Snap else host.sum())
    after = raw[:500]
    if isinstance(fmt, BlockFormatSpec) or fmt is Snap:
        nxt = fmt.stored_block(after, True, w.level, snappy_mask_crc(crc32c(after, 0)))
    else:  # a chunk whose match reaches back into the repaired block
        z = zlib.compressobj(6, zlib.DEFLATED, -15, zdict=raw)
        nxt = z.compress(after) + z.flush()
        assert len(nxt) < 100
    assert w._verify_or_repair(nxt, after, len(after), True, 7) == (nxt, 7)
    assert w.verify_stats == {"checked": 2, "repaired": 1}
