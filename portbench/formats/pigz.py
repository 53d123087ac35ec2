"""Plain reference for pigz's default Gzip stream: the layout of
``formats/gzip.py`` (each 128 KiB block deflated with the 32 KiB before it
as its dictionary, ended by a sync flush, the last block final, the
stream's CRC32 and length in the trailer) at zlib's default level, 6.

Its check is ``formats/gzip.py``'s, plus ``size_bad``: 1 where the stream's
bytes over its input exceed ``LIMIT`` times the ratio zlib reaches in the
same layout over the corpus bytes the window covered, else 0. The
reference deflates each block on its own with its dictionary, as pigz
does, so the blocks are shared out over a pool of processes. On Python's
``zlib``, independent of the port.
"""

from __future__ import annotations

import multiprocessing
import sys
import zlib
from concurrent.futures import ProcessPoolExecutor

from portbench.formats import gzip as stream

PROGRAM = "Gzip"  # the port's format object
HALO = stream.HALO  # a block's matches reach into the 32 KiB before it
LEVEL = 6  # pigz's default: Z_DEFAULT_COMPRESSION, which zlib takes as 6
BLOCK = 131072  # pigz's default block (-b 128)
# Most the port's bytes may exceed zlib's in this layout, as a share. The
# port's suffix matcher writes 0.98 of zlib's bytes on the seeded text and
# its hash matcher (level 5's route) 1.18, so a search weakened even to
# the hash route fails while the unchanged encoder has 3% to spare.
LIMIT = 1.01
POOL_MIN = 64  # fewest blocks worth a pool of processes


def body_bytes(piece: bytes, lead: int, level: int, block: int, final: bool) -> int:
    """Bytes of the raw deflate blocks of ``piece[lead:]``, ``block`` bytes
    each, each with the ``HALO`` bytes before it in ``piece`` as its
    dictionary and ended by a sync flush; the last one ends the stream
    where ``final``."""
    mv = memoryview(piece)
    total = 0
    for s in range(lead, len(piece), block):
        zd = bytes(mv[max(0, s - HALO): s])
        c = zlib.compressobj(level, zlib.DEFLATED, -15, **({"zdict": zd} if zd else {}))
        last = final and s + block >= len(piece)
        total += len(c.compress(mv[s: s + block]))
        total += len(c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return total


def _shares(data: bytes, block: int, procs: int) -> list[tuple]:
    """``body_bytes``'s arguments for ``procs`` contiguous runs of the
    blocks of ``data``, each run with the dictionary before it."""
    count = -(-len(data) // block)
    cuts = [count * i // procs * block for i in range(procs + 1)]
    out = []
    for a, b in zip(cuts, cuts[1:]):
        if a < b:
            lo = max(0, a - HALO)
            out.append((data[lo: min(b, len(data))], a - lo, LEVEL, block, b >= len(data)))
    return out


def check(parts, want, procs: int = 8) -> dict[str, int]:
    """``formats/gzip.check``'s counts and ``size_bad``. The reference's
    size is computed on ``procs`` fresh interpreters (``spawn``: nothing of
    the caller's CUDA state) while the stream is inflated, where there are
    ``POOL_MIN`` blocks or more. ``want`` is a ``members.Expected``."""
    covered = want.data[: min(want.total, len(want.data))]
    shares = _shares(covered, BLOCK, procs if len(covered) >= POOL_MIN * BLOCK else 1)
    if len(shares) > 1:
        # by its package name: the harness loads this file under another
        # one, which a fresh interpreter cannot import
        from portbench.formats import pigz

        with ProcessPoolExecutor(len(shares),
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            sizes = pool.map(pigz.body_bytes, *zip(*shares))
            bad = stream.check(parts, want)
            ref = 18 + sum(sizes)
    else:
        bad = stream.check(parts, want)
        ref = 18 + sum(body_bytes(*s) for s in shares)
    port = sum(len(p) for p in parts)
    port_ratio = port / want.total if want.total else 0.0
    ref_ratio = ref / len(covered) if covered else 0.0
    bad["size_bad"] = int(port_ratio > LIMIT * ref_ratio)
    share = port_ratio / ref_ratio if ref_ratio else 0.0
    print(f"pigz: {port_ratio:.6f} B/B written, zlib level {LEVEL} in pigz's layout "
          f"{ref_ratio:.6f} B/B over {len(covered)} B, {share:.6f} of it (limit {LIMIT})",
          file=sys.stderr)
    return bad


def control(sink, cfg: dict) -> stream.Writer:
    """The control: pigz's layout written by the reference at level 1, with
    the last block's CRC32 in the trailer in place of the stream's."""
    return stream.Writer(sink, 1, cfg["block_bytes"], cfg["rows"], combine=False)
