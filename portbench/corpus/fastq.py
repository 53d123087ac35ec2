"""Seeded FASTQ as a sequencer writes it, vectorised with NumPy.

Each record is four lines:

- the name in Illumina's CASAVA 1.8 form,
  ``@<instrument>:<run>:<flowcell>:<lane>:<tile>:<x>:<y> 1:N:0:<index>``.
  Instrument, run, flowcell and the 8-base sample index are drawn once
  from the seed. The tiles follow a NovaSeq flow cell's order (surface 1-2,
  swath 1-6, tile 01-78, then the next lane), ``TILE_READS`` records a
  tile, with ``y`` rising through the tile from 1,000 to 37,000 and ``x``
  uniform in 1,000-32,000, as a run's file lists its clusters;
- a ``READ``-base read of a seeded random reference of ``REFERENCE``
  bases (E. coli K-12 MG1655's length), from a uniform start on either
  strand with equal odds, each base substituted with odds
  ``SUBSTITUTION`` (0.1%) by one of the other three;
- a bare ``+``;
- Phred+33 qualities on NovaSeq RTA3's four bins (Q2, Q12, Q23, Q37 as
  ``#``, ``-``, ``8``, ``F``), from a Markov chain that starts at ``F``
  and steps by ``TRANSITIONS`` (to 1/4,096): from ``F`` it stays with
  odds 0.958, it leaves a low bin within a few bases, and about 92% of
  the qualities are ``F``.

The rates and the chain are assumed; none is taken from a published run.
Chunk ``i`` of ``TILE_READS`` records is tile ``i`` and is drawn from the
``i``-th child of the seed's ``SeedSequence``, so chunks are made in
parallel and the same seed gives the same bytes.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

REFERENCE = 4_641_652  # bases, E. coli K-12 MG1655
READ = 150  # bases a read
SUBSTITUTION = 0.001  # odds a base is substituted
TILE_READS = 8192  # records a tile, and the unit of work of a thread
BASES = np.frombuffer(b"ACGT", np.uint8)  # code c; its complement is 3 - c
QUALS = np.frombuffer(b"#-8F", np.uint8)  # Q2, Q12, Q23, Q37 in Phred+33
# next bin's odds from each bin, rows and columns in QUALS's order
TRANSITIONS = np.array([[0.400, 0.100, 0.100, 0.400],
                        [0.020, 0.300, 0.180, 0.500],
                        [0.010, 0.040, 0.450, 0.500],
                        [0.002, 0.010, 0.030, 0.958]])
_STEP = 12  # the chain draws its steps as 12-bit numbers: odds to 1/4,096
# _NEXT[(b << _STEP) | u] = the bin after bin b on draw u, shifted by _STEP
_NEXT = np.concatenate([
    (((np.arange(1 << _STEP) + 0.5) / (1 << _STEP))[:, None]
     > np.cumsum(row)[:3]).sum(1) << _STEP for row in TRANSITIONS]).astype(np.uint16)
TILES = [s * 1000 + w * 100 + t for s in (1, 2) for w in range(1, 7) for t in range(1, 79)]
_RECORD_BYTES = 362  # about, for the first draw of chunk seeds
_DIGITS = 5  # most digits of x and y
_POW = 10 ** np.arange(_DIGITS - 1, -1, -1)


def make(nbytes: int, seed: int, threads: int = 8) -> bytes:
    """``nbytes`` of FASTQ drawn from ``seed`` (any integer): the same seed
    gives the same bytes, whatever ``threads``."""
    root = np.random.SeedSequence(seed % (1 << 64))
    ref_seed, run_seed = root.spawn(2)
    ref = np.random.default_rng(ref_seed).integers(0, 4, REFERENCE, dtype=np.uint8)
    rng = np.random.default_rng(run_seed)
    alnum = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789", np.uint8)
    instrument = "A%05d" % rng.integers(0, 100000)
    run = int(rng.integers(1, 1000))
    flowcell = "H" + alnum[rng.integers(0, 36, 5)].tobytes().decode() + "DSX"
    index = BASES[rng.integers(0, 4, 8)].tobytes().decode()
    head = f"@{instrument}:{run}:{flowcell}:"
    tail = f" 1:N:0:{index}\n".encode()
    parts: list[bytes] = []
    total = 0
    with ThreadPoolExecutor(threads) as pool:
        while total < nbytes:
            count = int((nbytes - total) / (TILE_READS * _RECORD_BYTES) * 1.02) + 1
            tiles = range(len(parts), len(parts) + count)
            for flat in pool.map(partial(_chunk, ref, head, tail), tiles, root.spawn(count)):
                if total >= nbytes:
                    break
                parts.append(flat)
                total += len(flat)
    return b"".join(parts)[:nbytes]


def _digits(v: np.ndarray) -> np.ndarray:
    """[n, 5] ASCII digits of each value, the leading zeros as 0 bytes."""
    d = (v[:, None] // _POW % 10 + 48).astype(np.uint8)
    d[(v[:, None] < _POW) & (_POW > 1)] = 0
    return d


def _chunk(ref: np.ndarray, head: str, tail: bytes, i: int,
           seed: np.random.SeedSequence) -> bytes:
    """Tile ``i``'s ``TILE_READS`` records as bytes."""
    rng = np.random.default_rng(seed)
    n = TILE_READS
    lane, tile = 1 + i // len(TILES), TILES[i % len(TILES)]
    codes = ref[rng.integers(0, REFERENCE - READ + 1, n)[:, None] + np.arange(READ)]
    minus = rng.random(n) < 0.5
    codes[minus] = 3 - codes[minus, ::-1]
    subs = rng.random((n, READ)) < SUBSTITUTION
    codes[subs] = (codes[subs] + rng.integers(1, 4, int(subs.sum()), dtype=np.uint8)) % 4
    steps = rng.integers(0, 1 << _STEP, (READ, n), dtype=np.uint16)
    state = np.full(n, 3 << _STEP, np.uint16)
    for j in range(READ):
        state = steps[j] = _NEXT[state | steps[j]]
    quals = QUALS[steps.T >> _STEP]
    y = np.sort(rng.integers(1000, 37000, n))
    x = rng.integers(1000, 32000, n)

    def const(b: bytes) -> np.ndarray:
        return np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))

    rows = np.concatenate([
        const(f"{head}{lane}:{tile}:".encode()), _digits(x), const(b":"), _digits(y),
        const(tail), BASES[codes], const(b"\n+\n"), quals, const(b"\n")], axis=1)
    return rows[rows != 0].tobytes()
