"""Seeded English-like text: the word draw and 70-column lines of the
port's benchmark text, vectorised with NumPy.

The vocabulary (repeats and all, so repeated words are drawn more often),
the uniform draw over it and the rule that a line ends after the word that
takes it past 70 columns are those of ``make_corpus`` in the repository's
``bench.py``, which stands in for gzp's criterion corpus
(``bench-data/shakespeare.txt``, not shipped). Two departures make it fast:
the seed is the caller's, and words are drawn in paragraphs of
``PARAGRAPH`` words whose last word always ends its line, so every
paragraph's line breaks are found at once, column by column.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

VOCAB = (
    "the quick brown fox jumps over lazy dog and all that glitters is not gold "
    "to be or not to be that is the question whether tis nobler in the mind to "
    "suffer the slings and arrows of outrageous fortune or to take arms against "
    "a sea of troubles and by opposing end them to die to sleep no more and by a "
    "sleep to say we end the heartache and the thousand natural shocks that flesh "
    "is heir to tis a consummation devoutly to be wished to die to sleep"
).split()
PARAGRAPH = 4096  # words
CHUNK = 256  # paragraphs drawn from one child seed, and the unit of work of a thread
COLUMNS = 70
_LENS = np.array([len(w) for w in VOCAB], np.int64)
_WIDTHS = (_LENS + 1).astype(np.int16)  # each word with its separator
# row v: word v and a space; row v + len(VOCAB): word v and a newline; zero padded
_TABLE = np.zeros((2 * len(VOCAB), 16), np.uint8)
for _i, _w in enumerate(VOCAB):
    for _j, _sep in enumerate((b" ", b"\n")):
        _TABLE[_i + _j * len(VOCAB), : len(_w) + 1] = np.frombuffer(_w.encode() + _sep, np.uint8)


def make(nbytes: int, seed: int, threads: int = 8) -> bytes:
    """``nbytes`` of text drawn from ``seed`` (any integer): the same seed
    gives the same bytes, whatever ``threads``. Chunk ``i`` of ``CHUNK``
    paragraphs is drawn from the ``i``-th child of the seed's
    ``SeedSequence``, so chunks are made in parallel."""
    root = np.random.SeedSequence(seed % (1 << 64))
    per_chunk = CHUNK * PARAGRAPH * (float(_LENS.mean()) + 1)
    parts: list[bytes] = []
    total = 0
    with ThreadPoolExecutor(threads) as pool:
        while total < nbytes:
            count = int((nbytes - total) / per_chunk * 1.02) + 1
            seeds = root.spawn(count)
            for flat in pool.map(_chunk, seeds):
                if total >= nbytes:
                    break
                parts.append(flat)
                total += len(flat)
    return b"".join(parts)[:nbytes]


def _chunk(seed: np.random.SeedSequence) -> bytes:
    picks = np.random.default_rng(seed).integers(
        0, len(VOCAB), size=(CHUNK, PARAGRAPH), dtype=np.uint8)
    rows = picks + len(VOCAB) * _line_breaks(_WIDTHS[picks])
    words = _TABLE[rows.reshape(-1)]
    return words[words != 0].tobytes()


def _line_breaks(widths: np.ndarray) -> np.ndarray:
    """[paragraphs, words] of 0 and 1: 1 where the word ends its line (a
    newline follows it rather than a space). A line ends after the word
    that takes it past ``COLUMNS``, counting each word with its separator;
    a paragraph's last word ends its line."""
    cols = np.ascontiguousarray(widths.T)  # one row per word position
    line = np.zeros(cols.shape[1], np.int16)
    out = np.empty(cols.shape, np.uint8)
    for j in range(cols.shape[0]):
        line += cols[j]
        brk = line > COLUMNS
        out[j] = brk
        line[brk] = 0
    out[-1] = 1
    return out.T
