"""Inputs that put the tile-parallel kernels' cross-tile arguments at their
edges: the match tails' window (:func:`tail_edge_batch`, and
:func:`behind_halo` for the stream encoder's halo'd rows), the pack
pre-scan's look-back (:func:`pack_edge_batch`), the sorted-neighbour
kernel's lags halo (:func:`neighbor_edge_batch`) and the suffix merge's
ties, early ends and limits (:func:`suffix_merge_edge_batch`).

The tails K6 and K9 (``ops/lz_cuda.py``) run one CTA per tile of T
positions and saturate distance-1 runs at R (``lz_cuda.tail_window``).
:func:`tail_edge_batch` builds rows where that matters: runs of R - 1 to R
+ 1 across tile boundaries, periodic rows whose candidates chain through
every extension round, and runs far longer than R under chaining hash
candidates and a long suffix-field extension (K9's field choice). Both
the kernels and their plain versions take any candidate plane, so the
planes are synthetic; every capped candidate has a distance of at least 1,
as the candidate kernels write them.
"""

from __future__ import annotations

import numpy as np
import torch

from gzp_tpu_torch.ops.lz_cuda import (
    build_suffix_keys_plain, lcp_lags_plain, padded_len, suffix_order, tail_window,
)

KINDS = ("edge_runs", "period3", "period37", "period300", "run_vs_suffix", "random")
PACK_KINDS = ("long_segment", "zero_tiles", "tile_end_flush", "straddle31", "random")
SUFFIX_KINDS = ("zeros", "random", "period3", "text", "zeros_halo", "text_halo", "tile_edge")
NEIGHBOR_KINDS = ("bucket_edge", "row_start", "limits", "ties", "capped", "byte_diff",
                  "random")


def _words(rng, shape, payload_bytes: int) -> np.ndarray:
    """Random candidate words ``dist | len << 17 | capped << 22``: a third
    capped at ``payload_bytes``, the rest of random length."""
    capped = rng.random(shape) < 1 / 3
    ln = np.where(capped, min(payload_bytes, 31), rng.integers(0, 32, shape))
    dist = rng.integers(1, 32769, shape)
    return (dist | (ln << 17) | (capped.astype(np.int64) << 22)).astype(np.int32)


def _chain(dist: int, payload_bytes: int) -> np.int32:
    """A capped candidate at ``dist``: it chains wherever ``dist`` recurs."""
    return np.int32(dist | (min(payload_bytes, 31) << 17) | (1 << 22))


def _put_run(row: np.ndarray, start: int, length: int, value: int) -> None:
    """``length`` equal bytes from ``start``, with different bytes on both
    sides, so the longest distance-1 run inside is ``length`` - 1."""
    row[start: start + length] = value
    if start > 0:
        row[start - 1] = value ^ 0x55
    if start + length < len(row):
        row[start + length] = value ^ 0xAA


def tail_edge_batch(kinds, n: int, *, payload_bytes: int, max_match: int = 258,
                    tile: int | None = None, seed: int = 0) -> dict:
    """One row per entry of ``kinds`` (names from :data:`KINDS`), ``n``
    bytes each -> numpy ``data`` [rows, n] uint8, ``packed_hash`` and
    ``packed_suffix`` [rows, Np] int32 (position order), ``lengths`` and
    ``halo_start`` [rows] int32. Odd rows get ``halo_start`` > 0 (every
    fourth on a tile boundary); every third row from the third ends before
    ``n``. T and R are ``tail_window``'s for these arguments."""
    t, _, r = tail_window(payload_bytes, max_match, tile)
    npad = padded_len(n)
    rows = len(kinds)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (rows, n), dtype=np.uint8)
    hsh = _words(rng, (rows, npad), payload_bytes)
    suf = _words(rng, (rows, npad), payload_bytes)
    lengths = np.full(rows, n, np.int32)
    halo = np.zeros(rows, np.int32)
    bounds = list(range(t, n, t))
    for i, kind in enumerate(kinds):
        row = data[i]
        if kind == "edge_runs":
            # runs of R - 1, R and R + 1 (byte runs one longer) starting
            # before each tile boundary, at its middle, at the boundary - 1
            # and at the boundary; chaining distance-1 hash candidates ahead
            for k, edge in enumerate(bounds):
                length = r + k % 3
                start = edge - (length // 2, 1, length - 1, 0)[(k // 3) % 4]
                if 1 <= start and start + length < n:
                    _put_run(row, start, length, int(rng.integers(0, 256)))
                    hsh[i, max(start - 2 * payload_bytes, 0): start] = _chain(1, payload_bytes)
        elif kind.startswith("period"):
            period = int(kind[len("period"):])
            row[:] = np.resize(rng.integers(0, 256, period, dtype=np.uint8), n)
            # a changed byte every ~700 positions stops chains at varied places
            hits = rng.integers(0, n, max(n // 700, 1))
            row[hits] ^= 0x3C
            keep = rng.random(npad) < 0.97
            hsh[i] = np.where(keep, _chain(period, payload_bytes), hsh[i])
            suf[i] = np.where(keep, _chain(2 * period, payload_bytes), suf[i])
        elif kind == "run_vs_suffix":
            # runs far longer than R across tile boundaries, under chaining
            # distance-1 hash candidates and a suffix field that extends
            # through every round (K9's field choice at lengths above R)
            length = 2 * r + 100
            for edge in bounds[::2]:
                start = edge - length // 3
                if 1 <= start and start + length < n:
                    _put_run(row, start, length, int(rng.integers(0, 256)))
                    hsh[i, max(start - 2 * payload_bytes, 0): start] = _chain(1, payload_bytes)
                    suf[i, start: min(start + length, npad)] = _chain(5, payload_bytes)
        elif kind == "random":
            row[:] = rng.integers(0, 4, n, dtype=np.uint8)  # many short runs
        else:
            raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
        if i % 2 == 1:
            halo[i] = bounds[0] if i % 4 == 1 and bounds else rng.integers(1, n // 2)
        if i % 3 == 2:
            lengths[i] = n - int(rng.integers(1, min(t, n)))
    return dict(data=data, packed_hash=hsh, packed_suffix=suf, lengths=lengths,
                halo_start=halo)


def behind_halo(batch: dict, base: int, halo_start: int, *, payload_bytes: int,
                seed: int = 0) -> dict:
    """:func:`tail_edge_batch` rows moved behind a ``base``-byte halo, as
    the stream encoder's rows are: random halo bytes and random candidate
    words in front, every row's ``halo_start`` set to ``halo_start`` (0 =
    the whole halo is a source, ``base`` = none of it), ``lengths`` kept
    (they count from ``base``). ``base`` must be a multiple of 1024, so the
    rows' padding is unchanged."""
    if base % 1024:
        raise ValueError(f"base={base}: a multiple of 1024 keeps Np = base + Np(n)")
    rows, n = batch["data"].shape
    rng = np.random.default_rng(seed)
    npad = padded_len(base + n)
    out = dict(lengths=batch["lengths"].copy(),
               halo_start=np.full(rows, halo_start, np.int32))
    out["data"] = np.concatenate(
        [rng.integers(0, 256, (rows, base), dtype=np.uint8), batch["data"]], axis=1)
    for key in ("packed_hash", "packed_suffix"):
        plane = _words(rng, (rows, npad), payload_bytes)
        plane[:, base:] = batch[key]
        out[key] = plane
    return out


def _widths(rng, e: int) -> np.ndarray:
    """Random entry widths: half zero, the rest 1..31."""
    return np.where(rng.random(e) < 0.5, 0, rng.integers(1, 32, e)).astype(np.int64)


def _end_word_at(nb: np.ndarray, idx: int, base_bits: int) -> None:
    """Set the width of entry ``idx`` so that the bit position after it is a
    multiple of 32 (nothing to do if it already is at entry ``idx``)."""
    nb[idx] = (-(base_bits + int(nb[:idx].sum()))) % 32


def pack_edge_batch(kinds, e: int, *, tile: int, base_bits: int = 0, seed: int = 0):
    """One row per entry of ``kinds`` (names from :data:`PACK_KINDS`) of
    ``e`` (value, width) entries for the pack pre-scan K10, whose CTAs take
    tiles of ``tile`` entries -> numpy (bits [rows, e] uint32, nbits [rows,
    e] int32), every value < 2**width.

    * ``long_segment``: from tile / 2 on, a word-aligned segment of 3 tiles
      of zero-width entries with 20 one-bit entries of value 1 spread over
      it: no entry completes a word, so its OR state crosses two whole
      tiles without a segment start;
    * ``zero_tiles``: entries [tile, 3 * tile) have width 0;
    * ``tile_end_flush``: the last entry of every tile completes a word
      exactly (a 31-bit entry from bit 1 of a word);
    * ``straddle31``: 31-bit entries across every tile edge, each crossing
      a word boundary with its high bits;
    * ``random``: half zero-width entries.

    The rest of each row is random, half zero-width. ``base_bits`` is the
    offset the pre-scan will be given (the alignments depend on it)."""
    rng = np.random.default_rng(seed)
    nbits = np.zeros((len(kinds), e), np.int64)
    ones = np.zeros((len(kinds), e), bool)  # one-bit entries of value 1
    edges = list(range(tile, e, tile))
    for i, kind in enumerate(kinds):
        nb = nbits[i]
        nb[:] = _widths(rng, e)
        if kind == "long_segment":
            a = min(tile // 2, e)
            span = min(3 * tile, e - a)
            if a > 0 and span > 0:
                _end_word_at(nb, a - 1, base_bits)
                nb[a: a + span] = 0
                at = a + (np.arange(20) * span) // 20
                nb[at] = 1
                ones[i, at] = True
        elif kind == "zero_tiles":
            nb[tile: 3 * tile] = 0
        elif kind == "tile_end_flush":
            for edge in edges:
                if edge >= 2:
                    # bit position 1 mod 32 before entry edge - 1, then 31 bits
                    nb[edge - 2] = (1 - base_bits - int(nb[: edge - 2].sum())) % 32
                    nb[edge - 1] = 31
        elif kind == "straddle31":
            for edge in edges:
                nb[max(edge - 3, 0): edge + 3] = 31
        elif kind != "random":
            raise ValueError(f"unknown kind {kind!r}; expected one of {PACK_KINDS}")
    values = rng.integers(1 << 30, 1 << 31, nbits.shape)  # top bits set: nonzero hi
    bits = np.where(ones, 1, values & ((1 << nbits) - 1))
    return bits.astype(np.uint32), nbits.astype(np.int32)


def _prefix_ctx(rng, base: np.ndarray, lcp: np.ndarray) -> np.ndarray:
    """Context bytes [n, pb] equal to ``base`` [pb] before byte ``lcp[j]``,
    different at it (where it is < pb) and random after it."""
    n, pb = len(lcp), len(base)
    col = np.arange(pb)[None, :]
    out = np.where(col < lcp[:, None], base[None, :], rng.integers(0, 256, (n, pb)))
    flip = rng.integers(1, 256, n)
    at = col == lcp[:, None]
    out = np.where(at, base[None, :] ^ flip[:, None], out)
    return out.astype(np.uint8)


def neighbor_edge_batch(kinds, npad: int, *, tile: int, lags: int, payload_words: int,
                        max_dist: int, seed: int = 0) -> dict:
    """One row per entry of ``kinds`` (names from :data:`NEIGHBOR_KINDS`) of
    ``npad`` hash-sorted slots for the sorted-neighbour kernel K2, whose
    CTAs take tiles of ``tile`` slots with a halo of ``lags`` -> numpy
    ``sk`` [rows, npad] int64 (u32 keys ``hash << pos_bits | pos``),
    ``pays`` [pw, rows, npad] int32 (u32 context words, little-endian),
    ``halo_start`` [rows] int32, ``pos_bits`` (room for positions up to
    past ``max_dist``) and ``sites``, the (row, first slot, slots) of every
    bucket a kind built.

    The row is buckets of equal hash (about 1 in 3 slots starts one while
    the hash bits allow), positions ascending within each, contexts sharing
    a random prefix with the bucket's; then by kind:

    * ``bucket_edge``: a bucket over [e - lags - 3, e + 8) at every tile
      edge e short of the row's last bucket, where slot e and slot e - lags carry the bucket's whole
      context and every other slot a shorter prefix, so slot e's best
      candidate is exactly ``lags`` back, in the tile before;
    * ``row_start``: one bucket over the row's first lags + 4 slots, all
      capped, with the hash, context and lower positions of every other
      row's last bucket (a read across the row start would find them);
    * ``limits``: pairs at the source position halo_start and one below,
      at distance ``max_dist`` and one past, at distance 0 and -1;
    * ``ties``: buckets of 5 slots in shuffled position order whose
      contexts all share the same prefix: the nearest must win;
    * ``capped``: buckets of 6 slots of one whole context;
    * ``byte_diff``: pairs differing in one byte, every byte of every word
      in turn;
    * ``random``: the base row.

    Odd rows other than ``row_start``, and ``limits`` rows, get
    ``halo_start`` > 0. ``npad`` need not be a multiple of ``tile`` or of
    4."""
    pb = 4 * payload_words
    pos_bits = max((npad - 1).bit_length(), (max_dist + 1).bit_length() + 1)
    pmax = (1 << pos_bits) - 2
    hm = 1 << (31 - pos_bits)  # every row's last bucket; row_start rows above it
    rng = np.random.default_rng(seed)
    rows = len(kinds)
    shared = rng.integers(0, 256, pb).astype(np.uint8)
    tail = min(8, npad)
    sk = np.empty((rows, npad), np.int64)
    ctx = np.empty((rows, npad, pb), np.uint8)
    halo = np.zeros(rows, np.int32)
    built = []
    for i, kind in enumerate(kinds):
        if kind not in NEIGHBOR_KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of {NEIGHBOR_KINDS}")
        size = dict(limits=2, ties=5, capped=6, byte_diff=2).get(kind)
        sites = []  # (first slot, slots): buckets the kind fills itself
        edges = list(range(tile, npad - tail - 8, tile)) if kind == "bucket_edge" else []
        if edges:
            sites = [(max(e - lags - 3, 0), min(e + 8, npad) - max(e - lags - 3, 0))
                     for e in edges]
        elif kind == "row_start":
            sites = [(0, min(lags + 4, npad))]
        elif size:
            step = max(size + 3, npad // 512)
            sites = [(a, size) for a in range(1, npad - tail - size - 1, step)]
        built += [(i, a, n) for a, n in sites]
        if kind != "row_start":
            sites.append((npad - tail, tail))
        start = rng.random(npad) < min(0.35, 0.5 * (hm - 2) / npad)
        start[0] = True
        for a, n in sites:
            start[a] = True
            start[a + 1: a + n] = False
            if a + n < npad:
                start[a + n] = True
        bucket = np.cumsum(start) - 1
        nb = int(bucket[-1]) + 1
        assert nb <= hm - 2, (nb, hm)
        first = np.flatnonzero(start)
        base = rng.integers(0, 256, (nb, pb)).astype(np.uint8)
        c = _prefix_ctx(rng, np.zeros(pb, np.uint8), rng.integers(0, pb + 1, npad))
        c ^= base[bucket]  # a prefix of the bucket's context
        inc = np.cumsum(rng.integers(1, 61, npad))
        pos = rng.integers(0, pmax // 2, nb)[bucket] + inc - inc[first][bucket]
        lo = (pmax + 2) // 4
        for q, (a, n) in enumerate(sites):
            s = slice(a, a + n)
            bk = base[bucket[a]]
            if a == npad - tail and kind != "row_start":
                c[s], pos[s] = shared, np.arange(n)
            elif kind == "bucket_edge":
                c[s] = _prefix_ctx(rng, bk, rng.integers(0, pb, n))
                c[edges[q]] = c[max(edges[q] - lags, 0)] = bk
            elif kind == "row_start":
                c[s], pos[s] = shared, 8 + np.arange(n)
            elif kind == "limits":
                p = lo + 10
                pos[s] = [(lo, lo + 1), (lo - 1, lo + 1), (p, p + max_dist),
                          (p, p + max_dist + 1), (p, p), (p + 1, p)][q % 6]
                c[s] = bk
            elif kind == "ties":
                pos[s] = pos[a] + rng.permutation([0, 3, 7, 12, 20])
                cut = pb // 2 + 1
                c[s] = _prefix_ctx(rng, bk, np.full(n, cut))
                c[s, cut] = bk[cut] ^ np.arange(1, n + 1)
            elif kind == "capped":
                c[s] = bk
            elif kind == "byte_diff":
                c[s] = bk
                c[a + 1, q % pb] ^= rng.integers(1, 256)
        pos = np.clip(pos, 0, pmax)
        if kind == "row_start":
            h = hm + 1 + (np.arange(nb) * (hm - 3)) // nb
            h[0] = hm
        else:
            h = 1 + (np.arange(nb) * (hm - 2)) // nb
            h[-1] = hm
        sk[i] = (h[bucket] << pos_bits) | pos
        ctx[i] = c
        if kind == "limits":
            halo[i] = lo
        elif i % 2 == 1 and kind != "row_start":
            halo[i] = int(np.quantile(pos, 0.25))
    pays = ctx.view("<u4").transpose(2, 0, 1).view(np.int32)
    return dict(sk=sk, pays=np.ascontiguousarray(pays), halo_start=halo, pos_bits=pos_bits,
                sites=built)


def _text_bytes(rng, n: int) -> np.ndarray:
    """``n`` bytes of words of a small vocabulary, space-separated."""
    words = b"to be or not that is the question whether tis nobler in mind".split()
    picks = rng.integers(0, len(words), n // 2 + 1)
    return np.frombuffer(b" ".join(words[p] for p in picks)[:n], np.uint8)


def suffix_merge_edge_batch(kinds, n: int, *, lags: int, tile: int,
                            npad: int | None = None, payload_words: int = 7,
                            suffix_keys: int = 5, seed: int = 0) -> dict:
    """One row per entry of ``kinds`` (names from :data:`SUFFIX_KINDS`) of
    ``n`` bytes, content-sorted as the suffix pass sorts it (the plain
    versions of K7, the content sort and K4 at ``payload_words`` and
    ``suffix_keys``) -> numpy ``sp`` and ``adj`` [rows, Np] int32 and
    ``halo_start`` [rows] int32, the suffix merge K8's inputs:

    * ``zeros``: every LCP at 4 x ``payload_words`` and positions
      ascending: ties everywhere, each slot's nearest source 1 back;
    * ``random``: LCPs of a byte or two, so walks end within a few lags;
    * ``period3``: a 3-byte period: long LCPs at distances of multiples of
      3;
    * ``text``: words of a small vocabulary;
    * ``zeros_halo`` and ``text_halo``: as ``zeros`` and ``text``, with
      ``halo_start`` n // 3;
    * ``tile_edge``: a ``text`` row where, at the i-th multiple e of
      ``tile`` (i from 1), the best candidate of slot e (i odd) or of slot
      e - 1 (i even) is exactly ``lags`` away, in the tile before or after:
      the slots between carry the same full LCP at positions past the
      slot's own (distances below 1), the one at ``lags`` the position one
      before it.

    Rows have ``padded_len(n)`` slots, cut to ``npad`` where given (a cut
    row is no permutation of positions; K8 takes any)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((len(kinds), n), np.uint8)
    halo = np.zeros(len(kinds), np.int32)
    for i, kind in enumerate(kinds):
        if kind not in SUFFIX_KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of {SUFFIX_KINDS}")
        if kind == "random":
            data[i] = rng.integers(0, 256, n, dtype=np.uint8)
        elif kind == "period3":
            data[i] = np.resize(rng.integers(0, 256, 3, dtype=np.uint8), n)
        elif kind.startswith("text"):
            data[i] = _text_bytes(rng, n)
        if kind.endswith("_halo"):
            halo[i] = n // 3
    keys, pos = build_suffix_keys_plain(torch.from_numpy(data), payload_words=payload_words)
    order = suffix_order(keys, pos, suffix_keys)
    skeys = torch.gather(keys, 2, order.expand(payload_words, -1, -1))
    adj = lcp_lags_plain(skeys, 1, big_endian=True)[0].numpy().copy()
    sp = torch.gather(pos, 1, order).numpy().copy()
    full, mid = 4 * payload_words, sp.shape[1] // 2
    for i, kind in enumerate(kinds):
        if kind != "tile_edge":
            continue
        for q, e in enumerate(range(tile, sp.shape[1] - lags, tile)):
            if e < lags:
                continue
            me, step = (e, -1) if q % 2 == 0 else (e - 1, 1)
            first = e - lags + 1 if step < 0 else e  # adj's slots on the way
            adj[i, first: first + lags] = full
            at = me + step * np.arange(1, lags + 1)
            sp[i, me], sp[i, at[:-1]], sp[i, at[-1]] = mid, mid + np.arange(1, lags), mid - 1
    cut = slice(None, npad)
    return dict(sp=np.ascontiguousarray(sp[:, cut]), adj=np.ascontiguousarray(adj[:, cut]),
                halo_start=halo)
