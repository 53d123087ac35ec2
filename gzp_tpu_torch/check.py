"""Checksum subsystem: per-block checksums + whole-stream combine.

This is the equivalent of the reference's check layer (reference
src/check.rs:16-198): a :class:`Check` interface with ``update``,
``combine``, ``sum`` and ``amount``, implemented for CRC32 (gzip/mgzip/bgzf),
Adler32 (zlib), CRC32C (snappy frame CRCs) and a pass-through.

``combine`` is the pigz "COMB" trick: given checksums of two adjacent
byte ranges, produce the checksum of their concatenation without
rescanning — this is what lets block-parallel compression emit a
whole-stream checksum. A CRC combine applies the operator "advance the
register past len(B) zero bytes", which depends on the length alone: as in
zlib's ``crc32_combine_gen``/``crc32_combine_op``, it is x^(8·len) mod P,
composed from a table of x^(8·2^k) mod P and kept in a small cache per
length as four byte tables, so a stream of equal blocks builds it once and
then pays four lookups a block (``combine_stats`` counts both). Adler
combine is modular arithmetic.

Host-side ``update`` uses ``zlib.crc32``/``zlib.adler32`` (these are
checks, not codecs — the reference likewise delegates to flate2/zlib-ng,
reference src/check.rs:132-164) and, for CRC32C, which the stdlib does not
provide, a numpy table CRC run over many lanes at once. Device-side
batched checksums live in ``gzp_tpu_torch.ops.checksum``.
"""

from __future__ import annotations

import functools
import threading
import zlib

import numpy as np

__all__ = [
    "Check",
    "Crc32",
    "Adler32",
    "Crc32C",
    "PassThroughCheck",
    "crc32_combine",
    "combine_stats",
    "reset_combine_stats",
    "adler32_combine",
    "crc32c",
    "crc32c_combine",
    "snappy_mask_crc",
    "CRC32_POLY",
    "CRC32C_POLY",
    "crc_table",
    "crc_operator_tables",
    "apply_operator_tables",
]

U32 = 0xFFFFFFFF

# Reflected polynomials.
CRC32_POLY = 0xEDB88320
CRC32C_POLY = 0x82F63B78

ADLER_MOD = 65521


# ---------------------------------------------------------------------------
# GF(2) linear-operator machinery for CRC shifts.
#
# Processing input bits through a (reflected) CRC register is linear over
# GF(2) in the register state. The operator "advance the register past one
# zero bit" is a 32x32 bit-matrix; advancing past N zero bytes is that
# matrix to the 8N-th power. crc(A || B) is then op_{len(B)}(crc(A)) XOR
# crc(B), where crc() here is the raw register with standard
# pre/post-conditioning folded in (the conditioning terms cancel exactly as
# in zlib's crc32_combine). The matrices build the inverse shift for the
# device-side tables (ops/tables.py); forward shifts are built in
# polynomial form, below.
# ---------------------------------------------------------------------------


def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    """Apply a 32x32 GF(2) matrix (list of 32 column images) to a vector."""
    out = 0
    idx = 0
    while vec:
        if vec & 1:
            out ^= mat[idx]
        vec >>= 1
        idx += 1
    return out


def _gf2_matrix_square(mat: list[int]) -> list[int]:
    return [_gf2_matrix_times(mat, mat[n]) for n in range(32)]


def _zero_bit_operator(poly: int) -> list[int]:
    """Matrix advancing a reflected CRC register past a single zero bit.

    Register update for a zero input bit: r -> (r >> 1) ^ (poly if r & 1).
    Column images: e_0 -> poly, e_n -> e_{n-1}.
    """
    mat = [0] * 32
    mat[0] = poly
    row = 1
    for n in range(1, 32):
        mat[n] = row
        row <<= 1
    return mat


# ---------------------------------------------------------------------------
# The shift operator, as zlib builds it (crc32_combine_gen).
#
# In a reflected register bit 31 holds x^0 and bit 0 holds x^31, so a
# register is a polynomial of degree < 32 and advancing it past n zero bytes
# multiplies it by x^(8n) mod P, composed from a table of x^(8·2^k) mod P
# with one product a set bit of n. The product is linear in the register:
# its images of the 32 register bits are the operator's matrix, which
# ``crc_operator_tables`` turns into four byte tables. The combine keeps
# those tables per length in a small cache, so a stream of equal blocks
# builds them once and then pays four lookups a block.
# ---------------------------------------------------------------------------

combine_stats = {"combined": 0, "operators_built": 0}
_stats_lock = threading.Lock()  # writers on several threads share the counts


def _multmodp(a: int, b: int, poly: int) -> int:
    """a·b mod P for reflected polynomials (zlib's multmodp)."""
    m = 1 << 31
    p = 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ poly if b & 1 else b >> 1


@functools.cache
def _x8_pow2(k: int, poly: int) -> int:
    """x^(8·2^k) mod P: the operator for 2^k zero bytes."""
    if k == 0:
        return 1 << 23  # x^8
    half = _x8_pow2(k - 1, poly)
    return _multmodp(half, half, poly)


def _shift_columns(nbytes: int, poly: int) -> list[int]:
    """Column images of the operator advancing a register past ``nbytes``
    zero bytes; exact for any length, 2^32 and beyond."""
    op = 1 << 31  # x^0
    k = 0
    while nbytes:
        if nbytes & 1:
            op = _multmodp(_x8_pow2(k, poly), op, poly)
        nbytes >>= 1
        k += 1
    # bit 31 (x^0) maps to op, and each lower bit to the one above it times x
    cols = [0] * 32
    for j in range(31, -1, -1):
        cols[j] = op
        op = (op >> 1) ^ poly if op & 1 else op >> 1
    return cols


@functools.lru_cache(maxsize=64)
def _shift_tables(len2: int, poly: int) -> list[list[int]]:
    """The combine's operator for ``len2`` zero bytes, as four byte tables
    of Python ints (faster to index than numpy's)."""
    with _stats_lock:
        combine_stats["operators_built"] += 1
    return crc_operator_tables(len2, poly).tolist()


def reset_combine_stats() -> None:
    """Zero ``combine_stats``; the cached operators stay."""
    with _stats_lock:
        combine_stats.update(combined=0, operators_built=0)


def _crc_combine(crc1: int, crc2: int, len2: int, poly: int) -> int:
    """Combine CRCs of adjacent ranges: crc(A||B) from crc(A), crc(B), len(B)."""
    with _stats_lock:
        combine_stats["combined"] += 1
    crc1 &= U32
    if len2 == 0:
        return crc1
    t0, t1, t2, t3 = _shift_tables(len2, poly)
    return (t0[crc1 & 0xFF] ^ t1[(crc1 >> 8) & 0xFF] ^ t2[(crc1 >> 16) & 0xFF]
            ^ t3[crc1 >> 24] ^ crc2) & U32


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """pigz/zlib-style CRC32 combine (reference src/check.rs:161-163)."""
    return _crc_combine(crc1, crc2, len2, CRC32_POLY)


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    return _crc_combine(crc1, crc2, len2, CRC32C_POLY)


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler32 combine (reference src/check.rs:117-128 via zlib-ng FFI).

    Appending B (len2 bytes, adler (a2, b2)) after A (adler (a1, b1)):
      a = a1 + a2 - 1           (mod 65521)
      b = b1 + b2 + len2*(a1-1) (mod 65521)
    """
    rem = len2 % ADLER_MOD
    a1 = adler1 & 0xFFFF
    b1 = (adler1 >> 16) & 0xFFFF
    a2 = adler2 & 0xFFFF
    b2 = (adler2 >> 16) & 0xFFFF
    a = (a1 + a2 - 1) % ADLER_MOD
    b = (b1 + b2 + rem * (a1 - 1)) % ADLER_MOD  # Python % is non-negative
    return ((b << 16) | a) & U32


# ---------------------------------------------------------------------------
# Byte-at-a-time CRC table — the base for building device-side operator
# tables.
# ---------------------------------------------------------------------------

_TABLE_CACHE: dict[int, np.ndarray] = {}


def crc_table(poly: int) -> np.ndarray:
    """256-entry byte-at-a-time table for a reflected CRC polynomial."""
    tab = _TABLE_CACHE.get(poly)
    if tab is not None:
        return tab
    entries = np.arange(256, dtype=np.uint32)
    crc = entries.copy()
    for _ in range(8):
        low = crc & 1
        crc = crc >> 1
        crc = np.where(low.astype(bool), crc ^ np.uint32(poly), crc)
    _TABLE_CACHE[poly] = crc
    return crc


def _crc_update_raw(state: int, data: bytes | np.ndarray, poly: int) -> int:
    """Advance a raw (unconditioned) CRC register over data bytes."""
    tab = crc_table(poly)
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = np.uint32(state)
    for b in arr:
        crc = (crc >> np.uint32(8)) ^ tab[(crc ^ b) & np.uint32(0xFF)]
    return int(crc)


_CRC_LANE = 256  # bytes per lane of the lane-parallel CRC32C


@functools.lru_cache(maxsize=None)
def _lane_operator() -> np.ndarray:
    """O_256 for CRC32C: advances a register past one lane of zero bytes."""
    return crc_operator_tables(_CRC_LANE, CRC32C_POLY)


def crc32c(data: bytes, value: int = 0) -> int:
    """CRC-32C (Castagnoli), matching the snappy framing checksum.

    The same value as a byte-at-a-time table CRC, computed faster: the
    first ``len % 256`` bytes run byte by byte from ``value``; the rest
    runs as 256-byte lanes side by side (each lane's CRC from 0), folded
    in order by the combine rule crc(A || B) = O_256(crc(A)) ^ crc(B)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    head = len(arr) % _CRC_LANE
    state = _crc_update_raw((value ^ U32) & U32, arr[:head], CRC32C_POLY)
    crc = (state ^ U32) & U32
    lanes = arr[head:].reshape(-1, _CRC_LANE)
    if not len(lanes):
        return crc
    tab = crc_table(CRC32C_POLY)
    reg = np.full(len(lanes), U32, dtype=np.uint32)
    for q in range(_CRC_LANE):
        reg = (reg >> np.uint32(8)) ^ tab[(reg ^ lanes[:, q]) & np.uint32(0xFF)]
    op = _lane_operator()
    for lane_crc in (reg ^ np.uint32(U32)).tolist():
        crc = int(op[0][crc & 0xFF] ^ op[1][(crc >> 8) & 0xFF] ^ op[2][(crc >> 16) & 0xFF]
                  ^ op[3][crc >> 24]) ^ lane_crc
    return crc


def snappy_mask_crc(crc: int) -> int:
    """Snappy frame format masks its CRCs: rotate right 15, add constant."""
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & U32


# ---------------------------------------------------------------------------
# Precomputed shift-operator tables for device-side CRC folding.
#
# The operator O_L (advance register past L zero bytes) is linear; we
# materialize it as four 256-entry uint32 tables (one per register byte) so
# that applying it is four gathers + XOR:  O_L(r) = T0[r&255] ^ T1[(r>>8)&255]
# ^ T2[(r>>16)&255] ^ T3[r>>24].  These feed the log-tree combine of
# per-segment CRCs inside the batched device checksum kernel.
# ---------------------------------------------------------------------------


def gf2_matrix_invert(mat: list[int]) -> list[int]:
    """Invert a 32x32 GF(2) matrix given as 32 column images.

    The one-zero-byte CRC shift operator is invertible (multiplication by
    x^8 mod an odd polynomial), which lets us *remove* trailing zero bytes
    from a raw CRC register — the trick behind exact-length device CRCs of
    zero-padded blocks.
    """
    n = 32
    # rows of [M | I] as 64-bit ints: low 32 bits = M column space transposed?
    # Work column-wise: solve M X = I by Gaussian elimination on columns.
    # Represent M as list of columns; build augmented columns of (M, I).
    m = list(mat)
    inv = [1 << i for i in range(n)]
    # Forward elimination to reduced form.
    for bit in range(n):
        pivot = None
        for c in range(bit, n):
            if (m[c] >> bit) & 1:
                pivot = c
                break
        assert pivot is not None, "matrix not invertible"
        m[bit], m[pivot] = m[pivot], m[bit]
        inv[bit], inv[pivot] = inv[pivot], inv[bit]
        for c in range(n):
            if c != bit and ((m[c] >> bit) & 1):
                m[c] ^= m[bit]
                inv[c] ^= inv[bit]
    # Now m is a permutation-free identity: m[c] == 1<<c, and inv holds M^-1
    # columns: M @ inv_col_c = e_c, i.e. inv is the matrix of M^{-1}.
    return inv


def _columns_to_tables(cols: list[int]) -> np.ndarray:
    """32x32 GF(2) matrix (column images) -> [4, 256] uint32 byte tables."""
    tables = np.zeros((4, 256), dtype=np.uint32)
    idx = np.arange(256)
    for byte_idx in range(4):
        for bit in range(8):
            mask = ((idx >> bit) & 1).astype(bool)
            tables[byte_idx, mask] ^= np.uint32(cols[byte_idx * 8 + bit])
    return tables


def crc_operator_tables(nbytes: int, poly: int) -> np.ndarray:
    """Materialize O_{nbytes} as a [4, 256] uint32 lookup-table array."""
    return _columns_to_tables(_shift_columns(nbytes, poly))


def apply_operator_tables(tables: np.ndarray, crc: np.ndarray) -> np.ndarray:
    """Apply a [4,256] operator-table set to an array of uint32 registers."""
    crc = crc.astype(np.uint32)
    return (
        tables[0][crc & 0xFF]
        ^ tables[1][(crc >> 8) & 0xFF]
        ^ tables[2][(crc >> 16) & 0xFF]
        ^ tables[3][(crc >> 24) & 0xFF]
    )


# ---------------------------------------------------------------------------
# Check classes (reference src/check.rs Check trait).
# ---------------------------------------------------------------------------


class Check:
    """Streaming checksum with range combine (reference src/check.rs:16-35)."""

    name = "check"

    def sum(self) -> int:
        raise NotImplementedError

    def amount(self) -> int:
        """Bytes folded in so far (u32, wraps like the reference)."""
        raise NotImplementedError

    def update(self, data: bytes) -> None:
        raise NotImplementedError

    def combine(self, other: "Check") -> None:
        """Fold ``other`` (checksum of the bytes following ours) into self."""
        self.combine_sum(other.sum(), other.amount())

    def combine_sum(self, value: int, length: int) -> None:
        """Fold the check ``value`` of the ``length`` bytes following ours
        into self. ``length`` is taken as given, not modulo 2^32, so a
        range of 4 GiB or more folds right; ``amount()`` still wraps."""
        raise NotImplementedError

    @classmethod
    def from_sum(cls, value: int, amount: int) -> "Check":
        """Build a check directly from a known (sum, amount) — used when the
        per-block sums were computed on device."""
        obj = cls()
        obj._sum = value  # type: ignore[attr-defined]
        obj._amount = amount & U32  # type: ignore[attr-defined]
        return obj


class Crc32(Check):
    """CRC32 with combine (reference src/check.rs:132-164)."""

    name = "crc32"

    def __init__(self) -> None:
        self._sum = 0
        self._amount = 0

    def sum(self) -> int:
        return self._sum & U32

    def amount(self) -> int:
        return self._amount & U32

    def update(self, data: bytes) -> None:
        self._sum = zlib.crc32(data, self._sum) & U32
        self._amount = (self._amount + len(data)) & U32

    def combine_sum(self, value: int, length: int) -> None:
        self._sum = crc32_combine(self._sum, value, length)
        self._amount = (self._amount + length) & U32


class Adler32(Check):
    """Adler32 with combine (reference src/check.rs:85-129)."""

    name = "adler32"

    def __init__(self) -> None:
        self._sum = 1
        self._amount = 0

    def sum(self) -> int:
        return self._sum & U32

    def amount(self) -> int:
        return self._amount & U32

    def update(self, data: bytes) -> None:
        self._sum = zlib.adler32(data, self._sum) & U32
        self._amount = (self._amount + len(data)) & U32

    def combine_sum(self, value: int, length: int) -> None:
        self._sum = adler32_combine(self._sum, value, length)
        self._amount = (self._amount + length) & U32

    @classmethod
    def from_sum(cls, value: int, amount: int) -> "Adler32":
        obj = cls()
        obj._sum = value
        obj._amount = amount & U32
        return obj


class Crc32C(Check):
    """CRC-32C (snappy frame checksums). Not present in the reference's check
    layer (the snap crate computes it internally); surfaced here because the
    snappy frame assembly is explicit."""

    name = "crc32c"

    def __init__(self) -> None:
        self._sum = 0
        self._amount = 0

    def sum(self) -> int:
        return self._sum & U32

    def amount(self) -> int:
        return self._amount & U32

    def update(self, data: bytes) -> None:
        self._sum = crc32c(data, self._sum)
        self._amount = (self._amount + len(data)) & U32

    def combine_sum(self, value: int, length: int) -> None:
        self._sum = crc32c_combine(self._sum, value, length)
        self._amount = (self._amount + length) & U32


class PassThroughCheck(Check):
    """No-op check for formats with per-block or no checksums
    (reference src/check.rs:166-198)."""

    name = "passthrough"

    def __init__(self) -> None:
        self._amount = 0

    def sum(self) -> int:
        return 0

    def amount(self) -> int:
        return self._amount & U32

    def update(self, data: bytes) -> None:
        self._amount = (self._amount + len(data)) & U32

    def combine_sum(self, value: int, length: int) -> None:
        self._amount = (self._amount + length) & U32

    @classmethod
    def from_sum(cls, value: int, amount: int) -> "PassThroughCheck":
        obj = cls()
        obj._amount = amount & U32
        return obj
