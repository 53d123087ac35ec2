// K10: pre-placement pass of the sort-scan DEFLATE bit packer.
//
// Replaces the Pallas kernel `_kernel` (gzp_tpu/ops/pack_pallas.py:65,
// wrapper `pack_prescan_pallas` :171). Entries are (value < 2^31, width
// 0..31) pairs; entry E (one past the last) is a zero-width tail entry and
// entries past it are padding up to Ep. Per row:
//   bitpos[i] = base_bits + sum(width[0..i)); w = bitpos >> 5
//   lo = value << (bitpos & 31); hi = the bits of the value past the word
//   flush[i] = entry i completes word w; start[i] = flush[i-1] or i == 0
//   val[i] = OR of (lo | (start ? hi[i-1] : 0)) since the last start
//   key[i] = w where flush (and at the tail entry when its word is partial),
//            else 0xFFFFFFFF
// plus total_bits = base_bits + sum(width). The caller places val[i] at
// word key[i].
//
// Bound on the card: memory. It reads 8 bytes per entry and writes 8 bytes
// per padded entry.
//
// Design: a single-pass scan with decoupled look-back (Merrill and
// Garland). Each CTA of BLOCK = 512 threads takes one tile of T = BLOCK *
// ITEMS = 4096 consecutive entries of a row (ITEMS = 8 per thread, read
// with 16-byte loads), so a row of Ep entries is ceil(Ep / T) tiles and the
// grid is rows x that. (T = 1024 and 2048 ran within 8% of it on an H100
// 80GB HBM3 at 700 W.)
// A tile carries two prefixes from the tiles before it:
//   1. the width sum: the tile publishes its aggregate, looks back for its
//      exclusive prefix, then publishes the inclusive one;
//   2. the segmented-OR state (value, reset) under SegOrOp: the entries'
//      `c` values need the bit phase (bitpos & 31), so the tile computes
//      them, and its OR aggregate, only once its width prefix is known; the
//      previous entry's flush and hi across the tile edge are recomputed
//      from entry t0 - 1 and that prefix. The OR look-back stops at an
//      inclusive prefix or at an aggregate that holds a segment start. A
//      run of zero-width entries longer than T holds no start, so the look-
//      back may walk past several tiles; on real rows (flushes a few
//      hundred entries apart) it stops at the tile just before.
// Warp 0 looks back over 32 predecessors at a time. Each status word is
// flag << 62 | payload (33 bits: the value, and the reset bit at 32), so
// one 64-bit store publishes it. Tiles take their index from an atomic
// counter, not from blockIdx: a tile waits only on tiles that started
// before it, so the look-back cannot deadlock however many CTAs are
// resident. The status words and the counter live in a scratch buffer that
// the wrapper allocates and the entry point zeroes (one memset per call).
// The keys need only the width prefix, so they are stored before the OR
// look-back.
//
// What holds it back (tools/probe_lookback.py on an H100 80GB HBM3 at
// 700 W): a CTA spends 44% of its cycles in the two look-backs, mostly
// polling for a predecessor that has not published yet, and 3 CTAs per SM
// keep too few loads in flight to cover that. Persistent CTAs that claim the next tile
// and stage it with cp.async during the look-backs were slower: a claimed
// tile publishes only after its CTA's current one, which lengthens every
// look-back chain.
//
// PACK_PROBE(i) marks the end of phase i and PACK_PROBE_POLLS(polls) the
// end of the tile; both are empty here. tools/probe_lookback.cu defines
// them before it includes this file, to stamp each phase's clock and count
// the look-backs' polls.
#include "common.cuh"

#ifndef PACK_PROBE
#define PACK_PROBE(i)
#define PACK_PROBE_POLLS(polls)
#endif

namespace {

constexpr int BLOCK = 512;
constexpr int ITEMS = 8;
constexpr int T = BLOCK * ITEMS;
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;
constexpr u64 AGGREGATE = 1ull << 62;
constexpr u64 INCLUSIVE = 2ull << 62;
constexpr u64 RESET = 1ull << 32;
constexpr u64 PAYLOAD = (1ull << 33) - 1;

struct AddOp {
  __device__ u64 operator()(u64 a, u64 b) const { return a + b; }
};

// (value, reset) packed as value | reset << 32; op(a, b) with a earlier:
// b's value if b holds a segment start, else a's value OR b's. 0 is the
// identity.
struct SegOrOp {
  __device__ u64 operator()(u64 a, u64 b) const {
    const u64 reset = (a | b) & RESET;
    const uint32_t v = (b & RESET) ? static_cast<uint32_t>(b)
                                   : static_cast<uint32_t>(a) | static_cast<uint32_t>(b);
    return reset | v;
  }
};

struct IsInclusive {
  __device__ bool operator()(u64 s) const { return (s >> 62) == 2; }
};

// An OR prefix ends at an inclusive prefix or at an aggregate that starts
// a segment: nothing before it changes the state after it.
struct EndsOrPrefix {
  __device__ bool operator()(u64 s) const { return (s >> 62) == 2 || (s & RESET) != 0; }
};

__device__ __forceinline__ u64 load_status(const u64* p) {
  return *reinterpret_cast<const volatile u64*>(p);
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  *reinterpret_cast<volatile u64*>(p) = v;
}

// Exclusive scan over the CTA in threadIdx order, identity 0; `total`
// receives the CTA's aggregate. Every thread must call it.
template <int WARPS, typename Op>
__device__ __forceinline__ u64 cta_exclusive_scan(u64 x, Op op, u64* warp_sums, u64& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const u64 incl = warp_inclusive_scan(x, op);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const u64 s = warp_inclusive_scan(lane < WARPS ? warp_sums[lane] : 0ull, op);
    if (lane < WARPS) warp_sums[lane] = s;
  }
  __syncthreads();
  u64 ex = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) ex = 0;
  if (warp > 0) ex = op(warp_sums[warp - 1], ex);
  total = warp_sums[WARPS - 1];
  return ex;
}

// The fold of tiles [0, tile) of one row from their status words; called
// by the 32 lanes of warp 0. Lane l reads tile end - 32 + l; a window with
// a terminal status folds from the last terminal lane and ends the walk,
// else it folds whole and the walk moves 32 tiles back. Tiles before the
// row start read as an inclusive identity.
template <typename Op, typename Terminal>
__device__ u64 look_back(const u64* status, int tile, Op op, Terminal terminal,
                         unsigned& polls) {
  const int lane = threadIdx.x & 31;
  u64 prefix = 0;
  for (int end = tile;; end -= 32) {
    const int p = end - 32 + lane;
    u64 s = p < 0 ? INCLUSIVE : load_status(status + p);
    while (__any_sync(FULL, (s >> 62) == 0)) {
      if ((s >> 62) == 0) s = load_status(status + p);
      ++polls;
    }
    const unsigned term = __ballot_sync(FULL, terminal(s));
    const int first = term ? 31 - __clz(static_cast<int>(term)) : 0;
    u64 x = lane >= first ? (s & PAYLOAD) : 0ull;
    x = warp_inclusive_scan(x, op);
    prefix = op(__shfl_sync(FULL, x, 31), prefix);
    if (term) return prefix;
    ++polls;
  }
}

// Publish this tile's aggregate, look back, publish its inclusive prefix;
// returns the exclusive prefix. Warp 0 only.
template <typename Op, typename Terminal>
__device__ u64 scan_tile(u64* status, int tile, u64 aggregate, Op op, Terminal terminal,
                         unsigned& polls) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_status(status, INCLUSIVE | aggregate);
    return 0;
  }
  if (lane == 0) store_status(status + tile, AGGREGATE | aggregate);
  const u64 prefix = look_back(status, tile, op, terminal, polls);
  if (lane == 0) store_status(status + tile, INCLUSIVE | op(prefix, aggregate));
  return prefix;
}

// 3 CTAs of 512 threads per SM at 40 registers (2 at the 54 the compiler
// picks unbounded, which ran 10% slower on an H100 80GB HBM3 at 700 W)
__global__ void __launch_bounds__(BLOCK, 3)
pack_prescan_kernel(const uint32_t* __restrict__ bits, const int32_t* __restrict__ nbits,
                    uint32_t* __restrict__ key, uint32_t* __restrict__ val,
                    int32_t* __restrict__ total_bits, u64* __restrict__ status,
                    unsigned* __restrict__ counter, int e, int ep, int tiles, int base_bits) {
  constexpr int WARPS = BLOCK / 32;
  __shared__ u64 width_sums[WARPS];
  __shared__ u64 or_sums[WARPS];
  __shared__ uint32_t edge_flush[WARPS + 1];  // [w]: last entry before warp w
  __shared__ uint32_t edge_hi[WARPS + 1];
  __shared__ int tile_index;
  __shared__ u64 width_prefix;
  __shared__ u64 or_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned polls[2] = {0, 0};  // read by PACK_PROBE_POLLS only

  if (threadIdx.x == 0) tile_index = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  PACK_PROBE(0);
  const int b = tile_index / tiles;
  const int tile = tile_index - b * tiles;
  const int t0 = tile * T;
  const int i0 = t0 + threadIdx.x * ITEMS;
  const uint32_t* vrow = bits + static_cast<int64_t>(b) * e;
  const int32_t* nrow = nbits + static_cast<int64_t>(b) * e;
  u64* width_status = status + static_cast<int64_t>(b) * tiles;
  u64* or_status = status + static_cast<int64_t>(gridDim.x) + static_cast<int64_t>(b) * tiles;

  // ---- entries i0 .. i0 + ITEMS - 1 (zero at and past e)
  uint32_t v[ITEMS];
  int nb[ITEMS];
  const bool vec = i0 + ITEMS <= e && (reinterpret_cast<uintptr_t>(vrow + i0) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(nrow + i0) & 15) == 0;
  // entry t0 - 1 across the tile edge, for thread 0 (zero before the row
  // and at or past e)
  uint32_t edge_v = 0;
  int edge_n = 0;
  if (threadIdx.x == 0 && t0 > 0 && t0 - 1 < e) {
    edge_v = vrow[t0 - 1];
    edge_n = nrow[t0 - 1];
  }
  if (vec) {
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(vrow + i0) + q);
      const int4 c = __ldg(reinterpret_cast<const int4*>(nrow + i0) + q);
      v[4 * q] = a.x, v[4 * q + 1] = a.y, v[4 * q + 2] = a.z, v[4 * q + 3] = a.w;
      nb[4 * q] = c.x, nb[4 * q + 1] = c.y, nb[4 * q + 2] = c.z, nb[4 * q + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j;
      v[j] = i < e ? vrow[i] : 0u;
      nb[j] = i < e ? nrow[i] : 0;
    }
  }

  // ---- 1. width prefix
  int width = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) width += nb[j];
  u64 tile_width;
  const int width_before = static_cast<int>(
      cta_exclusive_scan<WARPS>(static_cast<u64>(width), AddOp(), width_sums, tile_width));
  PACK_PROBE(1);
  if (warp == 0) {
    const u64 prefix =
        scan_tile(width_status, tile, tile_width, AddOp(), IsInclusive(), polls[0]);
    if (lane == 0) {
      width_prefix = prefix;
      // entry t0 - 1: its flush and its hi
      uint32_t pf = 1, ph = 0;
      if (t0 > 0) {
        const int bp = base_bits + static_cast<int>(prefix) - edge_n;
        const uint32_t cnt = static_cast<uint32_t>(bp) & 31u;
        pf = static_cast<uint32_t>((bp + edge_n) >> 5) > static_cast<uint32_t>(bp >> 5);
        ph = (edge_v >> (31u - cnt)) >> 1;
      }
      edge_flush[0] = pf;
      edge_hi[0] = ph;
    }
  }
  __syncthreads();
  PACK_PROBE(2);

  // ---- 2. bit phases, flushes, and each entry's c (in v)
  const int row_before = static_cast<int>(width_prefix);
  int bitpos[ITEMS];
  unsigned flush = 0;  // bit j: entry j completes its word
  uint32_t hi_last = 0;
  {
    int bp = base_bits + row_before + width_before;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const uint32_t cnt = static_cast<uint32_t>(bp) & 31u;
      bitpos[j] = bp;
      const uint32_t hi = (v[j] >> (31u - cnt)) >> 1;
      v[j] <<= cnt;  // lo; entry 0's hi_prev comes from the thread before
      if (j > 0 && ((flush >> (j - 1)) & 1u)) v[j] |= hi_last;
      if (static_cast<uint32_t>((bp + nb[j]) >> 5) > static_cast<uint32_t>(bp >> 5)) {
        flush |= 1u << j;
      }
      hi_last = hi;
      bp += nb[j];
    }
  }
  const uint32_t last_flush = (flush >> (ITEMS - 1)) & 1u;
  uint32_t prev_flush = __shfl_up_sync(FULL, last_flush, 1);
  uint32_t prev_hi = __shfl_up_sync(FULL, hi_last, 1);
  if (lane == 31) {
    edge_flush[warp + 1] = last_flush;
    edge_hi[warp + 1] = hi_last;
  }
  __syncthreads();
  if (lane == 0) {
    prev_flush = edge_flush[warp];
    prev_hi = edge_hi[warp];
  }
  if (prev_flush) v[0] |= prev_hi;
  const unsigned start = (flush << 1) | prev_flush;  // bit j: entry j starts a segment
  u64 agg = 0;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    agg = SegOrOp()(agg, static_cast<u64>(v[j]) | (((start >> j) & 1u) ? RESET : 0ull));
  }

  // ---- 3. keys: they need only the width prefix, so they are stored
  // before the OR look-back (whose wait hides behind them)
  const bool in_row = i0 < ep;  // ep is a multiple of 1024: all ITEMS are in the row
  if (in_row) {
    uint4* krow = reinterpret_cast<uint4*>(key + static_cast<int64_t>(b) * ep + i0);
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      uint32_t k[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * q + r;
        const int i = i0 + j;
        const uint32_t w = static_cast<uint32_t>(bitpos[j] >> 5);
        k[r] = ((flush >> j) & 1u) ? w : 0xFFFFFFFFu;
        if (i == e) k[r] = (bitpos[j] & 31) ? w : 0xFFFFFFFFu;  // partial tail word
        if (i > e) k[r] = 0xFFFFFFFFu;
      }
      krow[q] = make_uint4(k[0], k[1], k[2], k[3]);
    }
  }

  // ---- 4. segmented-OR prefix
  u64 tile_or;
  const u64 or_before = cta_exclusive_scan<WARPS>(agg, SegOrOp(), or_sums, tile_or);
  PACK_PROBE(3);
  if (warp == 0) {
    const u64 prefix = scan_tile(or_status, tile, tile_or, SegOrOp(), EndsOrPrefix(), polls[1]);
    if (lane == 0) or_prefix = prefix;
  }
  __syncthreads();
  PACK_PROBE(4);

  // ---- 5. values
  if (in_row) {
    u64 state = SegOrOp()(or_prefix, or_before);
    uint4* orow = reinterpret_cast<uint4*>(val + static_cast<int64_t>(b) * ep + i0);
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      uint32_t out[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * q + r;
        state = SegOrOp()(state, static_cast<u64>(v[j]) | (((start >> j) & 1u) ? RESET : 0ull));
        out[r] = static_cast<uint32_t>(state);
      }
      orow[q] = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
  if (tile == tiles - 1 && threadIdx.x == 0) {
    total_bits[b] = base_bits + row_before + static_cast<int>(tile_width);
  }
  PACK_PROBE(5);
  PACK_PROBE_POLLS(polls);
}

}  // namespace

// bits [rows, e] u32; nbits [rows, e] i32 -> key, val [rows, ep] u32,
// total_bits [rows] i32. `scratch` holds 2 * rows * ceil(ep / 4096) + 1
// u64 words (16-byte aligned, like key and val), zeroed here.
GZP_EXPORT int gzp_pack_prescan(const void* bits, const void* nbits, void* key, void* val,
                                void* total_bits, void* scratch, int rows, int e, int ep,
                                int base_bits, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(key) | reinterpret_cast<uintptr_t>(val) |
                         reinterpret_cast<uintptr_t>(scratch)) & 15) == 0;
  if (ep <= e || ep % 1024 != 0 || !aligned) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (ep + T - 1) / T;
  const size_t words = 2 * static_cast<size_t>(rows) * tiles + 1;
  cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(u64), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  u64* status = static_cast<u64*>(scratch);
  pack_prescan_kernel<<<rows * tiles, BLOCK, 0, s>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(nbits),
      static_cast<uint32_t*>(key), static_cast<uint32_t*>(val),
      static_cast<int32_t*>(total_bits), status,
      reinterpret_cast<unsigned*>(status + words - 1), e, ep, tiles, base_bits);
  return static_cast<int>(cudaGetLastError());
}
