// Tile steps shared by the position-order tails K6 (match_tail.cu) and K9
// (match_tail2.cu). Both run one CTA of tail::BLOCK threads per tile of T
// positions of one row, grid (ceil(Np / T), rows); every helper here that
// touches shared memory is called by all threads of the CTA.
//
// Why a tile needs nothing from other CTAs (the window argument):
//   * an extension round at `cap` reads position j + cap; the caps double
//     from payload_bytes to below max_match, so they sum to S < 2 *
//     max_match, and lazy demotion reads j + 1. A tile [t0, t0 + T) thus
//     needs its candidates on [t0, t0 + T + E), E = S + 1; round by round
//     the valid region shrinks by `cap` and ends at [t0, t0 + T + 1);
//   * the distance-1 run at j can reach the row's end, but the tails only
//     compare it with lengths below R = 2 * max_match + 32 and clamp it to
//     max_match: a candidate length is at most 31 (5 bits), a chain adds at
//     most S, so every suffix-field length is at most 31 + S < R. The run
//     is saturated, run'(j) = min(run(j), R), which needs the bytes on
//     [t0 - 1, t0 + T + E + R). A hash-field length built on a saturated
//     run is at least R with or without saturation, so it wins K9's field
//     choice either way and the clamp brings both to the same value: the
//     output is bit-identical to the whole-row walk.
// The window constants come from the caller (ops/lz_cuda.py tail_window);
// the entry points refuse an E or R below these bounds.
//
// Shared memory of one CTA: the fields' planes over the window, each Wp =
// T + E rounded up to 4 ints: `len | capped << 30` and `dist` per field,
// then one more `len | capped` plane per field that the extension rounds
// ping-pong with. The staged bytes live in those last planes until the
// first round writes them.
#pragma once

#include <climits>

#include "common.cuh"

namespace tail {

constexpr int BLOCK = 512;  // threads per CTA
constexpr int LEN_MASK = (1 << 30) - 1;
constexpr int CAPPED_BIT = 1 << 30;

struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// One candidate: its length, distance, and whether the length stopped at
// the carried context (so it may chain further).
struct Cand {
  int len;
  int dist;
  bool capped;
};

// packed = dist | len << 17 | capped << 22
__device__ __forceinline__ Cand unpack(uint32_t p) {
  return {static_cast<int>((p >> 17) & 0x1F), static_cast<int>(p & 0x1FFFF),
          (p >> 22) == 1};
}

__device__ __forceinline__ int len_capped(const Cand& c) {
  return c.len | (c.capped ? CAPPED_BIT : 0);
}

// The sum S of the extension caps payload_bytes, 2x, ... < max_match
// (payload_bytes >= 1).
inline int sum_caps(int payload_bytes, int max_match) {
  int s = 0;
  for (int cap = payload_bytes; cap < max_match; cap *= 2) s += cap;
  return s;
}

// Ints per plane, and bytes of dynamic shared memory, for `fields`
// candidate fields at window (T, E, R).
__host__ __device__ inline int plane_len(int T, int E) { return (T + E + 3) / 4 * 4; }

inline size_t smem_bytes(int fields, int T, int E, int R) {
  const size_t plane = 4 * static_cast<size_t>(plane_len(T, E));
  const size_t staged = (16 + static_cast<size_t>(T) + E + R + 15) / 16 * 16;
  const size_t pong = fields * plane;
  return 2 * fields * plane + (staged > pong ? staged : pong);
}

// Shared checks of the entry points: cudaErrorInvalidValue for a window
// the argument above does not cover or whose planes do not fit in shared
// memory; otherwise raise the kernel's dynamic shared-memory limit to
// `smem`.
template <typename Kernel>
int prepare(Kernel kernel, int fields, int n, int npad, int payload_bytes,
            int max_match, int T, int E, int R, size_t& smem) {
  if (n > npad || payload_bytes < 1 || T <= 0 || T % 1024 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int s = sum_caps(payload_bytes, max_match);
  if (E < s + 1 || R < 32 + s || R <= max_match) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  smem = smem_bytes(fields, T, E, R);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// Bytes of a row of n into dst: dst[i] = row[t0 - 16 + i] for i < count (a
// multiple of 16), 0 outside [0, n). t0 is a multiple of 16, so a 16-byte
// aligned row is read with 16-byte loads.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* row, int n,
                                            int t0, int count) {
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  for (int q = threadIdx.x; q < count / 16; q += BLOCK) {
    const int g = t0 - 16 + 16 * q;
    if (vec && g >= 0 && g + 16 <= n) {
      *reinterpret_cast<uint4*>(dst + 16 * q) = *reinterpret_cast<const uint4*>(row + g);
    } else {
      for (int i = 0; i < 16; ++i) {
        dst[16 * q + i] = (g + i >= 0 && g + i < n) ? row[g + i] : 0;
      }
    }
  }
}

// `count` candidate words from src into dst, with 16-byte loads where src
// is aligned.
__device__ __forceinline__ void stage_words(int* dst, const uint32_t* src, int count) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int quads = vec ? count / 4 : 0;
  for (int q = threadIdx.x; q < quads; q += BLOCK) {
    reinterpret_cast<int4*>(dst)[q] = reinterpret_cast<const int4*>(src)[q];
  }
  for (int i = 4 * quads + threadIdx.x; i < count; i += BLOCK) {
    dst[i] = static_cast<int>(src[i]);
  }
}

// Saturated distance-1 runs of the tile's window: calls visit(p, run) once
// for every p < cand, run = min(first k >= t0 + p with d[k] != d[k-1], npad)
// - (t0 + p), capped at R. `bytes` is stage_bytes' output (position t0 + p
// at bytes[16 + p]) over `span` = min(T + E + R, npad - t0) positions. Each
// thread walks one chunk of the span from its right end; the first break
// right of its chunk comes from one CTA min-scan over the chunks, chunk c
// at thread BLOCK - 1 - c so that the scan runs right to left. `scratch`
// holds BLOCK / 32 ints, `carry` BLOCK.
template <typename Visit>
__device__ __forceinline__ void run_pass(const uint8_t* bytes, int t0, int span, int cand,
                                         int R, int* scratch, int* carry, Visit visit) {
  const int chunk = (span + BLOCK - 1) / BLOCK;
  const int c = BLOCK - 1 - static_cast<int>(threadIdx.x);
  const int lo = min(c * chunk, span);
  const int hi = min(lo + chunk, span);
  // the break index at p (a position whose byte differs from the one
  // before), or INT_MAX
  auto brk = [&](int p) {
    const int m = t0 + p;
    return (m >= 1 && bytes[16 + p] == bytes[15 + p]) ? INT_MAX : m;
  };
  int first = INT_MAX;  // the chunk's leftmost break is its least
  for (int p = lo; p < hi && first == INT_MAX; ++p) first = brk(p);
  int total;
  carry[threadIdx.x] = block_inclusive_scan<BLOCK>(first, MinOp(), scratch, total);
  __syncthreads();
  int next = threadIdx.x > 0 ? carry[threadIdx.x - 1] : INT_MAX;
  next = min(next, t0 + span);
  for (int p = hi - 1; p >= lo; --p) {
    next = min(next, brk(p));
    if (p < cand) visit(p, min(next - (t0 + p), R));
  }
}

// The run at j (counted only where j - 1 >= lo) replaces the candidate when
// longer, or equally long with dist > 1.
__device__ __forceinline__ void merge_run(Cand& c, int run, int j, int lo) {
  const int l3 = (j - 1 >= lo) ? run : 0;
  if (l3 > c.len || (l3 == c.len && c.dist > 1)) {
    c = {l3, 1, false};
  }
}

// One extension round at `cap` for window position p (`limit` = npad - t0):
// a capped match whose distance recurs at p + cap chains to cap + len[p +
// cap] and takes that position's capped flag; a capped match that does not
// chain stops.
__device__ __forceinline__ int extend_step(const int* src, const int* dist, int p,
                                           int limit, int cap) {
  const int a = src[p];
  if (!(a & CAPPED_BIT)) return a;
  const int k = p + cap;
  if (k < limit && dist[k] == dist[p]) {
    const int an = src[k];
    return (cap + (an & LEN_MASK)) | (an & CAPPED_BIT);
  }
  return a & LEN_MASK;
}

// Clamp to the block end and max_match, drop lengths below min_emit and
// length 3 beyond distance 4096, keep only positions in [base, end).
__device__ __forceinline__ int clamp_len(int len, int dist, int j, int base, int end,
                                         int max_match, int min_emit) {
  const int limit = end - j < max_match ? end - j : max_match;
  len = len < limit ? len : limit;
  if (len < min_emit) len = 0;
  if (len == 3 && dist > 4096) len = 0;
  if (j < base || j >= end) len = 0;
  return len;
}

// Lazy demotion (a match shorter than 32 yields to a longer one at the next
// position) and the tile's outputs on [t0, min(t0 + T, n)). `len` (clamped)
// and `dist` must hold window positions [0, min(T + 1, limit)).
__device__ __forceinline__ void write_tile(const int* len, const int* dist, int t0, int T,
                                           int n, int limit, int lazy, int32_t* lrow,
                                           int32_t* drow) {
  const int hi = min(T, n - t0);
  for (int p = threadIdx.x; p < hi; p += BLOCK) {
    int l = len[p];
    if (lazy) {
      const int next = p + 1 < limit ? len[p + 1] : 0;
      if (l > 0 && l < 32 && next > l) l = 0;
    }
    lrow[t0 + p] = l;
    drow[t0 + p] = dist[p];
  }
}

}  // namespace tail
