// Row walks shared by the position-order tails K6 (match_tail.cu) and K9
// (match_tail2.cu). Both run one CTA of SCAN_BLOCK threads per row; every
// helper here is called by all threads of the CTA.
//
// A candidate field is kept in device memory as two planes: `len | capped
// << 30` and `dist`. Extension rounds ping-pong the first plane between two
// buffers.
#pragma once

#include <climits>

#include "common.cuh"

namespace tail {

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

// Distance-1 runs: calls visit(j, run) once for every position j < npad,
// run = (first k >= j with d[k] != d[k-1]) - j, bytes at or past n read as
// 0. Tiles from the row's end, thread t at position ts + SCAN_BLOCK-1 - t,
// so the CTA min-scan of the next non-repeat index runs right to left; its
// minimum carries across tiles, which keeps the walk linear in the row
// (a thread counting forward would be quadratic on a long run).
template <typename Visit>
__device__ __forceinline__ void run_walk(const uint8_t* d, int n, int npad,
                                         int* scratch, Visit visit) {
  int next_break = npad;  // first non-repeat index right of the tile
  for (int ts = npad - SCAN_BLOCK; ts >= 0; ts -= SCAN_BLOCK) {
    const int j = ts + SCAN_BLOCK - 1 - static_cast<int>(threadIdx.x);
    const int cur = j < n ? d[j] : 0;
    const int prev = (j >= 1 && j - 1 < n) ? d[j - 1] : 0;
    const bool eq = j >= 1 && cur == prev;
    int tile_min;
    const int m = block_inclusive_scan(eq ? INT_MAX : j, MinOp(), scratch, tile_min);
    visit(j, (m < next_break ? m : next_break) - j);
    next_break = tile_min < next_break ? tile_min : next_break;
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

// One extension round at `cap` for position j: a capped match whose
// distance recurs at j + cap chains to cap + len[j + cap] and takes that
// position's capped flag; a capped match that does not chain stops.
__device__ __forceinline__ int extend_step(const int* src, const int* dist, int j,
                                           int npad, int cap) {
  const int a = src[j];
  if (!(a & CAPPED_BIT)) return a;
  const int k = j + cap;
  if (k < npad && dist[k] == dist[j]) {
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

// Lazy demotion (a match shorter than 32 yields to a longer one at j + 1)
// and the [0, n) outputs. `len` must be complete for the whole row.
__device__ __forceinline__ void write_row(const int* len, const int* dist, int n,
                                          int npad, int lazy, int32_t* lrow,
                                          int32_t* drow) {
  for (int j = threadIdx.x; j < n; j += SCAN_BLOCK) {
    int l = len[j];
    if (lazy) {
      const int next = j + 1 < npad ? len[j + 1] : 0;
      if (l > 0 && l < 32 && next > l) l = 0;
    }
    lrow[j] = l;
    drow[j] = dist[j];
  }
}

}  // namespace tail
