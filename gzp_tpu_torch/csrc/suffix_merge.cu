// K8: best of each suffix-sorted slot's ±lags neighbours.
//
// Replaces the Pallas kernel `_suffix_merge_kernel`
// (gzp_tpu/ops/lz_pallas.py:697), launched from `suffix_neighbor_pallas`
// (:766) after K4 computes the adjacent LCP (big-endian, lag 1).
//
// For lexicographically sorted strings lcp(s_i, s_{i-k}) = min(adj[i-k+1..i]).
// So for slot s and k = 1..lags, the up candidate (slot s - k) has the
// running minimum of adj over s-k+1..s, and the down candidate (slot s + k)
// that over s+1..s+k; below slot 0 adj reads 0 and the position -1, past the
// row the same. A candidate is valid at or after the row's halo_start, at a
// distance sp[s] - cpos in [1, max_dist]; an invalid one has length 0. The
// carry starts at (0, 0, 0) and every candidate, up then down for each k,
// replaces it unless the held one is longer, or equally long and nearer.
// Output: packed = dist | len << 17 | capped << 22, dist 0 where len is 0.
//
// Bound on the card: operations. Per slot it reads two words and writes
// one, but its lag loop issues about 20 integer-ALU instructions per lag
// (two running minima, two candidates' validity and keep tests; 81 per 4
// unrolled lags in the SASS, tools/sass_loops.py): on an H100 SXM's ALU
// pipe (64 lanes per SM per clock) ~0.16 ms at lags = 16 on 64 x 131072
// slots against 0.03 ms of memory traffic at 3.35 TB/s. Design: one
// thread per sorted slot; a CTA stages its tile of sp and adj in shared
// memory with a halo of HALO slots on each side (lags < HALO), so the
// 2 * lags neighbour reads per slot are shared-memory loads, and each
// thread keeps its two running minima and its best candidate in registers.
#include <climits>

#include "common.cuh"

namespace {

constexpr int TILE = 256;
constexpr int HALO = 128;

__global__ void __launch_bounds__(TILE)
suffix_merge_kernel(const int32_t* __restrict__ sp, const int32_t* __restrict__ adj,
                    const int32_t* __restrict__ halo_start,
                    uint32_t* __restrict__ packed, int npad, int lags,
                    int max_dist, int payload_bytes) {
  __shared__ int s_sp[TILE + 2 * HALO];
  __shared__ int s_adj[TILE + 2 * HALO];
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * TILE;
  const int64_t row = static_cast<int64_t>(b) * npad;
  for (int i = threadIdx.x; i < TILE + 2 * HALO; i += TILE) {
    const int s = tile0 - HALO + i;
    const bool in = s >= 0 && s < npad;
    s_sp[i] = in ? sp[row + s] : -1;
    s_adj[i] = in ? adj[row + s] : 0;
  }
  __syncthreads();

  const int c = HALO + threadIdx.x;  // this slot's place in the tile
  const int me = s_sp[c];
  const int lo = halo_start[b];
  int ls = 0, ds = 0, cs = 0;
  auto consider = [&](int lcp, int cpos) {
    const int dist = me - cpos;
    const bool valid = cpos >= lo && dist >= 1 && dist <= max_dist;
    const int len = valid ? lcp : 0;
    if (!(ls > len || (ls == len && ds < dist))) {
      ls = len;
      ds = dist;
      cs = (valid && lcp >= payload_bytes) ? 1 : 0;
    }
  };
  int m_up = INT_MAX, m_down = INT_MAX;
  for (int k = 1; k <= lags; ++k) {
    m_up = min(m_up, s_adj[c - k + 1]);
    consider(m_up, s_sp[c - k]);
    m_down = min(m_down, s_adj[c + k]);
    consider(m_down, s_sp[c + k]);
  }
  if (ls == 0) ds = 0;
  packed[row + tile0 + threadIdx.x] = static_cast<uint32_t>(ds) |
                                      (static_cast<uint32_t>(ls) << 17) |
                                      (static_cast<uint32_t>(cs) << 22);
}

}  // namespace

// sp, adj [rows, npad] i32 (suffix order); halo_start [rows] i32
// -> packed [rows, npad] u32
GZP_EXPORT int gzp_suffix_merge(const void* sp, const void* adj,
                                const void* halo_start, void* packed, int rows,
                                int npad, int lags, int max_dist,
                                int payload_bytes, void* stream) {
  if (npad % TILE != 0 || lags < 1 || lags >= HALO) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(npad / TILE, rows);
  suffix_merge_kernel<<<grid, TILE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sp), static_cast<const int32_t*>(adj),
      static_cast<const int32_t*>(halo_start), static_cast<uint32_t*>(packed), npad,
      lags, max_dist, payload_bytes);
  return static_cast<int>(cudaGetLastError());
}
