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
// result is the longest valid candidate, the nearest of those, packed as
// dist | len << 17 | capped << 22 (0 where none has len >= 1), which is what
// the reference's keep rule (up then down for each k, replace unless the
// held one is longer, or equally long and nearer) leaves.
//
// Bound on the card: bytes, 12 per slot (0.030 ms on 64 x 131,072 slots at
// 3.35 TB/s). The operations the inputs need are fewer: the exit rule of
// lz_cuda.suffix_merge_work leaves 0.42 of the 2 x lags candidate tests on
// level 6's text (chip_smoke.py counts them with suffix_merge_work), at 3
// ALU-pipe instructions a test here (tools/sass_loops.py). Design:
// * One key per candidate, K = ((len + 1) << 17) - dist, so "longer, then
//   nearer" is the larger K and the walk keeps one running max. On rows of
//   up to 2^22 slots (every level's block and halo) the keys are fp32 (struct
//   F32), exact there (half-integers below 2^23), which moves the two
//   additions per candidate to the FMA pipe (twice the ALU pipe's lanes):
//   per candidate the ALU pipe takes the running min, the validity test |w|
//   <= h and a predicated max. Validity is one test: with h = (max_dist - 1)
//   / 2 and w = sp[s] - 1 - h - cpos = dist - 1 - h, dist is in [1,
//   max_dist] iff |w| <= h; and K = G - w, where G = ((m + 1) << 17) - 1 - h
//   is the running min of the staged LCP keys ((adj + 1) << 17) - 1 - h. A
//   position before halo_start is staged as MARK, outside every slot's
//   window. Longer rows (up to 2^30 slots) take the same walk on int32 keys
//   (struct I32: w = dist - 1, valid iff w < max_dist unsigned), exact at
//   any position there, at 4 ALU-pipe instructions a test (the compiler
//   puts the two subtractions on the FMA pipe as IMAD). The best starts
//   at KEY0 = 1 << 17 (len 1 at distance 2^17): every valid candidate of len
//   >= 1 beats it, none of len 0 does, and KEY0 packs to 0.
// * Each thread takes runs of V = 4 consecutive slots. Lag k's up candidates
//   of the run's slots are 4 consecutive staged slots, lag k + 1's the same
//   shifted by one, so each lag loads one new (position, LCP key) pair per
//   direction for 4 slots and keeps the rest in registers: 0.5 shared-memory
//   loads per slot and lag, not 2. Lags go 4 at a time between two register
//   sets of those pairs, so no pair is moved (a last 1-3 lags one at a time).
// * The CTA stages TILE = 2048 slots and a halo of lags rounded up to 32 on
//   each side, so each input word is read about once, with 16-byte loads
//   where the row allows. Pairs are 8 bytes, staged slot i at row i & 3,
//   column i >> 2 of 4 rows of Q pairs (18.5 KB of dynamic shared memory):
//   a warp's 32 runs start 4 slots apart, so each of its loads reads one row
//   at 32 consecutive columns (no bank conflict), at an offset fixed at
//   compile time from one pointer per direction. Tiles of 1024, 4096 and
//   8192 slots were 2-9% slower on the H100 (PERF.md). gzp_suffix_merge_plan
//   gives the tile and the shared memory to reports and tests.
// * Every slot walks all lags in lock step, all 2 x lags tests: every 32
//   consecutive slots hold one that needs all lags, so a lane that ended
//   early would only idle. A warp-level refill under the exit rule (each lane
//   a slot, a new one when done) was exact and 3x slower on the H100
//   (PERF.md): per step it pays addresses, the exit test and the refill,
//   where the lock step pays 3 instructions a test.
#include <cfloat>
#include <climits>

#include "common.cuh"

namespace {

constexpr int NT = 256;                 // threads per CTA
constexpr int V = 4;                    // consecutive slots per run
constexpr int RUNS = 2;                 // runs per thread
constexpr int TILE = NT * V * RUNS;     // slots per CTA
constexpr int MAX_LAGS = 127;
constexpr int MAX_HALO = 128;           // MAX_LAGS rounded up to 32
// pairs per row of the staged tile; Q % 16 == 4 keeps the staging stores
// (4 rows x 4 columns per 16 lanes) off each other's banks
constexpr int Q = (TILE + 2 * MAX_HALO) / 4 + 4;
constexpr int SMEM_BYTES = 4 * Q * 8;
constexpr int KEY0 = 1 << 17;           // no candidate of len >= 1
constexpr int F32_ROWS = 1 << 22;       // the longest row F32 is exact on
constexpr int I32_ROWS = 1 << 30;       // ... and I32

static_assert(V == 4 && Q % 16 == 4, "the staged rows assume runs of 4 slots");
static_assert(SMEM_BYTES <= 227 * 1024, "K8's tile must fit an SM's shared memory");

// fp32 keys, for positions in [-1, 2^22): w = dist - 1 - h, valid iff |w|
// <= h; the key G - w.
struct F32 {
  using T = float;
  using T2 = float2;
  static constexpr float MARK = -8388608.0f;  // -2^23: no source position
  static constexpr float TOP = FLT_MAX;
  float h;                                    // (max_dist - 1) / 2
  __device__ explicit F32(int max_dist) : h(0.5f * static_cast<float>(max_dist - 1)) {}
  __device__ float2 pair(int p, int a, int lo) const {
    // a negative LCP is as 0 (no len >= 1); a position before lo, no source
    return make_float2(p >= lo ? static_cast<float>(p) : MARK,
                       static_cast<float>(max(a, 0) + 1) * static_cast<float>(KEY0) -
                           (1.0f + h));
  }
  // a slot before halo_start has no valid candidate (its distances are < 1)
  __device__ float own(float2 e) const { return e.x == MARK ? FLT_MAX : e.x - (1.0f + h); }
  __device__ void consider(float& best, float a, float g, float cpos) const {
    const float w = a - cpos;
    if (fabsf(w) <= h) best = fmaxf(best, g - w);
  }
  static __device__ float lower(float x, float y) { return fminf(x, y); }
  static __device__ int key(float best) { return static_cast<int>(best); }
};

// int32 keys, for positions in [-1, 2^30): w = dist - 1, valid iff w <
// max_dist as unsigned; the key G - w with G = ((m + 1) << 17) - 1.
struct I32 {
  using T = int;
  using T2 = int2;
  static constexpr int MARK = INT_MIN;  // w >= 2^31 - 2 from every own slot
  static constexpr int TOP = INT_MAX;
  unsigned n;                           // max_dist
  __device__ explicit I32(int max_dist) : n(static_cast<unsigned>(max_dist)) {}
  __device__ int2 pair(int p, int a, int lo) const {
    return make_int2(p >= lo ? p : MARK, (max(a, 0) + 1) * KEY0 - 1);
  }
  // 3 << 29 is more than max_dist past every position, and 2^31 + 3 << 29
  // past MARK
  __device__ int own(int2 e) const { return e.x == MARK ? 3 << 29 : e.x - 1; }
  __device__ void consider(int& best, int a, int g, int cpos) const {
    const unsigned w = static_cast<unsigned>(a) - static_cast<unsigned>(cpos);
    if (w < n) best = max(best, g - static_cast<int>(w));
  }
  static __device__ int lower(int x, int y) { return min(x, y); }
  static __device__ int key(int best) { return best; }
};

__host__ __device__ constexpr int halo_of(int lags) { return (lags + 31) / 32 * 32; }
__device__ __forceinline__ int at(int i) { return (i & 3) * Q + (i >> 2); }

// One slot at one lag: the up LCP step and candidate, then the down pair.
template <class K>
__device__ __forceinline__ void lag_step(const K& kk, typename K::T& best, typename K::T& gu,
                                         typename K::T& gd, typename K::T a,
                                         typename K::T2 step, typename K::T2 up,
                                         typename K::T2 dn) {
  gu = K::lower(gu, step.y);
  kk.consider(best, a, gu, up.x);
  gd = K::lower(gd, dn.y);
  kk.consider(best, a, gd, dn.x);
}

// Lags k..k+3 (k % 4 == 1) of a run: wu[j] / wd[j] hold slot j's up / down
// pair of lag k - 1, nu / nd get those of lag k + 3. The new up pairs sit in
// rows 3..0 of column `up`, the down pairs in rows 0..3 of column `dn`.
template <class K, class T, class T2>
__device__ __forceinline__ void four_lags(const K& kk, const T2* up, const T2* dn,
                                          const T2 (&wu)[V], const T2 (&wd)[V], T2 (&nu)[V],
                                          T2 (&nd)[V], const T (&a)[V], T (&best)[V],
                                          T (&gu)[V], T (&gd)[V]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    nu[3 - u] = up[(3 - u) * Q];  // lag k + u's up pair of slot 0
    nd[u] = dn[u * Q];            // lag k + u's down pair of slot V - 1
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      lag_step(kk, best[j], gu[j], gd[j], a[j], j - u >= 0 ? wu[j - u] : nu[4 - u + j],
               j - u - 1 >= 0 ? wu[j - u - 1] : nu[3 - u + j],
               j + u + 1 < V ? wd[j + u + 1] : nd[j + u + 1 - V]);
    }
  }
}

template <class K>
__global__ void __launch_bounds__(NT)
suffix_merge_kernel(const int32_t* __restrict__ sp, const int32_t* __restrict__ adj,
                    const int32_t* __restrict__ halo_start,
                    uint32_t* __restrict__ packed, int npad, int lags, int max_dist,
                    int payload_bytes) {
  using T = typename K::T;
  using T2 = typename K::T2;
  // (position or MARK, LCP key) per staged slot
  extern __shared__ __align__(16) unsigned char smem[];
  T2* s_e = reinterpret_cast<T2*>(smem);
  const K kk(max_dist);
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * TILE;
  const int halo = halo_of(lags);
  const int64_t row = static_cast<int64_t>(b) * npad;
  const int lo = halo_start[b];
  if ((npad & 3) == 0) {  // 16-byte loads: 4 slots, all in the row or all out
    for (int i = 4 * threadIdx.x; i < TILE + 2 * halo; i += 4 * NT) {
      const int s = tile0 - halo + i;
      int4 p4 = make_int4(-1, -1, -1, -1), a4 = make_int4(0, 0, 0, 0);
      if (s >= 0 && s < npad) {
        p4 = *reinterpret_cast<const int4*>(sp + row + s);
        a4 = *reinterpret_cast<const int4*>(adj + row + s);
      }
      s_e[at(i)] = kk.pair(p4.x, a4.x, lo);
      s_e[at(i + 1)] = kk.pair(p4.y, a4.y, lo);
      s_e[at(i + 2)] = kk.pair(p4.z, a4.z, lo);
      s_e[at(i + 3)] = kk.pair(p4.w, a4.w, lo);
    }
  } else {
    for (int i = threadIdx.x; i < TILE + 2 * halo; i += NT) {
      const int s = tile0 - halo + i;
      const bool in = s >= 0 && s < npad;
      s_e[at(i)] = kk.pair(in ? sp[row + s] : -1, in ? adj[row + s] : 0, lo);
    }
  }
  __syncthreads();

  for (int r = 0; r < RUNS; ++r) {
    const int t0 = r * NT * V + threadIdx.x * V;  // the run's first slot in the tile
    if (tile0 + t0 >= npad) break;
    const int c0 = halo + t0;                     // ... and in the staged tile (% 4 == 0)
    T a[V], best[V], gu[V], gd[V];
    T2 wu[V], wd[V], xu[V], xd[V];  // two sets of each slot's pairs of one lag
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const T2 e = s_e[at(c0 + j)];
      wu[j] = wd[j] = e;
      a[j] = kk.own(e);
      best[j] = static_cast<T>(KEY0);
      gu[j] = gd[j] = K::TOP;
    }
    const T2* up = s_e + (c0 >> 2) - 1;
    const T2* dn = s_e + (c0 >> 2) + 1;
    int k = 1;
    for (; k + 7 <= lags; k += 8, up -= 2, dn += 2) {
      four_lags(kk, up, dn, wu, wd, xu, xd, a, best, gu, gd);
      four_lags(kk, up - 1, dn + 1, xu, xd, wu, wd, a, best, gu, gd);
    }
    if (k + 3 <= lags) {
      four_lags(kk, up, dn, wu, wd, xu, xd, a, best, gu, gd);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        wu[j] = xu[j];
        wd[j] = xd[j];
      }
      k += 4;
    }
    for (; k <= lags; ++k) {  // the last lags % 4, one at a time
      const T2 nu = s_e[at(c0 - k)], nd = s_e[at(c0 + V - 1 + k)];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        lag_step(kk, best[j], gu[j], gd[j], a[j], wu[j], j >= 1 ? wu[j - 1] : nu,
                 j + 1 < V ? wd[j + 1] : nd);
      }
#pragma unroll
      for (int j = V - 1; j > 0; --j) wu[j] = wu[j - 1];
      wu[0] = nu;
#pragma unroll
      for (int j = 0; j + 1 < V; ++j) wd[j] = wd[j + 1];
      wd[V - 1] = nd;
    }
    uint32_t out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int key = K::key(best[j]);
      const int len = key >> 17;
      const uint32_t dist = static_cast<uint32_t>(((len + 1) << 17) - key);
      out[j] = key == KEY0 ? 0u
                           : dist | (static_cast<uint32_t>(len) << 17) |
                                 (static_cast<uint32_t>(len >= payload_bytes) << 22);
    }
    uint32_t* dst = packed + row + tile0 + t0;
    if ((npad & 3) == 0 && tile0 + t0 + V <= npad) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (tile0 + t0 + j < npad) dst[j] = out[j];
      }
    }
  }
}

template <class K>
int launch(const void* sp, const void* adj, const void* halo_start, void* packed, int rows,
           int npad, int lags, int max_dist, int payload_bytes, cudaStream_t stream) {
  if (SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        suffix_merge_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((npad + TILE - 1) / TILE, rows);
  suffix_merge_kernel<K><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const int32_t*>(sp), static_cast<const int32_t*>(adj),
      static_cast<const int32_t*>(halo_start), static_cast<uint32_t*>(packed), npad,
      lags, max_dist, payload_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sp, adj [rows, npad] i32 (suffix order); halo_start [rows] i32
// -> packed [rows, npad] u32: F32 keys on rows of up to 2^22 slots, I32 on
// longer ones. The wrapper (lz_cuda.suffix_merge_cuda) holds the domain:
// positions in [-1, npad), adj <= 31, max_dist < 2^17, payload_bytes >= 1.
GZP_EXPORT int gzp_suffix_merge(const void* sp, const void* adj,
                                const void* halo_start, void* packed, int rows,
                                int npad, int lags, int max_dist,
                                int payload_bytes, void* stream) {
  if (npad < 1 || npad > I32_ROWS || rows < 1 || lags < 1 || lags > MAX_LAGS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* s = static_cast<cudaStream_t>(stream);
  return npad <= F32_ROWS
             ? launch<F32>(sp, adj, halo_start, packed, rows, npad, lags, max_dist,
                           payload_bytes, s)
             : launch<I32>(sp, adj, halo_start, packed, rows, npad, lags, max_dist,
                           payload_bytes, s);
}

// K8's plan, for reports and tests: slots per CTA, dynamic shared memory per
// CTA in bytes, and the longest row on fp32 keys
GZP_EXPORT void gzp_suffix_merge_plan(int* tile, int* smem_bytes, int* f32_rows) {
  *tile = TILE;
  *smem_bytes = SMEM_BYTES;
  *f32_rows = F32_ROWS;
}
