// K6: position-order tail of the LZ77 match stage.
//
// Replaces the Pallas kernel `_tail_kernel` (gzp_tpu/ops/lz_pallas.py:472,
// wrapper `match_tail_pallas` :540). Per row, over the positions of the row
// padded to Np (bytes at or past N read as 0):
//   1. unpack the candidate (len, dist, capped) restored to position order;
//   2. distance-1 runs: run(i) = (first j >= i with d[j] != d[j-1]) - i,
//      counted only when i - 1 >= halo_start; the run wins when longer, or
//      equally long with dist > 1;
//   3. extension doubling at cap = 4*pw, 8*pw, ... < max_match: a capped
//      match whose distance recurs at i + cap chains to cap + len[i + cap];
//   4. clamp to the block end and max_match, drop len < min_emit and
//      len 3 beyond distance 4096, keep only positions in [base, base+len);
//   5. lazy demotion: a match shorter than 32 yields to a longer one at i+1.
//
// Design: one CTA of tail::BLOCK threads per tile of T positions of a row,
// grid (ceil(Np / T), rows), with no grid-wide barrier: every step reads
// only to the right and a bounded distance once the run is saturated at R
// (the window argument in match_tail.cuh). A CTA stages its window in
// shared memory once with 16-byte loads (bytes on [t0 - 1, t0 + T + E + R),
// candidates on [t0, t0 + T + E)), finds the runs with one CTA min-scan,
// runs every round in shared memory with a barrier between rounds, and
// writes len and dist of its tile once.
//
// Bound on the card: the integer operations of steps 1-5, about 90 per
// position; the halo (E + R positions of T) is recomputed by the next CTA
// and each of the ~5 rounds is a CTA barrier, which is what the tile size
// trades off.
#include "match_tail.cuh"

namespace {

__global__ void __launch_bounds__(tail::BLOCK)
match_tail_kernel(const uint8_t* __restrict__ data,
                  const uint32_t* __restrict__ packed,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ halo_start,
                  int32_t* __restrict__ ln_out, int32_t* __restrict__ dist_out, int n,
                  int npad, int base, int payload_bytes, int max_match, int min_emit,
                  int lazy, int T, int E, int R) {
  extern __shared__ int4 smem[];
  __shared__ int scratch[tail::BLOCK / 32];
  __shared__ int carry[tail::BLOCK];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * T;
  const int limit = npad - t0;
  const int cand = min(T + E, limit);
  const int span = min(T + E + R, limit);
  const int wp = tail::plane_len(T, E);
  int* lc0 = reinterpret_cast<int*>(smem);  // len | capped << 30
  int* dist = lc0 + wp;
  int* lc1 = dist + wp;                     // the rounds' second plane
  const int end = base + lengths[b];
  const int lo = halo_start[b];

  // ---- window: bytes into lc1's space (free until the first round), the
  // packed candidates into lc0
  const uint8_t* bytes = reinterpret_cast<uint8_t*>(lc1);
  tail::stage_bytes(reinterpret_cast<uint8_t*>(lc1), data + static_cast<int64_t>(b) * n,
                    n, t0, (16 + span + 15) / 16 * 16);
  tail::stage_words(lc0, packed + static_cast<int64_t>(b) * npad + t0, cand);
  __syncthreads();

  // ---- steps 1-2: unpack, and merge the saturated distance-1 run
  tail::run_pass(bytes, t0, span, cand, R, scratch, carry, [&](int p, int run) {
    tail::Cand c = tail::unpack(static_cast<uint32_t>(lc0[p]));
    tail::merge_run(c, run, t0 + p, lo);
    lc0[p] = tail::len_capped(c);
    dist[p] = c.dist;
  });
  __syncthreads();

  // ---- step 3: extension doubling; the valid region shrinks by each cap
  int* src = lc0;
  int* dst = lc1;
  int valid = T + E;
  for (int cap = payload_bytes; cap < max_match; cap *= 2) {
    valid -= cap;
    const int hi = min(valid, cand);
    for (int p = threadIdx.x; p < hi; p += tail::BLOCK) {
      dst[p] = tail::extend_step(src, dist, p, limit, cap);
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }

  // ---- step 4: clamp and heuristics on [t0, t0 + T + 1) (into dst)
  const int fin = min(T + 1, cand);
  for (int p = threadIdx.x; p < fin; p += tail::BLOCK) {
    dst[p] = tail::clamp_len(src[p] & tail::LEN_MASK, dist[p], t0 + p, base, end,
                             max_match, min_emit);
  }
  __syncthreads();

  // ---- step 5: lazy demotion, then the tile's outputs
  tail::write_tile(dst, dist, t0, T, n, limit, lazy, ln_out + static_cast<int64_t>(b) * n,
                   dist_out + static_cast<int64_t>(b) * n);
}

}  // namespace

// data [rows, n] u8; packed [rows, npad] u32 (position order); lengths,
// halo_start [rows] i32 -> ln, dist [rows, n] i32. (T, E, R): the tile and
// its window (ops/lz_cuda.py tail_window).
GZP_EXPORT int gzp_match_tail(const void* data, const void* packed,
                              const void* lengths, const void* halo_start, void* ln,
                              void* dist, int rows, int n, int npad, int base,
                              int payload_bytes, int max_match, int min_emit, int lazy,
                              int T, int E, int R, void* stream) {
  size_t smem = 0;
  const int err = tail::prepare(match_tail_kernel, 1, n, npad, payload_bytes, max_match,
                                T, E, R, smem);
  if (err != 0) return err;
  if (rows == 0 || npad == 0) return 0;
  const dim3 grid((npad + T - 1) / T, rows);
  match_tail_kernel<<<grid, tail::BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(lengths), static_cast<const int32_t*>(halo_start),
      static_cast<int32_t*>(ln), static_cast<int32_t*>(dist), n, npad, base,
      payload_bytes, max_match, min_emit, lazy, T, E, R);
  return static_cast<int>(cudaGetLastError());
}
