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
// Bound on the card: memory and latency of the row walks. Each round of
// step 3 reads len[i + cap] as written by the previous round, and step 5
// reads len[i + 1] after step 4, so each is a barrier over the whole row.
// Design: one CTA of 1024 threads per row walks the row in tiles. Step 2 is
// a suffix-min scan of the next non-repeat index, done tile by tile from
// the row's end with the minimum carried across tiles — linear in N (a
// thread counting forward would be quadratic on a long run; the walk and
// the per-position steps are in match_tail.cuh, shared with K9). The rounds of
// step 3 ping-pong between two row buffers in device memory with
// __syncthreads() between rounds. Only B CTAs run (64 at the flagship
// batch on 132 SMs), which caps the card's use; splitting a row over
// several CTAs needs a grid-wide barrier per round and is later work.
#include "match_tail.cuh"

namespace {

__global__ void __launch_bounds__(SCAN_BLOCK)
match_tail_kernel(const uint8_t* __restrict__ data,
                  const uint32_t* __restrict__ packed,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ halo_start,
                  int32_t* __restrict__ work, int32_t* __restrict__ ln_out,
                  int32_t* __restrict__ dist_out, int rows, int n, int npad,
                  int base, int payload_bytes, int max_match, int min_emit,
                  int lazy) {
  __shared__ int scratch[SCAN_WARPS];
  const int b = blockIdx.x;
  const uint8_t* d = data + static_cast<int64_t>(b) * n;
  const uint32_t* pk = packed + static_cast<int64_t>(b) * npad;
  const int64_t plane = static_cast<int64_t>(rows) * npad;
  int* lc0 = work + static_cast<int64_t>(b) * npad;  // len | capped << 30
  int* lc1 = lc0 + plane;
  int* dist = lc1 + plane;
  const int end = base + lengths[b];
  const int lo = halo_start[b];

  // ---- steps 1-2: unpack, and merge the distance-1 run
  tail::run_walk(d, n, npad, scratch, [&](int j, int run) {
    tail::Cand c = tail::unpack(pk[j]);
    tail::merge_run(c, run, j, lo);
    lc0[j] = tail::len_capped(c);
    dist[j] = c.dist;
  });
  __syncthreads();

  // ---- step 3: extension doubling, one full-row round per cap
  int* src = lc0;
  int* dst = lc1;
  for (int cap = payload_bytes; cap < max_match; cap *= 2) {
    for (int j = threadIdx.x; j < npad; j += SCAN_BLOCK) {
      dst[j] = tail::extend_step(src, dist, j, npad, cap);
    }
    __syncthreads();
    int* tmp = src;
    src = dst;
    dst = tmp;
  }

  // ---- step 4: clamp and heuristics (into dst)
  for (int j = threadIdx.x; j < npad; j += SCAN_BLOCK) {
    dst[j] = tail::clamp_len(src[j] & tail::LEN_MASK, dist[j], j, base, end,
                             max_match, min_emit);
  }
  __syncthreads();

  // ---- step 5: lazy demotion, then the [0, n) outputs
  tail::write_row(dst, dist, n, npad, lazy, ln_out + static_cast<int64_t>(b) * n,
                  dist_out + static_cast<int64_t>(b) * n);
}

}  // namespace

// data [rows, n] u8; packed [rows, npad] u32 (position order); lengths,
// halo_start [rows] i32; work [3, rows, npad] i32 scratch
// -> ln, dist [rows, n] i32
GZP_EXPORT int gzp_match_tail(const void* data, const void* packed,
                              const void* lengths, const void* halo_start,
                              void* work, void* ln, void* dist, int rows, int n,
                              int npad, int base, int payload_bytes,
                              int max_match, int min_emit, int lazy,
                              void* stream) {
  if (npad % SCAN_BLOCK != 0 || n > npad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  match_tail_kernel<<<rows, SCAN_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint32_t*>(packed),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(halo_start), static_cast<int32_t*>(work),
      static_cast<int32_t*>(ln), static_cast<int32_t*>(dist), rows, n, npad,
      base, payload_bytes, max_match, min_emit, lazy);
  return static_cast<int>(cudaGetLastError());
}
