// K9: position-order tail of the suffix matcher (levels 6-9), K6 with two
// candidate fields.
//
// Replaces the Pallas kernel `_tail2_kernel` (gzp_tpu/ops/lz_pallas.py:797,
// wrapper `match_tail2_pallas` :878). Per row, over the positions of the row
// padded to Np (bytes at or past N read as 0), with a hash field (the
// recency candidates) and a suffix field (the content-order candidates),
// both restored to position order:
//   1. unpack both fields;
//   2. distance-1 runs merge into the hash field only, by K6's rule;
//   3. extension doubling at cap = 4*pw, 8*pw, ... < max_match, each field
//      on its own (a chain needs one coherent distance field);
//   4. the suffix field wins when longer, or equally long and nearer; then
//      K6's clamp and heuristics;
//   5. K6's lazy demotion and the [0, n) outputs.
//
// Bound on the card: memory and latency of the row walks, as K6, with twice
// the planes per round. Design: K6's, through the helpers of match_tail.cuh:
// one CTA of 1024 threads per row; step 2 is the right-to-left tile walk
// with a CTA min-scan (one pass over the row, where the TPU's doubling
// ladder at lz_pallas.py:830-835 takes log2(Np) passes); each round of
// step 3 advances both fields between the same pair of barriers. Only B
// CTAs run (64 at the flagship batch on 132 SMs); splitting rows is later
// work.
#include "match_tail.cuh"

namespace {

__global__ void __launch_bounds__(SCAN_BLOCK)
match_tail2_kernel(const uint8_t* __restrict__ data,
                   const uint32_t* __restrict__ packed_hash,
                   const uint32_t* __restrict__ packed_suffix,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ halo_start,
                   int32_t* __restrict__ work, int32_t* __restrict__ ln_out,
                   int32_t* __restrict__ dist_out, int rows, int n, int npad,
                   int base, int payload_bytes, int max_match, int min_emit,
                   int lazy) {
  __shared__ int scratch[SCAN_WARPS];
  const int b = blockIdx.x;
  const uint8_t* d = data + static_cast<int64_t>(b) * n;
  const uint32_t* ph = packed_hash + static_cast<int64_t>(b) * npad;
  const uint32_t* ps = packed_suffix + static_cast<int64_t>(b) * npad;
  const int64_t plane = static_cast<int64_t>(rows) * npad;
  int* h0 = work + static_cast<int64_t>(b) * npad;  // hash: len | capped << 30
  int* h1 = h0 + plane;
  int* hd = h1 + plane;                             // hash: dist
  int* s0 = hd + plane;                             // suffix: len | capped << 30
  int* s1 = s0 + plane;
  int* sd = s1 + plane;                             // suffix: dist
  const int end = base + lengths[b];
  const int lo = halo_start[b];

  // ---- steps 1-2: unpack both fields; the run merges into the hash field
  tail::run_walk(d, n, npad, scratch, [&](int j, int run) {
    tail::Cand h = tail::unpack(ph[j]);
    tail::merge_run(h, run, j, lo);
    h0[j] = tail::len_capped(h);
    hd[j] = h.dist;
    const tail::Cand s = tail::unpack(ps[j]);
    s0[j] = tail::len_capped(s);
    sd[j] = s.dist;
  });
  __syncthreads();

  // ---- step 3: extension doubling of both fields, one round per cap
  int *hsrc = h0, *hdst = h1, *ssrc = s0, *sdst = s1;
  for (int cap = payload_bytes; cap < max_match; cap *= 2) {
    for (int j = threadIdx.x; j < npad; j += SCAN_BLOCK) {
      hdst[j] = tail::extend_step(hsrc, hd, j, npad, cap);
      sdst[j] = tail::extend_step(ssrc, sd, j, npad, cap);
    }
    __syncthreads();
    int* tmp = hsrc;
    hsrc = hdst;
    hdst = tmp;
    tmp = ssrc;
    ssrc = sdst;
    sdst = tmp;
  }

  // ---- step 4: the longer (then nearer) field, clamped, into hdst; its
  // distance into hd (each thread touches only its own positions)
  for (int j = threadIdx.x; j < npad; j += SCAN_BLOCK) {
    int len = hsrc[j] & tail::LEN_MASK;
    int dist = hd[j];
    const int len_s = ssrc[j] & tail::LEN_MASK;
    const int dist_s = sd[j];
    if (len_s > len || (len_s == len && dist_s < dist)) {
      len = len_s;
      dist = dist_s;
    }
    hd[j] = dist;
    hdst[j] = tail::clamp_len(len, dist, j, base, end, max_match, min_emit);
  }
  __syncthreads();

  // ---- step 5: lazy demotion, then the [0, n) outputs
  tail::write_row(hdst, hd, n, npad, lazy, ln_out + static_cast<int64_t>(b) * n,
                  dist_out + static_cast<int64_t>(b) * n);
}

}  // namespace

// data [rows, n] u8; packed_hash, packed_suffix [rows, npad] u32 (position
// order); lengths, halo_start [rows] i32; work [6, rows, npad] i32 scratch
// -> ln, dist [rows, n] i32
GZP_EXPORT int gzp_match_tail2(const void* data, const void* packed_hash,
                               const void* packed_suffix, const void* lengths,
                               const void* halo_start, void* work, void* ln,
                               void* dist, int rows, int n, int npad, int base,
                               int payload_bytes, int max_match, int min_emit,
                               int lazy, void* stream) {
  if (npad % SCAN_BLOCK != 0 || n > npad || payload_bytes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  match_tail2_kernel<<<rows, SCAN_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint32_t*>(packed_hash),
      static_cast<const uint32_t*>(packed_suffix),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(halo_start), static_cast<int32_t*>(work),
      static_cast<int32_t*>(ln), static_cast<int32_t*>(dist), rows, n, npad, base,
      payload_bytes, max_match, min_emit, lazy);
  return static_cast<int>(cudaGetLastError());
}
