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
// Design: K6's, through the tile steps of match_tail.cuh: one CTA of
// tail::BLOCK threads per tile of T positions, grid (ceil(Np / T), rows),
// no grid-wide barrier. Saturating the run at R keeps step 4's comparison:
// every suffix-field length is at most 31 + S < R (S the sum of the caps),
// so a hash length built on a saturated run wins with or without the
// saturation, and the clamp makes both the same (the window argument in
// match_tail.cuh). The run is one CTA min-scan over the window, where the
// TPU's doubling ladder at lz_pallas.py:830-835 takes log2(Np) passes; each
// round of step 3 advances both fields between the same pair of barriers.
//
// Bound on the card: the integer operations of steps 1-5, about 140 per
// position, with K6's halo and barriers per tile and twice its planes of
// shared memory per CTA.
#include "match_tail.cuh"

namespace {

__global__ void __launch_bounds__(tail::BLOCK)
match_tail2_kernel(const uint8_t* __restrict__ data,
                   const uint32_t* __restrict__ packed_hash,
                   const uint32_t* __restrict__ packed_suffix,
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
  int* h0 = reinterpret_cast<int*>(smem);  // hash: len | capped << 30
  int* hd = h0 + wp;                       // hash: dist
  int* s0 = hd + wp;                       // suffix: len | capped << 30
  int* sd = s0 + wp;                       // suffix: dist
  int* h1 = sd + wp;                       // the rounds' second planes
  int* s1 = h1 + wp;
  const int end = base + lengths[b];
  const int lo = halo_start[b];

  // ---- window: bytes into h1's space (free until the first round), the
  // packed candidates into h0 and s0
  const uint8_t* bytes = reinterpret_cast<uint8_t*>(h1);
  const int64_t row = static_cast<int64_t>(b) * npad + t0;
  tail::stage_bytes(reinterpret_cast<uint8_t*>(h1), data + static_cast<int64_t>(b) * n,
                    n, t0, (16 + span + 15) / 16 * 16);
  tail::stage_words(h0, packed_hash + row, cand);
  tail::stage_words(s0, packed_suffix + row, cand);
  __syncthreads();

  // ---- steps 1-2: unpack both fields; the saturated run merges into the
  // hash field
  tail::run_pass(bytes, t0, span, cand, R, scratch, carry, [&](int p, int run) {
    tail::Cand h = tail::unpack(static_cast<uint32_t>(h0[p]));
    tail::merge_run(h, run, t0 + p, lo);
    h0[p] = tail::len_capped(h);
    hd[p] = h.dist;
    const tail::Cand s = tail::unpack(static_cast<uint32_t>(s0[p]));
    s0[p] = tail::len_capped(s);
    sd[p] = s.dist;
  });
  __syncthreads();

  // ---- step 3: extension doubling of both fields; the valid region
  // shrinks by each cap
  int *hsrc = h0, *hdst = h1, *ssrc = s0, *sdst = s1;
  int valid = T + E;
  for (int cap = payload_bytes; cap < max_match; cap *= 2) {
    valid -= cap;
    const int hi = min(valid, cand);
    for (int p = threadIdx.x; p < hi; p += tail::BLOCK) {
      hdst[p] = tail::extend_step(hsrc, hd, p, limit, cap);
      sdst[p] = tail::extend_step(ssrc, sd, p, limit, cap);
    }
    __syncthreads();
    int* tmp = hsrc;
    hsrc = hdst;
    hdst = tmp;
    tmp = ssrc;
    ssrc = sdst;
    sdst = tmp;
  }

  // ---- step 4: the longer (then nearer) field, clamped, into hdst on
  // [t0, t0 + T + 1); its distance into hd (each thread touches only its
  // own positions)
  const int fin = min(T + 1, cand);
  for (int p = threadIdx.x; p < fin; p += tail::BLOCK) {
    int len = hsrc[p] & tail::LEN_MASK;
    int dist = hd[p];
    const int len_s = ssrc[p] & tail::LEN_MASK;
    const int dist_s = sd[p];
    if (len_s > len || (len_s == len && dist_s < dist)) {
      len = len_s;
      dist = dist_s;
    }
    hd[p] = dist;
    hdst[p] = tail::clamp_len(len, dist, t0 + p, base, end, max_match, min_emit);
  }
  __syncthreads();

  // ---- step 5: lazy demotion, then the tile's outputs
  tail::write_tile(hdst, hd, t0, T, n, limit, lazy, ln_out + static_cast<int64_t>(b) * n,
                   dist_out + static_cast<int64_t>(b) * n);
}

}  // namespace

// data [rows, n] u8; packed_hash, packed_suffix [rows, npad] u32 (position
// order); lengths, halo_start [rows] i32 -> ln, dist [rows, n] i32. (T, E,
// R): the tile and its window (ops/lz_cuda.py tail_window).
GZP_EXPORT int gzp_match_tail2(const void* data, const void* packed_hash,
                               const void* packed_suffix, const void* lengths,
                               const void* halo_start, void* ln, void* dist, int rows,
                               int n, int npad, int base, int payload_bytes,
                               int max_match, int min_emit, int lazy, int T, int E,
                               int R, void* stream) {
  size_t smem = 0;
  const int err = tail::prepare(match_tail2_kernel, 2, n, npad, payload_bytes, max_match,
                                T, E, R, smem);
  if (err != 0) return err;
  if (rows == 0 || npad == 0) return 0;
  const dim3 grid((npad + T - 1) / T, rows);
  match_tail2_kernel<<<grid, tail::BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint32_t*>(packed_hash),
      static_cast<const uint32_t*>(packed_suffix), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(halo_start), static_cast<int32_t*>(ln),
      static_cast<int32_t*>(dist), n, npad, base, payload_bytes, max_match, min_emit,
      lazy, T, E, R);
  return static_cast<int>(cudaGetLastError());
}
