// K4: common prefix of every sorted slot's context words with those of the
// slot `lag` above.
//
// Replaces the Pallas kernel `_lcp_lag_kernel` (gzp_tpu/ops/lz_pallas.py:315,
// wrapper `lcp_lags_pallas` :382). Per slot s of a sorted row and one lag:
//   x_k = w_k[s] ^ w_k[s - lag]   (zero words above slot 0)
//   lcp = 4k + zero bytes of the first nonzero x_k, or 4 * pw if none,
// counting leading zero bytes for big-endian words (the suffix pass, K7's
// keys: __clz(x) >> 3) and trailing ones for little-endian words (the hash
// pass, K1's payloads: (__ffs(x) - 1) >> 3). `lag` and the byte order are
// run-time arguments; one launch computes one lag.
//
// Bound on the card: memory. Per slot it reads the words up to the first
// that differs, twice (its own and its neighbour's), and writes one word.
// Design: one thread per slot; the neighbour's words are the previous
// threads' own, so their re-reads hit L1/L2. The loop stops at the first
// differing word, so sorted runs of distinct contexts read one word a slot.
#include "common.cuh"

namespace {

__global__ void lcp_lag_kernel(const uint32_t* __restrict__ words,
                               int32_t* __restrict__ out, int rows, int npad,
                               int payload_words, int lag, int big_endian) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(rows) * npad;
  if (idx >= plane) return;
  const bool has_prev = static_cast<int>(idx % npad) >= lag;
  int lcp = 4 * payload_words;
  for (int k = 0; k < payload_words; ++k) {
    const uint32_t* w = words + k * plane;
    const uint32_t x = w[idx] ^ (has_prev ? w[idx - lag] : 0u);
    if (x != 0) {
      const int zero_bytes =
          big_endian ? (__clz(static_cast<int>(x)) >> 3) : ((__ffs(static_cast<int>(x)) - 1) >> 3);
      lcp = 4 * k + zero_bytes;
      break;
    }
  }
  out[idx] = lcp;
}

}  // namespace

// words [payload_words, rows, npad] u32 -> out [rows, npad] i32 for one lag
GZP_EXPORT int gzp_lcp_lag(const void* words, void* out, int rows, int npad,
                           int payload_words, int lag, int big_endian,
                           void* stream) {
  if (lag < 1 || payload_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(rows) * npad;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  lcp_lag_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int32_t*>(out), rows, npad,
      payload_words, lag, big_endian);
  return static_cast<int>(cudaGetLastError());
}
