// K7: content-sort keys of the suffix matcher (levels 6-9).
//
// Replaces the Pallas kernel `_build_suffix_keys_kernel`
// (gzp_tpu/ops/lz_pallas.py:616, wrapper `build_suffix_keys_pallas` :633).
//
// For every position i of a row padded to Np (a multiple of 1024):
//   key_k[i] = big-endian 4-byte window at i + 4k, bytes at or past N read
//              as 0 (k < payload_words)
//   pos[i]   = i
// Sorting (key_0, ..., key_{kw-1}, pos) lexicographically as unsigned words
// is suffix order truncated at 4 * kw bytes. The TPU byte-swaps K1's
// little-endian windows; here the bytes are assembled big-endian directly.
//
// Bound on the card: memory. It reads N bytes and writes 4 * (pw + 1) * Np
// bytes per row, with a few shifts per output word. Design: K1's, one
// thread per position, so neighbouring threads read neighbouring bytes (the
// overlapping window reads hit L1) and write neighbouring words (coalesced
// 128-byte stores).
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t window4_be(const uint8_t* row, int n, int j) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = j + k;
    w = (w << 8) | static_cast<uint32_t>(p < n ? row[p] : 0);
  }
  return w;
}

__global__ void build_suffix_keys_kernel(const uint8_t* __restrict__ data,
                                         uint32_t* __restrict__ keys,
                                         uint32_t* __restrict__ pos, int rows,
                                         int n, int npad, int payload_words) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(rows) * npad;
  if (idx >= plane) return;
  const int b = static_cast<int>(idx / npad);
  const int i = static_cast<int>(idx % npad);
  const uint8_t* row = data + static_cast<int64_t>(b) * n;
  for (int k = 0; k < payload_words; ++k) {
    keys[k * plane + idx] = window4_be(row, n, i + 4 * k);
  }
  pos[idx] = static_cast<uint32_t>(i);
}

}  // namespace

// data [rows, n] u8 -> keys [payload_words, rows, npad] u32, pos [rows, npad] u32
GZP_EXPORT int gzp_build_suffix_keys(const void* data, void* keys, void* pos,
                                     int rows, int n, int npad, int payload_words,
                                     void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * npad;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  build_suffix_keys_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint32_t*>(keys),
      static_cast<uint32_t*>(pos), rows, n, npad, payload_words);
  return static_cast<int>(cudaGetLastError());
}
