// K1: hash-sort keys and context payloads for the LZ77 match stage.
//
// Replaces the Pallas kernel `_build_keys_kernel`
// (gzp_tpu/ops/lz_pallas.py:121, wrapper `build_keys_pallas` :147).
//
// For every position i of a row padded to Np (a multiple of 1024):
//   w4(j)   = little-endian 4-byte window at j, bytes at or past N read as 0
//   key[i]  = ((w4(i) * 0x9E3779B1 mod 2^32) >> pos_bits) << pos_bits | i
//   pay_k[i] = w4(i + 4k), k < payload_words
//
// Bound on the card: memory. It reads N bytes and writes 4 * (1 + pw) * Np
// bytes per row with a few integer operations per output word. Design: one
// thread per position, so neighbouring threads read neighbouring bytes (the
// overlapping window reads hit L1) and write neighbouring words (coalesced
// 128-byte stores). Nothing is staged in shared memory; a later version
// could load each tile's bytes once with 16-byte vector loads.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t window4(const uint8_t* row, int n, int j) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = j + k;
    w |= static_cast<uint32_t>(p < n ? row[p] : 0) << (8 * k);
  }
  return w;
}

__global__ void build_keys_kernel(const uint8_t* __restrict__ data,
                                  uint32_t* __restrict__ key,
                                  uint32_t* __restrict__ pays, int rows, int n,
                                  int npad, int pos_bits, int payload_words) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * npad) return;
  const int b = static_cast<int>(idx / npad);
  const int i = static_cast<int>(idx % npad);
  const uint8_t* row = data + static_cast<int64_t>(b) * n;
  const uint32_t w = window4(row, n, i);
  const uint32_t h = (w * 0x9E3779B1u) >> pos_bits;
  key[idx] = (h << pos_bits) | static_cast<uint32_t>(i);
  pays[idx] = w;
  for (int k = 1; k < payload_words; ++k) {
    pays[static_cast<int64_t>(k) * rows * npad + idx] = window4(row, n, i + 4 * k);
  }
}

}  // namespace

// data [rows, n] u8; key [rows, npad] u32; pays [payload_words, rows, npad] u32
GZP_EXPORT int gzp_build_keys(const void* data, void* key, void* pays, int rows,
                              int n, int npad, int pos_bits, int payload_words,
                              void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * npad;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  build_keys_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint32_t*>(key),
      static_cast<uint32_t*>(pays), rows, n, npad, pos_bits, payload_words);
  return static_cast<int>(cudaGetLastError());
}
