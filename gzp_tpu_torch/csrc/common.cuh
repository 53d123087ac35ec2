// Shared helpers for the hand-written Hopper kernels of gzp_tpu_torch.
//
// Every kernel library exposes a plain C interface (loaded with ctypes by
// gzp_tpu_torch/runtime/cuda_lib.py): each entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GZP_EXPORT extern "C" __attribute__((visibility("default")))

GZP_EXPORT const char* gzp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The row-scan kernels (K6, K10) run one CTA of SCAN_BLOCK threads per row
// and walk the row in tiles of SCAN_BLOCK elements.
constexpr int SCAN_BLOCK = 1024;
constexpr int SCAN_WARPS = SCAN_BLOCK / 32;

// Inclusive scan of one warp in lane order: lane l gets op(x_0, ..., x_l).
// `op(a, b)` combines an earlier element `a` with a later one `b`; it must
// be associative, not necessarily commutative.
template <typename T, typename Op>
__device__ __forceinline__ T warp_inclusive_scan(T x, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = op(y, x);
  }
  return x;
}

// Inclusive scan over a SCAN_BLOCK-thread CTA in threadIdx order.
// `scratch` is SCAN_WARPS elements of shared memory; `total` receives the
// aggregate of the whole CTA in every thread. Contains barriers: every
// thread of the CTA must call it.
template <typename T, typename Op>
__device__ __forceinline__ T block_inclusive_scan(T x, Op op, T* scratch,
                                                  T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_inclusive_scan(x, op);
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) scratch[lane] = warp_inclusive_scan(scratch[lane], op);
  __syncthreads();
  if (warp > 0) x = op(scratch[warp - 1], x);
  total = scratch[SCAN_WARPS - 1];
  __syncthreads();  // scratch may be reused by the next call
  return x;
}
