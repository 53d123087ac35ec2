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

// Inclusive scan over an NT-thread CTA in threadIdx order (NT a multiple
// of 32, at most 1024). `scratch` is NT / 32 elements of shared memory;
// `total` receives the aggregate of the whole CTA in every thread.
// Contains barriers: every thread of the CTA must call it.
template <int NT, typename T, typename Op>
__device__ __forceinline__ T block_inclusive_scan(T x, Op op, T* scratch,
                                                  T& total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_inclusive_scan(x, op);
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    // lanes at or past NW scan a copy and write nothing back: an inclusive
    // scan's lane l depends on lanes 0..l only
    const T s = warp_inclusive_scan(scratch[lane < NW ? lane : 0], op);
    if (lane < NW) scratch[lane] = s;
  }
  __syncthreads();
  if (warp > 0) x = op(scratch[warp - 1], x);
  total = scratch[NW - 1];
  __syncthreads();  // scratch may be reused by the next call
  return x;
}
