// The time of one table-lookup step of a serial Huffman decode on the card:
// the floor of the inflate kernel K11 (gzp_tpu_torch/csrc/inflate.cu), whose
// lane 0 decodes each row as one chain of dependent symbol decodes.
//
// One thread walks `steps` dependent steps, each K11's literal step without
// its store and its checks: the low 10 bits of a 64-bit bit buffer index a
// 1,024-entry table in shared memory, and the entry's code length (bits 0-3,
// 1-15) shifts the buffer on (a rotate here, so the chain never runs dry).
// Writes the chain's clock64() cycles and the last buffer (so the chain is
// not optimised away). Built and run by chip_smoke.py (`k11_step`), which
// times the launch with CUDA events as well.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void table_step(const uint32_t* __restrict__ tab_in, unsigned long long seed,
                           int steps, long long* __restrict__ cycles,
                           unsigned long long* __restrict__ sink) {
  __shared__ uint32_t tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) tab[i] = tab_in[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long buf = seed;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    const int n = static_cast<int>(tab[static_cast<uint32_t>(buf) & 1023u] & 15u);
    buf = (buf >> n) | (buf << (64 - n));
  }
  const long long t1 = clock64();
  cycles[0] = t1 - t0;
  sink[0] = buf;
}

}  // namespace

extern "C" int gzp_table_step(const uint32_t* tab, unsigned long long seed, int steps,
                              long long* cycles, unsigned long long* sink, cudaStream_t stream) {
  table_step<<<1, 32, 0, stream>>>(tab, seed, steps, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}
