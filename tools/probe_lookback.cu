// The pack pre-scan K10 (gzp_tpu_torch/csrc/pack_prescan.cu) with its probe
// points filled in. Thread 0 of each tile writes PROBE_WORDS u64 words at
// probe_out + tile index * PROBE_WORDS: the clock64() at the end of phases
// 0-5 (tile index, width sum, width look-back, OR sum with the keys' stores,
// OR look-back, values' stores), then each look-back's polls (reloads of a
// status word not yet published, plus windows walked past). The stores go
// straight to device memory, so no register or shared memory is held across
// the phases. Built by tools/probe_lookback.py; the package never loads it.
__device__ unsigned long long* probe_out;
constexpr int PROBE_WORDS = 8;

#define PACK_PROBE(i)                                                                   \
  if (threadIdx.x == 0)                                                                 \
  probe_out[static_cast<long long>(tile_index) * PROBE_WORDS + (i)] = clock64()
#define PACK_PROBE_POLLS(polls)                                                         \
  if (threadIdx.x == 0) {                                                               \
    probe_out[static_cast<long long>(tile_index) * PROBE_WORDS + 6] = (polls)[0];       \
    probe_out[static_cast<long long>(tile_index) * PROBE_WORDS + 7] = (polls)[1];       \
  }

#include "../gzp_tpu_torch/csrc/pack_prescan.cu"

// Points the probe points at `buf`: PROBE_WORDS u64 per tile of the next
// launches, (rows * ceil(ep / 4096)) * PROBE_WORDS words.
GZP_EXPORT int gzp_probe_set(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(probe_out, &buf, sizeof(buf)));
}
