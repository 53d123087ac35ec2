// K5: best recency candidate of every hash-sorted slot, from per-lag LCPs.
//
// Replaces the Pallas kernel `_hash_merge_kernel`
// (gzp_tpu/ops/lz_pallas.py:334), launched from `neighbor_pallas` (:404) when
// the hash pass carries more than three context words (the suffix matcher's
// shallow hash pass, pw = 7). The TPU split K2 into K4 (the word ladder, per
// lag) and this merge because the fused kernel overflowed Mosaic's scoped
// VMEM at pw = 7; the port keeps the split so that both kernels exist and
// compose as on the TPU.
//
// In hash-sorted order (sk = hash << pos_bits | pos, as int64), slot s takes
// the LCP of each lag k from lcps[k-1] (K4, little-endian). A candidate is
// valid in the same hash bucket, at or after the row's halo_start, at a
// distance in [1, max_dist]; an invalid one has length 0. The first lag is
// taken as is; a later one replaces it unless the held one is longer, or
// equally long and nearer (K2's rules). Output: the slot's position and
// packed = dist | len << 17 | capped << 22, dist 0 where len is 0.
//
// Bound on the card: memory. Per slot it reads one 8-byte key and `lags`
// 4-byte LCPs, and writes 8 bytes. Design: one thread per sorted slot; the
// predecessors' keys are the previous threads' own, so their re-reads hit
// L1/L2 rather than device memory.
#include "common.cuh"

namespace {

__global__ void hash_merge_kernel(const int64_t* __restrict__ sk,
                                  const int32_t* __restrict__ lcps,
                                  const int32_t* __restrict__ halo_start,
                                  int32_t* __restrict__ sp_out,
                                  uint32_t* __restrict__ packed_out, int rows,
                                  int npad, int pos_bits, int lags, int max_dist,
                                  int payload_bytes) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t plane = static_cast<int64_t>(rows) * npad;
  if (idx >= plane) return;
  const int b = static_cast<int>(idx / npad);
  const int s = static_cast<int>(idx % npad);
  const uint32_t pos_mask = (1u << pos_bits) - 1u;
  const uint32_t k0 = static_cast<uint32_t>(sk[idx]);
  const int sp = static_cast<int>(k0 & pos_mask);
  const uint32_t sh = k0 >> pos_bits;
  const int lo = halo_start[b];

  int ls = 0, ds = 0, cs = 0;
  for (int lag = 1; lag <= lags; ++lag) {
    int cpos = -1;
    bool same = false;
    if (s >= lag) {
      const uint32_t kc = static_cast<uint32_t>(sk[idx - lag]);
      cpos = static_cast<int>(kc & pos_mask);
      same = (kc >> pos_bits) == sh;
    }
    const int dist = sp - cpos;
    const bool valid = same && cpos >= lo && dist >= 1 && dist <= max_dist;
    const int lcp = lcps[(lag - 1) * plane + idx];
    const int len = valid ? lcp : 0;
    const int capped = (valid && lcp >= payload_bytes) ? 1 : 0;
    const bool keep = lag > 1 && (ls > len || (ls == len && ds < dist));
    if (!keep) {
      ls = len;
      ds = dist;
      cs = capped;
    }
  }
  if (ls == 0) ds = 0;
  sp_out[idx] = sp;
  packed_out[idx] = static_cast<uint32_t>(ds) | (static_cast<uint32_t>(ls) << 17) |
                    (static_cast<uint32_t>(cs) << 22);
}

}  // namespace

// sk [rows, npad] i64; lcps [lags, rows, npad] i32; halo_start [rows] i32
// -> sp [rows, npad] i32, packed [rows, npad] u32
GZP_EXPORT int gzp_hash_merge(const void* sk, const void* lcps,
                              const void* halo_start, void* sp, void* packed,
                              int rows, int npad, int pos_bits, int lags,
                              int max_dist, int payload_bytes, void* stream) {
  if (lags < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(rows) * npad;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  hash_merge_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sk), static_cast<const int32_t*>(lcps),
      static_cast<const int32_t*>(halo_start), static_cast<int32_t*>(sp),
      static_cast<uint32_t*>(packed), rows, npad, pos_bits, lags, max_dist,
      payload_bytes);
  return static_cast<int>(cudaGetLastError());
}
