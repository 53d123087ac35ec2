// K2 (and K3): best recency candidate of every hash-sorted slot.
//
// Replaces the Pallas kernels `_neighbor_kernel`
// (gzp_tpu/ops/lz_pallas.py:194) and `_neighbor_loop_kernel` (:256), both
// launched from `neighbor_pallas` (:404). The TPU needed two bodies only
// because an unrolled lag loop overflowed Mosaic's scoped VMEM past
// lags = 2; here `lags` is a run-time argument, so one kernel computes both.
//
// In hash-sorted order (sk = hash << pos_bits | pos, as int64), slot s is
// compared with the `lags` slots before it. A candidate is valid when it
// sits in the same hash bucket, at or after the row's halo_start, at a
// distance in [1, max_dist]. Its length is the common prefix of the carried
// context words (trailing-zero bytes of their XOR), capped at 4 * pw; the
// longest wins, ties go to the nearer. Output: the slot's position and
// packed = dist | len << 17 | capped << 22.
//
// Bound on the card: memory. Per slot it reads one 8-byte key and pw
// 4-byte words, and writes 8 bytes. Design: one thread per sorted slot; the
// `lags` predecessors are the previous threads' own inputs, so their
// re-reads hit L1/L2 rather than device memory.
#include "common.cuh"

namespace {

__global__ void neighbor_kernel(const int64_t* __restrict__ sk,
                                const uint32_t* __restrict__ pays,
                                const int32_t* __restrict__ halo_start,
                                int32_t* __restrict__ sp_out,
                                uint32_t* __restrict__ packed_out, int rows,
                                int npad, int pos_bits, int payload_words,
                                int lags, int max_dist) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * npad) return;
  const int b = static_cast<int>(idx / npad);
  const int s = static_cast<int>(idx % npad);
  const int64_t plane = static_cast<int64_t>(rows) * npad;
  const uint32_t pos_mask = (1u << pos_bits) - 1u;
  const uint32_t k0 = static_cast<uint32_t>(sk[idx]);
  const int sp = static_cast<int>(k0 & pos_mask);
  const uint32_t sh = k0 >> pos_bits;
  const int lo = halo_start[b];
  const int payload_bytes = 4 * payload_words;

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
    int len = 0, capped = 0;
    if (valid) {
      len = payload_bytes;
      for (int k = 0; k < payload_words; ++k) {
        const uint32_t x = pays[k * plane + idx] ^ pays[k * plane + idx - lag];
        if (x != 0) {
          len = 4 * k + ((__ffs(x) - 1) >> 3);
          break;
        }
      }
      capped = len >= payload_bytes;
    }
    // the first lag is taken as is; later lags replace it unless it is
    // longer, or equally long and nearer
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

// sk [rows, npad] i64; pays [payload_words, rows, npad] u32; halo_start [rows]
// i32 -> sp [rows, npad] i32, packed [rows, npad] u32
GZP_EXPORT int gzp_neighbor(const void* sk, const void* pays,
                            const void* halo_start, void* sp, void* packed,
                            int rows, int npad, int pos_bits, int payload_words,
                            int lags, int max_dist, void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * npad;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  neighbor_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sk), static_cast<const uint32_t*>(pays),
      static_cast<const int32_t*>(halo_start), static_cast<int32_t*>(sp),
      static_cast<uint32_t*>(packed), rows, npad, pos_bits, payload_words, lags,
      max_dist);
  return static_cast<int>(cudaGetLastError());
}
