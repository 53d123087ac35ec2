// K2 (and K3): best recency candidate of every hash-sorted slot.
//
// Replaces the Pallas kernels `_neighbor_kernel`
// (gzp_tpu/ops/lz_pallas.py:194) and `_neighbor_loop_kernel` (:256), both
// launched from `neighbor_pallas` (:404). The TPU needed two bodies only
// because an unrolled lag loop overflowed Mosaic's scoped VMEM past
// lags = 2; here `lags` (1..127, as the loop kernel asserts lags < 128) is a
// run-time argument, so one kernel computes both.
//
// In hash-sorted order (sk = hash << pos_bits | pos, as int64), slot s is
// compared with the `lags` slots before it. A candidate is valid when it
// sits in the same hash bucket, at or after the row's halo_start, at a
// distance in [1, max_dist]. Its length is the common prefix of the carried
// context words (trailing-zero bytes of their XOR), capped at 4 * pw. The
// reference takes the first lag as is and lets a later lag replace it unless
// the held one is longer, or equally long and nearer; invalid lags have
// length 0 and the distance is zeroed where the length is 0. That is the
// longest valid candidate of nonzero length, the nearest among equals, or
// nothing: so the kernel starts from (len 0, dist 0), skips invalid
// candidates, and takes one when it is longer, or equally long and nearer.
// Capped is len == 4 * pw. Output: the slot's position and packed = dist |
// len << 17 | capped << 22.
//
// Bound on the card: memory. Per slot it must read one 8-byte key and pw
// 4-byte words, and write 8 bytes; the lag loop does lags * (10 + 4 * pw)
// integer operations per slot at most, below the bytes' time up to lags ~6.
//
// Design: tiles across the row. A CTA of BLOCK threads takes TILE slots of
// one row (1,024: the fastest of 512 to 4,096 in a sweep, PERF.md §6), grid
// (ceil(Np / TILE), rows), and stages the low key words and the pw word
// planes of slots [t0 - lags, t0 + TILE) in shared memory once, with 16-byte
// loads where the row allows them (the halo of `lags` slots is the only
// input read twice; below the row start it holds a key whose position makes
// every distance < 1). Slot positions are written from the staged keys with
// 16-byte stores. Thread x then takes slots x, x + BLOCK, ..., so a warp
// reads 32 consecutive words per lag (no bank conflicts) and writes 128
// contiguous bytes of results (staging them for 16-byte stores measured no
// faster); it compares key, then halo_start and distance, and only for a
// valid candidate the word ladder, unrolled over the compile-time pw without
// branches. Index arithmetic is 32-bit, with one 64-bit row offset per CTA;
// lags 1 and 2 (the levels' value and the suffix matcher's hash pass) get
// unrolled instances, 6% faster at lags 2 than the run-time loop.
#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int SPT = 4;               // slots per thread
constexpr int TILE = BLOCK * SPT;    // slots per CTA
constexpr int MAX_LAGS = 127;
constexpr uint32_t BELOW_ROW = ~0u;  // position pos_mask: distance <= 0

// Halo room in the staged planes: lags rounded up to 4, so every plane's
// tile starts 16-byte aligned.
__host__ __device__ constexpr int halo_room(int lags) { return (lags + 3) & ~3; }

__host__ __device__ __forceinline__ size_t smem_bytes(int pw, int lags) {
  return 4 * static_cast<size_t>(halo_room(lags) + TILE) * (1 + pw);
}
// the most a CTA stages (7 words, 127 lags) needs no opt-in past 48 KB
static_assert(4 * (halo_room(MAX_LAGS) + TILE) * (1 + 7) <= 48 * 1024, "tile too large");

template <int PW, int LAGS>
__global__ void __launch_bounds__(BLOCK)
neighbor_kernel(const int64_t* __restrict__ sk, const uint32_t* __restrict__ pays,
                const int32_t* __restrict__ halo_start, int32_t* __restrict__ sp_out,
                uint32_t* __restrict__ packed_out, int npad, int64_t plane, int pos_bits,
                int lags_rt, int max_dist, int vec) {
  extern __shared__ uint4 smem[];
  const int lags = LAGS > 0 ? LAGS : lags_rt;
  const int hp = halo_room(lags);
  const int stride = hp + TILE;  // words per staged plane
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_pay = s_key + stride;  // PW planes

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * TILE;
  const int count = min(TILE, npad - t0);
  const int64_t row = static_cast<int64_t>(blockIdx.y) * npad + t0;
  const int64_t* krow = sk + row;
  const uint32_t* prow = pays + row;
  int32_t* sp_row = sp_out + row;
  uint32_t* packed_row = packed_out + row;
  const uint32_t pos_mask = (1u << pos_bits) - 1u;

  // ---- stage the tile (slot t0 + i at hp + i) and write the positions
  if (vec) {  // npad % 4 == 0 and aligned rows: count % 4 == 0
#pragma unroll
    for (int r = 0; r < SPT / 4; ++r) {
      const int i = 4 * (tid + r * BLOCK);
      if (i < count) {
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(krow + i));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(krow + i + 2));
        const uint4 k = make_uint4(static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y),
                                   static_cast<uint32_t>(b.x), static_cast<uint32_t>(b.y));
        uint4 w[PW];
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          w[p] = __ldg(reinterpret_cast<const uint4*>(prow + p * plane + i));
        }
        *reinterpret_cast<uint4*>(s_key + hp + i) = k;
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          *reinterpret_cast<uint4*>(s_pay + p * stride + hp + i) = w[p];
        }
        *reinterpret_cast<int4*>(sp_row + i) =
            make_int4(static_cast<int>(k.x & pos_mask), static_cast<int>(k.y & pos_mask),
                      static_cast<int>(k.z & pos_mask), static_cast<int>(k.w & pos_mask));
      }
    }
  } else {
    for (int i = tid; i < count; i += BLOCK) {
      const uint32_t k = static_cast<uint32_t>(krow[i]);
      s_key[hp + i] = k;
#pragma unroll
      for (int p = 0; p < PW; ++p) s_pay[p * stride + hp + i] = __ldg(prow + p * plane + i);
      sp_row[i] = static_cast<int>(k & pos_mask);
    }
  }
  for (int i = tid; i < lags; i += BLOCK) {  // the halo: slots t0 - lags ..
    const int h = i - lags;                  // .. t0 - 1, at hp + h
    const bool in = t0 + h >= 0;
    s_key[hp + h] = in ? static_cast<uint32_t>(krow[h]) : BELOW_ROW;
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      s_pay[p * stride + hp + h] = in ? __ldg(prow + p * plane + h) : 0u;
    }
  }
  __syncthreads();

  // ---- each slot against the `lags` slots before it
  const int lo = halo_start[blockIdx.y];
#pragma unroll 2
  for (int r = 0; r < SPT; ++r) {
    const int i = tid + r * BLOCK;
    if (i >= count) break;
    const int c = hp + i;
    const uint32_t key = s_key[c];
    const int sp = static_cast<int>(key & pos_mask);
    const uint32_t sh = key >> pos_bits;
    uint32_t w[PW];
#pragma unroll
    for (int p = 0; p < PW; ++p) w[p] = s_pay[p * stride + c];
    int ls = 0, ds = 0;
#pragma unroll 4
    for (int lag = 1; lag <= lags; ++lag) {
      const uint32_t kc = s_key[c - lag];
      const int cpos = static_cast<int>(kc & pos_mask);
      const int dist = sp - cpos;
      if ((kc >> pos_bits) == sh && cpos >= lo && dist >= 1 && dist <= max_dist) {
        int len = 4 * PW;
#pragma unroll
        for (int p = PW - 1; p >= 0; --p) {  // the first differing word wins
          const uint32_t x = w[p] ^ s_pay[p * stride + c - lag];
          if (x != 0) len = 4 * p + ((__ffs(static_cast<int>(x)) - 1) >> 3);
        }
        if (len > ls || (len == ls && dist < ds)) {
          ls = len;
          ds = dist;
        }
      }
    }
    packed_row[i] = static_cast<uint32_t>(ds) | (static_cast<uint32_t>(ls) << 17) |
                    (static_cast<uint32_t>(ls == 4 * PW) << 22);
  }
}

struct Launch {
  const int64_t* sk;
  const uint32_t* pays;
  const int32_t* halo_start;
  int32_t* sp;
  uint32_t* packed;
  int rows, npad, pos_bits, lags, max_dist, vec;
  cudaStream_t stream;
};

template <int PW, int LAGS>
int launch(const Launch& a) {
  const dim3 grid((a.npad + TILE - 1) / TILE, a.rows);
  neighbor_kernel<PW, LAGS><<<grid, BLOCK, smem_bytes(PW, a.lags), a.stream>>>(
      a.sk, a.pays, a.halo_start, a.sp, a.packed, a.npad, static_cast<int64_t>(a.rows) * a.npad,
      a.pos_bits, a.lags, a.max_dist, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int PW>
int launch_pw(const Launch& a) {
  if (a.lags == 1) return launch<PW, 1>(a);
  if (a.lags == 2) return launch<PW, 2>(a);
  return launch<PW, 0>(a);
}

}  // namespace

// sk [rows, npad] i64 (u32 keys); pays [payload_words, rows, npad] u32;
// halo_start [rows] i32 -> sp [rows, npad] i32, packed [rows, npad] u32.
// lags in 1..127, payload_words in 1..7 (the package routes more than 3
// words to K4 + K5, as the TPU does; wider instances exist to time this
// kernel against that route).
GZP_EXPORT int gzp_neighbor(const void* sk, const void* pays, const void* halo_start,
                            void* sp, void* packed, int rows, int npad, int pos_bits,
                            int payload_words, int lags, int max_dist, void* stream) {
  if (lags < 1 || lags > MAX_LAGS || payload_words < 1 || payload_words > 7 || rows > 65535 ||
      pos_bits < 1 || pos_bits > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || npad == 0) return 0;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(sk) | reinterpret_cast<uintptr_t>(pays) |
                         reinterpret_cast<uintptr_t>(sp) | reinterpret_cast<uintptr_t>(packed);
  const Launch a{static_cast<const int64_t*>(sk), static_cast<const uint32_t*>(pays),
                 static_cast<const int32_t*>(halo_start), static_cast<int32_t*>(sp),
                 static_cast<uint32_t*>(packed), rows, npad, pos_bits, lags, max_dist,
                 npad % 4 == 0 && (ptrs & 15) == 0, static_cast<cudaStream_t>(stream)};
  switch (payload_words) {
    case 1: return launch_pw<1>(a);
    case 2: return launch_pw<2>(a);
    case 3: return launch_pw<3>(a);
    case 4: return launch_pw<4>(a);
    case 5: return launch_pw<5>(a);
    case 6: return launch_pw<6>(a);
    default: return launch_pw<7>(a);
  }
}
