// K4: common prefix of every sorted slot's context words with those of the
// slots 1 .. `lags` above.
//
// Replaces the Pallas kernel `_lcp_lag_kernel` (gzp_tpu/ops/lz_pallas.py:315,
// wrapper `lcp_lags_pallas` :382). Per slot s of a sorted row and lag L:
//   x_k = w_k[s] ^ w_k[s - L]   (zero words above slot 0)
//   lcp = 4k + zero bytes of the first nonzero x_k, or 4 * pw if none,
// counting leading zero bytes for big-endian words (the suffix pass, K7's
// keys: __clz(x) >> 3) and trailing ones for little-endian words (the hash
// pass, K1's payloads: (__ffs(x) - 1) >> 3).
//
// Bound on the card: memory. Per slot it must read its words up to the
// deepest first difference over the lags, once, and write `lags` words.
//
// Design: one launch for every lag. The grid is (ceil(Np / TILE), rows);
// each thread takes 4 consecutive slots, loaded with one 16-byte load per
// word plane. The words of the slots up to 4 above come from the previous
// lane by __shfl_up_sync; lane 0 of each warp loads the 4 slots before its
// own itself (the previous warp's, from L1 or L2), so warps share no
// barrier and each stops on its own. Lags 1 and 2 (the ones the paths use)
// keep their LCPs in registers in one pass over the planes; a thread loads
// plane k only while a slot of its own or of the next lane still needs it.
// (Issuing plane k+1's load before comparing plane k was 3-5% slower on
// an H100 80GB HBM3 at 700 W: it reads one plane more per thread, and the
// resident warps already keep enough loads in flight.) Lags above 2 run
// after that pass, one at a time, with scalar loads. The word count (1-7)
// and the byte order are template parameters.
#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int TILE = 4 * BLOCK;  // slots per CTA
constexpr unsigned FULL = 0xffffffffu;

template <bool BE>
__device__ __forceinline__ int zero_bytes(uint32_t x) {
  return BE ? (__clz(static_cast<int>(x)) >> 3) : ((__ffs(static_cast<int>(x)) - 1) >> 3);
}

// Words of slots s .. s + 3 (zero past npad); `vec`: 16-byte aligned rows
// of a multiple of 4 slots.
__device__ __forceinline__ uint4 load4(const uint32_t* p, int s, int npad, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p + s));
  uint4 r;
  r.x = s < npad ? __ldg(p + s) : 0u;
  r.y = s + 1 < npad ? __ldg(p + s + 1) : 0u;
  r.z = s + 2 < npad ? __ldg(p + s + 2) : 0u;
  r.w = s + 3 < npad ? __ldg(p + s + 3) : 0u;
  return r;
}

template <int PW, bool BE>
__global__ void __launch_bounds__(BLOCK)
lcp_lags_kernel(const uint32_t* __restrict__ words, int32_t* __restrict__ out, int npad,
                int64_t plane, int lags, int vec) {
  const int lane = threadIdx.x & 31;
  const int s0 = (blockIdx.x * BLOCK + threadIdx.x) * 4;
  const uint32_t* row = words + static_cast<int64_t>(blockIdx.y) * npad;
  int32_t* orow = out + static_cast<int64_t>(blockIdx.y) * npad;
  const bool halo = lane == 0 && s0 > 0;  // lane 0 loads the 4 slots above

  // ---- lags 1 and 2: bit 4q + j of `alive` = slot j at lag q + 1 undecided
  int lcp[2][4];
  unsigned alive = 0;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lcp[q][j] = 4 * PW;
      if (q < lags && s0 + j < npad) alive |= 1u << (4 * q + j);
    }
  }
  unsigned next = __shfl_down_sync(FULL, alive, 1);
  bool need = alive != 0 || (lane < 31 && next != 0);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 cur = need ? load4(row, s0, npad, vec) : zero;
  uint4 above = halo && alive ? load4(row, s0 - 4, npad, vec) : zero;
#pragma unroll
  for (int k = 0; k < PW; ++k) {
    if (!__any_sync(FULL, need)) break;
    uint4 prev;
    prev.x = __shfl_up_sync(FULL, cur.x, 1);
    prev.y = __shfl_up_sync(FULL, cur.y, 1);
    prev.z = __shfl_up_sync(FULL, cur.z, 1);
    prev.w = __shfl_up_sync(FULL, cur.w, 1);
    if (lane == 0) prev = above;  // zero at the row start
    const uint32_t w[8] = {prev.x, prev.y, prev.z, prev.w, cur.x, cur.y, cur.z, cur.w};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned bit = 1u << (4 * q + j);
        const uint32_t x = w[4 + j] ^ w[3 + j - q];
        if ((alive & bit) && x != 0) {
          lcp[q][j] = 4 * k + zero_bytes<BE>(x);
          alive &= ~bit;
        }
      }
    }
    next = __shfl_down_sync(FULL, alive, 1);
    need = alive != 0 || (lane < 31 && next != 0);
    if (k + 1 < PW) {
      const uint32_t* pk = row + (k + 1) * plane;
      cur = need ? load4(pk, s0, npad, vec) : zero;
      above = halo && alive ? load4(pk, s0 - 4, npad, vec) : zero;
    }
  }
  if (s0 < npad) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= lags) break;
      int32_t* o = orow + q * plane;
      if (vec) {
        *reinterpret_cast<int4*>(o + s0) = make_int4(lcp[q][0], lcp[q][1], lcp[q][2], lcp[q][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (s0 + j < npad) o[s0 + j] = lcp[q][j];
        }
      }
    }
  }

  // ---- lags above 2, one at a time (no path uses them)
  for (int lag = 3; lag <= lags; ++lag) {
    for (int s = s0; s < s0 + 4 && s < npad; ++s) {
      int l = 4 * PW;
#pragma unroll
      for (int k = 0; k < PW; ++k) {
        const uint32_t a = __ldg(row + k * plane + s);
        const uint32_t x = a ^ (s >= lag ? __ldg(row + k * plane + s - lag) : 0u);
        if (x != 0) {
          l = 4 * k + zero_bytes<BE>(x);
          break;
        }
      }
      orow[(lag - 1) * plane + s] = l;
    }
  }
}

template <int PW>
void launch(bool big_endian, const uint32_t* words, int32_t* out, int rows, int npad,
            int lags, int vec, cudaStream_t stream) {
  const dim3 grid((npad + TILE - 1) / TILE, rows);
  const int64_t plane = static_cast<int64_t>(rows) * npad;
  if (big_endian) {
    lcp_lags_kernel<PW, true><<<grid, BLOCK, 0, stream>>>(words, out, npad, plane, lags, vec);
  } else {
    lcp_lags_kernel<PW, false><<<grid, BLOCK, 0, stream>>>(words, out, npad, plane, lags, vec);
  }
}

}  // namespace

// words [payload_words, rows, npad] u32 -> out [lags, rows, npad] i32, all
// lags in one launch; payload_words in 1..7.
GZP_EXPORT int gzp_lcp_lags(const void* words, void* out, int rows, int npad,
                            int payload_words, int lags, int big_endian, void* stream) {
  if (lags < 1 || payload_words < 1 || payload_words > 7 || rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || npad == 0) return 0;
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<int32_t*>(out);
  const int vec = npad % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool be = big_endian != 0;
  switch (payload_words) {
    case 1: launch<1>(be, w, o, rows, npad, lags, vec, s); break;
    case 2: launch<2>(be, w, o, rows, npad, lags, vec, s); break;
    case 3: launch<3>(be, w, o, rows, npad, lags, vec, s); break;
    case 4: launch<4>(be, w, o, rows, npad, lags, vec, s); break;
    case 5: launch<5>(be, w, o, rows, npad, lags, vec, s); break;
    case 6: launch<6>(be, w, o, rows, npad, lags, vec, s); break;
    default: launch<7>(be, w, o, rows, npad, lags, vec, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
