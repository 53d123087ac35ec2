// K10: pre-placement pass of the sort-scan DEFLATE bit packer.
//
// Replaces the Pallas kernel `_kernel` (gzp_tpu/ops/pack_pallas.py:65,
// wrapper `pack_prescan_pallas` :171). Entries are (value < 2^31, width
// 0..31) pairs; entry E (one past the last) is a zero-width tail entry and
// entries past it are padding up to Ep. Per row:
//   bitpos[i] = base_bits + sum(width[0..i)); w = bitpos >> 5
//   lo = value << (bitpos & 31); hi = the bits of the value past the word
//   flush[i] = entry i completes word w; start[i] = flush[i-1] or i == 0
//   val[i] = OR of (lo | (start ? hi[i-1] : 0)) since the last start
//   key[i] = w where flush (and at the tail entry when its word is partial),
//            else 0xFFFFFFFF
// plus total_bits = base_bits + sum(width). The caller places val[i] at
// word key[i].
//
// Bound on the card: memory. It reads 8 bytes and writes 8 bytes per
// entry. Design: one CTA per row walks the row in 1024-entry tiles; each
// tile runs two CTA scans (warp shuffles, then one warp over the 32 warp
// totals): an add-scan of widths and a segmented OR-scan. The running
// width sum, the previous entry's (flush, hi) and the OR-scan prefix carry
// from one tile to the next in registers. Only B CTAs run; a decoupled
// look-back scan over several CTAs per row is later work.
#include "common.cuh"

namespace {

struct AddOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

// (value, reset) packed as value | reset << 32; op(a, b) with a earlier:
// b's value if b holds a segment start, else a's value OR b's.
struct SegOrOp {
  __device__ unsigned long long operator()(unsigned long long a,
                                           unsigned long long b) const {
    const unsigned long long reset = (a | b) & (1ull << 32);
    const uint32_t v = (b >> 32) ? static_cast<uint32_t>(b)
                                 : static_cast<uint32_t>(a) | static_cast<uint32_t>(b);
    return reset | v;
  }
};

__global__ void __launch_bounds__(SCAN_BLOCK)
pack_prescan_kernel(const uint32_t* __restrict__ bits,
                    const int32_t* __restrict__ nbits, uint32_t* __restrict__ key,
                    uint32_t* __restrict__ val, int32_t* __restrict__ total_bits,
                    int e, int ep, int base_bits) {
  __shared__ int add_scratch[SCAN_WARPS];
  __shared__ unsigned long long or_scratch[SCAN_WARPS];
  __shared__ uint32_t tile_flush[SCAN_BLOCK];
  __shared__ uint32_t tile_hi[SCAN_BLOCK];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const uint32_t* vrow = bits + static_cast<int64_t>(b) * e;
  const int32_t* nrow = nbits + static_cast<int64_t>(b) * e;
  uint32_t* krow = key + static_cast<int64_t>(b) * ep;
  uint32_t* orow = val + static_cast<int64_t>(b) * ep;

  int width_before = 0;           // sum of widths of earlier tiles
  uint32_t prev_flush = 1;        // entry 0 starts a segment
  uint32_t prev_hi = 0;
  unsigned long long prefix = 0;  // OR-scan aggregate of earlier tiles

  for (int ts = 0; ts < ep; ts += SCAN_BLOCK) {
    const int i = ts + t;
    uint32_t v = 0;
    int nb = 0;
    if (i < e) {
      v = vrow[i];
      nb = nrow[i];
    }
    int tile_width;
    const int csum = width_before + block_inclusive_scan(nb, AddOp(), add_scratch, tile_width);
    width_before += tile_width;

    const int bitpos = base_bits + csum - nb;
    const uint32_t cnt = static_cast<uint32_t>(bitpos) & 31u;
    const uint32_t w = static_cast<uint32_t>(bitpos >> 5);
    const uint32_t lo = v << cnt;
    const uint32_t hi = (v >> (31u - cnt)) >> 1;
    const bool flush = static_cast<uint32_t>((bitpos + nb) >> 5) > w;

    tile_flush[t] = flush;
    tile_hi[t] = hi;
    __syncthreads();
    const bool start = t == 0 ? prev_flush != 0 : tile_flush[t - 1] != 0;
    const uint32_t hi_prev = t == 0 ? prev_hi : tile_hi[t - 1];
    const uint32_t c = lo | (start ? hi_prev : 0u);
    prev_flush = tile_flush[SCAN_BLOCK - 1];
    prev_hi = tile_hi[SCAN_BLOCK - 1];
    // the scan's barriers order these reads before the next tile's writes

    unsigned long long tile_or;
    const unsigned long long s = block_inclusive_scan(
        static_cast<unsigned long long>(c) | (start ? (1ull << 32) : 0ull),
        SegOrOp(), or_scratch, tile_or);
    const uint32_t value = static_cast<uint32_t>(SegOrOp()(prefix, s));
    prefix = SegOrOp()(prefix, tile_or);

    uint32_t k = flush ? w : 0xFFFFFFFFu;
    if (i == e) k = (bitpos & 31) ? w : 0xFFFFFFFFu;  // partial tail word
    if (i > e) k = 0xFFFFFFFFu;
    if (i < ep) {
      krow[i] = k;
      orow[i] = value;
    }
  }
  if (t == 0) total_bits[b] = base_bits + width_before;
}

}  // namespace

// bits [rows, e] u32; nbits [rows, e] i32 -> key, val [rows, ep] u32,
// total_bits [rows] i32
GZP_EXPORT int gzp_pack_prescan(const void* bits, const void* nbits, void* key,
                                void* val, void* total_bits, int rows, int e,
                                int ep, int base_bits, void* stream) {
  if (ep <= e) return static_cast<int>(cudaErrorInvalidValue);
  pack_prescan_kernel<<<rows, SCAN_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(nbits),
      static_cast<uint32_t*>(key), static_cast<uint32_t*>(val),
      static_cast<int32_t*>(total_bits), e, ep, base_bits);
  return static_cast<int>(cudaGetLastError());
}
