// K11: batched DEFLATE decode of independent raw streams, one warp each.
//
// Replaces `inflate_blocks` (gzp_tpu/ops/inflate_kernel.py:139, jitted with
// its CRC by `get_inflater` :390): XLA there, a lockstep while-loop over
// the batch, not a Pallas kernel. Input: B streams [B, in_cap] u8 with
// in_len and out_len per row (out_len is the member's ISIZE). Output:
// out [B, out_cap] u8 (the decoded bytes, zero from out_len on), out_count
// [B] int32 (output position at the end; meaningful where ok) and ok [B].
//
// `ok` decides which blocks ParDecompress(backend='device') hands to the
// host codec, so it follows the reference's rules exactly (line numbers in
// gzp_tpu/ops/inflate_kernel.py). A row with out_len == 0 is ok at once
// and decodes nothing (:377, done from the start). Otherwise ok is false on
//   - btype 3 (:197);
//   - a stored block whose LEN ^ 0xFFFF != NLEN (:205-207);
//   - HLIT > 286 or HDIST > 30 (:223-225);
//   - a code-length code, literal/length code or distance code not found
//     by the canonical decode (:246, :314, :323);
//   - code-length repeat 16 as the first code length (:254);
//   - a bit position past in_len * 8 after any code-length code (:264),
//     or after any literal/length symbol: a literal, an end of block or a
//     whole match with its extra bits (:344-348);
//   - a match distance past the output position (:330);
//   - an output position past out_len after any symbol (:344-348);
//   - no block with BFINAL within max_blocks blocks (:365-370, :386);
//   - a final output position other than out_len (:387).
// Nothing else is checked: a stored block may run past in_len (it reads
// the row as it lies, :209-211) or past out_len (caught by the last rule),
// code-length repeats are cut at HLIT + HDIST (:260), and over- or
// under-subscribed codes decode by the same first-length-that-fits rule
// (:108-131). Literal/length symbols 286 and 287 of the fixed code are
// matches of length 0 (their base and extra bits are 0, :43-58). Every
// read of the stream takes the 32-bit little-endian window at byte
// min(bitpos / 8, in_cap - 1), bytes at or past in_cap read as 0, shifted
// right by bitpos % 8 (:157-161); a stored block reads byte
// min(pos, in_cap - 1) (:209).
//
// Bound on the card: per stream the decode is serial, a chain of dependent
// bit reads; the bytes (each input read once, each output written once)
// and the integer operations per symbol are tiny beside it. Design, right
// before fast: one warp per stream, 4 warps per CTA. Lane 0 parses block
// headers, builds each block's canonical decode tables (count, first code
// and offset per length, symbols sorted by length) in the warp's shared
// memory and decodes one symbol at a time; it broadcasts each literal or
// match to the warp. Literals are stored by lane 0; matches are copied by
// the warp in chunks of min(dist, 32) bytes with a __syncwarp between
// chunks, so an overlapping copy (dist < len, an RLE run at dist 1) never
// reads a byte not yet written; stored blocks are copied 32 bytes a step.
// The warp then zeroes the row from out_len (from the last written byte
// on a failed row). Decoding a stream across lanes or warps, wgmma and TMA
// are for a later version.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

// canonical decode structure of one code (lengths 1..15)
template <int S>
struct Huff {
  int first[16];    // first code of length l (MSB-first), l >= 1
  short count[16];  // symbols of length l
  short offset[16]; // symbols of length < l (l >= 1)
  short sym[S];     // symbols sorted by (length, symbol), lengths > 0
};

struct WarpSmem {
  Huff<288> lit;
  Huff<32> dist;
  Huff<19> cl;
  uint8_t lens[320];
};

__constant__ short kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                                   15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                                   67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                      2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
__constant__ int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                                  17,   25,   33,   49,   65,   97,    129,   193,
                                  257,  385,  513,  769,  1025, 1537,  2049,  3073,
                                  4097, 6145, 8193, 12289, 16385, 24577};
__constant__ uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                       6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
__constant__ uint8_t kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                     11, 4, 12, 3, 13, 2, 14, 1, 15};

// length symbol s (257..287) -> base and extra bits; 286, 287 -> 0, 0
__device__ __forceinline__ int len_base(int s) {
  return (s >= 257 && s <= 285) ? kLenBase[s - 257] : 0;
}
__device__ __forceinline__ int len_extra(int s) {
  return (s >= 257 && s <= 285) ? kLenExtra[s - 257] : 0;
}

// 32-bit little-endian window at byte min(byte, cap - 1), zero past cap
__device__ __forceinline__ uint32_t window(const uint8_t* row, int cap, int byte) {
  const int c = min(byte, cap - 1);
  uint32_t w = row[c];
  if (c + 1 < cap) w |= static_cast<uint32_t>(row[c + 1]) << 8;
  if (c + 2 < cap) w |= static_cast<uint32_t>(row[c + 2]) << 16;
  if (c + 3 < cap) w |= static_cast<uint32_t>(row[c + 3]) << 24;
  return w;
}

__device__ __forceinline__ uint32_t peek(const uint8_t* row, int cap, int bitpos) {
  return window(row, cap, bitpos >> 3) >> (bitpos & 7);
}

template <int S>
__device__ void build(Huff<S>& h, const uint8_t* lens, int n) {
  for (int l = 0; l < 16; ++l) h.count[l] = 0;
  for (int s = 0; s < n; ++s) h.count[lens[s]]++;
  h.first[1] = 0;
  h.offset[1] = 0;
  for (int l = 2; l < 16; ++l) {
    h.first[l] = (h.first[l - 1] + h.count[l - 1]) << 1;
    h.offset[l] = h.offset[l - 1] + h.count[l - 1];
  }
  short next[16];
  for (int l = 1; l < 16; ++l) next[l] = h.offset[l];
  for (int s = 0; s < n; ++s) {
    const int l = lens[s];
    if (l) h.sym[next[l]++] = static_cast<short>(s);
  }
}

// canonical decode of the next code from a peeked window: the first length
// l whose MSB-first prefix lies in [first[l], first[l] + count[l]).
// Returns the symbol (and its length in `len`), or -1 if none fits.
template <int S>
__device__ __forceinline__ int decode(const Huff<S>& h, uint32_t pk, int& len) {
  const int p15 = static_cast<int>(__brev(pk & 0x7fffu) >> 17);
  for (int l = 1; l < 16; ++l) {
    const int c = h.count[l];
    const int prefix = p15 >> (15 - l);
    const int lo = h.first[l];
    if (c > 0 && prefix >= lo && prefix < lo + c) {
      len = l;
      return h.sym[h.offset[l] + prefix - lo];
    }
  }
  len = 0;
  return -1;
}

// the dynamic header of a block at `bp`: the code-length code, the code
// lengths, then the literal/length and distance tables. Returns false on
// any of the reference's header errors; `bp` moves past the header.
__device__ bool dynamic_tables(WarpSmem& sm, const uint8_t* row, int in_cap, int max_bits,
                               int& bp) {
  const uint32_t dh = peek(row, in_cap, bp);
  const int hlit = static_cast<int>(dh & 31) + 257;
  const int hdist = static_cast<int>((dh >> 5) & 31) + 1;
  const int hclen = static_cast<int>((dh >> 10) & 15) + 4;
  bp += 14;
  if (hlit > 286 || hdist > 30) return false;
  uint8_t cl[19];
  for (int i = 0; i < 19; ++i) cl[i] = 0;
  for (int i = 0; i < hclen; ++i) {
    cl[kClOrder[i]] = static_cast<uint8_t>(peek(row, in_cap, bp) & 7);
    bp += 3;
  }
  build(sm.cl, cl, 19);
  const int total = hlit + hdist;
  int n = 0;
  while (n < total) {
    const uint32_t pk = peek(row, in_cap, bp);
    int clen;
    const int sym = decode(sm.cl, pk, clen);
    if (sym < 0) return false;
    const int ebits = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
    const int ev = static_cast<int>((pk >> clen) & ((1u << ebits) - 1));
    const int rep = sym < 16 ? 1 : sym == 18 ? 11 + ev : 3 + ev;
    if (sym == 16 && n == 0) return false;
    const uint8_t val = sym < 16 ? static_cast<uint8_t>(sym) : sym == 16 ? sm.lens[n - 1] : 0;
    const int stop = min(n + rep, total);
    for (; n < stop; ++n) sm.lens[n] = val;
    bp += clen + ebits;
    if (bp > max_bits) return false;
  }
  build(sm.lit, sm.lens, hlit);  // symbols >= HLIT have length 0
  build(sm.dist, sm.lens + hlit, hdist);
  return true;
}

__device__ void fixed_tables(WarpSmem& sm) {
  for (int s = 0; s < 288; ++s) sm.lens[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
  build(sm.lit, sm.lens, 288);
  for (int s = 0; s < 30; ++s) sm.lens[s] = 5;
  build(sm.dist, sm.lens, 30);
}

// events lane 0 hands to the warp
enum : int { kLit = 0, kMatch = 1, kEnd = 2, kFail = 3, kStored = 4, kHuff = 5 };

__global__ void __launch_bounds__(32 * kWarps)
inflate_kernel(const uint8_t* __restrict__ streams, const int* __restrict__ in_lens,
               const int* __restrict__ out_lens, uint8_t* __restrict__ out,
               int* __restrict__ out_count, uint8_t* __restrict__ ok, int rows, int in_cap,
               int out_cap, int max_blocks) {
  __shared__ WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= rows) return;  // the whole warp leaves together
  WarpSmem& sm = smem[warp];
  const uint8_t* row = streams + static_cast<int64_t>(b) * in_cap;
  uint8_t* dst = out + static_cast<int64_t>(b) * out_cap;
  const int in_len = in_lens[b];
  const int out_len = out_lens[b];
  const int max_bits = in_len * 8;

  int op = 0;         // output position, the same in every lane
  int bp = 0;         // bit position, lane 0's
  bool good = true;   // the row's ok, the same in every lane
  if (out_len != 0) {
    bool done = false;
    for (int nb = 0; nb < max_blocks && !done && good; ++nb) {
      // ---- block header (lane 0) ----
      int kind = kFail, s_src = 0, s_len = 0, bfinal = 0;
      if (lane == 0) {
        const uint32_t hdr = peek(row, in_cap, bp);
        bfinal = hdr & 1;
        const int btype = (hdr >> 1) & 3;
        bp += 3;
        if (btype == 0) {
          const int sbyte = (bp + 7) >> 3;
          const uint32_t lenw = window(row, in_cap, sbyte);
          const int st_len = lenw & 0xffff;
          const int st_nlen = (lenw >> 16) & 0xffff;
          // a stored block past out_len fails the final-position rule
          // anyway (positions only grow); stop before copying it
          if ((st_len ^ 0xffff) == st_nlen && op + st_len <= out_len) {
            kind = kStored;
            s_src = sbyte + 4;
            s_len = st_len;
            bp = (sbyte + 4 + st_len) * 8;
          }
        } else if (btype == 1) {
          fixed_tables(sm);
          kind = kHuff;
        } else if (btype == 2) {
          if (dynamic_tables(sm, row, in_cap, max_bits, bp)) kind = kHuff;
        }
      }
      kind = __shfl_sync(kFull, kind, 0);
      bfinal = __shfl_sync(kFull, bfinal, 0);
      if (kind == kFail) {
        good = false;
        break;
      }
      if (kind == kStored) {
        s_src = __shfl_sync(kFull, s_src, 0);
        s_len = __shfl_sync(kFull, s_len, 0);
        for (int k = lane; k < s_len; k += 32) {
          const int p = op + k;
          if (p < out_cap) dst[p] = row[min(s_src + k, in_cap - 1)];
        }
        op += s_len;
      } else {
        // ---- symbols: lane 0 decodes, the warp writes ----
        for (;;) {
          int ev = kFail, a = 0, dist = 0;
          if (lane == 0) {
            int clen;
            const int sym = decode(sm.lit, peek(row, in_cap, bp), clen);
            const int bp1 = bp + clen;
            if (sym < 0) {
              ev = kFail;
            } else if (sym < 256) {
              if (op + 1 <= out_len && bp1 <= max_bits) {
                ev = kLit;
                a = sym;
                bp = bp1;
              }
            } else if (sym == 256) {
              if (bp1 <= max_bits) {
                ev = kEnd;
                bp = bp1;
              }
            } else {
              const int le = len_extra(sym);
              const int mlen = len_base(sym) +
                               static_cast<int>(peek(row, in_cap, bp1) & ((1u << le) - 1));
              const int bp2 = bp1 + le;
              int dbits;
              const int dsym = decode(sm.dist, peek(row, in_cap, bp2), dbits);
              if (dsym >= 0) {
                const int bp3 = bp2 + dbits;
                const int de = kDistExtra[dsym];
                const int d = kDistBase[dsym] +
                              static_cast<int>(peek(row, in_cap, bp3) & ((1u << de) - 1));
                const int bp4 = bp3 + de;
                if (d <= op && op + mlen <= out_len && bp4 <= max_bits) {
                  ev = kMatch;
                  a = mlen;
                  dist = d;
                  bp = bp4;
                }
              }
            }
            if (ev == kLit && op < out_cap) dst[op] = static_cast<uint8_t>(a);
          }
          ev = __shfl_sync(kFull, ev, 0);
          if (ev == kLit) {
            op += 1;
          } else if (ev == kMatch) {
            const int len = __shfl_sync(kFull, a, 0);
            dist = __shfl_sync(kFull, dist, 0);
            const int w = min(dist, 32);
            __syncwarp();  // lane 0's literals and the last copy are visible
            for (int c = 0; c < len; c += w) {
              const int k = c + lane;
              if (lane < w && k < len) {
                const int p = op + k;
                if (p < out_cap) dst[p] = dst[p - dist];
              }
              __syncwarp();
            }
            op += len;
          } else {
            if (ev == kFail) good = false;
            break;
          }
        }
      }
      __syncwarp();
      if (good && bfinal) done = true;
    }
    if (!done || op != out_len) good = false;
  }
  // ---- the row's tail: zero from out_len (from the last byte written on a
  // failed row, so no byte of the row is left unwritten) ----
  __syncwarp();
  for (int p = min(min(op, out_len), out_cap) + lane; p < out_cap; p += 32) dst[p] = 0;
  if (lane == 0) {
    out_count[b] = op;
    ok[b] = good ? 1 : 0;
  }
}

}  // namespace

GZP_EXPORT int gzp_inflate(const uint8_t* streams, const int* in_lens, const int* out_lens,
                           uint8_t* out, int* out_count, uint8_t* ok, int rows, int in_cap,
                           int out_cap, int max_blocks, cudaStream_t stream) {
  const int grid = (rows + kWarps - 1) / kWarps;
  inflate_kernel<<<grid, 32 * kWarps, 0, stream>>>(streams, in_lens, out_lens, out, out_count,
                                                    ok, rows, in_cap, out_cap, max_blocks);
  return static_cast<int>(cudaGetLastError());
}
