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
// symbol decodes; the bytes (each input read once, each output written
// once) and the integer operations per symbol are tiny beside it. So the
// design shortens what one symbol costs lane 0. One warp per stream, one
// warp per CTA (faster than 4 per CTA on the card). Lane 0 parses block
// headers and decodes; the warp builds tables and copies matches.
//   - Lookup tables per Deflate block, in the warp's shared memory: the
//     literal/length code indexed by the next kLitBits bits of the stream
//     as they come (LSB first, so no bit reversal per symbol), the
//     distance code by kDistBits, the code-length code by 7 (its lengths
//     are at most 7). An entry holds the code's length and what the symbol
//     means: a literal, the end of block, or a length or distance base
//     with its extra-bit count. The warp builds entry i by running the
//     canonical decode on a peek whose low bits are i, restricted to
//     lengths up to the table's bits; so an over- or under-subscribed code
//     gets the reference's first-length-that-fits result by construction
//     (filling each symbol's code range would not). An entry where no
//     length up to the table's bits fits is "long": lane 0 then runs the
//     canonical decode on the full 15-bit peek, exact for codes of 11-15
//     bits and for prefixes no code fits (the row fails).
//   - A register bit buffer: lane 0 keeps 64 bits of the stream and adds
//     a 4-byte word whenever 32 or fewer are left (word loads where in_cap
//     and the tensor put every row on a 4-byte boundary, byte loads
//     otherwise: two instances of the kernel), the next word loaded one
//     refill ahead. A symbol that starts at least 15 bytes before in_cap
//     is served from the buffer: the code and its length's extra bits
//     from one 32-bit window (at most 20 bits), the distance code and its
//     extra bits from a second (at most 28), each after one refill; every
//     byte it reads then lies below in_cap, so the buffer holds what the
//     reference's window holds at each field's own bit position (no clip,
//     and no byte at or past in_cap among the bits used). A symbol nearer
//     the row's end reads each field with the reference's clipped window
//     itself (`peek`), so a read past in_cap repeats the row's last byte
//     exactly as it does there.
//   - Lane 0 decodes runs of literals on its own, storing each to the
//     output, and hands over to the warp only for a match, the end of a
//     block or a failure: one shuffle for the event and its operands, one
//     for lane 0's output position. Matches are copied by the warp in
//     chunks of min(dist, 32) bytes with a __syncwarp between chunks (the
//     one before the first makes lane 0's literals visible), so an
//     overlapping copy (dist < len, an RLE run at dist 1) never reads a
//     byte not yet written; stored blocks are copied 32 bytes a step.
// The warp then zeroes the row from out_len (from the last written byte
// on a failed row).
//
// On 64 BGZF level-6 blocks of 65,280 B (tools/time_kernels.py --kernels
// K11, NVIDIA H100 80GB HBM3 at 700 W) the parent design (the canonical
// per-length loop, a 4-byte window read from device memory per field, a
// warp round trip per symbol, 4 warps per CTA) took 6.11-6.16 ms; this one
// takes 3.20-3.25 ms, about 750 cycles per symbol of the longest row: lane
// 0's decode about 400 (each instruction's latency exposed, one warp per
// SM) and, per match, about 350 in the warp's copy and 65 in the hand-over.
// Decoding one stream across lanes or warps, the output window in shared
// memory, wgmma and TMA are for a later version.
#include "common.cuh"

namespace {

constexpr int kWarps = 1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLitBits = 10;   // literal/length table: 1,024 entries
constexpr int kDistBits = 10;  // distance table: 1,024 entries
constexpr int kClBits = 7;     // code-length table: every code fits

// canonical decode structure of one code (lengths 1..15)
template <int S>
struct Huff {
  int first[16];    // first code of length l (MSB-first), l >= 1
  short count[16];  // symbols of length l
  short offset[16]; // symbols of length < l (l >= 1)
  short sym[S];     // symbols sorted by (length, symbol), lengths > 0
};

struct WarpSmem {
  uint32_t lit_tab[1 << kLitBits];
  uint32_t dist_tab[1 << kDistBits];
  uint32_t cl_tab[1 << kClBits];
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

// a table entry: the code's length in bits 0-3 (0: no code of at most the
// table's bits fits), extra bits in 4-7, kEndBit or kMatchBit (neither for a
// literal), the value (the literal, a length or distance base, a
// code-length symbol) in 16-31
constexpr uint32_t kEndBit = 0x100, kMatchBit = 0x200;

// literal/length symbol s of a code of `len` bits; 286 and 287 are
// matches of length 0 (base and extra bits 0)
__device__ __forceinline__ uint32_t lit_entry(int s, int len) {
  if (s < 256) return len | (static_cast<uint32_t>(s) << 16);
  if (s == 256) return len | kEndBit;
  const bool m = s <= 285;
  const uint32_t base = m ? kLenBase[s - 257] : 0, extra = m ? kLenExtra[s - 257] : 0;
  return len | (extra << 4) | kMatchBit | (base << 16);
}
__device__ __forceinline__ uint32_t dist_entry(int s, int len) {
  return len | (static_cast<uint32_t>(kDistExtra[s]) << 4) |
         (static_cast<uint32_t>(kDistBase[s]) << 16);
}
__device__ __forceinline__ uint32_t cl_entry(int s, int len) {
  return len | (static_cast<uint32_t>(s) << 16);
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

// Lane 0's reader of one row. `bp` is the bit position. While bp < lim
// (its byte lies at least 15 bytes below cap) a symbol is served from
// `buf`, which then holds the row's bits [bp, bp + nb) and zeros above: a
// refill at nb <= 32 adds `nxt`, the word at byte (bp + nb) / 8, and loads
// the next word; one symbol takes at most two refills, and every word
// they load lies below byte bp / 8 + 15, inside the row.
// From lim on every read is the reference's clipped window (`peek`) at its
// own bit position; bp only grows until the next `seek`, so the buffer is
// not read again before it is reloaded.
template <bool Aligned>  // the rows' words can be loaded as 4-byte words
struct Bits {
  const uint8_t* row;
  int cap;
  int lim;              // (cap - 14) * 8
  uint64_t buf;
  int nb;
  const uint8_t* next;  // the word after `nxt`: next - row == (bp + nb) / 8 + 4
  uint32_t nxt;         // the word at (bp + nb) / 8, loaded one refill ahead
  int bp;

  __device__ __forceinline__ static uint32_t word(const uint8_t* p) {
    if (Aligned) return __ldg(reinterpret_cast<const unsigned int*>(p));
    return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
           static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
  }
  __device__ __forceinline__ void seek(int p) {
    bp = p;
    int w = (p >> 3) & ~3;
    buf = 0;
    nb = 0;
    if (w + 4 <= cap) {  // always so while p < lim
      const int s = p - w * 8;
      buf = word(row + w) >> s;
      nb = 32 - s;
      w += 4;
    }
    next = row + w + 4;
    if (w + 4 <= cap) nxt = word(row + w);
  }
  // only while bp < lim (at the start of the symbol being read)
  __device__ __forceinline__ void refill() {
    if (nb <= 32) {
      buf |= static_cast<uint64_t>(nxt) << nb;
      nb += 32;
      nxt = word(next);
      next += 4;
    }
  }
  // the next 32 bits as the reference's peek gives them
  __device__ __forceinline__ uint32_t look() {
    if (bp < lim) {
      refill();
      return static_cast<uint32_t>(buf);
    }
    return peek(row, cap, bp);
  }
  __device__ __forceinline__ void skip(int n) {
    bp += n;
    buf >>= n;
    nb -= n;
  }
};

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
// l <= max_len whose MSB-first prefix lies in [first[l], first[l] +
// count[l]). Returns the symbol (and its length in `len`), or -1 if none
// fits.
template <int S>
__device__ __forceinline__ int decode(const Huff<S>& h, uint32_t pk, int& len,
                                      int max_len = 15) {
  const int p15 = static_cast<int>(__brev(pk & 0x7fffu) >> 17);
  for (int l = 1; l <= max_len; ++l) {
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

// the warp fills a table of 2^bits entries from a built code: entry i is
// the canonical decode of a peek whose low bits are i, over lengths up to
// `bits` (0 where none fits)
template <int S, typename Entry>
__device__ void fill(uint32_t* tab, int bits, const Huff<S>& h, Entry entry, int lane) {
  for (int i = lane; i < (1 << bits); i += 32) {
    int len;
    const int s = decode(h, static_cast<uint32_t>(i), len, bits);
    tab[i] = s < 0 ? 0u : entry(s, len);
  }
}

// the dynamic header of a block at `bp` up to the code-length code: HLIT,
// HDIST, HCLEN and the code-length code lengths, built into sm.cl. Returns
// false on the reference's HLIT / HDIST errors; `bp` moves past them.
__device__ __forceinline__ bool dynamic_header(WarpSmem& sm, const uint8_t* row, int in_cap,
                                               int& bp, int& hlit, int& hdist) {
  const uint32_t dh = peek(row, in_cap, bp);
  hlit = static_cast<int>(dh & 31) + 257;
  hdist = static_cast<int>((dh >> 5) & 31) + 1;
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
  return true;
}

// the code lengths of a dynamic block (after sm.cl_tab is filled), then
// its literal/length and distance codes. Returns false on any of the
// reference's errors there.
template <bool Aligned>
__device__ __forceinline__ bool code_lengths(WarpSmem& sm, Bits<Aligned>& r, int hlit, int hdist,
                                             int max_bits) {
  const int total = hlit + hdist;
  int n = 0;
  while (n < total) {
    const uint32_t pk = r.look();
    const uint32_t e = sm.cl_tab[pk & ((1u << kClBits) - 1)];
    const int clen = static_cast<int>(e & 15);
    if (clen == 0) return false;
    const int sym = static_cast<int>(e >> 16);
    const int ebits = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
    const int ev = static_cast<int>((pk >> clen) & ((1u << ebits) - 1));
    const int rep = sym < 16 ? 1 : sym == 18 ? 11 + ev : 3 + ev;
    if (sym == 16 && n == 0) return false;
    const uint8_t val = sym < 16 ? static_cast<uint8_t>(sym) : sym == 16 ? sm.lens[n - 1] : 0;
    const int stop = min(n + rep, total);
    for (; n < stop; ++n) sm.lens[n] = val;
    r.skip(clen + ebits);
    if (r.bp > max_bits) return false;
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

// events lane 0 hands to the warp (bits 0-2 of the message; a match's
// length in bits 3-11 and distance in bits 12-27; kLit stays in lane 0),
// and block kinds
enum : int { kLit = 0, kMatch = 1, kEnd = 2, kFail = 3, kStored = 4, kHuff = 5, kDynamic = 6 };

__device__ __forceinline__ uint32_t lit_lookup(const WarpSmem& sm, uint32_t pk) {
  const uint32_t e = sm.lit_tab[pk & ((1u << kLitBits) - 1)];
  if (e & 15) return e;
  int l;  // a code longer than the table's bits, or none (entry 0)
  const int s = decode(sm.lit, pk, l);
  return s < 0 ? 0u : lit_entry(s, l);
}
__device__ __forceinline__ uint32_t dist_lookup(const WarpSmem& sm, uint32_t pk) {
  const uint32_t e = sm.dist_tab[pk & ((1u << kDistBits) - 1)];
  if (e & 15) return e;
  int l;
  const int s = decode(sm.dist, pk, l);
  return s < 0 ? 0u : dist_entry(s, l);
}
__device__ __forceinline__ int extra(uint32_t pk, int shift, int bits) {
  return static_cast<int>((pk >> shift) & ((1u << bits) - 1));
}

// one symbol read the reference's way, a clipped peek per field (the code,
// its extra bits, the distance code, its extra bits): near the row's end.
// Returns decode_run's message, or kLit | byte << 3 for a literal, and the
// bit position after the symbol.
struct Step {
  int msg;
  int bp;
};
__device__ __noinline__ Step slow_symbol(const WarpSmem& sm, const uint8_t* row, int cap, int bp,
                                         int op, int out_len, int max_bits) {
  const uint32_t e = lit_lookup(sm, peek(row, cap, bp));
  const int clen = static_cast<int>(e & 15);
  if (clen == 0) return {kFail, bp};
  if ((e & (kEndBit | kMatchBit)) == 0) {
    if (op >= out_len || bp + clen > max_bits) return {kFail, bp};
    return {kLit | static_cast<int>(e >> 16) << 3, bp + clen};
  }
  if (e & kEndBit) {
    if (bp + clen > max_bits) return {kFail, bp};
    return {kEnd, bp + clen};
  }
  const int le = static_cast<int>((e >> 4) & 15);
  const int mlen = static_cast<int>(e >> 16) + extra(peek(row, cap, bp + clen), 0, le);
  const int bp2 = bp + clen + le;
  const uint32_t d = dist_lookup(sm, peek(row, cap, bp2));
  const int dl = static_cast<int>(d & 15);
  if (dl == 0) return {kFail, bp};
  const int de = static_cast<int>((d >> 4) & 15);
  const int dist = static_cast<int>(d >> 16) + extra(peek(row, cap, bp2 + dl), 0, de);
  const int bp4 = bp2 + dl + de;
  if (dist > op || op + mlen > out_len || bp4 > max_bits) return {kFail, bp};
  return {kMatch | (mlen << 3) | (dist << 12), bp4};
}

// lane 0: decode symbols of a Huffman block from `r`, storing literals,
// until a match, the end of the block or a failure; returns the message.
// A symbol starting below r.lim reads the buffer: the code and its extra
// bits from one 32-bit window (at most 20 bits), the distance code and its
// extra bits from a second (at most 28), each after a refill to 33 bits.
template <bool Aligned>
__device__ __forceinline__ int decode_run(const WarpSmem& sm, Bits<Aligned>& r, uint8_t* dst,
                                          int& op, int out_len, int out_cap, int max_bits) {
  for (;;) {
    if (__builtin_expect(r.bp >= r.lim, 0)) {
      const Step st = slow_symbol(sm, r.row, r.cap, r.bp, op, out_len, max_bits);
      r.bp = st.bp;
      if ((st.msg & 7) != kLit) return st.msg;
      if (op < out_cap) dst[op] = static_cast<uint8_t>(st.msg >> 3);
      ++op;
      continue;
    }
    r.refill();
    const uint32_t pk = static_cast<uint32_t>(r.buf);
    uint32_t e = sm.lit_tab[pk & ((1u << kLitBits) - 1)];
    if (__builtin_expect((e & 15) == 0, 0)) {
      e = lit_lookup(sm, pk);
      if (e == 0) return kFail;
    }
    const int clen = static_cast<int>(e & 15);
    if ((e & (kEndBit | kMatchBit)) == 0) {  // a literal
      if (__builtin_expect(op >= out_len || r.bp + clen > max_bits, 0)) return kFail;
      if (op < out_cap) dst[op] = static_cast<uint8_t>(e >> 16);
      ++op;
      r.skip(clen);
      continue;
    }
    if (__builtin_expect(e & kEndBit, 0)) {  // the end of the block
      if (r.bp + clen > max_bits) return kFail;
      r.skip(clen);
      return kEnd;
    }
    const int le = static_cast<int>((e >> 4) & 15);
    const int mlen = static_cast<int>(e >> 16) + extra(pk, clen, le);
    r.skip(clen + le);
    r.refill();
    const uint32_t pd = static_cast<uint32_t>(r.buf);
    uint32_t d = sm.dist_tab[pd & ((1u << kDistBits) - 1)];
    if (__builtin_expect((d & 15) == 0, 0)) {
      d = dist_lookup(sm, pd);
      if (d == 0) return kFail;
    }
    const int dl = static_cast<int>(d & 15);
    const int de = static_cast<int>((d >> 4) & 15);
    const int dist = static_cast<int>(d >> 16) + extra(pd, dl, de);
    r.skip(dl + de);
    if (dist > op || op + mlen > out_len || r.bp > max_bits) return kFail;
    return kMatch | (mlen << 3) | (dist << 12);
  }
}

template <bool Aligned>
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

  Bits<Aligned> r;  // lane 0's
  r.row = row;
  r.cap = in_cap;
  r.lim = (in_cap - 14) * 8;
  r.bp = 0;

  int op = 0;         // output position, the same in every lane at each hand-over
  bool good = true;   // the row's ok, the same in every lane
  if (out_len != 0) {
    bool done = false;
    for (int nb = 0; nb < max_blocks && !done && good; ++nb) {
      // ---- block header (lane 0) ----
      int kind = kFail, s_src = 0, s_len = 0, bfinal = 0, hlit = 0, hdist = 0;
      if (lane == 0) {
        const uint32_t hdr = peek(row, in_cap, r.bp);
        bfinal = hdr & 1;
        const int btype = (hdr >> 1) & 3;
        r.bp += 3;
        if (btype == 0) {
          const int sbyte = (r.bp + 7) >> 3;
          const uint32_t lenw = window(row, in_cap, sbyte);
          const int st_len = lenw & 0xffff;
          const int st_nlen = (lenw >> 16) & 0xffff;
          // a stored block past out_len fails the final-position rule
          // anyway (positions only grow); stop before copying it
          if ((st_len ^ 0xffff) == st_nlen && op + st_len <= out_len) {
            kind = kStored;
            s_src = sbyte + 4;
            s_len = st_len;
            r.bp = (sbyte + 4 + st_len) * 8;
          }
        } else if (btype == 1) {
          fixed_tables(sm);
          kind = kHuff;
        } else if (btype == 2) {
          if (dynamic_header(sm, row, in_cap, r.bp, hlit, hdist)) kind = kDynamic;
        }
      }
      kind = __shfl_sync(kFull, kind, 0);
      bfinal = __shfl_sync(kFull, bfinal, 0);
      if (kind == kDynamic) {
        __syncwarp();  // lane 0's code-length code is visible
        fill(sm.cl_tab, kClBits, sm.cl, cl_entry, lane);
        __syncwarp();
        if (lane == 0) {
          r.seek(r.bp);
          kind = code_lengths(sm, r, hlit, hdist, max_bits) ? kHuff : kFail;
        }
        kind = __shfl_sync(kFull, kind, 0);
      }
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
        // ---- the block's lookup tables (the warp) ----
        __syncwarp();  // lane 0's codes are visible
        fill(sm.lit_tab, kLitBits, sm.lit, lit_entry, lane);
        fill(sm.dist_tab, kDistBits, sm.dist, dist_entry, lane);
        __syncwarp();
        if (lane == 0) r.seek(r.bp);
        // ---- symbols: lane 0 decodes runs of literals, the warp copies ----
        for (;;) {
          int msg = kFail;
          if (lane == 0) msg = decode_run(sm, r, dst, op, out_len, out_cap, max_bits);
          msg = __shfl_sync(kFull, msg, 0);
          op = __shfl_sync(kFull, op, 0);
          const int ev = msg & 7;
          if (ev != kMatch) {
            if (ev == kFail) good = false;
            break;
          }
          const int len = (msg >> 3) & 511;
          const int dist = msg >> 12;
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
  // rows start on 4-byte boundaries: the reader loads words, not bytes
  // (3.14-3.16 ms against 3.29 ms with byte loads only on 64 BGZF level-6
  // blocks, tools/time_kernels.py --kernels K11, H100 80GB HBM3 at 700 W)
  const bool aligned = (in_cap & 3) == 0 && (reinterpret_cast<uintptr_t>(streams) & 3) == 0;
  const auto kernel = aligned ? inflate_kernel<true> : inflate_kernel<false>;
  const int grid = (rows + kWarps - 1) / kWarps;
  kernel<<<grid, 32 * kWarps, 0, stream>>>(streams, in_lens, out_lens, out, out_count, ok, rows,
                                           in_cap, out_cap, max_blocks);
  return static_cast<int>(cudaGetLastError());
}
