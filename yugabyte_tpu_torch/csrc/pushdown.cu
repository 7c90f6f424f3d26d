// Kernels J and K: the query pushdown's row pass and segment reduce.
//
// Replace the device work of yugabyte_tpu/ops/scan.py `_scan_filtered_fused`
// (:585) and `_scan_agg_fused` (:612) after their snapshot resolution
// (kernels G, I.1 and B): the structural tail of `_pushdown_base`
// (:522-542), `_row_pass` (:545), `_segment_any` (:435), `_doc_segments`
// (:445), `_key_byte_at` (:470), `_cmp_words` (:481), the packing of the
// filtered keep and the reductions of `_scan_agg_fused` (:651-695).
//
// Inputs: the sorted matrix s [>= 8 + w, n] u32 (kernel B's input; rows
// key_len | dkl | ... | key words), kernel B's keep bytes [n], and the
// sorted value words sv [>= 4, n] u32 (row 0 the payload byte length, rows
// 1-3 the first 12 payload bytes, big-endian).
//
// J.1 row_flags: one u32 per entry,
//   bits 0-3  slot k's predicate match (base, a 3-byte column subkey equal
//             to the slot's, an accepted payload tag, the compare true);
//   bit  4    row liveness: base and (a bare doc key or a column key);
//   bits 5-6  aggregate slot c's qualifying entry (base, its column, tag);
//   bit  7    base: kept by B, a real row, inside [lower, upper);
//   bit  8    new_doc: the dkl-masked key words differ from the previous
//             lane's (lane 0 always starts a document).
// J.2 segment_or (replaces `_segment_any`, ops/scan.py:435, called at
//     :578 and :652): bits 0-4 OR'ed over each entry's whole document
//     segment; a segment starts at new_doc (and at lane 0). The JAX function
//     runs a forward and a backward segmented-OR scan per slot; bitwise, one
//     pass serves every slot. Bound: 8 bytes an entry (the flag word in, the
//     OR out). One launch after one memset (segment_or_kernel): ticketed
//     tiles of kSegTile entries, flag words as 16-byte vectors kept as one
//     byte an entry, the forward OR by warp shuffles in registers and by
//     decoupled look-back across tiles (tile_chain.cuh; a tile holding a
//     segment start publishes its prefix at once). No backward scan across
//     tiles: a segment's OR is complete at its end, so each entry takes the
//     forward OR at the nearest end after it inside the tile. Only the head
//     (the entries before the tile's first start) needs the carry: the rest
//     is stored before the look-back is awaited. The entries after a tile's
//     last end go to a tail CTA a group of 32 tiles (later tickets), which
//     chains the nearest end beyond each tile from the last tile down. Each
//     flag word is read once (plus one halo word a warp), each output word
//     written once. On an H100, CTAs of 256 threads and tiles of 1024,
//     4096 or 8192 entries ran slower than these; a first design that put
//     a segment's writes on the CTA of its end took 1.1 ms for one segment
//     over 2^24 entries (kernel_ab.py). The design it replaces took
//     three launches: tile aggregates both ways, one CTA scanning them, a
//     re-scan of each tile, with four scalar loads a thread, a re-read of
//     the next word and Hillis-Steele scans in shared memory.
// J.3 row_pass_pack (replaces `_row_pass`'s AND over the slots and the
//     packing of `_scan_filtered_fused`, ops/scan.py:545, :606-607):
//     keep = base and the row verdict, the AND over active slots of
//     (segment bit XOR p_neg), as K takes it: one masked compare (seg &
//     need) == want. Packed little-endian as pack_bits_u32. Bound: 8 bytes
//     an entry in, n/8 out. One launch, no memset (row_pass_pack_kernel):
//     resident CTAs, grid-stride, 8 lanes a thread as two 16-byte loads of
//     each input, every load of a step in flight first, bytes into words by
//     warp shuffles, 16-byte stores. The design it replaces (about 1.5 TB/s
//     at 2^24 entries): a thread a lane, two 4-byte loads, a CTA of 256
//     lanes (65,536 CTAs), a loop over the slots' operator and negation
//     words, and one 4-byte store a warp from __ballot_sync.
// K agg_reduce (replaces the reductions of `_scan_agg_fused`, ops/scan.py:
//     612-695): rows = sum(new_doc & live & rowpass); per aggregate slot,
//     over qualifying entries of passing rows: the count, the 8 byte sums
//     of the biased int payload (u32, wrapping as jnp.sum(dtype=uint32)),
//     and min / max of the payload's (hi, lo) limbs as one u64, which
//     equals the JAX two-step (min hi, then min lo where hi == min hi).
//     Bound: 8 bytes an entry (flags, seg) plus 12 value bytes a qualifying
//     entry. One launch (agg_reduce_kernel, a template on the slot count):
//     resident CTAs, 16-byte loads, the row verdict one masked compare,
//     each CTA's partial to scratch, the last CTA (a completion ticket that
//     it resets) folding them; no init launch and no atomic on the result,
//     which is deterministic (integer sums, min and max). The design it
//     replaces: an init launch, then scalar loads into a branchy loop over
//     19 u32 and 4 u64 accumulators for every slot count and per block a
//     serial fold and up to 23 atomics.
//
// Bound on an H100: memory. J.1 reads key_len, dkl, the key words up to
// the subkey bytes (and the words a bound compare needs; the bounds:
// key_bounds.cuh), keep and the value words, and writes 4 bytes per
// entry; the first design (one lane a thread) also spent its time
// re-reading words and issuing compares, so this one keeps lanes, words
// and compares in registers (see row_flags_kernel); J.3 reads 8 bytes per
// entry and writes n/8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_bounds.cuh"
#include "tile_chain.cuh"

namespace {

using key_bounds::KeyBounds;
using tile_chain::kFull;
using tile_chain::look_back;

constexpr int kRowKeyLen = 0, kRowDkl = 1, kRowWords = 8;
constexpr uint32_t kPadSentinel = 0xFFFFFFFFu;
constexpr uint32_t kTagColumnId = 0x4B, kTagSysColumnId = 0x4A;
constexpr int kMaxPred = 4, kMaxAgg = 2, kValWords = 3;
constexpr uint32_t kLiveBit = 1u << 4, kBaseBit = 1u << 7,
                   kNewDocBit = 1u << 8, kSegBits = 0x1Fu;

constexpr int kThreads = 256;

// Predicate and aggregate operands (passed by value). p_hi / p_lo: slot
// k's compare operand as two 64-bit keys, (word 0, word 1) and (word 2,
// length biased by 2^31), so that the (words, int32 length) order is two
// unsigned compares; p_acc: the outcomes slot k's operator accepts (bit 0
// below, bit 1 equal, bit 2 above).
struct Ops {
  uint64_t p_hi[kMaxPred], p_lo[kMaxPred];
  uint32_t p_sub[kMaxPred], p_acc[kMaxPred];
  uint32_t p_ta[kMaxPred], p_tb[kMaxPred];
  uint32_t a_sub[kMaxAgg], a_ta[kMaxAgg], a_tb[kMaxAgg];
  int p, c;
};

// host operand array layout (u32), as ops/pushdown.py `_ops_array` writes
// it: p_sub, p_op, p_neg, p_tag_a, p_tag_b, p_len [kMaxPred] each, p_words
// [kMaxPred][kValWords], a_sub, a_tag_a, a_tag_b [kMaxAgg] each (J.1 reads
// no p_neg: a slot's negation is J.3's and K's, in their verdict masks)
constexpr int kOpsLen = 6 * kMaxPred + kMaxPred * kValWords + 3 * kMaxAgg;

Ops unpack_ops(const uint32_t* h, int p, int c) {
  Ops o;
  for (int k = 0; k < kMaxPred; ++k) {
    o.p_sub[k] = h[k];
    o.p_ta[k] = h[3 * kMaxPred + k];
    o.p_tb[k] = h[4 * kMaxPred + k];
    const uint32_t* words = h + 6 * kMaxPred + k * kValWords;
    o.p_hi[k] = ((uint64_t)words[0] << 32) | words[1];
    o.p_lo[k] = ((uint64_t)words[2] << 32) | (h[5 * kMaxPred + k] ^ 0x80000000u);
    // 1 =, 2 !=, 3 <, 4 <=, 5 >, else >= (ops/scan.py's operator codes)
    static const uint32_t kAccept[6] = {6u, 2u, 5u, 1u, 3u, 4u};
    const uint32_t op = h[kMaxPred + k];
    o.p_acc[k] = op < 6 ? kAccept[op] : 6u;
  }
  const int a0 = 6 * kMaxPred + kMaxPred * kValWords;
  for (int k = 0; k < kMaxAgg; ++k) {
    o.a_sub[k] = h[a0 + k];
    o.a_ta[k] = h[a0 + kMaxAgg + k];
    o.a_tb[k] = h[a0 + 2 * kMaxAgg + k];
  }
  o.p = p;
  o.c = c;
  return o;
}

__device__ __forceinline__ uint32_t at(const uint32_t* m, int64_t n, int r,
                                       int64_t i) {
  return m[(int64_t)r * n + i];
}

__device__ __forceinline__ uint32_t doc_mask(int32_t dkl, int j) {
  int nb = dkl - 4 * j;
  nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
  return nb >= 4 ? 0xFFFFFFFFu : (nb == 0 ? 0u : (0xFFFFFFFFu << ((4 - nb) * 8)));
}

constexpr int kFlagLanes = 4;                  // J.1 lanes a thread
constexpr int kFlagWarpLanes = 32 * kFlagLanes;
constexpr int kRowBatch = 2;   // key-word rows a thread loads before using

// J.1. Each thread takes 4 consecutive lanes and reads every row it needs
// as one 16-byte vector: key_len, dkl, keep (one u32), the key words only
// through the last document-key word any of its lanes needs (new_doc) or
// a word a candidate (kept by B, real) is still tied with a bound on, the
// two words holding a candidate's 3-byte subkey (one u32 each, mostly a
// cache hit), and the 4 value rows only where a base lane has a 3-byte
// subkey. The document-key rows are loaded kRowBatch at a time before any
// is used (measured on q6_agg's tensors, an H100: 2 beat 1 and 4, whose
// registers cost occupancy); the rows only a bound compare needs follow
// one at a time while a lane is tied. new_doc compares lane i with lane
// i-1 from registers: the thread's own previous lane, the previous
// thread's last lane by __shfl_up_sync, and for a warp's first lane a halo
// word loaded with its batch. Beyond word ceil(dkl/4) doc_mask is 0 on
// both sides of an equal dkl, so the compare stops there. kLo / kHi: a
// lower bound that is not empty, an upper bound that is not infinite;
// without them no bound compare runs (the empty lower bound still settles
// the lanes whose key_len is negative as int32, which the compare with an
// empty key would drop when all their words are zero). A predicate slot's
// compare is two 64-bit compares against operands packed on the host
// (Ops::p_hi, p_lo) and its operator a 3-bit accept mask. Flags leave as
// one 16-byte store.
template <bool kLo, bool kHi>
__global__ void __launch_bounds__(kThreads)
row_flags_kernel(const uint32_t* __restrict__ s, int64_t n, int w,
                 const uint8_t* __restrict__ keep,
                 const uint32_t* __restrict__ sv,
                 const __grid_constant__ KeyBounds b, int up_trunc,
                 const __grid_constant__ Ops o, uint32_t* __restrict__ flags) {
  extern __shared__ uint32_t sb[];  // lower words, then upper words
  if (kLo || kHi) key_bounds::stage(b, sb);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t step = ((int64_t)gridDim.x * kThreads >> 5) * kFlagWarpLanes;
  const bool test_vals = sv != nullptr && (o.p > 0 || o.c > 0);
  for (int64_t base0 = warp * kFlagWarpLanes; base0 < n; base0 += step) {
    const int64_t i = base0 + (int64_t)lane * kFlagLanes;
    const bool in = i < n;  // n is a multiple of 32: all 4 lanes are in
    uint32_t len[4] = {0u, 0u, 0u, 0u}, dkl[4] = {0u, 0u, 0u, 0u}, kp = 0u;
    if (in) {
      key_bounds::unpack4(key_bounds::ld4(s, n, kRowKeyLen, i), len);
      key_bounds::unpack4(key_bounds::ld4(s, n, kRowDkl, i), dkl);
      kp = __ldg(reinterpret_cast<const uint32_t*>(keep + i));
    }
    uint32_t pdkl = __shfl_up_sync(full, dkl[3], 1);
    if (lane == 0 && in && i > 0) pdkl = at(s, n, kRowDkl, i - 1);
    // per lane bits: same (dkl equal to the previous lane's, not lane 0),
    // cand (kept by B and real), len3 (cand with a 3-byte subkey),
    // negl (cand with key_len < 0 as int32)
    uint32_t same = 0u, cand = 0u, len3 = 0u, negl = 0u;
    // per lane: nd the words holding doc-key bytes, last_m the mask of the
    // last of them; wa / wb the words holding the subkey's first and last
    // byte (dkl >> 2, (dkl + 2) >> 2; -1 below the key)
    int nd[4], wa[4], wb[4];
    uint32_t last_m[4];
    int nload = 0;  // key-word rows this thread reads for new_doc
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bit = 1u << e;
      const int32_t d = (int32_t)dkl[e];
      nd[e] = d > 0 ? min(w, (d + 3) >> 2) : 0;
      last_m[e] = nd[e] > 0 ? doc_mask(d, nd[e] - 1) : 0u;
      wa[e] = wb[e] = -1;
      nload = max(nload, nd[e]);
      if (!in) continue;
      if (i + e > 0 && dkl[e] == (e ? dkl[e - 1] : pdkl)) same |= bit;
      if (((kp >> (8 * e)) & 0xFFu) && len[e] != kPadSentinel) {
        cand |= bit;
        if ((int32_t)len[e] < 0) negl |= bit;
        if ((int32_t)(len[e] - dkl[e]) == 3) {
          len3 |= bit;
          wa[e] = d >> 2;
          wb[e] = (int)(((int64_t)d + 2) >> 2);
        }
      }
    }
    // the words holding each 3-byte subkey (0 below the key or past the w
    // words)
    uint32_t sa[4] = {0u, 0u, 0u, 0u}, sz[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((len3 >> e) & 1u)) continue;
      if (wa[e] >= 0 && wa[e] < w) sa[e] = __ldg(s + (int64_t)(kRowWords + wa[e]) * n + i + e);
      if (wb[e] >= 0 && wb[e] < w)
        sz[e] = wb[e] == wa[e] ? sa[e] : __ldg(s + (int64_t)(kRowWords + wb[e]) * n + i + e);
    }
    uint32_t tie_lo = kLo ? cand : negl, tie_hi = kHi ? cand : 0u;
    uint32_t pass = cand;   // cand lanes inside [lower, upper) so far
    uint32_t diff = 0u;     // lanes whose document words differ from i-1's
    const int nload_w = (int)__reduce_max_sync(full, (unsigned)nload);
    for (int j = 0; j < nload_w; j += kRowBatch) {
      const uint32_t tied0 = (tie_lo | tie_hi) & pass;
      uint32_t vb[kRowBatch][4], halo[kRowBatch];
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        const int jj = j + q;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (jj < nload_w && (jj < nload || tied0))
          x = key_bounds::ld4(s, n, kRowWords + jj, i);
        key_bounds::unpack4(x, vb[q]);
        halo[q] = lane == 0 && (same & 1u) && jj < nd[0]
                      ? at(s, n, kRowWords + jj, i - 1) : 0u;
      }
#pragma unroll
      for (int q = 0; q < kRowBatch; ++q) {
        const int jj = j + q;
        if (jj >= nload_w) break;  // warp-uniform
        uint32_t pv = __shfl_up_sync(full, vb[q][3], 1);
        if (lane == 0) pv = halo[q];
        const uint32_t* v = vb[q];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t bit = 1u << e;
          if ((same & bit) && jj < nd[e] &&
              ((v[e] ^ (e ? v[e - 1] : pv)) &
               (jj + 1 < nd[e] ? 0xFFFFFFFFu : last_m[e])))
            diff |= bit;
        }
        const uint32_t tied = (tie_lo | tie_hi) & pass;
        if (tied)
          key_bounds::compare_row<4>(tied, vb[q], kLo ? sb[jj] : 0u,
                                     kHi ? sb[w + jj] : 0u, tie_lo, tie_hi,
                                     pass);
      }
    }
    // the words only a bound compare still needs, one row at a time
    for (int j = nload_w; j < w; ++j) {
      const uint32_t tied = (tie_lo | tie_hi) & pass;
      if (!tied) break;
      uint32_t v[4];
      key_bounds::unpack4(key_bounds::ld4(s, n, kRowWords + j, i), v);
      key_bounds::compare_row<4>(tied, v, kLo ? sb[j] : 0u,
                                 kHi ? sb[w + j] : 0u, tie_lo, tie_hi, pass);
    }
    const uint32_t tied = (tie_lo | tie_hi) & pass;
    if (tied)
      key_bounds::compare_len<4>(tied, len, kLo ? b.lo_len : 0, b.hi_len,
                                 up_trunc != 0, tie_lo, tie_hi, pass);
    const uint32_t base = cand & pass;
    // the value rows, where a base lane has a 3-byte subkey a slot may test
    uint32_t vl[4] = {0u, 0u, 0u, 0u}, v0[4] = {0u, 0u, 0u, 0u},
             v1[4] = {0u, 0u, 0u, 0u}, v2[4] = {0u, 0u, 0u, 0u};
    if (test_vals && (base & len3)) {
      key_bounds::unpack4(key_bounds::ld4(sv, n, 0, i), vl);
      key_bounds::unpack4(key_bounds::ld4(sv, n, 1, i), v0);
      key_bounds::unpack4(key_bounds::ld4(sv, n, 2, i), v1);
      key_bounds::unpack4(key_bounds::ld4(sv, n, 3, i), v2);
    }
    uint32_t f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t bit = 1u << e;
      // the subkey's 3 bytes: bytes dkl & 3 .. +2 of the two words sa:sz
      // (a byte below the key or past the w words reads 0)
      const uint64_t pair = ((uint64_t)sa[e] << 32) | sz[e];
      const uint32_t sub =
          (uint32_t)(pair >> (8 * (5 - ((int32_t)dkl[e] & 3)))) & 0xFFFFFFu;
      const uint32_t b0 = sub >> 16;
      const bool is_colkey = (len3 & bit) && (b0 == kTagColumnId || b0 == kTagSysColumnId);
      uint32_t x = 0u;
      if (base & bit) {
        x |= kBaseBit;
        if (len[e] == dkl[e] || is_colkey) x |= kLiveBit;
      }
      if (!(same & bit) || (diff & bit)) x |= kNewDocBit;
      if (test_vals && (base & len3 & bit)) {
        const uint32_t tag = v0[e] >> 24;
        const uint64_t key_hi = ((uint64_t)v0[e] << 32) | v1[e];
        const uint64_t key_lo = ((uint64_t)v2[e] << 32) | (vl[e] ^ 0x80000000u);
#pragma unroll
        for (int k = 0; k < kMaxPred; ++k) {
          const bool hit = k < o.p && sub == o.p_sub[k] &&
                           (tag == o.p_ta[k] || tag == o.p_tb[k]);
          const int cls = key_hi != o.p_hi[k] ? (key_hi < o.p_hi[k] ? 0 : 2)
                          : key_lo != o.p_lo[k] ? (key_lo < o.p_lo[k] ? 0 : 2)
                                                : 1;
          if (hit && ((o.p_acc[k] >> cls) & 1u)) x |= 1u << k;
        }
#pragma unroll
        for (int c = 0; c < kMaxAgg; ++c)
          if (c < o.c && sub == o.a_sub[c] &&
              (tag == o.a_ta[c] || tag == o.a_tb[c]))
            x |= 1u << (5 + c);
      }
      f[e] = x;
    }
    if (in) *reinterpret_cast<uint4*>(flags + i) = make_uint4(f[0], f[1], f[2], f[3]);
  }
}

// ---------------------------------------------------------------- J.2

constexpr int kSegThreads = 128;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegVec = 4;                           // 16-byte vectors a thread
constexpr int kSegWarpLanes = kSegVec * 128;         // entries a warp
constexpr int kSegTile = kSegWarps * kSegWarpLanes;  // entries a CTA

// The forward scan's element and carry, 6 bits: bits 0-4 the OR since
// the last segment start, bit 5 a start seen. Four entries' elements ride
// in one 32-bit word, a byte each.
constexpr uint32_t kFwdStart = 1u << 5;
__device__ __forceinline__ uint32_t fwd(uint32_t a, uint32_t b) {
  return (b & kFwdStart) ? b : (a | b);
}
struct SegFwd {
  __device__ static uint64_t combine(uint64_t a, uint64_t b) {
    return fwd((uint32_t)a, (uint32_t)b);
  }
};

// The backward pass: each entry takes the nearest segment end at or after
// it, as bit 5 (an end seen) and bits 0-4 (the forward OR there: the whole
// segment's OR). `near` lies before `far`; 0 is the identity.
constexpr uint32_t kBwdEnd = 1u << 5, kBwdBits = kBwdEnd | kSegBits;
__device__ __forceinline__ uint32_t nearest(uint32_t near, uint32_t far) {
  return (near & kBwdEnd) ? near : far;
}
// The same over tiles, for the tail CTAs' chain, which runs from the last
// tile down: the later element in the chain's order is the nearer tile.
struct SegNearest {
  __device__ static uint64_t combine(uint64_t far, uint64_t near) {
    return (near & kBwdEnd) ? near : far;
  }
};

// A main CTA's record for its group's tail CTA: bit 63 ready, bits 8-23 the
// tile's first entry with no segment end after it inside the tile, bits
// 0-5 the nearest end from the tile's first entry (kBwdBits).
constexpr uint64_t kRecReady = 1ull << 63;

__device__ __forceinline__ uint32_t comp(const uint4& x, int k) {
  return k == 0 ? x.x : (k == 1 ? x.y : (k == 2 ? x.z : x.w));
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return (w >> (8 * k)) & 0xFFu;
}

// An entry's forward element from its flag word: bits 0-4, new_doc as bit 5.
__device__ __forceinline__ uint32_t fwd_elem(uint32_t f) {
  return (f & kSegBits) | ((f >> 3) & kFwdStart);
}

// Warp-wide inclusive forward scan of one element a lane, in lane order.
__device__ __forceinline__ uint32_t warp_fwd(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = fwd(y, x);
  }
  return x;
}

// Warp-wide inclusive backward scan (nearest end from lane l onward).
__device__ __forceinline__ uint32_t warp_nearest(uint32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_down_sync(kFull, x, o);
    if (lane + o < 32) x = nearest(x, y);
  }
  return x;
}

// Writes val to out[a, b), as 16-byte stores where aligned (every thread
// of the CTA calls it).
__device__ __forceinline__ void fill_range(uint32_t* out, int64_t a, int64_t b,
                                           uint32_t val) {
  const int64_t up = (a + 3) & ~(int64_t)3, down = b & ~(int64_t)3;
  const int64_t a4 = up < b ? up : b, b4 = down > a4 ? down : a4;
  const int tid = threadIdx.x;
  for (int64_t i = a + tid; i < a4; i += blockDim.x) out[i] = val;
  const uint4 q = make_uint4(val, val, val, val);
  for (int64_t i = a4 + 4 * (int64_t)tid; i < b4; i += 4 * (int64_t)blockDim.x)
    *reinterpret_cast<uint4*>(out + i) = q;
  for (int64_t i = b4 + tid; i < b; i += blockDim.x) out[i] = val;
}

struct SegArgs {
  const uint32_t* flags;  // [n]
  int64_t n, tiles;
  uint64_t* fwd;          // [tiles] forward chain, zeroed
  uint64_t* tail;         // [tiles] tail chain, a word a group of 32 tiles
                          // used (the last group first), zeroed
  uint64_t* rec;          // [tiles] main CTAs' records, zeroed
  unsigned* ticket;       // zeroed
  uint32_t* out;          // [n]
};

// J.2's tail CTAs, one per group of 32 tiles (tickets after every main
// CTA's, the last group first): a tile's trailing entries with no segment
// end after them inside it take the nearest end beyond the tile. Lane l of
// warp 0 waits for tile 32 g + l's record; a shuffle scan gives each tile
// the nearest end in the group's later tiles, a look-back over the later
// groups' chain the nearest one beyond the group; then the CTA fills the
// 32 tails. Every CTA it waits on holds an earlier ticket.
__device__ void segment_or_tail(const SegArgs& a, int64_t r) {
  __shared__ uint32_t sh_start[32], sh_val[32];
  const int lane = threadIdx.x & 31;
  const int64_t groups = (a.tiles + 31) / 32;
  const int64_t g = groups - 1 - r;
  if (threadIdx.x < 32) {
    const int64_t tile = g * 32 + lane;
    uint64_t rec = 0;  // past the last tile: no end, no tail
    if (tile < a.tiles)
      do {
        rec = tile_chain::ld_relaxed(a.rec + tile);
      } while (!(rec & kRecReady));
    // the nearest end from tile 32 g + l's first entry on, inside the group
    uint32_t incl = (uint32_t)(rec & kBwdBits);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_down_sync(kFull, incl, o);
      if (lane + o < 32) incl = nearest(incl, y);
    }
    const uint32_t next = __shfl_down_sync(kFull, incl, 1);
    const uint32_t group = __shfl_sync(kFull, incl, 0);
    const uint64_t after =
        look_back<SegNearest>(a.tail, r, group, (group & kBwdEnd) != 0);
    sh_start[lane] = (uint32_t)((rec >> 8) & 0xFFFFu);
    sh_val[lane] = nearest(lane < 31 ? next : 0u, (uint32_t)after) & kSegBits;
  }
  __syncthreads();
  for (int l = 0; l < 32 && g * 32 + l < a.tiles; ++l) {
    const int64_t tbase = (g * 32 + l) * kSegTile;
    const int64_t end = tbase + kSegTile < a.n ? tbase + kSegTile : a.n;
    fill_range(a.out, tbase + sh_start[l], end, sh_val[l]);
  }
}

// Stores entry k of o (bits 0-5: kBwdEnd and the OR) OR'ed with `bits`
// at out[p + k] for each bit k of `mask`; one 16-byte store for all four.
__device__ __forceinline__ void store_entries(uint32_t* out, int64_t p,
                                              const uint32_t (&o)[4],
                                              uint32_t mask, uint32_t bits) {
  if (mask == 0xFu) {
    *reinterpret_cast<uint4*>(out + p) =
        make_uint4((o[0] & kSegBits) | bits, (o[1] & kSegBits) | bits,
                   (o[2] & kSegBits) | bits, (o[3] & kSegBits) | bits);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if ((mask >> k) & 1u) out[p + k] = (o[k] & kSegBits) | bits;
}

// J.2. One launch of tiles + ceil(tiles / 32) CTAs after one memset of
// its scratch. The first `tiles` tickets are main CTAs: each takes a tile
// of kSegTile entries; lane l of warp w holds entries w * kSegWarpLanes +
// 128 v + 4 l + k, read as 16-byte vectors and kept as one byte each. The
// forward OR (reset at each start) runs in registers, across the warp by
// shuffles and across the tile's warps through shared memory; the tile's
// aggregate is published for the look-back at once. A segment's OR is
// complete at its end, so each entry takes the forward OR at the nearest
// end at or after it inside the tile (a backward pass, the same way). Only
// the entries before the tile's first segment start (the head, whose
// segment began in an earlier tile) need the carry from earlier tiles:
// every other entry with an end is stored first, then warp 0 waits for the
// carry and the head is stored with the carry's bits OR'ed in. The entries
// after the tile's last end (their segment goes on past the tile) are left
// to the tail CTA of the tile's group, which takes a later ticket.
__global__ void __launch_bounds__(kSegThreads) segment_or_kernel(SegArgs a) {
  __shared__ uint32_t sh_fwd[kSegWarps], sh_bwd[kSegWarps];
  __shared__ uint32_t sh_carry;
  __shared__ int sh_first_start, sh_last_end;
  __shared__ unsigned sh_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    sh_tile = atomicAdd(a.ticket, 1u);
    sh_first_start = kSegTile;
    sh_last_end = -1;
  }
  __syncthreads();
  if ((int64_t)sh_tile >= a.tiles) {
    segment_or_tail(a, (int64_t)sh_tile - a.tiles);
    return;
  }
  const int64_t n = a.n;
  const uint32_t* __restrict__ flags = a.flags;
  uint32_t* __restrict__ out = a.out;
  const int64_t tile = sh_tile;
  const int64_t tbase = tile * kSegTile;
  const int64_t p0 = tbase + (int64_t)warp * kSegWarpLanes;

  // byte k of e[v]: entry k's forward element (0 past n); the entry after
  // the warp's last
  int64_t pv[kSegVec];
  uint32_t e[kSegVec];
#pragma unroll
  for (int v = 0; v < kSegVec; ++v) {
    pv[v] = p0 + v * 128 + 4 * lane;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (pv[v] + 4 <= n) {
      x = __ldg(reinterpret_cast<const uint4*>(flags + pv[v]));
    } else {
      if (pv[v] < n) x.x = __ldg(flags + pv[v]);
      if (pv[v] + 1 < n) x.y = __ldg(flags + pv[v] + 1);
      if (pv[v] + 2 < n) x.z = __ldg(flags + pv[v] + 2);
    }
    e[v] = fwd_elem(x.x) | (fwd_elem(x.y) << 8) | (fwd_elem(x.z) << 16) |
           (fwd_elem(x.w) << 24);
  }
  if (tbase == 0 && tid == 0) e[0] |= kFwdStart;  // position 0 starts
  const int64_t pnext = p0 + kSegWarpLanes;
  const uint32_t halo = (lane == 31 && pnext < n) ? __ldg(flags + pnext) : 0u;

  // bit k of em[v]: entry k ends a segment (the next one starts one, or it
  // is entry n - 1); the thread's first start and last end, from the tile's
  // first entry
  uint32_t em[kSegVec];
  int first_start = kSegTile, last_end = -1;
#pragma unroll
  for (int v = 0; v < kSegVec; ++v) {
    const uint32_t sm = ((e[v] >> 5) & 1u) | ((e[v] >> 12) & 2u) |
                        ((e[v] >> 19) & 4u) | ((e[v] >> 26) & 8u);
    const uint32_t up = __shfl_down_sync(kFull, sm, 1);
    // lane 31: the next vector's lane 0, or the halo
    const uint32_t wrap =
        v + 1 < kSegVec ? __shfl_sync(kFull, e[v + 1 < kSegVec ? v + 1 : v], 0) >> 5
                        : halo >> 8;
    em[v] = (sm >> 1) | (((lane < 31 ? up : wrap) & 1u) << 3);
    const int64_t last = n - 1 - pv[v];  // entry n - 1, from the vector
    if (last < 0)
      em[v] = 0u;
    else if (last < 4)
      em[v] = (em[v] | (1u << last)) & ((2u << last) - 1u);
    const int off = (int)(pv[v] - tbase);
    if (sm && first_start == kSegTile) first_start = off + __ffs(sm) - 1;
    if (em[v]) last_end = off + 31 - __clz(em[v]);
  }
  if (first_start < kSegTile) atomicMin(&sh_first_start, first_start);
  if (last_end >= 0) atomicMax(&sh_last_end, last_end);

  // ---- forward: the OR since the segment's start, inside the tile --------
  uint32_t r[kSegVec], incl[kSegVec], tot[kSegVec];  // r: byte k inclusive
#pragma unroll
  for (int v = 0; v < kSegVec; ++v) {
    uint32_t acc = byte_of(e[v], 0);
    r[v] = acc;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      acc = fwd(acc, byte_of(e[v], k));
      r[v] |= acc << (8 * k);
    }
    incl[v] = warp_fwd(acc);
    tot[v] = __shfl_sync(kFull, incl[v], 31);
  }
  uint32_t wt = 0u;
#pragma unroll
  for (int v = 0; v < kSegVec; ++v) wt = fwd(wt, tot[v]);
  if (lane == 0) sh_fwd[warp] = wt;
  __syncthreads();
  uint32_t run = 0u, tile_agg = 0u;
#pragma unroll
  for (int w = 0; w < kSegWarps; ++w) {
    if (w == warp) run = tile_agg;
    tile_agg = fwd(tile_agg, sh_fwd[w]);
  }
  const bool own = (tile_agg & kFwdStart) != 0;
  if (warp == 0) tile_chain::publish(a.fwd, tile, tile_agg, own);
  const int head = sh_first_start;  // entries before it need the carry
  // byte k of ov[v]: the nearest end at or after entry k inside the vector
  uint32_t ov[kSegVec];
#pragma unroll
  for (int v = 0; v < kSegVec; ++v) {
    const uint32_t le = __shfl_up_sync(kFull, incl[v], 1);
    const uint32_t pre = fwd(run, lane > 0 ? le : 0u);
    uint32_t near = 0u;
    ov[v] = 0u;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      if ((em[v] >> k) & 1u) near = kBwdEnd | (fwd(pre, byte_of(r[v], k)) & kSegBits);
      ov[v] |= near << (8 * k);
    }
    run = fwd(run, tot[v]);
  }

  // ---- backward: the nearest end past each vector -------------------------
  uint32_t bincl[kSegVec], btot[kSegVec];
#pragma unroll
  for (int v = 0; v < kSegVec; ++v) {
    bincl[v] = warp_nearest(byte_of(ov[v], 0));
    btot[v] = __shfl_sync(kFull, bincl[v], 0);
  }
  uint32_t wb = 0u;
#pragma unroll
  for (int v = kSegVec - 1; v >= 0; --v) wb = nearest(btot[v], wb);
  if (lane == 0) sh_bwd[warp] = wb;
  __syncthreads();
  uint32_t later = 0u;  // the nearest end in the tile's later warps
  for (int w = kSegWarps - 1; w > warp; --w) later = nearest(sh_bwd[w], later);
  uint32_t hm[kSegVec];  // bit k: entry k is in the head and has an end
#pragma unroll
  for (int v = kSegVec - 1; v >= 0; --v) {
    const uint32_t nx = __shfl_down_sync(kFull, bincl[v], 1);
    const uint32_t past = lane < 31 ? nearest(nx, later) : later;
    uint32_t o[4], ob = 0u, done = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = nearest(byte_of(ov[v], k), past);
      ob |= o[k] << (8 * k);
      if ((o[k] & kBwdEnd) && pv[v] + k < n) done |= 1u << k;
    }
    ov[v] = ob;  // byte k: the nearest end at or after entry k
    const int off = (int)(pv[v] - tbase);
    const uint32_t in_head =
        off >= head ? 0u : (off + 4 <= head ? 0xFu : (1u << (head - off)) - 1u);
    hm[v] = done & in_head;
    store_entries(out, pv[v], o, done & ~in_head, 0u);
    later = nearest(btot[v], later);
  }

  // ---- the head, once the carry is known -----------------------------------
  if (warp == 0 && head > 0) {
    const uint64_t c = tile_chain::wait_prefix<SegFwd>(a.fwd, tile, tile_agg, own);
    if (lane == 0) sh_carry = (uint32_t)c & kSegBits;
  }
  __syncthreads();
  const uint32_t carry = head > 0 ? sh_carry : 0u;
#pragma unroll
  for (int v = 0; v < kSegVec; ++v) {
    if (!hm[v]) continue;
    const uint32_t o[4] = {byte_of(ov[v], 0), byte_of(ov[v], 1),
                           byte_of(ov[v], 2), byte_of(ov[v], 3)};
    store_entries(out, pv[v], o, hm[v], carry);
  }
  // the record for the tail CTA: where the tile's tail starts, the nearest
  // end from the tile's first entry (with the carry's bits where that entry
  // is in the head)
  if (tid == 0) {
    uint32_t first = byte_of(ov[0], 0);
    if (first & kBwdEnd) first |= carry;
    tile_chain::st_relaxed(a.rec + tile, kRecReady |
                                             ((uint64_t)(sh_last_end + 1) << 8) |
                                             (first & kBwdBits));
  }
}

// ---------------------------------------------------------- J.3 and K

// The row verdict of J.3 and K: every active predicate slot's segment bit
// set, or clear where the slot is negated, as one masked compare (need:
// the active slots, want: those not negated; ops/pushdown.py
// verdict_masks).
__device__ __forceinline__ bool row_passes(uint32_t seg, uint32_t need,
                                           uint32_t want) {
  return (seg & need) == want;
}

constexpr int kPackThreads = 256;
constexpr int kPackLanes = 8;    // lanes a thread a block: one output byte
constexpr int kPackBlocks = 2;   // blocks of 256 lanes a warp takes a step
constexpr int kPackWarpStep = 32 * kPackLanes * kPackBlocks;  // 512 lanes
constexpr int kPackCtaStep = (kPackThreads / 32) * kPackWarpStep;

// J.3. One launch over resident CTAs, grid-stride, a warp 512 consecutive
// lanes a step as two blocks of 256: a thread's 8 consecutive lanes of a
// block are two 16-byte loads of flags and two of seg (each pair one
// 32-byte sector), all 8 loads of the step in flight before the first is
// used. Its 8 verdicts make one byte; four threads' bytes make a word
// (two xor shuffles, lane 4k + j at byte j: pack_bits_u32's little-endian
// order), and lanes 0 and 16 gather words 0-3 and 4-7 of the block (three
// down shuffles) and store them as one 16-byte vector, or word by word at
// the tail. n % 32 == 0, so a word's lanes are all below n or all past it:
// every output word is written once, with no memset.
__global__ void __launch_bounds__(kPackThreads)
row_pass_pack_kernel(const uint32_t* __restrict__ flags,
                     const uint32_t* __restrict__ seg, int64_t n,
                     uint32_t need, uint32_t want,
                     uint32_t* __restrict__ packed) {
  const int lane = threadIdx.x & 31;
  const int64_t n_words = n >> 5;
  const int64_t step = (int64_t)gridDim.x * kPackCtaStep;
  for (int64_t base = (int64_t)blockIdx.x * kPackCtaStep +
                      (int64_t)(threadIdx.x >> 5) * kPackWarpStep;
       base < n; base += step) {
    uint4 f[kPackBlocks][2], s[kPackBlocks][2];
#pragma unroll
    for (int b = 0; b < kPackBlocks; ++b) {
      const int64_t i = base + (int64_t)(b * 32 + lane) * kPackLanes;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f[b][h] = s[b][h] = make_uint4(0u, 0u, 0u, 0u);
        if (i < n) {
          f[b][h] = __ldg(reinterpret_cast<const uint4*>(flags + i) + h);
          s[b][h] = __ldg(reinterpret_cast<const uint4*>(seg + i) + h);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kPackBlocks; ++b) {
      uint32_t byte = 0u;
#pragma unroll
      for (int e = 0; e < kPackLanes; ++e) {
        const uint32_t fl = comp(f[b][e >> 2], e & 3);
        const uint32_t sg = comp(s[b][e >> 2], e & 3);
        byte |= (uint32_t)((fl & kBaseBit) != 0u && row_passes(sg, need, want))
                << e;
      }
      uint32_t word = byte << (8 * (lane & 3));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      const uint32_t w1 = __shfl_down_sync(kFull, word, 4);
      const uint32_t w2 = __shfl_down_sync(kFull, word, 8);
      const uint32_t w3 = __shfl_down_sync(kFull, word, 12);
      if ((lane & 15) == 0) {
        const int64_t wi = (base >> 5) + 8 * b + (lane >> 2);
        if (wi + 4 <= n_words) {
          *reinterpret_cast<uint4*>(packed + wi) = make_uint4(word, w1, w2, w3);
        } else {
          const uint32_t v[4] = {word, w1, w2, w3};
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (wi + k < n_words) packed[wi + k] = v[k];
        }
      }
    }
  }
}

constexpr int kAccPerSlot = 9;  // nonnull, 8 byte sums
constexpr int kAggThreads = 256;
constexpr int kAggWarps = kAggThreads / 32;

typedef unsigned long long u64;

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return b < a ? b : a; }
__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return b > a ? b : a; }

// K's accumulators over C aggregate slots: the row count, then per slot
// the nonnull count and 8 byte sums (a); per slot min and max (x).
template <int C>
struct AggAcc {
  static constexpr int kLen = 1 + kAccPerSlot * C;
  static constexpr int kExt = 2 * C > 0 ? 2 * C : 1;
  uint32_t a[kLen];
  u64 x[kExt];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int q = 0; q < kLen; ++q) a[q] = 0u;
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) x[j] = (j & 1) ? 0ull : ~0ull;
  }
  __device__ __forceinline__ void fold_ext(int j, u64 y) {
    x[j] = (j & 1) ? umax64(x[j], y) : umin64(x[j], y);
  }
};

// Folds every thread's accumulators of the CTA: thread q < kLen returns
// column q's sum in v32, thread kLen + j (j < 2C) the min (j even) or max
// of slot j / 2 in v64. Shuffles inside each warp, then one thread a column
// over the warps' results in shared memory.
template <int C>
__device__ __forceinline__ void block_fold(AggAcc<C>& t, uint32_t* sh32,
                                           u64* sh64, uint32_t& v32, u64& v64) {
  constexpr int kLen = AggAcc<C>::kLen;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < kLen; ++r) t.a[r] += __shfl_down_sync(kFull, t.a[r], off);
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) t.fold_ext(j, __shfl_down_sync(kFull, t.x[j], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kLen; ++r) sh32[warp * kLen + r] = t.a[r];
#pragma unroll
    for (int j = 0; j < 2 * C; ++j) sh64[warp * 2 * C + j] = t.x[j];
  }
  __syncthreads();
  if (q < kLen) {
    uint32_t s = 0u;
#pragma unroll
    for (int g = 0; g < kAggWarps; ++g) s += sh32[g * kLen + q];
    v32 = s;
  } else if (q < kLen + 2 * C) {
    const int j = q - kLen;
    u64 m = sh64[j];
#pragma unroll
    for (int g = 1; g < kAggWarps; ++g)
      m = (j & 1) ? umax64(m, sh64[g * 2 * C + j]) : umin64(m, sh64[g * 2 * C + j]);
    v64 = m;
  }
  __syncthreads();
}

// K. One launch over resident CTAs, grid-stride, 4 entries a thread a step:
// flags and seg as 16-byte vectors, the row verdict as one masked compare
// ((seg & need) == want), the value words as 16-byte vectors only where one
// of the thread's entries qualifies. Each CTA folds its threads and writes
// one partial; the last CTA to take the completion ticket folds the
// partials into acc / ext, zeroes the slots past C and resets the ticket.
// Integer sums, min and max: the result does not depend on the order.
template <int C>
__global__ void __launch_bounds__(kAggThreads)
agg_reduce_kernel(const uint32_t* __restrict__ flags,
                  const uint32_t* __restrict__ seg,
                  const uint32_t* __restrict__ sv, int64_t n, uint32_t need,
                  uint32_t want, unsigned* ticket, u64* part64,
                  uint32_t* part32, int c_pad, uint32_t* __restrict__ acc,
                  u64* __restrict__ ext) {
  constexpr int kLen = AggAcc<C>::kLen;
  __shared__ uint32_t sh32[kAggWarps * kLen];
  __shared__ u64 sh64[kAggWarps * AggAcc<C>::kExt];
  __shared__ bool sh_last;
  AggAcc<C> t;
  t.init();
  const int q = threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * kAggThreads * 4;
  for (int64_t i = ((int64_t)blockIdx.x * kAggThreads + q) * 4; i < n; i += step) {
    const uint4 f4 = __ldg(reinterpret_cast<const uint4*>(flags + i));
    const uint4 s4 = __ldg(reinterpret_cast<const uint4*>(seg + i));
    uint32_t qual = 0u;  // bit 4c + e: entry e qualifies for slot c
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t f = comp(f4, e), s = comp(s4, e);
      if (!row_passes(s, need, want)) continue;
      if ((f & kNewDocBit) && (s & kLiveBit)) t.a[0] += 1u;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if ((f >> (5 + c)) & 1u) qual |= 1u << (4 * c + e);
    }
    if (C > 0 && qual) {
      const uint4 w0 = key_bounds::ld4(sv, n, 1, i);
      const uint4 w1 = key_bounds::ld4(sv, n, 2, i);
      const uint4 w2 = key_bounds::ld4(sv, n, 3, i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t v0 = comp(w0, e), v1 = comp(w1, e), v2 = comp(w2, e);
        const uint32_t hi = ((v0 & 0xFFFFFFu) << 8) | (v1 >> 24);
        const uint32_t lo = (v1 << 8) | (v2 >> 24);
        const u64 x = ((u64)hi << 32) | lo;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (!((qual >> (4 * c + e)) & 1u)) continue;
          uint32_t* s = t.a + 1 + c * kAccPerSlot;
          s[0] += 1u;
          s[1] += (v0 >> 16) & 0xFFu;
          s[2] += (v0 >> 8) & 0xFFu;
          s[3] += v0 & 0xFFu;
          s[4] += v1 >> 24;
          s[5] += (v1 >> 16) & 0xFFu;
          s[6] += (v1 >> 8) & 0xFFu;
          s[7] += v1 & 0xFFu;
          s[8] += v2 >> 24;
          t.fold_ext(2 * c, x);
          t.fold_ext(2 * c + 1, x);
        }
      }
    }
  }
  uint32_t v32 = 0u;
  u64 v64 = 0ull;
  block_fold<C>(t, sh32, sh64, v32, v64);
  if (q < kLen)
    part32[(int64_t)blockIdx.x * kLen + q] = v32;
  else if (q < kLen + 2 * C)
    part64[(int64_t)blockIdx.x * 2 * C + (q - kLen)] = v64;
  __threadfence();
  __syncthreads();
  if (q == 0) {
    __threadfence();
    sh_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  t.init();
  for (int64_t g = q; g < gridDim.x; g += kAggThreads) {
#pragma unroll
    for (int r = 0; r < kLen; ++r)
      t.a[r] += *reinterpret_cast<volatile uint32_t*>(part32 + g * kLen + r);
#pragma unroll
    for (int j = 0; j < 2 * C; ++j)
      t.fold_ext(j, *reinterpret_cast<volatile u64*>(part64 + g * 2 * C + j));
  }
  block_fold<C>(t, sh32, sh64, v32, v64);
  if (q < kLen) acc[q] = v32;
  else if (q < kLen + 2 * C) ext[q - kLen] = v64;
  if (q >= kLen && q < 1 + kAccPerSlot * c_pad) acc[q] = 0u;  // slots past C
  if (q >= 2 * C && q < 2 * c_pad) ext[q] = 0ull;
  if (q == 0) *ticket = 0u;  // the next launch on this stream starts at 0
}

// J.3's grid: its CTAs resident on every SM (the occupancy counted once),
// at most one step a CTA.
unsigned pack_grid(int64_t n) {
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_pass_pack_kernel,
                                                  kPackThreads, 0);
  return key_bounds::sm_grid(per_sm, (n + kPackCtaStep - 1) / kPackCtaStep);
}

template <bool kLo, bool kHi>
int launch_row_flags(const uint32_t* s, int64_t n, int w, const uint8_t* keep,
                     const uint32_t* sv, const KeyBounds& b, int up_trunc,
                     const Ops& o, uint32_t* flags, cudaStream_t st) {
  const int64_t ctas = (n + (int64_t)kThreads * kFlagLanes - 1) /
                       ((int64_t)kThreads * kFlagLanes);
  const size_t smem = (kLo || kHi) ? 2 * sizeof(uint32_t) * (size_t)w : 0;
  static int per_sm = 0;
  static size_t per_sm_smem = 0;
  if (per_sm == 0 || per_sm_smem != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_flags_kernel<kLo, kHi>, kThreads, smem);
    per_sm_smem = smem;
  }
  row_flags_kernel<kLo, kHi>
      <<<key_bounds::sm_grid(per_sm, ctas), kThreads, smem, st>>>(
          s, n, w, keep, sv, b, up_trunc, o, flags);
  return (int)cudaGetLastError();
}

int64_t seg_tiles(int64_t n) { return (n + kSegTile - 1) / kSegTile; }

// K's grid: its CTAs resident on every SM (the occupancy counted once per
// template), at most one 4-entry step a thread.
template <int C>
unsigned agg_grid(int64_t n) {
  static int per_sm = 0;
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, agg_reduce_kernel<C>,
                                                  kAggThreads, 0);
  return key_bounds::sm_grid(per_sm, (n + 4 * kAggThreads - 1) / (4 * kAggThreads));
}

// K's scratch: the completion ticket (16 bytes), then per CTA 2 kMaxAgg
// u64 and 1 + 9 kMaxAgg u32 partials.
constexpr size_t kAggTicketBytes = 16;
constexpr size_t kAggPartBytes = 2 * kMaxAgg * sizeof(u64) + (1 + kAccPerSlot * kMaxAgg) * sizeof(uint32_t);

template <int C>
int launch_agg(const uint32_t* flags, const uint32_t* seg, const uint32_t* sv,
               int64_t n, uint32_t need, uint32_t want, uint8_t* scratch,
               int c_pad, uint32_t* acc, u64* ext, cudaStream_t st) {
  const unsigned grid = agg_grid<C>(n);
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch);
  u64* part64 = reinterpret_cast<u64*>(scratch + kAggTicketBytes);
  uint32_t* part32 = reinterpret_cast<uint32_t*>(part64 + (size_t)grid * 2 * kMaxAgg);
  agg_reduce_kernel<C><<<grid, kAggThreads, 0, st>>>(
      flags, seg, sv, n, need, want, ticket, part64, part32, c_pad, acc, ext);
  return (int)cudaGetLastError();
}

bool ops_ok(int p, int c) { return p >= 0 && p <= kMaxPred && c >= 0 && c <= kMaxAgg; }

}  // namespace

extern "C" {

int ybt_pushdown_ops_len() { return kOpsLen; }

int ybt_key_bounds_size() { return (int)sizeof(KeyBounds); }

// J.1. s: [>= 8 + w, n] u32, 16-byte aligned; keep: [n] bytes, 4-byte
// aligned; sv: [>= 4, n] u32, 16-byte aligned, or null (no value words:
// predicate and aggregate bits stay 0); bounds: a host KeyBounds (copied
// into the launch's parameters; its `dev` words, when w > kBoundCap, on the
// card); lo_empty: the lower bound is empty (length 0, zero words);
// host_ops: kOpsLen u32 on the host; flags: [n] u32 out, 16-byte aligned;
// n a multiple of 32. Returns cudaGetLastError().
int ybt_row_flags(const uint32_t* s, int64_t n, int w, const uint8_t* keep,
                  const uint32_t* sv, const KeyBounds* bounds, int lo_empty,
                  int up_inf, int up_trunc, const uint32_t* host_ops, int p,
                  int c, uint32_t* flags, void* stream) {
  if (n <= 0 || n % 32 != 0 || w <= 0 || !ops_ok(p, c) || bounds == nullptr ||
      bounds->w != w || (w > key_bounds::kBoundCap && bounds->dev == nullptr) ||
      2 * sizeof(uint32_t) * (size_t)w > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const Ops o = unpack_ops(host_ops, p, c);
  cudaStream_t st = (cudaStream_t)stream;
  if (!lo_empty && !up_inf)
    return launch_row_flags<true, true>(s, n, w, keep, sv, *bounds, up_trunc, o, flags, st);
  if (!lo_empty)
    return launch_row_flags<true, false>(s, n, w, keep, sv, *bounds, up_trunc, o, flags, st);
  if (!up_inf)
    return launch_row_flags<false, true>(s, n, w, keep, sv, *bounds, up_trunc, o, flags, st);
  return launch_row_flags<false, false>(s, n, w, keep, sv, *bounds, up_trunc, o, flags, st);
}

// J.2's tile (ops/pushdown.py SEGMENT_OR_TILE mirrors it).
int ybt_segment_or_tile() { return kSegTile; }

// J.2. flags, out: [n] u32, 16-byte aligned; scratch: 3 tiles + 1 u64,
// 8-byte aligned (per tile a forward status word, a tail status word (one
// a group of 32 tiles is used) and a record, then the ticket), zeroed
// here. One memset and one launch;
// returns cudaGetLastError().
int ybt_segment_or(const uint32_t* flags, int64_t n, uint8_t* scratch,
                   uint32_t* out, void* stream) {
  if (n <= 0 || n > 0x7FFFFFFF || reinterpret_cast<uintptr_t>(flags) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 8)
    return (int)cudaErrorInvalidValue;
  SegArgs a;
  a.flags = flags;
  a.n = n;
  a.tiles = seg_tiles(n);
  a.fwd = reinterpret_cast<uint64_t*>(scratch);
  a.tail = a.fwd + a.tiles;
  a.rec = a.tail + a.tiles;
  a.ticket = reinterpret_cast<unsigned*>(a.rec + a.tiles);
  a.out = out;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(3 * a.tiles + 1) * sizeof(uint64_t), st);
  if (e != cudaSuccess) return (int)e;
  segment_or_kernel<<<(unsigned)(a.tiles + (a.tiles + 31) / 32), kSegThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// J.3. flags, seg: [n] u32, 16-byte aligned; need / want: a row passes
// when (seg & need) == want (ops/pushdown.py verdict_masks); packed: [n /
// 32] u32 out, 16-byte aligned; n a multiple of 32. One launch, no memset;
// returns cudaGetLastError().
int ybt_row_pass_pack(const uint32_t* flags, const uint32_t* seg, int64_t n,
                      uint32_t need, uint32_t want, uint32_t* packed,
                      void* stream) {
  if (n <= 0 || n % 32 != 0 || reinterpret_cast<uintptr_t>(flags) % 16 ||
      reinterpret_cast<uintptr_t>(seg) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  row_pass_pack_kernel<<<pack_grid(n), kPackThreads, 0, (cudaStream_t)stream>>>(
      flags, seg, n, need, want, packed);
  return (int)cudaGetLastError();
}

// Bytes of K's scratch on the current device: the ticket, then the
// largest grid's partials. The caller keeps one zeroed buffer a stream;
// every launch leaves its ticket at 0.
int64_t ybt_agg_reduce_scratch_bytes() {
  const int64_t big = (int64_t)1 << 40;
  unsigned g = agg_grid<0>(big);
  if (agg_grid<1>(big) > g) g = agg_grid<1>(big);
  if (agg_grid<2>(big) > g) g = agg_grid<2>(big);
  return (int64_t)(kAggTicketBytes + (size_t)g * kAggPartBytes);
}

// K. flags, seg: [n] u32; sv: [>= 4, n] u32 (may be null when c == 0); all
// 16-byte aligned, n a multiple of 4; need / want: a row passes when
// (seg & need) == want (ops/pushdown.py verdict_masks); scratch: see above;
// acc: [1 + 9 c_pad] u32 out (rows, then per slot nonnull and 8 byte sums);
// ext: [2 c_pad] u64 out (per slot min, max; slots >= c are 0). One launch;
// returns cudaGetLastError().
int ybt_agg_reduce(const uint32_t* flags, const uint32_t* seg,
                   const uint32_t* sv, int64_t n, uint32_t need, uint32_t want,
                   int c, int c_pad, uint8_t* scratch, uint32_t* acc,
                   unsigned long long* ext, void* stream) {
  if (n <= 0 || n % 4 != 0 || c < 0 || c_pad < c || c_pad > kMaxAgg ||
      (c > 0 && sv == nullptr) || reinterpret_cast<uintptr_t>(flags) % 16 ||
      reinterpret_cast<uintptr_t>(seg) % 16 ||
      reinterpret_cast<uintptr_t>(sv) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (c == 0)
    return launch_agg<0>(flags, seg, sv, n, need, want, scratch, c_pad, acc, ext, st);
  if (c == 1)
    return launch_agg<1>(flags, seg, sv, n, need, want, scratch, c_pad, acc, ext, st);
  return launch_agg<2>(flags, seg, sv, n, need, want, scratch, c_pad, acc, ext, st);
}

}  // extern "C"
