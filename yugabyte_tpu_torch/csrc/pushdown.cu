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
// J.2 segment_or: bits 0-4 OR'ed over each entry's whole document segment.
//     The JAX function runs a forward and a backward segmented-OR scan per
//     slot; bitwise, one pair of scans serves every slot. Segments may span
//     any number of 1024-entry tiles, so this is kernel B's cross-tile
//     pattern (csrc/gc_pack.cu): per tile a forward and a backward
//     aggregate, one CTA scans the tile aggregates in both directions, and
//     each tile re-scans its entries from its two carries (three launches).
// J.3 row_pass_pack: rowpass = AND over active slots of (segment bit XOR
//     p_neg); keep = base and rowpass, packed little-endian by
//     __ballot_sync as pack_bits_u32.
// K agg_reduce: rows = sum(new_doc & live & rowpass); per aggregate slot,
//     over qualifying entries of passing rows: the count, the 8 byte sums
//     of the biased int payload (u32, wrapping as jnp.sum(dtype=uint32)),
//     and min / max of the payload's (hi, lo) limbs as one u64, which
//     equals the JAX two-step (min hi, then min lo where hi == min hi). A
//     block reduction, then integer atomics: the result is deterministic.
//
// Bound on an H100: memory. J.1 reads key_len, dkl, the key words up to
// the subkey bytes (and the words a bound compare needs; the bounds:
// key_bounds.cuh), keep and the value words, and writes 4 bytes per
// entry; the first design (one lane a thread) also spent its time
// re-reading words and issuing compares, so this one keeps lanes, words
// and compares in registers (see row_flags_kernel); J.2 reads and writes 4 bytes per entry (plus a 16-byte aggregate
// pair per 1024 entries); J.3 reads 8 bytes per entry and writes n/8; K
// reads 8 bytes per entry plus 12 value bytes per qualifying entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_bounds.cuh"

namespace {

using key_bounds::KeyBounds;

constexpr int kRowKeyLen = 0, kRowDkl = 1, kRowWords = 8;
constexpr uint32_t kPadSentinel = 0xFFFFFFFFu;
constexpr uint32_t kTagColumnId = 0x4B, kTagSysColumnId = 0x4A;
constexpr int kMaxPred = 4, kMaxAgg = 2, kValWords = 3;
constexpr uint32_t kLiveBit = 1u << 4, kBaseBit = 1u << 7,
                   kNewDocBit = 1u << 8, kSegBits = 0x1Fu;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;  // entries per tile of J.2
constexpr int kScanThreads = 1024;

// Predicate and aggregate operands (passed by value). p_hi / p_lo: slot
// k's compare operand as two 64-bit keys, (word 0, word 1) and (word 2,
// length biased by 2^31), so that the (words, int32 length) order is two
// unsigned compares; p_acc: the outcomes slot k's operator accepts (bit 0
// below, bit 1 equal, bit 2 above).
struct Ops {
  uint64_t p_hi[kMaxPred], p_lo[kMaxPred];
  uint32_t p_sub[kMaxPred], p_op[kMaxPred], p_neg[kMaxPred], p_acc[kMaxPred];
  uint32_t p_ta[kMaxPred], p_tb[kMaxPred];
  uint32_t a_sub[kMaxAgg], a_ta[kMaxAgg], a_tb[kMaxAgg];
  int p, c;
};

// host operand array layout (u32), as ops/pushdown.py `_ops_array` writes
// it: p_sub, p_op, p_neg, p_tag_a, p_tag_b, p_len [kMaxPred] each, p_words
// [kMaxPred][kValWords], a_sub, a_tag_a, a_tag_b [kMaxAgg] each
constexpr int kOpsLen = 6 * kMaxPred + kMaxPred * kValWords + 3 * kMaxAgg;

Ops unpack_ops(const uint32_t* h, int p, int c) {
  Ops o;
  for (int k = 0; k < kMaxPred; ++k) {
    o.p_sub[k] = h[k];
    o.p_op[k] = h[kMaxPred + k];
    o.p_neg[k] = h[2 * kMaxPred + k];
    o.p_ta[k] = h[3 * kMaxPred + k];
    o.p_tb[k] = h[4 * kMaxPred + k];
    const uint32_t* words = h + 6 * kMaxPred + k * kValWords;
    o.p_hi[k] = ((uint64_t)words[0] << 32) | words[1];
    o.p_lo[k] = ((uint64_t)words[2] << 32) | (h[5 * kMaxPred + k] ^ 0x80000000u);
    // 1 =, 2 !=, 3 <, 4 <=, 5 >, else >= (ops/scan.py's operator codes)
    static const uint32_t kAccept[6] = {6u, 2u, 5u, 1u, 3u, 4u};
    o.p_acc[k] = o.p_op[k] < 6 ? kAccept[o.p_op[k]] : 6u;
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

struct Agg {  // segmented OR: (a segment boundary seen, OR since it)
  uint32_t r, v;
  __device__ static Agg identity() { return {0u, 0u}; }
  __device__ static Agg combine(const Agg& a, const Agg& b) {
    return {a.r | b.r, b.r ? b.v : (a.v | b.v)};
  }
};

// Exclusive scan of one value per thread across the CTA (Hillis-Steele in
// shared memory), in thread order or in reverse thread order. `total`
// receives the combine of all values.
__device__ Agg block_exclusive_scan(Agg v, Agg* sh, Agg& total, bool rev) {
  const int t = rev ? (int)blockDim.x - 1 - (int)threadIdx.x : (int)threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const Agg x = t >= off ? sh[t - off] : Agg::identity();
    __syncthreads();
    if (t >= off) sh[t] = Agg::combine(x, sh[t]);
    __syncthreads();
  }
  const Agg excl = t > 0 ? sh[t - 1] : Agg::identity();
  total = sh[blockDim.x - 1];
  __syncthreads();
  return excl;
}

// One thread's kItems entries: the OR'ed bits, starts (new_doc) and ends
// (the next entry starts a document, or the last entry).
struct Items {
  uint32_t x[kItems];
  bool st[kItems], en[kItems];
  int cnt;
};

__device__ Items load_items(const uint32_t* flags, int64_t n, int64_t base) {
  Items it;
  it.cnt = 0;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    it.x[k] = 0;
    it.st[k] = it.en[k] = false;
    if (i >= n) continue;
    const uint32_t f = flags[i];
    it.x[k] = f & kSegBits;
    it.st[k] = (f & kNewDocBit) != 0;
    it.en[k] = i == n - 1 || (flags[i + 1] & kNewDocBit) != 0;
    it.cnt = k + 1;
  }
  return it;
}

__global__ void seg_reduce(const uint32_t* __restrict__ flags, int64_t n,
                           Agg* agg_f, Agg* agg_r) {
  __shared__ Agg sh[kThreads];
  const Items it = load_items(flags, n, (int64_t)blockIdx.x * kChunk +
                                            threadIdx.x * kItems);
  Agg f = Agg::identity(), r = Agg::identity();
  for (int k = 0; k < it.cnt; ++k) f = Agg::combine(f, Agg{it.st[k], it.x[k]});
  for (int k = it.cnt - 1; k >= 0; --k) r = Agg::combine(r, Agg{it.en[k], it.x[k]});
  Agg tf, tr;
  block_exclusive_scan(f, sh, tf, false);
  block_exclusive_scan(r, sh, tr, true);
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = tf;
    agg_r[blockIdx.x] = tr;
  }
}

// Exclusive scan of the tile aggregates by one CTA, forward or backward.
__device__ void carry_scan(const Agg* agg, Agg* carry, int64_t nb, bool rev,
                           Agg* sh) {
  const int64_t per = (nb + kScanThreads - 1) / kScanThreads;
  const int64_t s0 = threadIdx.x * per;
  const int64_t s1 = s0 + per < nb ? s0 + per : nb;
  Agg acc = Agg::identity();
  for (int64_t q = s0; q < s1; ++q) acc = Agg::combine(acc, agg[rev ? nb - 1 - q : q]);
  Agg total;
  Agg run = block_exclusive_scan(acc, sh, total, false);
  for (int64_t q = s0; q < s1; ++q) {
    const int64_t b = rev ? nb - 1 - q : q;
    carry[b] = run;
    run = Agg::combine(run, agg[b]);
  }
}

__global__ void seg_carry(const Agg* agg_f, const Agg* agg_r, Agg* carry_f,
                          Agg* carry_r, int64_t nb) {
  __shared__ Agg sh[kScanThreads];
  carry_scan(agg_f, carry_f, nb, false, sh);
  carry_scan(agg_r, carry_r, nb, true, sh);
}

__global__ void seg_apply(const uint32_t* __restrict__ flags, int64_t n,
                          const Agg* carry_f, const Agg* carry_r,
                          uint32_t* __restrict__ out) {
  __shared__ Agg sh[kThreads];
  const int64_t base = (int64_t)blockIdx.x * kChunk + threadIdx.x * kItems;
  const Items it = load_items(flags, n, base);
  Agg f = Agg::identity(), r = Agg::identity();
  for (int k = 0; k < it.cnt; ++k) f = Agg::combine(f, Agg{it.st[k], it.x[k]});
  for (int k = it.cnt - 1; k >= 0; --k) r = Agg::combine(r, Agg{it.en[k], it.x[k]});
  Agg tf, tr;
  Agg run_f = Agg::combine(carry_f[blockIdx.x], block_exclusive_scan(f, sh, tf, false));
  Agg run_r = Agg::combine(carry_r[blockIdx.x], block_exclusive_scan(r, sh, tr, true));
  uint32_t fwd[kItems];
  for (int k = 0; k < it.cnt; ++k) {
    run_f = Agg::combine(run_f, Agg{it.st[k], it.x[k]});
    fwd[k] = run_f.v;
  }
  for (int k = it.cnt - 1; k >= 0; --k) {
    run_r = Agg::combine(run_r, Agg{it.en[k], it.x[k]});
    out[base + k] = fwd[k] | run_r.v;
  }
}

// ---------------------------------------------------------- J.3 and K

__device__ __forceinline__ bool row_pass(uint32_t seg, const Ops& o) {
  bool pass = true;
  for (int k = 0; k < o.p; ++k)
    if (o.p_op[k] != 0) pass = pass && ((((seg >> k) & 1u) != 0) != (o.p_neg[k] != 0));
  return pass;
}

__global__ void row_pass_pack_kernel(const uint32_t* __restrict__ flags,
                                     const uint32_t* __restrict__ seg,
                                     int64_t n, Ops o,
                                     uint32_t* __restrict__ packed) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool k = false;
  if (i < n) k = (flags[i] & kBaseBit) && row_pass(seg[i], o);
  const unsigned bits = __ballot_sync(0xffffffffu, k);
  if ((threadIdx.x & 31) == 0 && i < n) packed[i >> 5] = bits;
}

constexpr int kAccPerSlot = 9;  // nonnull, 8 byte sums
constexpr int kAccLen = 1 + kMaxAgg * kAccPerSlot;
constexpr int kReduceBlocks = 1024;

__global__ void agg_init(uint32_t* acc, unsigned long long* ext, int c_pad,
                         int c) {
  const int t = threadIdx.x;
  if (t < 1 + c_pad * kAccPerSlot) acc[t] = 0u;
  if (t < c_pad) {
    ext[2 * t] = t < c ? ~0ull : 0ull;
    ext[2 * t + 1] = 0ull;
  }
}

__global__ void agg_reduce_kernel(const uint32_t* __restrict__ flags,
                                  const uint32_t* __restrict__ seg,
                                  const uint32_t* __restrict__ sv, int64_t n,
                                  Ops o, uint32_t* acc,
                                  unsigned long long* ext) {
  uint32_t a[kAccLen];
  unsigned long long mn[kMaxAgg], mx[kMaxAgg];
  for (int q = 0; q < kAccLen; ++q) a[q] = 0u;
  for (int c = 0; c < kMaxAgg; ++c) {
    mn[c] = ~0ull;
    mx[c] = 0ull;
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint32_t f = flags[i], sg = seg[i];
    if (!row_pass(sg, o)) continue;
    if ((f & kNewDocBit) && (sg & kLiveBit)) a[0] += 1u;
#pragma unroll
    for (int c = 0; c < kMaxAgg; ++c) {
      if (c >= o.c || !((f >> (5 + c)) & 1u)) continue;
      const uint32_t v0 = at(sv, n, 1, i), v1 = at(sv, n, 2, i), v2 = at(sv, n, 3, i);
      const uint32_t hi = ((v0 & 0xFFFFFFu) << 8) | (v1 >> 24);
      const uint32_t lo = (v1 << 8) | (v2 >> 24);
      const unsigned long long x = ((unsigned long long)hi << 32) | lo;
      uint32_t* s = a + 1 + c * kAccPerSlot;
      s[0] += 1u;
      s[1] += (v0 >> 16) & 0xFFu;
      s[2] += (v0 >> 8) & 0xFFu;
      s[3] += v0 & 0xFFu;
      s[4] += v1 >> 24;
      s[5] += (v1 >> 16) & 0xFFu;
      s[6] += (v1 >> 8) & 0xFFu;
      s[7] += v1 & 0xFFu;
      s[8] += v2 >> 24;
      mn[c] = x < mn[c] ? x : mn[c];
      mx[c] = x > mx[c] ? x : mx[c];
    }
  }
  // warp, then block, then one set of atomics per block
  for (int off = 16; off > 0; off >>= 1) {
    for (int q = 0; q < kAccLen; ++q) a[q] += __shfl_down_sync(0xffffffffu, a[q], off);
    for (int c = 0; c < kMaxAgg; ++c) {
      const unsigned long long y = __shfl_down_sync(0xffffffffu, mn[c], off);
      const unsigned long long z = __shfl_down_sync(0xffffffffu, mx[c], off);
      mn[c] = y < mn[c] ? y : mn[c];
      mx[c] = z > mx[c] ? z : mx[c];
    }
  }
  __shared__ uint32_t sa[kThreads / 32][kAccLen];
  __shared__ unsigned long long smn[kThreads / 32][kMaxAgg], smx[kThreads / 32][kMaxAgg];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    for (int q = 0; q < kAccLen; ++q) sa[warp][q] = a[q];
    for (int c = 0; c < kMaxAgg; ++c) {
      smn[warp][c] = mn[c];
      smx[warp][c] = mx[c];
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int q = 0; q < 1 + o.c * kAccPerSlot; ++q) {
    uint32_t t = 0;
    for (int g = 0; g < kThreads / 32; ++g) t += sa[g][q];
    if (t) atomicAdd(acc + q, t);
  }
  for (int c = 0; c < o.c; ++c) {
    unsigned long long lo = ~0ull, hi = 0ull;
    for (int g = 0; g < kThreads / 32; ++g) {
      lo = smn[g][c] < lo ? smn[g][c] : lo;
      hi = smx[g][c] > hi ? smx[g][c] : hi;
    }
    if (lo != ~0ull) atomicMin(ext + 2 * c, lo);
    if (hi != 0ull) atomicMax(ext + 2 * c + 1, hi);
  }
}

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

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
int64_t num_tiles(int64_t n) { return (n + kChunk - 1) / kChunk; }
size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

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

// Scratch bytes J.2 needs over n entries.
int64_t ybt_segment_or_scratch_bytes(int64_t n) {
  return (int64_t)(4 * align16(num_tiles(n) * sizeof(Agg)));
}

// J.2. flags, out: [n] u32. Three launches; returns cudaGetLastError().
int ybt_segment_or(const uint32_t* flags, int64_t n, uint8_t* scratch,
                   uint32_t* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nb = num_tiles(n);
  const size_t step = align16(nb * sizeof(Agg));
  Agg* agg_f = reinterpret_cast<Agg*>(scratch);
  Agg* agg_r = reinterpret_cast<Agg*>(scratch + step);
  Agg* carry_f = reinterpret_cast<Agg*>(scratch + 2 * step);
  Agg* carry_r = reinterpret_cast<Agg*>(scratch + 3 * step);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  seg_reduce<<<(unsigned)nb, kThreads, 0, st>>>(flags, n, agg_f, agg_r);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  seg_carry<<<1, kScanThreads, 0, st>>>(agg_f, agg_r, carry_f, carry_r, nb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  seg_apply<<<(unsigned)nb, kThreads, 0, st>>>(flags, n, carry_f, carry_r, out);
  return (int)cudaGetLastError();
}

// J.3. flags, seg: [n] u32; packed: [n / 32] u32 out; n a multiple of 32.
int ybt_row_pass_pack(const uint32_t* flags, const uint32_t* seg, int64_t n,
                      const uint32_t* host_ops, int p, uint32_t* packed,
                      void* stream) {
  if (n <= 0 || n % 32 != 0 || !ops_ok(p, 0)) return (int)cudaErrorInvalidValue;
  row_pass_pack_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      flags, seg, n, unpack_ops(host_ops, p, 0), packed);
  return (int)cudaGetLastError();
}

// K. flags, seg: [n] u32; sv: [>= 4, n] u32 (may be null when c == 0);
// acc: [1 + 9 * c_pad] u32 out (rows, then per slot nonnull and 8 byte
// sums); ext: [2 * c_pad] u64 out (per slot min, max; slots >= c are 0).
int ybt_agg_reduce(const uint32_t* flags, const uint32_t* seg,
                   const uint32_t* sv, int64_t n, const uint32_t* host_ops,
                   int p, int c, int c_pad, uint32_t* acc,
                   unsigned long long* ext, void* stream) {
  if (n <= 0 || !ops_ok(p, c) || c_pad < c || c_pad > kMaxAgg ||
      (c > 0 && sv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  agg_init<<<1, 32, 0, st>>>(acc, ext, c_pad, c);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < kReduceBlocks ? want : kReduceBlocks);
  agg_reduce_kernel<<<blocks, kThreads, 0, st>>>(flags, seg, sv, n,
                                                 unpack_ops(host_ops, p, c), acc, ext);
  return (int)cudaGetLastError();
}

}  // extern "C"
