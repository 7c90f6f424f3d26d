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
// the subkey bytes, keep and the value words, and writes 4 bytes per
// entry; J.2 reads and writes 4 bytes per entry (plus a 16-byte aggregate
// pair per 1024 entries); J.3 reads 8 bytes per entry and writes n/8; K
// reads 8 bytes per entry plus 12 value bytes per qualifying entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Predicate and aggregate operands (passed by value).
struct Ops {
  uint32_t p_sub[kMaxPred], p_op[kMaxPred], p_neg[kMaxPred];
  uint32_t p_ta[kMaxPred], p_tb[kMaxPred], p_words[kMaxPred][kValWords];
  int32_t p_len[kMaxPred];
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
    o.p_len[k] = (int32_t)h[5 * kMaxPred + k];
    for (int j = 0; j < kValWords; ++j)
      o.p_words[k][j] = h[6 * kMaxPred + k * kValWords + j];
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

// Byte of the packed big-endian key at byte offset off; 0 outside the w
// words (scan.py:470).
__device__ __forceinline__ uint32_t key_byte_at(const uint32_t* s, int64_t n,
                                                int w, int64_t i, int32_t off) {
  if (off < 0 || (off >> 2) >= w) return 0u;
  return (at(s, n, kRowWords + (off >> 2), i) >> ((3 - (off & 3)) * 8)) & 0xFFu;
}

// (key < bound, key == bound) over (key words, key_len as int32).
__device__ void cmp_key(const uint32_t* s, int64_t n, int w, int64_t i,
                        const uint32_t* bw, int32_t blen, bool& lt, bool& eq) {
  for (int j = 0; j < w; ++j) {
    const uint32_t x = at(s, n, kRowWords + j, i);
    if (x != bw[j]) {
      lt = x < bw[j];
      eq = false;
      return;
    }
  }
  const int32_t len = (int32_t)at(s, n, kRowKeyLen, i);
  lt = len < blen;
  eq = len == blen;
}

__global__ void row_flags_kernel(const uint32_t* __restrict__ s, int64_t n,
                                 int w, const uint8_t* __restrict__ keep,
                                 const uint32_t* __restrict__ sv,
                                 const uint32_t* __restrict__ bounds,
                                 int32_t lo_len, int32_t hi_len, int up_inf,
                                 int up_trunc, Ops o,
                                 uint32_t* __restrict__ flags) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t len_u = at(s, n, kRowKeyLen, i);
  const int32_t len = (int32_t)len_u;
  const int32_t dkl = (int32_t)at(s, n, kRowDkl, i);
  bool lo_lt, lo_eq, hi_lt, hi_eq;
  cmp_key(s, n, w, i, bounds, lo_len, lo_lt, lo_eq);
  cmp_key(s, n, w, i, bounds + w, hi_len, hi_lt, hi_eq);
  const bool in_hi = up_inf || (up_trunc ? (hi_lt || hi_eq) : hi_lt);
  const bool base = keep[i] && len_u != kPadSentinel && !lo_lt && in_hi;
  bool new_doc = true;
  if (i > 0) {
    const int32_t pdkl = (int32_t)at(s, n, kRowDkl, i - 1);
    bool same = dkl == pdkl;
    for (int j = 0; j < w && same; ++j)
      same = (at(s, n, kRowWords + j, i) & doc_mask(dkl, j)) ==
             (at(s, n, kRowWords + j, i - 1) & doc_mask(pdkl, j));
    new_doc = !same;
  }
  const int32_t sub_len = (int32_t)(len_u - (uint32_t)dkl);
  const uint32_t b0 = key_byte_at(s, n, w, i, dkl);
  const uint32_t b1 = key_byte_at(s, n, w, i, dkl + 1);
  const uint32_t b2 = key_byte_at(s, n, w, i, dkl + 2);
  const uint32_t sub3 = (b0 << 16) | (b1 << 8) | b2;
  const bool is_len3 = sub_len == 3;
  const bool is_colkey = is_len3 && (b0 == kTagColumnId || b0 == kTagSysColumnId);
  uint32_t f = 0;
  if (base && (len == dkl || is_colkey)) f |= kLiveBit;
  if (base) f |= kBaseBit;
  if (new_doc) f |= kNewDocBit;
  if (sv != nullptr && base && is_len3) {
    const int32_t v_len = (int32_t)at(sv, n, 0, i);
    uint32_t v[kValWords];
    for (int j = 0; j < kValWords; ++j) v[j] = at(sv, n, 1 + j, i);
    const uint32_t tag = v[0] >> 24;
    for (int k = 0; k < o.p; ++k) {
      if (sub3 != o.p_sub[k] || (tag != o.p_ta[k] && tag != o.p_tb[k])) continue;
      bool lt = false, eq = true;
      for (int j = 0; j < kValWords && eq; ++j) {
        if (v[j] != o.p_words[k][j]) {
          lt = v[j] < o.p_words[k][j];
          eq = false;
        }
      }
      if (eq) {
        lt = v_len < o.p_len[k];
        eq = v_len == o.p_len[k];
      }
      bool m;
      switch (o.p_op[k]) {
        case 1: m = eq; break;
        case 2: m = !eq; break;
        case 3: m = lt; break;
        case 4: m = lt || eq; break;
        case 5: m = !(lt || eq); break;
        default: m = !lt; break;
      }
      if (m) f |= 1u << k;
    }
    for (int c = 0; c < o.c; ++c)
      if (sub3 == o.a_sub[c] && (tag == o.a_ta[c] || tag == o.a_tb[c]))
        f |= 1u << (5 + c);
  }
  flags[i] = f;
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
int64_t num_tiles(int64_t n) { return (n + kChunk - 1) / kChunk; }
size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

bool ops_ok(int p, int c) { return p >= 0 && p <= kMaxPred && c >= 0 && c <= kMaxAgg; }

}  // namespace

extern "C" {

int ybt_pushdown_ops_len() { return kOpsLen; }

// J.1. s: [>= 8 + w, n] u32; keep: [n] bytes; sv: [>= 4, n] u32 or null
// (no value words: predicate and aggregate bits stay 0); bounds: [2, w]
// u32 (lower words, then upper words) on the device; host_ops: kOpsLen
// u32 on the host; flags: [n] u32 out. Returns cudaGetLastError().
int ybt_row_flags(const uint32_t* s, int64_t n, int w, const uint8_t* keep,
                  const uint32_t* sv, const uint32_t* bounds, int lo_len,
                  int hi_len, int up_inf, int up_trunc, const uint32_t* host_ops,
                  int p, int c, uint32_t* flags, void* stream) {
  if (n <= 0 || w <= 0 || !ops_ok(p, c)) return (int)cudaErrorInvalidValue;
  row_flags_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      s, n, w, keep, sv, bounds, lo_len, hi_len, up_inf, up_trunc,
      unpack_ops(host_ops, p, c), flags);
  return (int)cudaGetLastError();
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
