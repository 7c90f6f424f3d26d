// Kernel B: MVCC GC over the merged matrix, fused with decision packing.
//
// Replaces the XLA program that follows the Pallas tournament in the JAX
// package: yugabyte_tpu/ops/merge_gc.py `gc_over_sorted` (:85) +
// `pack_bits_u32` (:306) + the packing of yugabyte_tpu/ops/pallas_merge.py
// (:313-320).
//
// Input: the merged payload [rp, n] u32 (rows 0..7+w: key_len | dkl | ht_hi |
// ht_lo | write_id | flags | ttl_hi | ttl_lo | key words, merge_gc.py:37-39)
// and the perm row (run-major input index of each merged position).
// Output: packed u32 [n/32, 2+b] (col 0 keep bits, col 1 make-tombstone
// bits, cols 2.. bit t of perm >> log2(m)), little-endian within a word as
// pack_bits_u32, plus keep/make-tombstone as one byte per position.
//
// Two quantities are segmented scans whose segments span blocks:
//   scan 1: "a version <= cutoff was seen earlier in this full-key
//            segment" (merge_gc.py:132-138) -> visible_slot;
//   scan 2: the root-overwrite (ht, write_id) of the last visible root
//            write in this document segment (merge_gc.py:152-168).
// Scan 2 needs scan 1's result, so the kernel runs in five launches:
//   gc_mark     per position: segment starts, cutoff test, TTL expiry (two
//               32/20-bit limbs, no int64), flag bits -> one byte; per-block
//               aggregate of scan 1
//   scan_carry  one CTA scans the block aggregates -> carry into each block
//   gc_visible  applies scan 1 -> visible; per-block aggregate of scan 2
//   scan_carry  the same for scan 2
//   gc_final    applies scan 2 -> covered; keep / make-tombstone / pad mask;
//               packs 32 consecutive positions per warp with __ballot_sync
// Every position's decision matches the JAX function bit for bit: both
// scans are associative "reset at segment start" combines, evaluated
// sequentially inside a thread, by a shared-memory scan across the CTA and
// by the carry across CTAs.
//
// Bound on an H100: memory. The function must read the 8+w payload rows it
// uses and the perm row once and write the packed words and two bytes per
// position; the extra traffic of this design is the flag byte written once
// and read twice, plus the ht/write_id rows re-read only where a root
// overwrite is in play.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowKeyLen = 0, kRowDkl = 1, kRowHtHi = 2, kRowHtLo = 3,
              kRowWid = 4, kRowFlags = 5, kRowTtlHi = 6, kRowTtlLo = 7,
              kRowWords = 8;
constexpr uint32_t kFlagTombstone = 1, kFlagHasTtl = 4;
constexpr uint32_t kPadSentinel = 0xFFFFFFFFu;

// per-position flag byte
constexpr uint8_t kC = 1, kNewSeg = 2, kNewDoc = 4, kRoot = 8, kExpired = 16,
                  kTomb = 32, kPad = 64, kVisible = 128;

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;  // positions per CTA
constexpr int kScanThreads = 1024;

struct Agg1 {  // scan 1: (segment start seen, any c since the last start)
  uint32_t r, v;
  __device__ static Agg1 identity() { return {0u, 0u}; }
  __device__ static Agg1 combine(const Agg1& a, const Agg1& b) {
    return {a.r | b.r, b.r ? b.v : (a.v | b.v)};
  }
};

struct Agg2 {  // scan 2: last valid (ht_hi, ht_lo, wid) since a doc start
  uint32_t r, v, hi, lo, wid;
  __device__ static Agg2 identity() { return {0u, 0u, 0u, 0u, 0u}; }
  __device__ static Agg2 combine(const Agg2& a, const Agg2& b) {
    if (b.v) return {a.r | b.r, 1u, b.hi, b.lo, b.wid};
    if (b.r) return {1u, 0u, 0u, 0u, 0u};
    return a;
  }
};

struct Args {
  const uint32_t* s;     // [rows, n]
  const uint32_t* perm;  // [n]
  int64_t n;
  int w;
  uint32_t cut_hi, cut_lo, cphys_hi, cphys_lo;
  int is_major, retain_deletes, snapshot;
  int log2m, b;
  uint8_t* bits;  // [n]
  Agg1* agg1;     // [nb]
  Agg1* carry1;   // [nb]
  Agg2* agg2;     // [nb]
  Agg2* carry2;   // [nb]
  uint32_t* packed;  // [n/32, 2+b]
  uint8_t* keep;     // [n]
  uint8_t* mk;       // [n]
};

// Exclusive scan of one value per thread across the CTA (Hillis-Steele in
// shared memory). `total` receives the combine of all values.
template <class A>
__device__ A block_exclusive_scan(A v, A* sh, A& total) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    A x = t >= off ? sh[t - off] : A::identity();
    __syncthreads();
    if (t >= off) sh[t] = A::combine(x, sh[t]);
    __syncthreads();
  }
  A excl = t > 0 ? sh[t - 1] : A::identity();
  total = sh[blockDim.x - 1];
  __syncthreads();
  return excl;
}

__device__ __forceinline__ uint32_t doc_mask(int dkl, int j) {
  int nb = dkl - 4 * j;
  nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
  return nb >= 4 ? 0xFFFFFFFFu : (nb == 0 ? 0u : (0xFFFFFFFFu << ((4 - nb) * 8)));
}

__device__ __forceinline__ uint32_t row(const Args& a, int r, int64_t i) {
  return a.s[(int64_t)r * a.n + i];
}

__global__ void gc_mark(Args a) {
  __shared__ Agg1 sh[kThreads];
  const int64_t base = (int64_t)blockIdx.x * kChunk + threadIdx.x * kItems;
  Agg1 acc = Agg1::identity();
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i >= a.n) break;
    const int len = (int)row(a, kRowKeyLen, i);
    const int dkl = (int)row(a, kRowDkl, i);
    const uint32_t hi = row(a, kRowHtHi, i), lo = row(a, kRowHtLo, i);
    const uint32_t fl = row(a, kRowFlags, i);
    bool new_seg = true, new_doc = true;
    if (i > 0) {
      const int plen = (int)row(a, kRowKeyLen, i - 1);
      const int pdkl = (int)row(a, kRowDkl, i - 1);
      bool same_key = len == plen, same_doc = dkl == pdkl;
      for (int j = 0; j < a.w; ++j) {
        const uint32_t x = row(a, kRowWords + j, i);
        const uint32_t px = row(a, kRowWords + j, i - 1);
        same_key = same_key && x == px;
        same_doc = same_doc && (x & doc_mask(dkl, j)) == (px & doc_mask(pdkl, j));
      }
      new_seg = !same_key;
      new_doc = !same_doc;
    }
    const bool c = hi < a.cut_hi || (hi == a.cut_hi && lo <= a.cut_lo);
    bool expired = false;
    if (fl & kFlagHasTtl) {
      uint32_t sum_lo = (lo >> 12) + row(a, kRowTtlLo, i);
      const uint32_t carry = sum_lo >> 20;
      const uint32_t sum_hi = hi + row(a, kRowTtlHi, i) + carry;
      sum_lo &= 0xFFFFFu;
      expired = sum_hi < a.cphys_hi || (sum_hi == a.cphys_hi && sum_lo <= a.cphys_lo);
    }
    uint8_t f = 0;
    f |= c ? kC : 0;
    f |= new_seg ? kNewSeg : 0;
    f |= new_doc ? kNewDoc : 0;
    f |= len == dkl ? kRoot : 0;
    f |= expired ? kExpired : 0;
    f |= (fl & kFlagTombstone) ? kTomb : 0;
    f |= (uint32_t)len == kPadSentinel ? kPad : 0;
    a.bits[i] = f;
    acc = Agg1::combine(acc, Agg1{new_seg ? 1u : 0u, c ? 1u : 0u});
  }
  Agg1 total;
  block_exclusive_scan(acc, sh, total);
  if (threadIdx.x == 0) a.agg1[blockIdx.x] = total;
}

template <class A>
__global__ void scan_carry(const A* agg, A* carry, int64_t nb) {
  __shared__ A sh[kScanThreads];
  const int64_t per = (nb + kScanThreads - 1) / kScanThreads;
  const int64_t s0 = threadIdx.x * per;
  const int64_t s1 = s0 + per < nb ? s0 + per : nb;
  A acc = A::identity();
  for (int64_t i = s0; i < s1; ++i) acc = A::combine(acc, agg[i]);
  A total;
  A run = block_exclusive_scan(acc, sh, total);
  for (int64_t i = s0; i < s1; ++i) {
    carry[i] = run;
    run = A::combine(run, agg[i]);
  }
}

__global__ void gc_visible(Args a) {
  __shared__ Agg1 sh1[kThreads];
  __shared__ Agg2 sh2[kThreads];
  const int64_t base = (int64_t)blockIdx.x * kChunk + threadIdx.x * kItems;
  uint8_t f[kItems];
  Agg1 acc = Agg1::identity();
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    f[k] = i < a.n ? a.bits[i] : 0;
    if (i < a.n)
      acc = Agg1::combine(acc, Agg1{(f[k] & kNewSeg) ? 1u : 0u,
                                    (f[k] & kC) ? 1u : 0u});
  }
  Agg1 total1;
  Agg1 run = Agg1::combine(a.carry1[blockIdx.x],
                           block_exclusive_scan(acc, sh1, total1));
  Agg2 acc2 = Agg2::identity();
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    if (i >= a.n) break;
    const bool seen_before = !(f[k] & kNewSeg) && run.v;
    const bool visible = (f[k] & kC) && !seen_before;
    run = Agg1::combine(run, Agg1{(f[k] & kNewSeg) ? 1u : 0u,
                                  (f[k] & kC) ? 1u : 0u});
    if (visible) {
      f[k] |= kVisible;
      a.bits[i] = f[k];
    }
    const bool ov = visible && (f[k] & kRoot);
    Agg2 e = {(f[k] & kNewDoc) ? 1u : 0u, 0u, 0u, 0u, 0u};
    if (ov) {
      e.v = 1u;
      e.hi = row(a, kRowHtHi, i);
      e.lo = row(a, kRowHtLo, i);
      e.wid = row(a, kRowWid, i);
    }
    acc2 = Agg2::combine(acc2, e);
  }
  Agg2 total2;
  block_exclusive_scan(acc2, sh2, total2);
  if (threadIdx.x == 0) a.agg2[blockIdx.x] = total2;
}

__global__ void gc_final(Args a) {
  __shared__ Agg2 sh2[kThreads];
  __shared__ uint8_t dec[kChunk];   // bit0 keep, bit1 make-tombstone
  __shared__ uint32_t srcv[kChunk];
  const int64_t cbase = (int64_t)blockIdx.x * kChunk;
  const int64_t base = cbase + threadIdx.x * kItems;
  uint8_t f[kItems];
  Agg2 e[kItems];
  Agg2 acc = Agg2::identity();
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    f[k] = i < a.n ? a.bits[i] : 0;
    e[k] = Agg2{(f[k] & kNewDoc) ? 1u : 0u, 0u, 0u, 0u, 0u};
    if (i < a.n && (f[k] & kVisible) && (f[k] & kRoot)) {
      e[k].v = 1u;
      e[k].hi = row(a, kRowHtHi, i);
      e[k].lo = row(a, kRowHtLo, i);
      e[k].wid = row(a, kRowWid, i);
    }
    if (i < a.n) acc = Agg2::combine(acc, e[k]);
  }
  Agg2 total;
  Agg2 run = Agg2::combine(a.carry2[blockIdx.x],
                           block_exclusive_scan(acc, sh2, total));
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + k;
    const int li = threadIdx.x * kItems + k;
    if (i >= a.n) {
      dec[li] = 0;
      srcv[li] = 0;
      continue;
    }
    run = Agg2::combine(run, e[k]);  // inclusive, as associative_scan
    const bool c = f[k] & kC, visible = f[k] & kVisible;
    const bool is_root = f[k] & kRoot, expired = f[k] & kExpired;
    const bool tomb = f[k] & kTomb;
    bool covered = false;
    if (!is_root && run.v) {
      const uint32_t hi = row(a, kRowHtHi, i), lo = row(a, kRowHtLo, i);
      const uint32_t wid = row(a, kRowWid, i);
      covered = hi < run.hi ||
                (hi == run.hi && (lo < run.lo || (lo == run.lo && wid < run.wid)));
    }
    const bool is_tomb = tomb || (expired && c);
    bool keep, mk;
    if (a.snapshot) {
      keep = visible && !covered && !is_tomb;
      mk = false;
    } else {
      const bool drop_tomb =
          visible && is_tomb && a.is_major && !a.retain_deletes;
      keep = (!c || visible) && !covered && !drop_tomb;
      mk = expired && keep && c && !tomb && !a.is_major;
    }
    keep = keep && !(f[k] & kPad);
    a.keep[i] = keep ? 1 : 0;
    a.mk[i] = mk ? 1 : 0;
    dec[li] = (keep ? 1 : 0) | (mk ? 2 : 0);
    srcv[li] = a.perm[i] >> a.log2m;
  }
  __syncthreads();
  // pack: one warp ballot per 32 consecutive positions and decision plane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncols = 2 + a.b;
  for (int g = warp; g < kChunk / 32; g += kThreads / 32) {
    const int64_t pos0 = cbase + (int64_t)g * 32;
    if (pos0 >= a.n) break;  // n is a multiple of 32
    const uint8_t d = dec[g * 32 + lane];
    const uint32_t sv = srcv[g * 32 + lane];
    uint32_t* out = a.packed + (pos0 / 32) * ncols;
    const uint32_t wk = __ballot_sync(0xFFFFFFFFu, d & 1);
    const uint32_t wm = __ballot_sync(0xFFFFFFFFu, d & 2);
    if (lane == 0) {
      out[0] = wk;
      out[1] = wm;
    }
    for (int t = 0; t < a.b; ++t) {
      const uint32_t wt = __ballot_sync(0xFFFFFFFFu, (sv >> t) & 1u);
      if (lane == 0) out[2 + t] = wt;
    }
  }
}

int64_t num_blocks(int64_t n) { return (n + kChunk - 1) / kChunk; }

size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

}  // namespace

extern "C" {

// Scratch bytes the wrapper allocates for a launch over n positions.
int64_t ybt_gc_pack_scratch_bytes(int64_t n) {
  const int64_t nb = num_blocks(n);
  return (int64_t)(align16((size_t)n) + 2 * align16(nb * sizeof(Agg1)) +
                   2 * align16(nb * sizeof(Agg2)));
}

// s: [rows, n] u32 merged payload (row stride n); perm: [n] u32.
// packed: [n/32, 2+b] u32; keep, mk: [n] bytes; scratch: see above.
// Returns cudaGetLastError() after the last launch (0 = success).
int ybt_gc_pack(const uint32_t* s, const uint32_t* perm, int64_t n, int w,
                uint32_t cut_hi, uint32_t cut_lo, uint32_t cphys_hi,
                uint32_t cphys_lo, int is_major, int retain_deletes,
                int snapshot, int log2m, int b, uint8_t* scratch,
                uint32_t* packed, uint8_t* keep, uint8_t* mk, void* stream) {
  if (n <= 0 || n % 32 != 0 || w < 0 || b < 1 || b > 30 || log2m < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = num_blocks(n);
  Args a;
  a.s = s;
  a.perm = perm;
  a.n = n;
  a.w = w;
  a.cut_hi = cut_hi;
  a.cut_lo = cut_lo;
  a.cphys_hi = cphys_hi;
  a.cphys_lo = cphys_lo;
  a.is_major = is_major;
  a.retain_deletes = retain_deletes;
  a.snapshot = snapshot;
  a.log2m = log2m;
  a.b = b;
  uint8_t* p = scratch;
  a.bits = p;
  p += align16((size_t)n);
  a.agg1 = reinterpret_cast<Agg1*>(p);
  p += align16(nb * sizeof(Agg1));
  a.carry1 = reinterpret_cast<Agg1*>(p);
  p += align16(nb * sizeof(Agg1));
  a.agg2 = reinterpret_cast<Agg2*>(p);
  p += align16(nb * sizeof(Agg2));
  a.carry2 = reinterpret_cast<Agg2*>(p);
  a.packed = packed;
  a.keep = keep;
  a.mk = mk;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  gc_mark<<<(unsigned)nb, kThreads, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_carry<Agg1><<<1, kScanThreads, 0, st>>>(a.agg1, a.carry1, nb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gc_visible<<<(unsigned)nb, kThreads, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_carry<Agg2><<<1, kScanThreads, 0, st>>>(a.agg2, a.carry2, nb);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  gc_final<<<(unsigned)nb, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
