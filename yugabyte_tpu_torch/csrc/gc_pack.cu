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
// Two quantities are segmented scans whose segments span tiles:
//   scan 1: "a version <= cutoff was seen earlier in this full-key
//            segment" (merge_gc.py:132-138) -> visible;
//   scan 2: the last visible root write in this document segment
//            (merge_gc.py:152-168), carried as its position.
// Scan 2 needs scan 1's result. One launch after one memset (tile status
// words and the ticket), single pass:
//   - each CTA (256 threads) takes a tile of 2048 positions from a global
//     atomic ticket, so every tile it looks back on is held by a running
//     CTA. Warp w owns 256 consecutive positions, lane l the 4 at
//     w*256 + v*128 + 4l (v = 0, 1): every row is read as 16-byte vectors,
//     a warp's load covering 512 contiguous bytes;
//   - the neighbour at i-1 of each row comes from __shfl_up_sync (and lane
//     31 of the previous vector); only a warp's first position reads it
//     from global memory (lane 0, one word a row; the neighbouring warp's
//     line, mostly an L1/L2 hit). same_key and same_doc accumulate row by
//     row as a bit per position; the flags and ht_hi, ht_lo, write_id of
//     each position stay in registers, nothing goes back to scratch;
//   - TTL rows are read only where FLAG_HAS_TTL is set in a vector;
//   - scan 1 (2 bits) and then scan 2 (2 bits and a 32-bit position) run as
//     warp-shuffle scans, one pass over the 8 warp totals, and a decoupled
//     look-back across tiles (tile_chain.cuh) on flag-tagged 64-bit
//     status words (2-bit flag, the payload in the same word, so relaxed
//     loads and stores suffice). Warp 0 looks back 32 tiles at a time.
//     Scan 2 starts once the tile's scan-1 prefix is known. A root write's
//     (ht, write_id) is read back by position: the carried one once a
//     tile, a root write inside the tile only where a covered check needs
//     it;
//   - keep and make-tombstone leave as 4-byte stores of 4 bytes; the packed
//     words are built by OR-reducing each lane's 4-bit nibble across the 8
//     lanes of a 32-position group (shfl_xor), the source-run planes from
//     perm >> log2(m) loaded as 16-byte vectors.
// Every position's decision matches the JAX function bit for bit: both
// scans are associative "reset at segment start" combines, evaluated
// sequentially inside a thread, by shuffles across the warp and the CTA,
// and by the look-back across tiles. Look-back cannot deadlock: a tile
// waits only on tiles with earlier tickets.
//
// Bound on an H100: memory. The function must read the 8+w payload rows it
// uses and the perm row once and write the packed words and two bytes per
// position; this design reads each once (the TTL rows only where a vector
// holds a TTL) plus one word a warp a row and the covered checks'
// (ht, write_id). Registers are capped at 80 (3 CTAs an SM, a few spilled):
// measured faster than 114 registers and 2 CTAs, and than 1 or 4 vectors
// a thread. Left: each CTA's chain of dependent steps (ticket, loads, two
// look-backs) at 8,192 tiles for 2^24 positions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_chain.cuh"

namespace {

using tile_chain::kFull;
using tile_chain::look_back;
using tile_chain::warp_inclusive;

constexpr int kRowKeyLen = 0, kRowDkl = 1, kRowHtHi = 2, kRowHtLo = 3,
              kRowWid = 4, kRowFlags = 5, kRowTtlHi = 6, kRowTtlLo = 7,
              kRowWords = 8;
constexpr uint32_t kFlagTombstone = 1, kFlagHasTtl = 4;
constexpr uint32_t kPadSentinel = 0xFFFFFFFFu;

// per-position flag bits
constexpr uint32_t kC = 1, kNewSeg = 2, kNewDoc = 4, kRoot = 8,
                   kExpired = 16, kTomb = 32, kPad = 64, kVisible = 128;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 2;                   // 16-byte vectors a thread a row
constexpr int kWarpPos = kVec * 128;      // positions per warp
constexpr int kTile = kWarps * kWarpPos;  // positions per CTA

// scan 1: bit 1 a segment start seen, bit 0 a version <= cutoff seen since
// the last start
struct Scan1 {
  __device__ static uint64_t combine(uint64_t a, uint64_t b) {
    return (b & 2u) ? b : (a | b);
  }
};

// scan 2: bit 33 a document start seen, bit 32 a visible root write seen
// since the last start, bits 0-31 its position (0 when bit 32 is clear)
constexpr uint64_t kR2 = 1ull << 33, kV2 = 1ull << 32;
struct Scan2 {
  __device__ static uint64_t combine(uint64_t a, uint64_t b) {
    return b ? (b | (a & kR2)) : a;
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
  uint64_t* status1;  // [tiles], zeroed
  uint64_t* status2;  // [tiles], zeroed
  unsigned* ticket;   // zeroed
  uint32_t* packed;   // [n/32, 2+b]
  uint8_t* keep;      // [n]
  uint8_t* mk;        // [n]
};

__device__ __forceinline__ uint32_t comp(const uint4& x, int k) {
  return k == 0 ? x.x : (k == 1 ? x.y : (k == 2 ? x.z : x.w));
}

__device__ __forceinline__ uint32_t doc_mask(int dkl, int j) {
  int nb = dkl - 4 * j;
  nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
  return nb >= 4 ? 0xFFFFFFFFu : (nb == 0 ? 0u : (0xFFFFFFFFu << ((4 - nb) * 8)));
}

// The thread's vectors of row r (zeros past n) and, for lane 0, the value
// at the warp's first position - 1 (0 at position 0).
__device__ __forceinline__ void load_row(const Args& a, int r,
                                         const int64_t (&pv)[kVec], int64_t p0,
                                         uint4 (&x)[kVec], uint32_t& edge) {
  const uint32_t* row = a.s + (int64_t)r * a.n;
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    x[v] = pv[v] < a.n ? __ldcs(reinterpret_cast<const uint4*>(row + pv[v]))
                       : make_uint4(0, 0, 0, 0);
  edge = ((threadIdx.x & 31) == 0 && p0 > 0 && p0 <= a.n) ? row[p0 - 1] : 0u;
}

// The same positions' values at i - 1.
__device__ __forceinline__ void prev_vals(const uint4 (&x)[kVec], uint32_t edge,
                                          uint4 (&px)[kVec]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const uint32_t up = __shfl_up_sync(kFull, x[v].w, 1);
    const uint32_t wrap =
        v > 0 ? __shfl_sync(kFull, x[v > 0 ? v - 1 : 0].w, 31) : edge;
    px[v] = make_uint4(lane > 0 ? up : wrap, x[v].x, x[v].y, x[v].z);
  }
}

__global__ void __launch_bounds__(kThreads, 3) gc_pack_kernel(Args a) {
  __shared__ uint64_t sh_w[kWarps];
  __shared__ uint64_t sh_excl;
  __shared__ uint32_t sh_ov[3];
  __shared__ int sh_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh_tile = (int)atomicAdd(a.ticket, 1u);
  __syncthreads();
  const int64_t tile = sh_tile;
  const int64_t tbase = tile * kTile;
  const int64_t p0 = tbase + (int64_t)warp * kWarpPos;
  int64_t pv[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) pv[v] = p0 + v * 128 + 4 * lane;

  // ---- rows 0-5: per-position bits; then the key words -------------------
  uint4 dkl[kVec], hi[kVec], lo[kVec], wid[kVec];
  uint32_t same_key = 0, same_doc = 0;  // bit 4v + k
  uint32_t m_c = 0, m_root = 0, m_exp = 0, m_tomb = 0, m_pad = 0;
  {
    uint4 len[kVec], fl[kVec], pl[kVec], pd[kVec];
    uint32_t e_len, e_dkl, unused;
    load_row(a, kRowKeyLen, pv, p0, len, e_len);
    load_row(a, kRowDkl, pv, p0, dkl, e_dkl);
    load_row(a, kRowHtHi, pv, p0, hi, unused);
    load_row(a, kRowHtLo, pv, p0, lo, unused);
    load_row(a, kRowWid, pv, p0, wid, unused);
    load_row(a, kRowFlags, pv, p0, fl, unused);
    prev_vals(len, e_len, pl);
    prev_vals(dkl, e_dkl, pd);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      uint4 th = make_uint4(0, 0, 0, 0), tl = th;
      if ((fl[v].x | fl[v].y | fl[v].z | fl[v].w) & kFlagHasTtl) {
        th = __ldcs(reinterpret_cast<const uint4*>(a.s + kRowTtlHi * a.n + pv[v]));
        tl = __ldcs(reinterpret_cast<const uint4*>(a.s + kRowTtlLo * a.n + pv[v]));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t bit = 1u << (4 * v + k);
        const uint32_t h = comp(hi[v], k), l = comp(lo[v], k);
        const uint32_t flg = comp(fl[v], k);
        const uint32_t ln = comp(len[v], k), dk = comp(dkl[v], k);
        if (ln == comp(pl[v], k)) same_key |= bit;
        if (dk == comp(pd[v], k)) same_doc |= bit;
        if (h < a.cut_hi || (h == a.cut_hi && l <= a.cut_lo)) m_c |= bit;
        if (ln == dk) m_root |= bit;
        if (ln == kPadSentinel) m_pad |= bit;
        if (flg & kFlagTombstone) m_tomb |= bit;
        if (flg & kFlagHasTtl) {
          uint32_t sum_lo = (l >> 12) + comp(tl, k);
          const uint32_t carry = sum_lo >> 20;
          const uint32_t sum_hi = h + comp(th, k) + carry;
          sum_lo &= 0xFFFFFu;
          if (sum_hi < a.cphys_hi ||
              (sum_hi == a.cphys_hi && sum_lo <= a.cphys_lo))
            m_exp |= bit;
        }
      }
    }
  }
  {
    // two rows in flight ahead of the one compared
    uint4 x[kVec], x1[kVec], x2[kVec];
    uint32_t ex = 0, ex1 = 0, ex2 = 0;
    if (a.w > 0) load_row(a, kRowWords, pv, p0, x, ex);
    if (a.w > 1) load_row(a, kRowWords + 1, pv, p0, x1, ex1);
    for (int j = 0; j < a.w; ++j) {
      if (j + 2 < a.w) load_row(a, kRowWords + j + 2, pv, p0, x2, ex2);
      uint4 px[kVec];
      prev_vals(x, ex, px);
#pragma unroll
      for (int v = 0; v < kVec; ++v)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t diff = comp(x[v], k) ^ comp(px[v], k);
          const uint32_t bit = 1u << (4 * v + k);
          if (diff) same_key &= ~bit;
          if (diff & doc_mask((int)comp(dkl[v], k), j)) same_doc &= ~bit;
        }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        x[v] = x1[v];
        x1[v] = x2[v];
      }
      ex = ex1;
      ex1 = ex2;
    }
  }
  if (p0 == 0 && lane == 0) {  // position 0 starts both
    same_key &= ~1u;
    same_doc &= ~1u;
  }
  uint32_t f[kVec];  // byte k: flags of position 4v + k
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    f[v] = 0;
    if (pv[v] < a.n) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t bit = 1u << (4 * v + k);
        uint32_t b = 0;
        b |= (m_c & bit) ? kC : 0u;
        b |= (same_key & bit) ? 0u : kNewSeg;
        b |= (same_doc & bit) ? 0u : kNewDoc;
        b |= (m_root & bit) ? kRoot : 0u;
        b |= (m_exp & bit) ? kExpired : 0u;
        b |= (m_tomb & bit) ? kTomb : 0u;
        b |= (m_pad & bit) ? kPad : 0u;
        f[v] |= b << (8 * k);
      }
    }
  }

  // ---- scan 1: visible ---------------------------------------------------
  uint64_t incl[kVec], tot[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    uint64_t agg = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = f[v] >> (8 * k);
      agg = Scan1::combine(agg, ((b & kNewSeg) ? 2u : 0u) | (b & kC));
    }
    incl[v] = warp_inclusive<Scan1>(agg);
    tot[v] = __shfl_sync(kFull, incl[v], 31);
  }
  uint64_t wt = 0;
#pragma unroll
  for (int v = 0; v < kVec; ++v) wt = Scan1::combine(wt, tot[v]);
  if (lane == 0) sh_w[warp] = wt;
  __syncthreads();
  uint64_t run = 0, tile_agg = 0;
#pragma unroll
  for (int x = 0; x < kWarps; ++x) {
    if (x == warp) run = tile_agg;
    tile_agg = Scan1::combine(tile_agg, sh_w[x]);
  }
  if (warp == 0) {
    const uint64_t e = look_back<Scan1>(a.status1, tile, tile_agg);
    if (lane == 0) sh_excl = e;
  }
  __syncthreads();
  run = Scan1::combine(sh_excl, run);
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    uint64_t le = __shfl_up_sync(kFull, incl[v], 1);
    uint64_t r = Scan1::combine(run, lane > 0 ? le : 0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = f[v] >> (8 * k);
      const bool seen_before = !(b & kNewSeg) && (r & 1u);
      if ((b & kC) && !seen_before) f[v] |= kVisible << (8 * k);
      r = Scan1::combine(r, ((b & kNewSeg) ? 2u : 0u) | (b & kC));
    }
    run = Scan1::combine(run, tot[v]);
  }

  // ---- scan 2: the last visible root write of the document --------------
  uint64_t e2[kVec][4];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    uint64_t agg = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = f[v] >> (8 * k);
      uint64_t e = (b & kNewDoc) ? kR2 : 0;
      if ((b & kVisible) && (b & kRoot)) e |= kV2 | (uint64_t)(pv[v] + k);
      e2[v][k] = e;
      agg = Scan2::combine(agg, e);
    }
    incl[v] = warp_inclusive<Scan2>(agg);
    tot[v] = __shfl_sync(kFull, incl[v], 31);
  }
  wt = 0;
#pragma unroll
  for (int v = 0; v < kVec; ++v) wt = Scan2::combine(wt, tot[v]);
  if (lane == 0) sh_w[warp] = wt;
  __syncthreads();
  run = 0;
  tile_agg = 0;
#pragma unroll
  for (int x = 0; x < kWarps; ++x) {
    if (x == warp) run = tile_agg;
    tile_agg = Scan2::combine(tile_agg, sh_w[x]);
  }
  if (warp == 0) {
    const uint64_t e = look_back<Scan2>(a.status2, tile, tile_agg);
    if (lane == 0) {
      sh_excl = e;
      if (e & kV2) {
        const int64_t p = (uint32_t)e;
        sh_ov[0] = a.s[kRowHtHi * a.n + p];
        sh_ov[1] = a.s[kRowHtLo * a.n + p];
        sh_ov[2] = a.s[kRowWid * a.n + p];
      }
    }
  }
  __syncthreads();
  run = Scan2::combine(sh_excl, run);

  // ---- decisions, bytes and packed words ---------------------------------
  const int ncols = 2 + a.b;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    uint64_t le = __shfl_up_sync(kFull, incl[v], 1);
    uint64_t r = Scan2::combine(run, lane > 0 ? le : 0);
    uint32_t kb = 0, mb = 0, kn = 0, mn = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t b = f[v] >> (8 * k);
      r = Scan2::combine(r, e2[v][k]);  // inclusive, as associative_scan
      const bool c = b & kC, visible = b & kVisible;
      const bool is_root = b & kRoot, expired = b & kExpired;
      const bool tomb = b & kTomb;
      bool covered = false;
      if (!is_root && (r & kV2)) {
        const int64_t p = (uint32_t)r;
        uint32_t oh, ol, ow;
        if (p < tbase) {
          oh = sh_ov[0];
          ol = sh_ov[1];
          ow = sh_ov[2];
        } else {
          oh = __ldg(a.s + kRowHtHi * a.n + p);
          ol = __ldg(a.s + kRowHtLo * a.n + p);
          ow = __ldg(a.s + kRowWid * a.n + p);
        }
        const uint32_t h = comp(hi[v], k), l = comp(lo[v], k);
        const uint32_t wd = comp(wid[v], k);
        covered = h < oh || (h == oh && (l < ol || (l == ol && wd < ow)));
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
      keep = keep && !(b & kPad) && pv[v] < a.n;
      mk = mk && pv[v] < a.n;
      kb |= (uint32_t)keep << (8 * k);
      mb |= (uint32_t)mk << (8 * k);
      kn |= (uint32_t)keep << k;
      mn |= (uint32_t)mk << k;
    }
    const bool valid = pv[v] < a.n;  // n % 32 == 0: a 32-group is all in
    if (valid) {
      *reinterpret_cast<uint32_t*>(a.keep + pv[v]) = kb;
      *reinterpret_cast<uint32_t*>(a.mk + pv[v]) = mb;
    }
    const uint4 pm = valid ? __ldcs(reinterpret_cast<const uint4*>(a.perm + pv[v]))
                           : make_uint4(0, 0, 0, 0);
    const uint32_t src[4] = {pm.x >> a.log2m, pm.y >> a.log2m,
                             pm.z >> a.log2m, pm.w >> a.log2m};
    // plane t of the 32-group lanes 8g..8g+7 cover; lane 8g + (t & 7)
    // stores it
    uint32_t* out = a.packed + ((pv[v] - 4 * (lane & 7)) / 32) * ncols;
    for (int t = 0; t < ncols; ++t) {
      uint32_t nib;
      if (t == 0) {
        nib = kn;
      } else if (t == 1) {
        nib = mn;
      } else {
        const int s = t - 2;
        nib = ((src[0] >> s) & 1u) | (((src[1] >> s) & 1u) << 1) |
              (((src[2] >> s) & 1u) << 2) | (((src[3] >> s) & 1u) << 3);
      }
      uint32_t word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      word |= __shfl_xor_sync(kFull, word, 4);
      if (valid && (lane & 7) == (t & 7)) out[t] = word;
    }
    run = Scan2::combine(run, tot[v]);
  }
}

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// Scratch bytes the wrapper allocates for a launch over n positions: the
// status words of both scans, then the ticket.
int64_t ybt_gc_pack_scratch_bytes(int64_t n) {
  return (2 * num_tiles(n) + 1) * (int64_t)sizeof(uint64_t);
}

// s: [rows, n] u32 merged payload (row stride n), perm: [n] u32, both
// 16-byte aligned; packed: [n/32, 2+b] u32; keep, mk: [n] bytes (4-byte
// aligned); scratch: see above, zeroed here. Returns cudaGetLastError()
// after the launch (0 = success).
int ybt_gc_pack(const uint32_t* s, const uint32_t* perm, int64_t n, int w,
                uint32_t cut_hi, uint32_t cut_lo, uint32_t cphys_hi,
                uint32_t cphys_lo, int is_major, int retain_deletes,
                int snapshot, int log2m, int b, uint8_t* scratch,
                uint32_t* packed, uint8_t* keep, uint8_t* mk, void* stream) {
  if (n <= 0 || n % 32 != 0 || n > 0x7FFFFFFF || w < 0 || b < 1 || b > 30 ||
      log2m < 0 || reinterpret_cast<uintptr_t>(s) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(perm) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(keep) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(mk) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = num_tiles(n);
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
  uint64_t* st = reinterpret_cast<uint64_t*>(scratch);
  a.status1 = st;
  a.status2 = st + tiles;
  a.ticket = reinterpret_cast<unsigned*>(st + 2 * tiles);
  a.packed = packed;
  a.keep = keep;
  a.mk = mk;
  cudaStream_t stream_ = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)ybt_gc_pack_scratch_bytes(n), stream_);
  if (e != cudaSuccess) return (int)e;
  gc_pack_kernel<<<(unsigned)tiles, kThreads, 0, stream_>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
