// Kernel A: one merge-path tournament level over the run-major payload.
//
// Replaces the Pallas kernel of the JAX package:
//   yugabyte_tpu/ops/pallas_merge.py `_merge_level` -> pl.pallas_call
//   (:222, :270), tile body `_make_tile_kernel` (:161), splits
//   `_compute_splits` (:95).
//
// What it computes: the payload `in` is [rp, n] u32, row-major (row r at
// in + r*n). Consecutive column ranges of length L are sorted runs; pair p
// is A = [2pL, 2pL+L) and B = [2pL+L, 2pL+2L). The level writes, for every
// pair, the stable merge of A and B (all rp payload rows ride along) into
// `out`. The order is the comparator of the JAX package: the c pruned
// compare rows (`cmp.rows`, most significant first; ht_hi/ht_lo/write_id
// complemented through `cmp.inv`), then the global run-major index. Every
// index in A is below every index in B, so "equal compare rows -> A first"
// IS the index tiebreak: the strict predicate keyA[mid] > keyB[d-mid-1] of
// `_compute_splits` decides both the tile splits and the per-thread merge.
// That order is total, so each split is unique.
//
// Design (Hopper, two launches a level):
//   1. merge_splits_kernel: every tile boundary of the level at once, in
//      `_compute_splits`'s layout (int32 [n_pairs * (tpp + 1)]: for pair p
//      and boundary t, the number of A elements among the first
//      min(t * tile, 2L) merged ones). A group of kGroup = 4 lanes per
//      boundary (8 boundaries a warp) runs a 4-ary co-rank search: each
//      round 3 lanes test evenly spaced pivots in device memory and a
//      ballot narrows the range 4-fold (11 rounds for L = 2^22, where one
//      thread's binary search takes 22 dependent steps). The probes read
//      scattered 32-byte sectors, so the launch trades rounds (latency)
//      against probes (random reads): on an H100 at the YCSB shape 32
//      lanes a boundary (5 rounds of 31 probes) took 0.15 ms a level,
//      8 lanes 0.09, 4 lanes 0.08 and 2 lanes 0.10 (kernel_ab.py).
//   2. merge_tile_kernel: one CTA per output tile of one pair, tile / 4
//      threads. It reads its two splits and copies the A window
//      [a0, a0 + la) and the B window [b0, b0 + lb) of all rp rows into
//      shared memory with cp.async: 16-byte copies where a row's window is
//      aligned, 4-byte copies for its ragged head and tail. Each shared row
//      keeps a window at its global address mod 4, so source and
//      destination share their alignment. The compare rows are among those
//      rows: every payload byte is read once. Each thread then merge-paths
//      its 4 outputs from shared memory (a binary search on its diagonal
//      within the tile, then 4 steps) and keeps their sources in
//      registers; for each row it gathers those 4 words from shared memory
//      and writes them as one 16-byte store (scalar stores where a row's
//      output is not 16-byte aligned). A warp writes 512 contiguous bytes
//      a row.
//   The tile is the largest power of two <= 2048 whose rp rows fit a third
//   of the SM's shared memory (3 CTAs an SM): 1024 at rp = 17, about 70 KB.
//   The CTA is single-buffered: its copy, merge and stores run one after
//   the other, and the SM's other CTAs fill the gaps. A persistent CTA that
//   prefetches its next tile's windows while it merges is the next step.
// Not carried over from the TPU: the lane-flipped copy of the payload, the
// roll-based shifts, the 2-D i1 masks and the bitonic stages.
//
// Bound on an H100: memory. Each level reads and writes the whole payload
// once: 2 * rp * n * 4 bytes (rp = 8 + w + 1; no padding of rp to 8 rows,
// which was a TPU tiling artifact). The split launch reads a few sectors
// per probe and writes 4 bytes per boundary; at the YCSB shape it takes
// about 8% of the level, and the tile launch about 1.3x its share of the
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCmp = 128;     // compare rows the descriptor holds
constexpr int kPer = 4;          // merged outputs per tile thread
constexpr int kPad = 12;         // words a shared row holds beyond the tile,
                                 // itself rounded up to a multiple of 4
constexpr int kSmemMax = 232448; // the most shared memory one CTA may hold
constexpr int kSplitWarps = 8;   // warps per split CTA
constexpr int kGroup = 4;        // lanes per boundary (a power of two)
constexpr unsigned kFull = 0xFFFFFFFFu;

// Words of one shared row: 16-byte aligned rows, each window at its
// global address mod 4 (at most 6 words more than the window).
__host__ __device__ __forceinline__ int row_words(int tile) {
  return (tile + 3) / 4 * 4 + kPad;
}

struct Cmp {
  int c;
  int rows[kMaxCmp];
  uint32_t inv[kMaxCmp];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kSplitWarps * 32)
    merge_splits_kernel(const uint32_t* __restrict__ in, int64_t n,
                        int64_t L, int tile, int64_t tpp, int64_t n_bounds,
                        const __grid_constant__ Cmp cmp,
                        int32_t* __restrict__ splits) {
  __shared__ int rows[kMaxCmp];
  __shared__ uint32_t inv[kMaxCmp];
  for (int k = threadIdx.x; k < cmp.c; k += blockDim.x) {
    rows[k] = cmp.rows[k];
    inv[k] = cmp.inv[k];
  }
  __syncthreads();
  const int c = cmp.c;
  const int lane = threadIdx.x & 31;
  const int j = lane % kGroup;            // the lane's place in its group
  const int g0 = lane - j;                // the group's first lane
  const int64_t b = ((int64_t)blockIdx.x * kSplitWarps + (threadIdx.x >> 5)) *
                        (32 / kGroup) + lane / kGroup;
  if (((int64_t)blockIdx.x * kSplitWarps + (threadIdx.x >> 5)) *
          (32 / kGroup) >= n_bounds)
    return;  // the whole warp
  const bool live = b < n_bounds;
  const int64_t p = b / (tpp + 1);
  const int64_t t = b % (tpp + 1);
  const int64_t base_a = p * 2 * L;
  const int64_t base_b = base_a + L;
  const int64_t d = t * tile < 2 * L ? t * tile : 2 * L;
  int64_t lo = live && d - L > 0 ? d - L : 0;
  int64_t hi = !live ? 0 : d < L ? d : L;
  // invariant: the split is in [lo, hi]; the predicate is false below lo
  // and true from hi on (hi itself counts as true). Each round the
  // group's first kGroup - 1 lanes test evenly spaced pivots.
  while (__any_sync(kFull, lo < hi)) {
    const int64_t s = hi - lo;
    const int64_t piv = lo + ((int64_t)(j + 1) * s) / kGroup;  // last: hi
    bool gt = true;
    if (j < kGroup - 1 && lo < hi) {
      const int64_t ia = base_a + piv, ib = base_b + (d - piv - 1);
      gt = false;
      for (int k = 0; k < c; ++k) {
        const uint32_t* row = in + (int64_t)rows[k] * n;
        const uint32_t x = __ldg(row + ia) ^ inv[k];
        const uint32_t y = __ldg(row + ib) ^ inv[k];
        if (x != y) {
          gt = x > y;
          break;
        }
      }
    }
    const unsigned m = (__ballot_sync(kFull, gt) >> g0) &
                       (kGroup == 32 ? kFull : (1u << (kGroup & 31)) - 1u);
    const int f = __ffs(m) - 1;  // the group's first true lane
    const long long below =
        __shfl_sync(kFull, (long long)piv, g0 + (f > 0 ? f - 1 : 0));
    const long long at = __shfl_sync(kFull, (long long)piv, g0 + f);
    if (lo < hi) {
      hi = at;
      lo = f > 0 ? below + 1 : lo;
    }
  }
  if (j == 0 && live) splits[b] = (int32_t)lo;
}

// The tile CTA's view of one row's two windows in shared memory.
struct Windows {
  int64_t ga, gb;   // column of A's and B's first element (row 0)
  int la, lb;
  int64_t n;
  // offset of A's word 0 and of B's word 0 in row r's shared row
  __device__ __forceinline__ int a_off(int r) const {
    return (int)(((int64_t)r * n + ga) & 3);
  }
  __device__ __forceinline__ int a_chunks(int r) const {
    if (la == 0) return 0;
    const int64_t g = (int64_t)r * n + ga;
    return (int)(((g + la + 3) >> 2) - (g >> 2));
  }
  __device__ __forceinline__ int b_off(int r) const {
    return 4 * a_chunks(r) + (int)(((int64_t)r * n + gb) & 3);
  }
  __device__ __forceinline__ int b_chunks(int r) const {
    if (lb == 0) return 0;
    const int64_t g = (int64_t)r * n + gb;
    return (int)(((g + lb + 3) >> 2) - (g >> 2));
  }
};

__global__ void __launch_bounds__(512)
    merge_tile_kernel(const uint32_t* __restrict__ in,
                      uint32_t* __restrict__ out, int rp, int64_t n,
                      int64_t L, int tile, int64_t tpp,
                      const int32_t* __restrict__ splits,
                      const __grid_constant__ Cmp cmp) {
  extern __shared__ __align__(16) uint32_t win[];  // [rp][row_words(tile)]
  const int S = row_words(tile);
  const int c = cmp.c;
  uint32_t* inv = win + (int64_t)rp * S;
  int* aoff = reinterpret_cast<int*>(inv + c);  // compare row k's A word 0
  int* boff = aoff + c;                         // and its B word 0

  const int64_t p = blockIdx.x / tpp;
  const int64_t t = blockIdx.x % tpp;
  const int64_t base_a = p * 2 * L;
  const int64_t d0 = t * tile;
  const int tl = (int)((d0 + tile < 2 * L ? d0 + tile : 2 * L) - d0);
  const int64_t a0 = splits[p * (tpp + 1) + t];
  Windows w;
  w.la = (int)(splits[p * (tpp + 1) + t + 1] - a0);
  w.lb = tl - w.la;
  w.ga = base_a + a0;
  w.gb = base_a + L + (d0 - a0);
  w.n = n;

  // every row's two windows, once, into shared memory
  for (int r = 0; r < rp; ++r) {
    const int na = w.a_chunks(r), nq = na + w.b_chunks(r);
    uint32_t* srow = win + (int64_t)r * S;
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      const bool is_a = q < na;
      const int64_t g = (int64_t)r * n + (is_a ? w.ga : w.gb);
      const int64_t lo = g, hi = g + (is_a ? w.la : w.lb);
      const int64_t c0 = ((g >> 2) + (is_a ? q : q - na)) * 4;
      uint32_t* dst = srow + 4 * q;
      if (c0 >= lo && c0 + 4 <= hi) {
        cp_async16(dst, in + c0);
      } else {
        for (int e = 0; e < 4; ++e)
          if (c0 + e >= lo && c0 + e < hi) cp_async4(dst + e, in + c0 + e);
      }
    }
  }
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    const int r = cmp.rows[k];
    inv[k] = cmp.inv[k];
    aoff[k] = r * S + w.a_off(r);
    boff[k] = r * S + w.b_off(r);
  }
  cp_async_wait_all();
  __syncthreads();

  // keyA[i] > keyB[j] over the compare rows
  auto gt = [&](int i, int j) {
    for (int k = 0; k < c; ++k) {
      const uint32_t x = win[aoff[k] + i] ^ inv[k];
      const uint32_t y = win[boff[k] + j] ^ inv[k];
      if (x != y) return x > y;
    }
    return false;
  };

  const int la = w.la, lb = w.lb;
  const int e0 = threadIdx.x * kPer;
  if (e0 >= tl) return;
  int lo = e0 - lb > 0 ? e0 - lb : 0;
  int hi = e0 < la ? e0 : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (gt(mid, e0 - mid - 1))
      hi = mid;
    else
      lo = mid + 1;
  }
  int i = lo, j = e0 - lo;
  int src[kPer];  // A word i, or ~j for B word j
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (e0 + e < tl) {
      const bool take_a = i < la && (j >= lb || !gt(i, j));
      src[e] = take_a ? i++ : ~(j++);
    } else {
      src[e] = 0;
    }
  }

  const int64_t ocol = base_a + d0 + e0;
  const bool full = e0 + kPer <= tl;
  for (int r = 0; r < rp; ++r) {
    const uint32_t* srow = win + (int64_t)r * S;
    const int oa = w.a_off(r), ob = w.b_off(r);
    uint32_t v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      v[e] = src[e] >= 0 ? srow[oa + src[e]] : srow[ob + ~src[e]];
    uint32_t* dst = out + (int64_t)r * n + ocol;
    if (full && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (e0 + e < tl) dst[e] = v[e];
    }
  }
}

int tile_threads(int tile) {
  const int t = (tile + kPer - 1) / kPer;
  return (t + 31) / 32 * 32;
}

bool valid_level(int rp, int64_t n, int64_t L, int c, int tile) {
  return rp > 0 && n > 0 && L > 0 && n % (2 * L) == 0 && c > 0 &&
         c <= kMaxCmp && tile > 0 && tile <= 2 * L && n <= 0x7FFFFFFF;
}

bool fill_cmp(const int32_t* desc, int c, int rp, Cmp* cmp) {
  cmp->c = c;
  for (int k = 0; k < c; ++k) {
    if (desc[k] < 0 || desc[k] >= rp) return false;
    cmp->rows[k] = desc[k];
    cmp->inv[k] = (uint32_t)desc[c + k];
  }
  return true;
}

}  // namespace

extern "C" {

// Dynamic shared memory a tile launch needs: rp rows of row_words(tile)
// words, then the compare rows' masks and their A and B offsets.
int64_t ybt_merge_tiles_smem_bytes(int rp, int c, int tile) {
  return ((int64_t)rp * row_words(tile) + 3 * (int64_t)c) * 4;
}

// The split launch. in: [rp, n] u32 device matrix; desc: HOST int32 [2c] =
// c compare row ids, then c complement masks; splits: device int32
// [n_pairs * (tpp + 1)], tpp = ceil(2L / tile). Returns
// cudaGetLastError() after the launch.
int ybt_merge_splits(const uint32_t* in, int rp, int64_t n, int64_t L,
                     const int32_t* desc, int c, int tile, int32_t* splits,
                     void* stream) {
  Cmp cmp;
  if (!valid_level(rp, n, L, c, tile) || !fill_cmp(desc, c, rp, &cmp))
    return (int)cudaErrorInvalidValue;
  const int64_t tpp = (2 * L + tile - 1) / tile;
  const int64_t n_bounds = n / (2 * L) * (tpp + 1);
  const int64_t per_cta = kSplitWarps * (32 / kGroup);
  merge_splits_kernel<<<(unsigned)((n_bounds + per_cta - 1) / per_cta),
                        kSplitWarps * 32, 0, (cudaStream_t)stream>>>(
      in, n, L, tile, tpp, n_bounds, cmp, splits);
  return (int)cudaGetLastError();
}

// The tile launch: in/out [rp, n] u32 device matrices (distinct), splits
// from ybt_merge_splits with the same tile. Returns cudaGetLastError()
// after the launch.
int ybt_merge_tiles(const uint32_t* in, uint32_t* out, int rp, int64_t n,
                    int64_t L, const int32_t* desc, int c, int tile,
                    const int32_t* splits, void* stream) {
  Cmp cmp;
  if (!valid_level(rp, n, L, c, tile) || !fill_cmp(desc, c, rp, &cmp))
    return (int)cudaErrorInvalidValue;
  const int64_t tpp = (2 * L + tile - 1) / tile;
  const int64_t smem = ybt_merge_tiles_smem_bytes(rp, c, tile);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // once: opt in to the most a CTA may hold, and to the largest carveout
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    return e != cudaSuccess
               ? e
               : cudaFuncSetAttribute(
                     merge_tile_kernel,
                     cudaFuncAttributePreferredSharedMemoryCarveout,
                     (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  merge_tile_kernel<<<(unsigned)(n / (2 * L) * tpp), tile_threads(tile),
                      (size_t)smem, (cudaStream_t)stream>>>(
      in, out, rp, n, L, tile, tpp, splits, cmp);
  return (int)cudaGetLastError();
}

}  // extern "C"
