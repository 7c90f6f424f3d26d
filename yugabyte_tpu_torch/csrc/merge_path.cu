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
// compare rows (`cmp_rows`, most significant first; ht_hi/ht_lo/write_id
// complemented through `inv`), then the global run-major index. Every index
// in A is below every index in B, so "equal compare rows -> A first" IS
// the index tiebreak: the strict predicate keyA[mid] > keyB[d-mid-1] of
// `_compute_splits` decides both the tile splits and the per-thread merge.
//
// Design (Hopper, one launch per level):
//   - one CTA per output tile of `tile` merged positions of one pair;
//   - two threads run the CTA's own diagonal binary search in device
//     memory (the tile's start and end diagonals);
//   - the A and B windows' compare tuples are loaded into shared memory
//     (complemented once on load);
//   - each thread merge-paths its own sub-range of the tile from shared
//     memory and records the source column of each output position;
//   - the payload rows are then copied row by row: writes are coalesced,
//     reads come from two nearly contiguous windows.
// Not carried over from the TPU: the lane-flipped copy of the payload, the
// roll-based shifts, the 2-D i1 masks and the bitonic stages.
//
// Bound on an H100: memory. Each level reads and writes the whole payload
// once: 2 * rp * n * 4 bytes (rp = 8 + w + 1; no padding of rp to 8 rows,
// which was a TPU tiling artifact). The split searches read a few KB. The
// design streams each payload byte once per level; what it does not do yet
// is overlap the window loads with the merge (cp.async/TMA staging is for a
// later change).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ bool gt_global(const uint32_t* __restrict__ in,
                                          int64_t n, const int* rows,
                                          const uint32_t* inv, int c,
                                          int64_t ia, int64_t ib) {
  for (int k = 0; k < c; ++k) {
    const uint32_t* row = in + (int64_t)rows[k] * n;
    uint32_t a = row[ia] ^ inv[k];
    uint32_t b = row[ib] ^ inv[k];
    if (a != b) return a > b;
  }
  return false;
}

__device__ __forceinline__ bool gt_shared(const uint32_t* keys, int tile,
                                          int c, int ia, int ib) {
  for (int k = 0; k < c; ++k) {
    uint32_t a = keys[k * tile + ia];
    uint32_t b = keys[k * tile + ib];
    if (a != b) return a > b;
  }
  return false;
}

__global__ void merge_level_kernel(const uint32_t* __restrict__ in,
                                   uint32_t* __restrict__ out, int rp,
                                   int64_t n, int64_t L,
                                   const int32_t* __restrict__ cmp_desc,
                                   int c, int tile, int64_t tpp) {
  extern __shared__ uint32_t sm[];
  int* rows = reinterpret_cast<int*>(sm);
  uint32_t* inv = sm + c;
  uint32_t* keys = sm + 2 * c;                  // [c, tile]
  uint32_t* src = keys + (int64_t)c * tile;     // [tile]
  __shared__ int64_t split[2];

  const int64_t p = blockIdx.x / tpp;
  const int64_t t = blockIdx.x % tpp;
  const int64_t base_a = p * 2 * L;
  const int64_t base_b = base_a + L;
  const int64_t d0 = t * tile;
  const int64_t d1 = d0 + tile < 2 * L ? d0 + tile : 2 * L;

  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    rows[k] = cmp_desc[k];
    inv[k] = (uint32_t)cmp_desc[c + k];
  }
  __syncthreads();

  // diagonal binary search (the predicate of _compute_splits)
  if (threadIdx.x < 2) {
    const int64_t d = threadIdx.x == 0 ? d0 : d1;
    int64_t lo = d - L > 0 ? d - L : 0;
    int64_t hi = d < L ? d : L;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (gt_global(in, n, rows, inv, c, base_a + mid, base_b + (d - mid - 1)))
        hi = mid;
      else
        lo = mid + 1;
    }
    split[threadIdx.x] = lo;
  }
  __syncthreads();

  const int64_t a0 = split[0];
  const int la = (int)(split[1] - a0);
  const int tl = (int)(d1 - d0);
  const int lb = tl - la;
  const int64_t b0 = d0 - a0;

  // window tuples: positions [0, la) from A[a0..], [la, tl) from B[b0..]
  for (int k = 0; k < c; ++k) {
    const uint32_t* row = in + (int64_t)rows[k] * n;
    const uint32_t iv = inv[k];
    for (int j = threadIdx.x; j < tl; j += blockDim.x) {
      const int64_t g = j < la ? base_a + a0 + j : base_b + b0 + (j - la);
      keys[k * tile + j] = row[g] ^ iv;
    }
  }
  __syncthreads();

  // per-thread merge path over the shared windows
  const int per = (tl + blockDim.x - 1) / blockDim.x;
  const int e0 = threadIdx.x * per;
  if (e0 < tl) {
    const int e1 = min(e0 + per, tl);
    int lo = e0 - lb > 0 ? e0 - lb : 0;
    int hi = e0 < la ? e0 : la;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (gt_shared(keys, tile, c, mid, la + (e0 - mid - 1)))
        hi = mid;
      else
        lo = mid + 1;
    }
    int i = lo;
    int j = e0 - lo;
    for (int e = e0; e < e1; ++e) {
      const bool take_a =
          i < la && (j >= lb || !gt_shared(keys, tile, c, i, la + j));
      // source column, relative to the pair's base
      src[e] = take_a ? (uint32_t)(a0 + i) : (uint32_t)(L + b0 + j);
      if (take_a)
        ++i;
      else
        ++j;
    }
  }
  __syncthreads();

  // payload: every row rides along
  for (int r = 0; r < rp; ++r) {
    const uint32_t* irow = in + (int64_t)r * n + base_a;
    uint32_t* orow = out + (int64_t)r * n + base_a + d0;
    for (int j = threadIdx.x; j < tl; j += blockDim.x) orow[j] = irow[src[j]];
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// Shared memory a launch needs for c compare rows and the given tile.
int64_t ybt_merge_level_smem_bytes(int c, int tile) {
  return (int64_t)(2 * c + (int64_t)c * tile + tile) * 4;
}

// One tournament level. in/out: [rp, n] u32 device matrices (distinct).
// cmp_desc: device int32 [2c] = c compare row ids, then c complement masks.
// Returns cudaGetLastError() after the launch.
int ybt_merge_level(const uint32_t* in, uint32_t* out, int rp, int64_t n,
                    int64_t L, const int32_t* cmp_desc, int c, int tile,
                    void* stream) {
  if (rp <= 0 || n <= 0 || L <= 0 || n % (2 * L) != 0 || c <= 0 ||
      tile <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_pairs = n / (2 * L);
  const int64_t tpp = (2 * L + tile - 1) / tile;
  const int64_t smem = ybt_merge_level_smem_bytes(c, tile);
  cudaError_t e = cudaFuncSetAttribute(
      merge_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  merge_level_kernel<<<(unsigned)(n_pairs * tpp), kThreads, (size_t)smem,
                       (cudaStream_t)stream>>>(in, out, rp, n, L, cmp_desc,
                                               c, tile, tpp);
  return (int)cudaGetLastError();
}

}  // extern "C"
