// Kernel I: the scan's gather and bound mask, around kernel B.
//
// Replaces the device work of yugabyte_tpu/ops/scan.py `_scan_fused` (:47)
// around its sort (kernel G) and its GC (kernel B in snapshot mode):
//
// I.1 sorted_gather: the sorted matrix cols[:, perm] (scan.py:56-57, and
//     merge_gc.py:230 in sort_and_gc) in kernel B's input layout. Input
//     cols u32 [R, n], perm int32 [n]. Output u32 [R+1, n]: rows 0..R-1
//     are cols[:, perm], row R is perm (kernel B reads it as the source
//     index; with one run its source planes are all zero).
//     One thread per lane: perm read once, R gathered reads, R+1
//     coalesced writes.
// I.2 bound_pack: keep AND the lower / upper bound tests, packed. Input
//     the sorted matrix from I.1, kernel B's keep bytes [n] and the bounds
//     (key_bounds.cuh: by value up to kBoundCap words, else one device
//     copy). Output u32 [n/32], bit i%32 of word i/32 = keep of lane i
//     (little-endian lanes). The compare is scan.py:62-81: the
//     lexicographic order of (key words, key_len) is memcmp order on the
//     raw keys; key_len compares as int32 as in the JAX function. An upper
//     bound truncated to the key stride keeps keys EQUAL to it (the host
//     re-checks them against the full bound). An unbounded scan launches
//     no I.2: its answer is plane 0 of kernel B's packed buffer
//     (ops/scan.py `_scan_fused`).
//
// merge_gc.sort_and_gc runs I.1 (ops/radix.sorted_payload) and kernel B;
// the range scan then runs I.2 (ops/scan.bound_pack). Bound on an H100:
// memory. I.1 must read the R rows and perm and write R+1 rows; its reads
// are a gather, one 32-byte sector per word where perm scatters. I.2 must
// read keep, the key words of each kept lane up to the first that settles
// both bounds (key_len where all are equal), and write n/8 bytes. Its
// design: each thread takes 16 consecutive lanes (keep as one 16-byte
// load, the keep bits packed in registers), reads a key-word row as 16-byte
// vectors only where a kept lane of the vector is still tied with a bound,
// and a warp writes its 16 packed words as four 16-byte stores (pairs of
// threads' 16 bits joined and gathered by shuffles); a grid of resident
// CTAs strides over the lanes, each CTA staging the bound words in shared
// memory once. The bounds reach the kernel as a parameter, so a call
// makes no host-to-device copy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "key_bounds.cuh"

namespace {

using key_bounds::KeyBounds;

constexpr int kThreads = 256;
constexpr int kRowKeyLen = 0, kRowWords = 8;

__global__ void sorted_gather_kernel(const uint32_t* __restrict__ cols,
                                     int rows, int64_t n,
                                     const int32_t* __restrict__ perm,
                                     uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t p = perm[i];
  for (int r = 0; r < rows; ++r) out[(int64_t)r * n + i] = cols[(int64_t)r * n + p];
  out[(int64_t)rows * n + i] = (uint32_t)p;
}

constexpr int kLanes = 16;                  // I.2 lanes a thread
constexpr int kWarpLanes = 32 * kLanes;     // lanes a warp step

// Row r of lanes [i, i + kLanes), a 16-byte vector for each 4 lanes that
// hold a lane of `need` (zeros elsewhere).
__device__ __forceinline__ void load_lanes(const uint32_t* __restrict__ s,
                                           int64_t n, int r, int64_t i,
                                           uint32_t need, uint32_t (&v)[kLanes]) {
#pragma unroll
  for (int q = 0; q < kLanes / 4; ++q) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if ((need >> (4 * q)) & 0xFu) x = key_bounds::ld4(s, n, r, i + 4 * q);
    key_bounds::unpack4(x, v + 4 * q);
  }
}

template <bool kLo, bool kHi>
__global__ void __launch_bounds__(kThreads)
bound_pack_kernel(const uint32_t* __restrict__ s, int64_t n, int w,
                  const uint8_t* __restrict__ keep,
                  const __grid_constant__ KeyBounds b, int up_trunc,
                  uint32_t* __restrict__ packed) {
  extern __shared__ uint32_t sb[];  // lower words, then upper words
  if (kLo || kHi) key_bounds::stage(b, sb);
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t step = ((int64_t)gridDim.x * kThreads >> 5) * kWarpLanes;
  for (int64_t base = warp * kWarpLanes; base < n; base += step) {
    const int64_t i = base + (int64_t)lane * kLanes;
    uint32_t alive = 0;  // bit e: lane i + e is kept so far
    if (i < n) {  // n is a multiple of 32: all 16 lanes are in
      const uint4 k = __ldg(reinterpret_cast<const uint4*>(keep + i));
      const uint32_t kw[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
      for (int e = 0; e < kLanes; ++e)
        if ((kw[e >> 2] >> (8 * (e & 3))) & 0xFFu) alive |= 1u << e;
      if (kLo || kHi) {
        uint32_t tie_lo = kLo ? alive : 0u, tie_hi = kHi ? alive : 0u;
        uint32_t v[kLanes];
        for (int j = 0; j < w; ++j) {
          const uint32_t need = (tie_lo | tie_hi) & alive;
          if (!need) break;
          load_lanes(s, n, kRowWords + j, i, need, v);
          key_bounds::compare_row<kLanes>(need, v, kLo ? sb[j] : 0u,
                                          kHi ? sb[w + j] : 0u, tie_lo,
                                          tie_hi, alive);
        }
        const uint32_t need = (tie_lo | tie_hi) & alive;
        if (need) {
          load_lanes(s, n, kRowKeyLen, i, need, v);
          key_bounds::compare_len<kLanes>(need, v, b.lo_len, b.hi_len,
                                          up_trunc != 0, tie_lo, tie_hi,
                                          alive);
        }
      }
    }
    // threads 2q and 2q+1 hold packed word q's low and high 16 bits; lane
    // l < 4 stores words 4l..4l+3, held by threads 8l, 8l+2, 8l+4, 8l+6
    const uint32_t word = alive | (__shfl_down_sync(full, alive, 1) << 16);
    const int src = (lane & 3) * 8;
    const uint32_t x0 = __shfl_sync(full, word, src);
    const uint32_t x1 = __shfl_sync(full, word, src + 2);
    const uint32_t x2 = __shfl_sync(full, word, src + 4);
    const uint32_t x3 = __shfl_sync(full, word, src + 6);
    if (lane < 4) {
      const int64_t wi = (base >> 5) + 4 * lane, nw = n >> 5;
      if (base + kWarpLanes <= n) {
        *reinterpret_cast<uint4*>(packed + wi) = make_uint4(x0, x1, x2, x3);
      } else {
        if (wi < nw) packed[wi] = x0;
        if (wi + 1 < nw) packed[wi + 1] = x1;
        if (wi + 2 < nw) packed[wi + 2] = x2;
        if (wi + 3 < nw) packed[wi + 3] = x3;
      }
    }
  }
}

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <bool kLo, bool kHi>
int launch_bound_pack(const uint32_t* s, int64_t n, int w,
                      const uint8_t* keep, const KeyBounds& b, int up_trunc,
                      uint32_t* packed, cudaStream_t st) {
  const int64_t ctas = (n + (int64_t)kThreads * kLanes - 1) /
                       ((int64_t)kThreads * kLanes);
  const size_t smem = (kLo || kHi) ? 2 * sizeof(uint32_t) * (size_t)w : 0;
  static int per_sm = 0;
  static size_t per_sm_smem = 0;
  if (per_sm == 0 || per_sm_smem != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bound_pack_kernel<kLo, kHi>, kThreads, smem);
    per_sm_smem = smem;
  }
  bound_pack_kernel<kLo, kHi>
      <<<key_bounds::sm_grid(per_sm, ctas), kThreads, smem, st>>>(
          s, n, w, keep, b, up_trunc, packed);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cols: [rows, n] u32; perm: [n] int32; out: [rows + 1, n] u32.
// Returns cudaGetLastError() after the launch.
int ybt_sorted_gather(const uint32_t* cols, int rows, int64_t n,
                      const int32_t* perm, uint32_t* out, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  sorted_gather_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      cols, rows, n, perm, out);
  return (int)cudaGetLastError();
}

int ybt_key_bounds_size() { return (int)sizeof(KeyBounds); }

// s: [>= 8 + w, n] u32 (the sorted matrix), 16-byte aligned; keep: [n]
// bytes, 16-byte aligned; bounds: a host KeyBounds (copied into the launch's
// parameters; its `dev` words, when w > kBoundCap, on the card); packed:
// [n / 32] u32 out, 16-byte aligned; n a multiple of 32. Returns
// cudaGetLastError() after the launch.
int ybt_bound_pack(const uint32_t* s, int64_t n, int w, const uint8_t* keep,
                   const KeyBounds* bounds, int has_lower, int has_upper,
                   int upper_truncated, uint32_t* packed, void* stream) {
  if (n <= 0 || n % 32 != 0 || w <= 0 || bounds == nullptr ||
      bounds->w != w || (w > key_bounds::kBoundCap && bounds->dev == nullptr) ||
      2 * sizeof(uint32_t) * (size_t)w > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (has_lower && has_upper)
    return launch_bound_pack<true, true>(s, n, w, keep, *bounds,
                                         upper_truncated, packed, st);
  if (has_lower)
    return launch_bound_pack<true, false>(s, n, w, keep, *bounds,
                                          upper_truncated, packed, st);
  if (has_upper)
    return launch_bound_pack<false, true>(s, n, w, keep, *bounds,
                                          upper_truncated, packed, st);
  return launch_bound_pack<false, false>(s, n, w, keep, *bounds,
                                         upper_truncated, packed, st);
}

}  // extern "C"
