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
//     the sorted matrix from I.1, kernel B's keep bytes [n], the bounds'
//     key words u32 [2][w] and byte lengths. Output u32 [n/32], bit i%32
//     of word i/32 = keep of lane i (little-endian lanes, one
//     __ballot_sync per 32 lanes). The compare is scan.py:62-81: the
//     lexicographic order of (key words, key_len) is memcmp order on the
//     raw keys; key_len compares as int32 as in the JAX function. An upper
//     bound truncated to the key stride keeps keys EQUAL to it (the host
//     re-checks them against the full bound).
//
// merge_gc.sort_and_gc runs I.1 (ops/radix.sorted_payload) and kernel B;
// the scan then runs I.2 (ops/scan.bound_pack). Bound on an H100:
// memory. I.1 must read the R rows and perm and write R+1 rows; its reads
// are a gather, one 32-byte sector per word where perm scatters. I.2 must
// read key_len, the w key words and keep, and write n/8 bytes; it stops
// reading a lane's words at the first that differs from the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// (key < bound, key == bound) of lane i over the sorted matrix s.
__device__ void cmp_bound(const uint32_t* __restrict__ s, int64_t n, int w,
                          int64_t i, const uint32_t* __restrict__ bw,
                          int32_t blen, bool& lt, bool& eq) {
  for (int j = 0; j < w; ++j) {
    const uint32_t x = s[(int64_t)(kRowWords + j) * n + i];
    if (x != bw[j]) {
      lt = x < bw[j];
      eq = false;
      return;
    }
  }
  const int32_t len = (int32_t)s[(int64_t)kRowKeyLen * n + i];
  lt = len < blen;
  eq = len == blen;
}

__global__ void bound_pack_kernel(const uint32_t* __restrict__ s, int64_t n,
                                  int w, const uint8_t* __restrict__ keep,
                                  const uint32_t* __restrict__ bounds,
                                  int32_t lo_len, int32_t hi_len,
                                  int has_lower, int has_upper,
                                  int upper_truncated,
                                  uint32_t* __restrict__ packed) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool k = false;
  if (i < n) {
    k = keep[i] != 0;
    bool lt, eq;
    if (k && has_lower) {
      cmp_bound(s, n, w, i, bounds, lo_len, lt, eq);
      k = !lt;
    }
    if (k && has_upper) {
      cmp_bound(s, n, w, i, bounds + w, hi_len, lt, eq);
      k = upper_truncated ? (lt || eq) : lt;
    }
  }
  const unsigned bits = __ballot_sync(0xffffffffu, k);
  if ((threadIdx.x & 31) == 0 && i < n) packed[i >> 5] = bits;
}

unsigned grid_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

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

// s: [>= 8 + w, n] u32 (the sorted matrix); keep: [n] bytes; bounds: [2, w]
// u32 (lower words, then upper words); packed: [n / 32] u32 out; n a
// multiple of 32. Returns cudaGetLastError() after the launch.
int ybt_bound_pack(const uint32_t* s, int64_t n, int w, const uint8_t* keep,
                   const uint32_t* bounds, int lo_len, int hi_len,
                   int has_lower, int has_upper, int upper_truncated,
                   uint32_t* packed, void* stream) {
  if (n <= 0 || n % 32 != 0 || w <= 0) return (int)cudaErrorInvalidValue;
  bound_pack_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      s, n, w, keep, bounds, lo_len, hi_len, has_lower, has_upper,
      upper_truncated, packed);
  return (int)cudaGetLastError();
}

}  // extern "C"
