// Kernel H: staged concat, per-SST staged cols laid out into one matrix.
//
// Replaces the XLA programs yugabyte_tpu/ops/run_merge.py
// `_concat_staged_fused` (:672, the radix and scan input: parts back to
// back) and `_restage_concat` (:643, the run-major merge input: part i at
// lane i*m); storage/device_cache.py `concat_staged` (:510) reaches the
// first.
//
// Input: K parts, part i a u32 matrix [r_i, stride_i] of which the first
// n_i lanes are real, placed at output lane off_i (the parts' lane ranges
// are disjoint and ordered by offset), and a template column tmpl [rows].
// Output: u32 [rows, n_out] where lane j of row r is
//   part i's [r][j - off_i]  if off_i <= j < off_i + n_i and r < r_i,
//   0                        if off_i <= j < off_i + n_i and r >= r_i
//                            (word rows a narrow part does not have),
//   tmpl[r]                  if no part covers lane j.
// The JAX functions pass the pad template; the pushdown scan's value
// concat is the same function with a zero template.
//
// Design: one thread per output lane and row (grid.y = row); the part is
// found by a binary search over the offsets, so reads and writes both
// coalesce along the lane. Bound on an H100: memory, the real lanes' rows
// read once and the output written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;   // lanes per thread, kThreads apart

// desc: int64 [k][5] = (pointer, stride, n, off, rows) per part
__global__ void staged_concat_kernel(const int64_t* __restrict__ desc, int k,
                                     int64_t n_out,
                                     const uint32_t* __restrict__ tmpl,
                                     uint32_t* __restrict__ out) {
  const int r = blockIdx.y;
  const uint32_t fill = tmpl[r];
  const int64_t base = (int64_t)blockIdx.x * kThreads * kItems + threadIdx.x;
  for (int it = 0; it < kItems; ++it) {
    const int64_t j = base + (int64_t)it * kThreads;
    if (j >= n_out) return;
    // last part whose offset is <= j
    int lo = 0, hi = k - 1, p = -1;
    while (lo <= hi) {
      const int mid = (lo + hi) >> 1;
      if (desc[5 * mid + 3] <= j) {
        p = mid;
        lo = mid + 1;
      } else {
        hi = mid - 1;
      }
    }
    uint32_t v = fill;
    if (p >= 0) {
      const int64_t idx = j - desc[5 * p + 3];
      if (idx < desc[5 * p + 2]) {
        const uint32_t* part = (const uint32_t*)(uintptr_t)desc[5 * p];
        v = r < desc[5 * p + 4] ? part[(int64_t)r * desc[5 * p + 1] + idx]
                                : 0u;
      }
    }
    out[(int64_t)r * n_out + j] = v;
  }
}

}  // namespace

extern "C" {

// desc: device int64 [k][5] as above, offsets increasing; tmpl: device u32
// [rows]; out: device u32 [rows, n_out]. Returns cudaGetLastError().
int ybt_staged_concat(const int64_t* desc, int k, int rows, int64_t n_out,
                      const uint32_t* tmpl, uint32_t* out, void* stream) {
  if (k < 0 || rows <= 0 || rows > 65535 || n_out <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t per_cta = (int64_t)kThreads * kItems;
  dim3 grid((unsigned)((n_out + per_cta - 1) / per_cta), (unsigned)rows);
  staged_concat_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      desc, k, n_out, tmpl, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
