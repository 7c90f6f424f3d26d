// Kernels D and E: the survivor scan and the span gather of write-through
// staging (the device half of the codec job's output path).
//
// Kernel D replaces yugabyte_tpu/ops/run_merge.py `_survivor_positions_impl`
// (:866, jnp.nonzero(keep, size=n_pad, fill_value=n_pad-1)); kernel E
// replaces `_gather_staged_output` (:901). Both were XLA programs.
//
// Kernel D, survivor positions. Input: keep, one byte per merged position
// [n]. Output: pos int32 [n], the kept positions in increasing order, then
// n - 1 in every remaining slot. A stream compaction whose scan crosses
// CTAs, in three launches (counted as one call by the wrapper):
//   scan_count    per CTA of 4096 positions: the number kept;
//   scan_carry    one CTA: exclusive scan of the counts, plus the total;
//   scan_scatter  per CTA: each thread loads 16 consecutive keep bytes as
//                 one 16-byte word, a CTA scan of the per-thread counts
//                 gives its output offset, and it writes its kept indices;
//                 the CTA then fills its own slots at or above the total.
// Bound on an H100: memory, n bytes read and 4n bytes written (the counts
// are n/1024 bytes). The design reads keep twice (count, then scatter).
//
// Kernel E, span gather. Input: the merged payload p_mat [rp, n_pad] (rows
// 0..R-1 the cols layout in merged order), pos from kernel D, the merged
// make-tombstone bytes mk [n_pad], and a survivor span [start, end).
// Output: cols [R, n_out] with, for lane i, idx = start + i:
//   valid (idx < end): column pos[idx] of p_mat, with FLAG_TOMBSTONE OR'd
//                      into the flags row where mk[pos[idx]] is set;
//   otherwise:         the pad template (0xFFFFFFFF lens and key words).
// The JAX function gathers cols[:, perm[pos]] from the run-major input;
// p_mat[:R, pos] is the same column (the merge carried every row along),
// and it saves the perm indirection: pos increases with i, so neighbouring
// lanes read neighbouring columns.
// Design: one thread per output lane, looping over the R rows; writes
// coalesce, reads are a gather over a nearly contiguous window.
// Bound on an H100: memory, per lane 4 (pos) + 1 (mk) + 4R read + 4R
// written bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kChunk = kThreads * kItems;  // positions per scan CTA
constexpr int kCarryThreads = 1024;
constexpr int kRowFlags = 5, kRowWords = 8;
constexpr uint32_t kFlagTombstone = 1;

__global__ void scan_count(const uint8_t* __restrict__ keep, int64_t n,
                           int32_t* __restrict__ counts) {
  const int64_t base = (int64_t)blockIdx.x * kChunk + threadIdx.x;
  int total = 0;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    total += __syncthreads_count(i < n && keep[i] != 0);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Exclusive scan of one int per thread across the CTA (Hillis-Steele in
// shared memory); `total` receives the sum.
__device__ int block_exclusive_sum(int v, int* sh, int& total) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const int x = t >= off ? sh[t - off] : 0;
    __syncthreads();
    sh[t] += x;
    __syncthreads();
  }
  total = sh[blockDim.x - 1];
  const int excl = sh[t] - v;
  __syncthreads();
  return excl;
}

// offsets: [nb + 1], offsets[nb] = the total.
__global__ void scan_carry(const int32_t* __restrict__ counts, int64_t nb,
                           int32_t* __restrict__ offsets) {
  __shared__ int sh[kCarryThreads];
  const int64_t per = (nb + kCarryThreads - 1) / kCarryThreads;
  const int64_t s0 = threadIdx.x * per;
  const int64_t s1 = s0 + per < nb ? s0 + per : nb;
  int acc = 0;
  for (int64_t i = s0; i < s1; ++i) acc += counts[i];
  int total;
  int run = block_exclusive_sum(acc, sh, total);
  for (int64_t i = s0; i < s1; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (threadIdx.x == 0) offsets[nb] = total;
}

__global__ void scan_scatter(const uint8_t* __restrict__ keep, int64_t n,
                             int64_t nb, const int32_t* __restrict__ offsets,
                             int32_t* __restrict__ pos) {
  __shared__ int sh[kThreads];
  const int64_t cbase = (int64_t)blockIdx.x * kChunk;
  const int64_t base = cbase + (int64_t)threadIdx.x * kItems;
  uint8_t b[kItems];
  if (base + kItems <= n) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + base);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; k < kItems; ++k) b[k] = (words[k >> 2] >> (8 * (k & 3))) & 0xFFu;
  } else {
    for (int k = 0; k < kItems; ++k) b[k] = base + k < n ? keep[base + k] : 0;
  }
  int c = 0;
  for (int k = 0; k < kItems; ++k) c += b[k] != 0;
  int block_total;
  int off = offsets[blockIdx.x] + block_exclusive_sum(c, sh, block_total);
  for (int k = 0; k < kItems; ++k)
    if (b[k]) pos[off++] = (int32_t)(base + k);
  // tail: this CTA's own slots at or above the total hold n - 1
  const int64_t total = offsets[nb];
  for (int64_t i = cbase + threadIdx.x; i < cbase + kChunk && i < n;
       i += kThreads)
    if (i >= total) pos[i] = (int32_t)(n - 1);
}

__global__ void span_gather_kernel(const uint32_t* __restrict__ p_mat,
                                   int64_t n_pad, int rows,
                                   const int32_t* __restrict__ pos,
                                   const uint8_t* __restrict__ mk,
                                   int64_t start, int64_t end, int64_t n_out,
                                   uint32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int64_t idx = start + i;
  const bool valid = idx < end;
  const int64_t p = pos[idx < 0 ? 0 : (idx < n_pad ? idx : n_pad - 1)];
  const bool tomb = valid && mk[p] != 0;
  for (int r = 0; r < rows; ++r) {
    uint32_t v;
    if (valid) {
      v = p_mat[(int64_t)r * n_pad + p];
      if (r == kRowFlags && tomb) v |= kFlagTombstone;
    } else {
      v = (r < 2 || r >= kRowWords) ? 0xFFFFFFFFu : 0u;
    }
    out[(int64_t)r * n_out + i] = v;
  }
}

int64_t num_chunks(int64_t n) { return (n + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// Scratch int32 words the wrapper allocates for a scan over n positions.
int64_t ybt_survivor_scan_scratch_words(int64_t n) {
  return 2 * num_chunks(n) + 1;
}

// keep: [n] bytes (n a multiple of 16); pos: [n] int32; scratch: see above.
// Returns cudaGetLastError() after the last launch.
int ybt_survivor_scan(const uint8_t* keep, int64_t n, int32_t* scratch,
                      int32_t* pos, void* stream) {
  if (n <= 0 || n % 16 != 0 || n > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = num_chunks(n);
  int32_t* counts = scratch;
  int32_t* offsets = scratch + nb;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  scan_count<<<(unsigned)nb, kThreads, 0, st>>>(keep, n, counts);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_carry<<<1, kCarryThreads, 0, st>>>(counts, nb, offsets);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_scatter<<<(unsigned)nb, kThreads, 0, st>>>(keep, n, nb, offsets, pos);
  return (int)cudaGetLastError();
}

// p_mat: [>= rows, n_pad] u32; pos: [n_pad] int32; mk: [n_pad] bytes;
// out: [rows, n_out] u32. Returns cudaGetLastError() after the launch.
int ybt_span_gather(const uint32_t* p_mat, int64_t n_pad, int rows,
                    const int32_t* pos, const uint8_t* mk, int64_t start,
                    int64_t end, int64_t n_out, uint32_t* out, void* stream) {
  if (n_pad <= 0 || rows <= kRowWords || n_out <= 0 || start < 0 ||
      end < start)
    return (int)cudaErrorInvalidValue;
  span_gather_kernel<<<(unsigned)((n_out + kThreads - 1) / kThreads),
                       kThreads, 0, (cudaStream_t)stream>>>(
      p_mat, n_pad, rows, pos, mk, start, end, n_out, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
