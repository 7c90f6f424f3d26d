// Kernel L: the chunk split search of the chunked subcompaction.
//
// Replaces the XLA program yugabyte_tpu/ops/run_merge.py
// `_chunk_split_search` (:1029), reached from `_launch_chunked` (:1293).
//
// Input: the run-major staged matrix cols u32 [rows, n_pad] (row layout of
// ops/merge_gc.py: row 1 doc_key_len, rows 8.. key words), the real row
// count of each of the k_pad run slots run_ns i32 [k_pad] (slot i holds
// rows [i*m, i*m + run_ns[i])), and n_split splitters u32 [n_split,
// w_route] (route keys, w_route <= 4).
// Output: out i32 [k_pad, n_split], out[i][s] = the first row j of run i
// whose route key is >= splitter s, searched over [0, run_ns[i]) by
// n_iters bisection steps (n_iters = bit_length(m) + 1 covers any run).
//
// The route key of a row is its first w_route key words, word q masked to
// its clip(doc_key_len - 4q, 0, 4) leading bytes (merge_gc.route_word_mask,
// the single definition of route masking); keys compare as unsigned words,
// most significant first. Runs are sorted and routes are monotone within a
// run, so the bisection finds the partition point. Only rows below the
// run's end are read (mid < hi <= run_ns[i]).
//
// Design: one thread per (run, splitter) lane; each step reads at most
// w_route + 1 words of one row. The search is tiny (k_pad x n_split lanes,
// about 24 dependent steps): bound by latency, not by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowDkl = 1;
constexpr int kRowWords = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t route_mask(int32_t dkl, int q) {
  int nb = dkl - 4 * q;
  nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
  if (nb >= 4) return 0xFFFFFFFFu;
  if (nb == 0) return 0u;
  return 0xFFFFFFFFu << ((4 - nb) * 8);
}

__global__ void chunk_split_search_kernel(
    const uint32_t* __restrict__ cols, int64_t n_pad,
    const int32_t* __restrict__ run_ns,
    const uint32_t* __restrict__ splitters, int k_pad, int n_split,
    int64_t m, int w_route, int n_iters, int32_t* __restrict__ out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= k_pad * n_split) return;
  const int run = lane / n_split;
  const int s = lane - run * n_split;
  const uint32_t* sp = splitters + (int64_t)s * w_route;
  const int64_t base = (int64_t)run * m;
  int32_t lo = 0, hi = run_ns[run];
  for (int it = 0; it < n_iters && lo < hi; ++it) {
    const int32_t mid = (lo + hi) >> 1;
    const int64_t idx = base + mid;
    const int32_t dkl = (int32_t)cols[kRowDkl * n_pad + idx];
    bool lt = false;
    for (int q = 0; q < w_route; ++q) {
      const uint32_t kr =
          cols[(int64_t)(kRowWords + q) * n_pad + idx] & route_mask(dkl, q);
      if (kr != sp[q]) {
        lt = kr < sp[q];
        break;
      }
    }
    if (lt) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[lane] = lo;
}

}  // namespace

extern "C" {

// cols: device u32 [rows, n_pad]; run_ns: device i32 [k_pad]; splitters:
// device u32 [n_split, w_route]; out: device i32 [k_pad, n_split].
// Returns cudaGetLastError().
int ybt_chunk_split_search(const uint32_t* cols, int64_t n_pad,
                           const int32_t* run_ns, const uint32_t* splitters,
                           int k_pad, int n_split, int64_t m, int w_route,
                           int n_iters, int32_t* out, void* stream) {
  if (k_pad <= 0 || n_split <= 0 || w_route < 1 || w_route > 4 || m <= 0 ||
      n_pad < (int64_t)k_pad * m || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int lanes = k_pad * n_split;
  chunk_split_search_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                              (cudaStream_t)stream>>>(
      cols, n_pad, run_ns, splitters, k_pad, n_split, m, w_route, n_iters,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
