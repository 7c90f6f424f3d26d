// Kernels P1-P4: the batched point read's hash, bloom probe, locate +
// gather, and the learned-index fit.
//
// Replace the four device programs of yugabyte_tpu/ops/point_read.py:
//   P1 `_fnv64_fused` (:150, with `_mul64_by_prime` :129): FNV-1a-64 over
//      the first qlens[i] bytes of each query's big-endian key words; out
//      h1 = low word, h2 = high word | 1. One thread per query. The JAX
//      limb multiply is h*0x100000001B3 mod 2^64, so one u64 multiply
//      gives the same bits (as kernel F in block_codec.cu).
//   P2 `_bloom_probe_fused` (:171): one thread per query, k <= 12 probes
//      of bit (h1 + i*h2) % m_bits of the little-endian bit words. In u64,
//      h1 + 11*h2 < 2^36, so the plain modulo equals the JAX modular
//      identity ((h1%m) + (i*(h2%m)) % m) % m and storage/bloom.py's u64
//      arithmetic: the positions are bit-identical.
//   P3 `_locate_gather_fused` (:317, with `_seek_pred` :296, `_predict_pos`
//      :224, `_x_words` :246): one thread per query, a binary seek over
//      the staged cols [8 + w, n_pad] (row-major, u32) for the first entry
//      with key == q and ht <= read_ht, with the JAX step count (exact:
//      n_pad.bit_length(); model: 15 inside the learned window), mid =
//      (lo + hi) >> 1, P(i) := true for i >= n, key words and key_len
//      compared as u32 (pad columns hold 0xFFFFFFFF and compare greater),
//      the model's invariant checked on both sides (a failing lane is a
//      miss, never another entry), the gather at clip(r, 0, n_pad - 1)
//      even on a miss.
//   P4 `_index_fit_fused` (:257): prefix skip p from entries 0 and n-1,
//      exact anchor limbs at (arange(17) * (n-1)) / 16, and max_err = max
//      over the real entries of |rint(pred) - i|: each block sets up the
//      model in shared memory, predicts a grid-stride share of the
//      entries, reduces its max and issues one integer atomicMax.
//
// Float rounding: `_predict_pos` must round as XLA and numpy do (the
// recorded bound and the learned window depend on it), so every float
// operation of the prediction is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn): nvcc never contracts them
// into an FMA. u32 -> f32 by __uint2float_rn; rint for jnp.round (half to
// even). The file is built without --use_fast_math.
//
// Bound on an H100. P1, P2: a few bytes per query, launch-bound at B <=
// 1024. P3: a chain of dependent loads per query (steps x the words a
// compare reads), bound by memory latency, not bandwidth: a warp's 32
// seeks hit 32 unrelated columns. P4 streams the two coordinate rows of
// the real entries once: bandwidth-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowKeyLen = 0, kRowHtHi = 2, kRowHtLo = 3, kRowWid = 4,
              kRowWords = 8;
constexpr int kSegments = 16, kAnchors = kSegments + 1;
constexpr int kKMax = 12;
constexpr int kMaxP = 2;
constexpr int kThreads = 256;
constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ull;
constexpr uint64_t kFnvPrime = 0x100000001B3ull;

// The learned index's kernel operands (storage/learned_index.py).
struct Model {
  uint32_t a_hi[kAnchors], a_lo[kAnchors];
  int32_t pos[kAnchors];
  int32_t p, max_err;
};

__device__ __forceinline__ bool ge64(uint32_t xh, uint32_t xl, uint32_t yh,
                                     uint32_t yl) {
  return xh > yh || (xh == yh && xl >= yl);
}

// float32 of the two-limb difference x - y (wrapping), as `_f64ish` of
// `_sub64`: hi * 2^32 is exact, one rounding in the add.
__device__ __forceinline__ float diff_f32(uint32_t xh, uint32_t xl,
                                          uint32_t yh, uint32_t yl) {
  const uint32_t lo = xl - yl;
  const uint32_t hi = xh - yh - (xl < yl ? 1u : 0u);
  return __fadd_rn(__fmul_rn(__uint2float_rn(hi), 4294967296.0f),
                   __uint2float_rn(lo));
}

// `_predict_pos` for one coordinate; m points to shared memory.
__device__ float predict_pos(uint32_t xh, uint32_t xl, const Model& m) {
  int seg = 0;
  for (int s = 1; s < kSegments; ++s) seg += ge64(xh, xl, m.a_hi[s], m.a_lo[s]);
  const uint32_t a0h = m.a_hi[seg], a0l = m.a_lo[seg];
  const uint32_t a1h = m.a_hi[seg + 1], a1l = m.a_lo[seg + 1];
  const float p0 = __int2float_rn(m.pos[seg]);
  const float p1 = __int2float_rn(m.pos[seg + 1]);
  const bool ge0 = ge64(xh, xl, a0h, a0l);
  const float dx = diff_f32(xh, xl, a0h, a0l);
  const float da = diff_f32(a1h, a1l, a0h, a0l);
  float t = (ge0 && da > 0.0f) ? __fdiv_rn(dx, da) : 0.0f;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return __fadd_rn(p0, __fmul_rn(t, __fsub_rn(p1, p0)));
}

// `_seek_pred`: entry i is at or after the query's seek point.
__device__ __forceinline__ bool seek_pred(const uint32_t* __restrict__ cols,
                                          int64_t n_pad, int i, int n,
                                          const uint32_t* __restrict__ q,
                                          uint32_t qlen, int w, uint32_t rhi,
                                          uint32_t rlo) {
  if (i >= n) return true;
  const int64_t ii = i < 0 ? 0 : i;  // i < n <= n_pad
  bool gt = false, eq = true;
  for (int j = 0; j < w && eq; ++j) {  // gt and eq are final once eq fails
    const uint32_t c = cols[(kRowWords + j) * n_pad + ii];
    gt = c > q[j];
    eq = c == q[j];
  }
  if (eq) {
    const uint32_t klen = cols[kRowKeyLen * n_pad + ii];
    gt = klen > qlen;
    eq = klen == qlen;
  }
  if (!eq) return gt;
  const uint32_t hh = cols[kRowHtHi * n_pad + ii];
  const uint32_t hl = cols[kRowHtLo * n_pad + ii];
  return hh < rhi || (hh == rhi && hl <= rlo);
}

__global__ void fnv64_kernel(const uint32_t* __restrict__ qwords,
                             const int32_t* __restrict__ qlens, int b, int w,
                             uint32_t* __restrict__ h1,
                             uint32_t* __restrict__ h2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const uint32_t* q = qwords + (int64_t)i * w;
  const int len = qlens[i];
  uint64_t h = kFnvOffset;
  for (int j = 0; j < 4 * w && j < len; ++j) {
    const uint32_t byte = (q[j >> 2] >> (8 * (3 - (j & 3)))) & 0xFFu;
    h = (h ^ byte) * kFnvPrime;
  }
  h1[i] = (uint32_t)h;
  h2[i] = (uint32_t)(h >> 32) | 1u;
}

__global__ void bloom_kernel(const uint32_t* __restrict__ h1,
                             const uint32_t* __restrict__ h2,
                             const uint32_t* __restrict__ words,
                             uint32_t m_bits, int k, int b,
                             bool* __restrict__ ok) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const uint64_t a = h1[i], d = h2[i];
  const int kk = k < kKMax ? k : kKMax;
  bool r = true;
  for (int p = 0; p < kk; ++p) {
    const uint32_t pos = (uint32_t)((a + (uint64_t)p * d) % m_bits);
    r = r && ((words[pos >> 5] >> (pos & 31u)) & 1u);
  }
  ok[i] = r;
}

__global__ void locate_kernel(const uint32_t* __restrict__ cols,
                              int64_t n_pad, int n,
                              const uint32_t* __restrict__ qwords,
                              const int32_t* __restrict__ qlens, int b, int w,
                              uint32_t rhi, uint32_t rlo, Model model,
                              int use_model, int steps,
                              int32_t* __restrict__ out,
                              bool* __restrict__ flags) {
  __shared__ Model m;
  if (threadIdx.x == 0) m = model;
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const uint32_t* q = qwords + (int64_t)i * w;
  const uint32_t qlen = (uint32_t)qlens[i];
  int lo = 0, hi = n;
  if (use_model) {
    int pp = m.p < 0 ? 0 : m.p;
    pp = pp > w - 2 ? w - 2 : pp;
    const int pi = (int)rintf(predict_pos(q[pp], q[pp + 1], m));
    lo = min(max(pi - m.max_err, 0), n);
    hi = min(max(pi + m.max_err + 1, 0), n);
  }
  for (int s = 0; s < steps && lo < hi; ++s) {
    const int mid = (lo + hi) >> 1;
    if (seek_pred(cols, n_pad, mid, n, q, qlen, w, rhi, rlo))
      hi = mid;
    else
      lo = mid + 1;
  }
  const int r = lo;
  bool miss = false;
  if (use_model) {
    const bool ok_left =
        r == 0 || !seek_pred(cols, n_pad, r - 1, n, q, qlen, w, rhi, rlo);
    const bool ok_right =
        r >= n || seek_pred(cols, n_pad, r, n, q, qlen, w, rhi, rlo);
    miss = !(ok_left && ok_right);
  }
  const int64_t rr = r < 0 ? 0 : (r >= n_pad ? n_pad - 1 : r);
  bool eq = true;
  for (int j = 0; j < w && eq; ++j)
    eq = cols[(kRowWords + j) * n_pad + rr] == q[j];
  eq = eq && cols[kRowKeyLen * n_pad + rr] == qlen;
  const uint32_t hh = cols[kRowHtHi * n_pad + rr];
  const uint32_t hl = cols[kRowHtLo * n_pad + rr];
  const bool le = hh < rhi || (hh == rhi && hl <= rlo);
  out[i] = r;
  out[b + i] = (int32_t)hh;
  out[2 * b + i] = (int32_t)hl;
  out[3 * b + i] = (int32_t)cols[kRowWid * n_pad + rr];
  flags[i] = r < n && eq && le && !miss;
  flags[b + i] = miss;
}

__global__ void index_fit_kernel(const uint32_t* __restrict__ cols,
                                 int64_t n_pad, int n, int w,
                                 uint32_t* __restrict__ a_hi_out,
                                 uint32_t* __restrict__ a_lo_out,
                                 int32_t* __restrict__ p_out,
                                 int32_t* __restrict__ max_err) {
  __shared__ Model m;
  __shared__ int pp_s;
  __shared__ int warp_max[kThreads / 32];
  if (threadIdx.x == 0) {
    int64_t last = (int64_t)n - 1;
    last = last < 0 ? 0 : (last > n_pad - 1 ? n_pad - 1 : last);
    int run = 1, p = 0;
    const int jmax = w - 2 < kMaxP ? w - 2 : kMaxP;
    for (int j = 0; j < jmax; ++j) {
      const int64_t row = (int64_t)(kRowWords + j) * n_pad;
      run *= cols[row] == cols[row + last] ? 1 : 0;
      p += run;
    }
    m.p = p;
    pp_s = p > w - 2 ? w - 2 : p;
  }
  __syncthreads();
  const uint32_t* xh_row = cols + (int64_t)(kRowWords + pp_s) * n_pad;
  const uint32_t* xl_row = xh_row + n_pad;
  if (threadIdx.x < kAnchors) {
    const int pos = (int)(((int64_t)threadIdx.x * (n - 1)) / kSegments);
    m.pos[threadIdx.x] = pos;
    m.a_hi[threadIdx.x] = xh_row[pos];
    m.a_lo[threadIdx.x] = xl_row[pos];
    if (blockIdx.x == 0) {
      a_hi_out[threadIdx.x] = xh_row[pos];
      a_lo_out[threadIdx.x] = xl_row[pos];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *p_out = m.p;
  __syncthreads();
  int best = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float pred = predict_pos(xh_row[i], xl_row[i], m);
    const int err = abs((int)rintf(pred) - (int)i);
    best = err > best ? err : best;
  }
  best = __reduce_max_sync(0xFFFFFFFFu, best);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x < 32) {
    best = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0;
    best = __reduce_max_sync(0xFFFFFFFFu, best);
    if (threadIdx.x == 0) atomicMax(max_err, best);
  }
}

int blocks_for(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// P1. qwords [b, w] u32, qlens [b] i32; h1, h2 [b] u32 out.
int ybt_point_fnv64(const uint32_t* qwords, const int32_t* qlens, int b,
                    int w, uint32_t* h1, uint32_t* h2, void* stream) {
  if (b <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  fnv64_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
      qwords, qlens, b, w, h1, h2);
  return (int)cudaGetLastError();
}

// P2. h1, h2 [b] u32; words: the filter's bit words (>= m_bits / 32);
// ok [b] bool out.
int ybt_point_bloom(const uint32_t* h1, const uint32_t* h2,
                    const uint32_t* words, uint32_t m_bits, int k, int b,
                    bool* ok, void* stream) {
  if (b <= 0 || m_bits == 0) return (int)cudaErrorInvalidValue;
  bloom_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
      h1, h2, words, m_bits, k, b, ok);
  return (int)cudaGetLastError();
}

// P3. cols [8 + w, n_pad] u32; qwords [b, w] u32; qlens [b] i32; the model
// operands on the host (17 each; ignored unless use_model); out [4, b]
// i32 (idx, ht_hi, ht_lo, wid), flags [2, b] bool (hit, miss).
int ybt_point_locate(const uint32_t* cols, int64_t n_pad, int n,
                     const uint32_t* qwords, const int32_t* qlens, int b,
                     int w, uint32_t rhi, uint32_t rlo, const uint32_t* a_hi,
                     const uint32_t* a_lo, const int32_t* anchor_pos, int p,
                     int max_err, int use_model, int steps, int32_t* out,
                     bool* flags, void* stream) {
  if (b <= 0 || w <= 0 || n <= 0 || n > n_pad || (use_model && w < 2))
    return (int)cudaErrorInvalidValue;
  Model model;
  for (int s = 0; s < kAnchors; ++s) {
    model.a_hi[s] = a_hi[s];
    model.a_lo[s] = a_lo[s];
    model.pos[s] = anchor_pos[s];
  }
  model.p = p;
  model.max_err = max_err;
  locate_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
      cols, n_pad, n, qwords, qlens, b, w, rhi, rlo, model, use_model, steps,
      out, flags);
  return (int)cudaGetLastError();
}

// P4. cols [8 + w, n_pad] u32, n real entries (sorted); a_hi, a_lo [17]
// u32 out; p, max_err: one i32 each, max_err zeroed by the caller.
int ybt_point_index_fit(const uint32_t* cols, int64_t n_pad, int n, int w,
                        uint32_t* a_hi, uint32_t* a_lo, int32_t* p,
                        int32_t* max_err, void* stream) {
  if (w < 2 || n <= 0 || n > n_pad) return (int)cudaErrorInvalidValue;
  int grid = blocks_for(n);
  grid = grid > 132 * 8 ? 132 * 8 : grid;
  index_fit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      cols, n_pad, n, w, a_hi, a_lo, p, max_err);
  return (int)cudaGetLastError();
}

}  // extern "C"
