// Kernel G: the LSD radix merge of sort_and_gc, one stable sort per
// scheduled row.
//
// Replaces the `lax.fori_loop` of yugabyte_tpu/ops/merge_gc.py
// `sort_and_gc` (:216-228): for each scheduled row k (least significant
// first) perm <- perm stably sorted by cols[row_k][perm] ^ invert, where
// the ht_hi, ht_lo and write_id rows (2-4) are complemented so that they
// sort descending. The result is the unique stable order, so perm equals
// the JAX package's bit for bit: ties fall to the input index.
//
// Input: cols u32 [R, n] (the merge_gc row layout), the host schedule of
// row ids. Output: perm int32 [n]. Per scheduled row:
//   gather_keys   keys[i] = cols[row][perm[i]] ^ invert
//   then four stable counting-sort passes over the 8-bit digits of the key
//   (least significant digit first), perm riding along as the payload,
//   ping-ponging between two key and two perm buffers (four passes: the
//   row ends in the perm buffer it started from). Each pass is
//     digit_hist     per tile of 4096 keys: its 256-bucket histogram,
//                    stored bucket-major [256][tiles];
//     bucket_scan    one CTA per bucket: exclusive scan of that bucket's
//                    counts across tiles, plus the bucket's total;
//     digit_scatter  per tile: each warp owns 512 consecutive keys and
//                    ranks equal digits in index order (__match_any_sync
//                    and a per-warp running count per digit), a scan over
//                    the 8 warps per digit orders the warps, and each key
//                    lands at digit base + tile prefix + its rank.
// Stability comes from that order: within a tile by (warp, round, lane),
// across tiles by the bucket-major scan.
//
// Bound on an H100: memory. The function must read the scheduled rows and
// write perm; this design moves per row a 4-byte gather and per pass 8
// bytes in and 8 out per key (the keys are re-read by the histogram), so
// it sits far above that bound. A onesweep pass with decoupled look-back
// and a shared-memory staged scatter is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // keys per thread
constexpr int kWarpKeys = 32 * kItems;     // 512 consecutive keys per warp
constexpr int kTile = kThreads * kItems;   // 4096 keys per CTA
constexpr int kBuckets = 256;
constexpr int kScanThreads = 1024;
constexpr int kRowHtHi = 2, kRowWid = 4;
static_assert(kThreads == kBuckets, "one thread per digit in the scatter");

// Exclusive scan of one int per thread across the CTA (warp shuffles, then
// one warp over the warp sums); `total` receives the sum.
__device__ int block_exclusive_sum(int v, int& total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  total = warp_sums[nwarps - 1];
  const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return excl;
}

__global__ void iota(int32_t* __restrict__ perm, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) perm[i] = (int32_t)i;
}

__global__ void gather_keys(const uint32_t* __restrict__ col,
                            const int32_t* __restrict__ perm, int64_t n,
                            uint32_t invert, uint32_t* __restrict__ keys) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) keys[i] = col[perm[i]] ^ invert;
}

__global__ void digit_hist(const uint32_t* __restrict__ keys, int64_t n,
                           int shift, int tiles, int32_t* __restrict__ hist) {
  __shared__ int cnt[kBuckets];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    const bool valid = i < n;
    const uint32_t d = valid ? (keys[i] >> shift) & 0xFFu : 0x100u;
    // one shared atomic per distinct digit of the warp
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (valid && lane == __ffs(peers) - 1) atomicAdd(&cnt[d], __popc(peers));
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
}

// CTA b: exclusive scan in place of hist[b][0..tiles), totals[b] = the sum.
__global__ void bucket_scan(int32_t* __restrict__ hist, int tiles,
                            int32_t* __restrict__ totals) {
  int32_t* row = hist + (int64_t)blockIdx.x * tiles;
  int carry = 0;
  for (int start = 0; start < tiles; start += kScanThreads) {
    const int i = start + threadIdx.x;
    const int v = i < tiles ? row[i] : 0;
    int total;
    const int ex = block_exclusive_sum(v, total);
    if (i < tiles) row[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void digit_scatter(const uint32_t* __restrict__ keys_in,
                              const int32_t* __restrict__ vals_in, int64_t n,
                              int shift, int tiles,
                              const int32_t* __restrict__ hist,
                              const int32_t* __restrict__ totals,
                              uint32_t* __restrict__ keys_out,
                              int32_t* __restrict__ vals_out,
                              int write_keys) {
  __shared__ int cnt[kWarps][kBuckets];
  __shared__ int base[kBuckets];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = 0; w < kWarps; ++w) cnt[w][threadIdx.x] = 0;
  {
    // this tile's start in digit threadIdx.x: all smaller digits, then the
    // earlier tiles' keys of this digit
    int unused;
    const int d_excl = block_exclusive_sum(totals[threadIdx.x], unused);
    base[threadIdx.x] =
        d_excl + hist[(int64_t)threadIdx.x * tiles + blockIdx.x];
  }
  __syncthreads();

  const int64_t wbase = (int64_t)blockIdx.x * kTile + (int64_t)warp * kWarpKeys;
  const unsigned lt_mask = (1u << lane) - 1u;
  uint32_t key[kItems];
  int32_t val[kItems];
  int off[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    const bool valid = i < n;
    key[j] = valid ? keys_in[i] : 0u;
    val[j] = valid ? vals_in[i] : 0;
    const uint32_t d = valid ? (key[j] >> shift) & 0xFFu : 0x100u;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    int b = 0;
    if (valid && lane == leader) b = cnt[warp][d];
    b = __shfl_sync(0xffffffffu, b, leader);
    if (valid && lane == leader) cnt[warp][d] = b + __popc(peers);
    off[j] = b + __popc(peers & lt_mask);
    __syncwarp();
  }
  __syncthreads();
  {
    const int d = threadIdx.x;
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][d];
      cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    if (i < n) {
      const uint32_t d = (key[j] >> shift) & 0xFFu;
      const int64_t dst = (int64_t)base[d] + cnt[warp][d] + off[j];
      if (write_keys) keys_out[dst] = key[j];
      vals_out[dst] = val[j];
    }
  }
}

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

}  // namespace

extern "C" {

// Scratch bytes the wrapper allocates for a sort of n keys.
int64_t ybt_radix_scratch_bytes(int64_t n) {
  return 3 * align16(4 * n) + align16(4 * kBuckets * num_tiles(n)) +
         align16(4 * kBuckets);
}

// cols: [>= max(rows)+1, n] u32; rows: host array of n_rows row ids (least
// significant first); perm: [n] int32 out. Returns cudaGetLastError()
// after the last launch (the first failing launch's error).
int ybt_radix_sort(const uint32_t* cols, int64_t n, const int32_t* rows,
                   int n_rows, void* scratch, int32_t* perm, void* stream) {
  if (n <= 0 || n > 0x7FFFFFFF || n_rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = num_tiles(n);
  char* s = (char*)scratch;
  uint32_t* keys_a = (uint32_t*)s;
  s += align16(4 * n);
  uint32_t* keys_b = (uint32_t*)s;
  s += align16(4 * n);
  int32_t* vals_b = (int32_t*)s;
  s += align16(4 * n);
  int32_t* hist = (int32_t*)s;
  s += align16(4 * kBuckets * tiles);
  int32_t* totals = (int32_t*)s;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  cudaError_t e;
  iota<<<grid, kThreads, 0, st>>>(perm, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  for (int k = 0; k < n_rows; ++k) {
    const int row = rows[k];
    const uint32_t invert =
        (row >= kRowHtHi && row <= kRowWid) ? 0xFFFFFFFFu : 0u;
    gather_keys<<<grid, kThreads, 0, st>>>(cols + (int64_t)row * n, perm, n,
                                           invert, keys_a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    for (int p = 0; p < 4; ++p) {
      const bool even = (p & 1) == 0;
      const uint32_t* kin = even ? keys_a : keys_b;
      const int32_t* vin = even ? perm : vals_b;
      uint32_t* kout = even ? keys_b : keys_a;
      int32_t* vout = even ? vals_b : perm;
      digit_hist<<<(unsigned)tiles, kThreads, 0, st>>>(kin, n, 8 * p,
                                                      (int)tiles, hist);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      bucket_scan<<<kBuckets, kScanThreads, 0, st>>>(hist, (int)tiles, totals);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      digit_scatter<<<(unsigned)tiles, kThreads, 0, st>>>(
          kin, vin, n, 8 * p, (int)tiles, hist, totals, kout, vout, p < 3);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
