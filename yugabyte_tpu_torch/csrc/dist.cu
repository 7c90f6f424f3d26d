// Kernels M1-M3: the splitter pick, the shard routing and the stable
// bucket scatter of the key-range-sharded distributed compaction.
//
// Replace the per-shard device program of yugabyte_tpu/parallel/
// dist_compact.py `dist_compact_fn`'s `per_shard` (:112-178):
//   M1 `splitter_pick`  the route of the gathered samples, their lexsort
//                       with the pad flag as final key and the splitters at
//                       the real-sample quantiles (:113-140);
//   M2 `route_dest`     per row the route key, `dest` = the number of
//                       splitters <= it, and per-tile counts of dest over
//                       all rows and over real rows (:113-124, :142-158);
//   M3 `bucket_scatter` the stable bucketing of the shard's columns plus
//                       the global-index row into [r+1, S*capacity] send
//                       slots, and the overflow word (:150-178).
//
// Row layout of ops/merge_gc.py: row 0 key_len (PAD_SENTINEL marks a pad
// row), row 1 doc_key_len, rows 8.. key words. The route key of a row is
// its first w_route (<= 4) key words, word q masked to its clip(doc_key_len
// - 4q, 0, 4) leading bytes (merge_gc.route_word_mask, as kernel L inlines
// it); a pad row's route is all 0xFFFFFFFF. Routes compare as unsigned
// words, most significant first.
//
// Bounds on an H100: M1 sorts a few hundred samples in one CTA (bitonic, in
// shared memory): latency-bound, a few microseconds of dependent steps. M2
// reads 24 bytes a lane and writes dest (4 bytes): memory-bound. M3 reads
// the shard's r rows and dest, and writes the [r+1, S*capacity] send
// buffer (the unwritten slots are the pad template): memory-bound; the
// scatter writes runs of consecutive slots, one per destination and warp.
//
// M3 is three launches, counted as one wrapper call: `send_fill` (the pad
// template, idx 0xFFFFFFFF, and the overflow word cleared), `dest_scan`
// (one CTA per destination: the exclusive scan of its tile counts and the
// overflow test on its real count) and `dest_scatter` (per tile of 4096
// lanes: each warp owns 512 consecutive lanes and ranks equal dests in
// input order with __match_any_sync, a scan over the 8 warps orders the
// warps, and each lane lands at dest*capacity + its rank, or is dropped
// past capacity). Ranks count every row, pads included: pads sit at the
// shard's tail and route to the last shard, so they rank after its real
// rows, as the JAX program's stable argsort ranks them. The tiles of M2
// and M3 are the same, so M2's per-tile counts are M3's tile bases.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowKeyLen = 0;
constexpr int kRowDkl = 1;
constexpr int kRowWords = 8;
constexpr uint32_t kPad = 0xFFFFFFFFu;
constexpr int kMaxRoute = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // lanes per thread
constexpr int kWarpLanes = 32 * kItems;    // 512 consecutive lanes per warp
constexpr int kTile = kThreads * kItems;   // 4096 lanes per CTA
constexpr int kMaxShards = kThreads;       // one thread per destination
constexpr int kSortThreads = 1024;
constexpr int kScanThreads = 1024;
constexpr int kSortWords = kMaxRoute + 1;  // route words + the pad flag
// M1's bitonic network in shared memory: 8192 x 5 words = 160 KB
constexpr int kMaxSamples = 8192;

__device__ __forceinline__ uint32_t route_mask(int32_t dkl, int q) {
  int nb = dkl - 4 * q;
  nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
  if (nb >= 4) return 0xFFFFFFFFu;
  if (nb == 0) return 0u;
  return 0xFFFFFFFFu << ((4 - nb) * 8);
}

// ---------------------------------------------------------------- M1

// a > b over (words 0..w-1, flag), unsigned
__device__ __forceinline__ bool tuple_gt(const uint32_t* a, const uint32_t* b,
                                         int w) {
  for (int q = 0; q <= w; ++q) {
    const int k = q < w ? q : kMaxRoute;
    if (a[k] != b[k]) return a[k] > b[k];
  }
  return false;
}

// samp: [2 + w, n_samp] (key_len, doc_key_len, key words 0..w-1 of the
// sampled rows); out: [w, n_shards - 1] splitters. p2: the power of two
// >= n_samp the bitonic network sorts (the tail holds flag-2 fillers that
// sort after every sample).
__global__ void splitter_pick_kernel(const uint32_t* __restrict__ samp,
                                     int n_samp, int w, int n_shards, int p2,
                                     uint32_t* __restrict__ out) {
  extern __shared__ uint32_t el[];  // [p2][kSortWords]
  __shared__ int n_pad_samples;
  if (threadIdx.x == 0) n_pad_samples = 0;
  __syncthreads();
  int my_pads = 0;
  for (int i = threadIdx.x; i < p2; i += blockDim.x) {
    uint32_t* e = el + (int64_t)i * kSortWords;
    if (i < n_samp) {
      const bool pad = samp[(int64_t)kRowKeyLen * n_samp + i] == kPad;
      const int32_t dkl = (int32_t)samp[(int64_t)kRowDkl * n_samp + i];
      for (int q = 0; q < w; ++q)
        e[q] = pad ? kPad : samp[(int64_t)(2 + q) * n_samp + i] &
                                route_mask(dkl, q);
      e[kMaxRoute] = pad ? 1u : 0u;
      my_pads += pad;
    } else {
      for (int q = 0; q < w; ++q) e[q] = kPad;
      e[kMaxRoute] = 2u;
    }
  }
  if (my_pads) atomicAdd(&n_pad_samples, my_pads);
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          uint32_t* a = el + (int64_t)i * kSortWords;
          uint32_t* b = el + (int64_t)ixj * kSortWords;
          const bool up = (i & k) == 0;
          // ascending blocks swap a > b, descending ones a < b; equal
          // tuples are identical, so swapping them changes nothing
          if (tuple_gt(a, b, w) == up) {
            for (int q = 0; q < kSortWords; ++q) {
              const uint32_t t = a[q];
              a[q] = b[q];
              b[q] = t;
            }
          }
        }
      }
      __syncthreads();
    }
  }
  int64_t n_real = (int64_t)n_samp - n_pad_samples;
  if (n_real < 1) n_real = 1;
  for (int t = threadIdx.x; t < (n_shards - 1) * w; t += blockDim.x) {
    const int q = t / (n_shards - 1);
    const int s = t - q * (n_shards - 1);
    const int64_t pos = ((int64_t)(s + 1) * n_real) / n_shards;
    out[t] = el[pos * kSortWords + q];
  }
}

// ---------------------------------------------------------------- M2

// cols: [>= 8 + w, n] (the shard, row stride n); split: [w, n_shards - 1];
// dest: [n]; hist, real_hist: [n_shards][tiles] counts of dest per tile
// over every row and over the real rows.
__global__ void route_dest_kernel(const uint32_t* __restrict__ cols, int64_t n,
                                  int w, const uint32_t* __restrict__ split,
                                  int n_shards, int tiles,
                                  int32_t* __restrict__ dest,
                                  int32_t* __restrict__ hist,
                                  int32_t* __restrict__ real_hist) {
  __shared__ uint32_t sp[kMaxRoute * kMaxShards];
  __shared__ int cnt[kMaxShards];
  __shared__ int rcnt[kMaxShards];
  const int n_split = n_shards - 1;
  for (int t = threadIdx.x; t < w * n_split; t += blockDim.x) sp[t] = split[t];
  if (threadIdx.x < n_shards) {
    cnt[threadIdx.x] = 0;
    rcnt[threadIdx.x] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    const bool valid = i < n;
    uint32_t key = 0xFFFFFFFFu;
    int d = 0;
    bool pad = false;
    if (valid) {
      pad = cols[(int64_t)kRowKeyLen * n + i] == kPad;
      const int32_t dkl = (int32_t)cols[(int64_t)kRowDkl * n + i];
      uint32_t r[kMaxRoute];
      for (int q = 0; q < w; ++q)
        r[q] = pad ? kPad : cols[(int64_t)(kRowWords + q) * n + i] &
                                route_mask(dkl, q);
      // dest = the number of splitters lexicographically <= the route
      for (int s = 0; s < n_split; ++s) {
        bool lt = false;
        for (int q = 0; q < w; ++q) {
          const uint32_t sw = sp[q * n_split + s];
          if (r[q] != sw) {
            lt = r[q] < sw;
            break;
          }
        }
        d += !lt;
      }
      dest[i] = d;
      key = ((uint32_t)d << 1) | (pad ? 1u : 0u);
    }
    // one shared atomic per distinct (dest, pad) of the warp
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (valid && lane == __ffs(peers) - 1) {
      atomicAdd(&cnt[d], __popc(peers));
      if (!pad) atomicAdd(&rcnt[d], __popc(peers));
    }
  }
  __syncthreads();
  if (threadIdx.x < n_shards) {
    hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
    real_hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = rcnt[threadIdx.x];
  }
}

// ---------------------------------------------------------------- M3

// The pad template of an [rows, width] send buffer whose last row is the
// global index: rows 0-1 (key_len, doc_key_len) PAD_SENTINEL, rows 2-7
// zero, key words and the index row 0xFFFFFFFF. width % 4 == 0.
__global__ void send_fill_kernel(uint4* __restrict__ send, int rows,
                                 int64_t width, uint32_t* __restrict__ overflow) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = 0u;
  const int64_t n4 = (int64_t)rows * width / 4;
  const int64_t w4 = width / 4;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / w4;
    const uint32_t v = (row <= kRowDkl || row >= kRowWords) ? 0xFFFFFFFFu : 0u;
    send[i] = make_uint4(v, v, v, v);
  }
}

// Exclusive scan of one int per thread across the CTA; `total` receives
// the sum (the block scan of csrc/radix.cu).
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

// CTA d: base[d][t] = the rows of dest d in tiles < t; the overflow word
// set when dest d's real rows exceed the capacity.
__global__ void dest_scan_kernel(const int32_t* __restrict__ hist,
                                 const int32_t* __restrict__ real_hist,
                                 int tiles, int64_t capacity,
                                 int32_t* __restrict__ base,
                                 uint32_t* __restrict__ overflow) {
  const int64_t row = (int64_t)blockIdx.x * tiles;
  int carry = 0;
  int64_t real = 0;
  for (int start = 0; start < tiles; start += kScanThreads) {
    const int i = start + threadIdx.x;
    int total, real_total;
    const int ex = block_exclusive_sum(i < tiles ? hist[row + i] : 0, total);
    block_exclusive_sum(i < tiles ? real_hist[row + i] : 0, real_total);
    if (i < tiles) base[row + i] = carry + ex;
    carry += total;
    real += real_total;
  }
  if (threadIdx.x == 0 && real > capacity) *overflow = 1u;
}

// cols: [r, n] (row stride n); send: [r + 1, n_shards * capacity].
__global__ void dest_scatter_kernel(const uint32_t* __restrict__ cols,
                                    int64_t n, int r,
                                    const int32_t* __restrict__ dest,
                                    const int32_t* __restrict__ base_in,
                                    int tiles, int64_t capacity, int n_shards,
                                    uint32_t idx_base,
                                    uint32_t* __restrict__ send) {
  __shared__ int cnt[kWarps][kMaxShards];
  __shared__ int base[kMaxShards];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < n_shards) {
    for (int w = 0; w < kWarps; ++w) cnt[w][threadIdx.x] = 0;
    base[threadIdx.x] = base_in[(int64_t)threadIdx.x * tiles + blockIdx.x];
  }
  __syncthreads();
  const int64_t wbase =
      (int64_t)blockIdx.x * kTile + (int64_t)warp * kWarpLanes;
  const unsigned lt_mask = (1u << lane) - 1u;
  int d[kItems];
  int off[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    const bool valid = i < n;
    const int dd = valid ? dest[i] : kMaxShards;
    const unsigned peers = __match_any_sync(0xffffffffu, dd);
    const int leader = __ffs(peers) - 1;
    int b = 0;
    if (valid && lane == leader) b = cnt[warp][dd];
    b = __shfl_sync(0xffffffffu, b, leader);
    if (valid && lane == leader) cnt[warp][dd] = b + __popc(peers);
    d[j] = dd;
    off[j] = b + __popc(peers & lt_mask);
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x < n_shards) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w][threadIdx.x];
      cnt[w][threadIdx.x] = run;
      run += c;
    }
  }
  __syncthreads();
  const int64_t width = (int64_t)n_shards * capacity;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    if (i < n) {
      const int64_t rank = (int64_t)base[d[j]] + cnt[warp][d[j]] + off[j];
      if (rank < capacity) {
        const int64_t slot = (int64_t)d[j] * capacity + rank;
        for (int row = 0; row < r; ++row)
          send[row * width + slot] = cols[row * n + i];
        send[(int64_t)r * width + slot] = idx_base + (uint32_t)i;
      }
    }
  }
}

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// M1. samp: device u32 [2 + w, n_samp]; out: device u32 [w, n_shards-1].
int ybt_splitter_pick(const uint32_t* samp, int n_samp, int w, int n_shards,
                      uint32_t* out, void* stream) {
  if (n_samp < 1 || n_samp > kMaxSamples || w < 1 || w > kMaxRoute ||
      n_shards < 2 || n_shards > kMaxShards)
    return (int)cudaErrorInvalidValue;
  int p2 = 1;
  while (p2 < n_samp) p2 <<= 1;
  const size_t smem = (size_t)p2 * kSortWords * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      splitter_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  splitter_pick_kernel<<<1, kSortThreads, smem, (cudaStream_t)stream>>>(
      samp, n_samp, w, n_shards, p2, out);
  return (int)cudaGetLastError();
}

// M2. cols: device u32 [>= 8 + w, n]; split: device u32 [w, n_shards-1];
// dest: device i32 [n]; hist, real_hist: device i32 [n_shards, tiles].
int ybt_route_dest(const uint32_t* cols, int64_t n, int w,
                   const uint32_t* split, int n_shards, int32_t* dest,
                   int32_t* hist, int32_t* real_hist, void* stream) {
  if (n < 1 || n > 0x7FFFFFFF || w < 1 || w > kMaxRoute || n_shards < 1 ||
      n_shards > kMaxShards)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = num_tiles(n);
  route_dest_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      cols, n, w, split, n_shards, (int)tiles, dest, hist, real_hist);
  return (int)cudaGetLastError();
}

// Scratch bytes of M3 for a shard of n lanes and n_shards destinations.
int64_t ybt_bucket_scatter_scratch_bytes(int64_t n, int n_shards) {
  return 4 * (int64_t)n_shards * num_tiles(n);
}

// M3. cols: device u32 [r, n]; dest: device i32 [n]; hist, real_hist: M2's
// counts; send: device u32 [r + 1, n_shards * capacity]; overflow: device
// u32 [1]; scratch: ybt_bucket_scatter_scratch_bytes. Returns the first
// failing launch's error, else cudaGetLastError().
int ybt_bucket_scatter(const uint32_t* cols, int64_t n, int r,
                       const int32_t* dest, const int32_t* hist,
                       const int32_t* real_hist, int64_t capacity,
                       int n_shards, uint32_t idx_base, void* scratch,
                       uint32_t* send, uint32_t* overflow, void* stream) {
  if (n < 1 || n > 0x7FFFFFFF || r < kRowWords + 1 || capacity < 1 ||
      capacity % 4 || n_shards < 1 || n_shards > kMaxShards)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t tiles = num_tiles(n);
  const int64_t width = (int64_t)n_shards * capacity;
  cudaError_t e;
  send_fill_kernel<<<1024, kThreads, 0, st>>>((uint4*)send, r + 1, width,
                                              overflow);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  int32_t* base = (int32_t*)scratch;
  dest_scan_kernel<<<n_shards, kScanThreads, 0, st>>>(
      hist, real_hist, (int)tiles, capacity, base, overflow);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  dest_scatter_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      cols, n, r, dest, base, (int)tiles, capacity, n_shards, idx_base, send);
  return (int)cudaGetLastError();
}

}  // extern "C"
