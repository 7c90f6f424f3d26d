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
// Bounds on an H100: M1 picks S - 1 order statistics of a few hundred
// samples (512 at the mesh job): latency-bound, one launch, one round trip
// for the samples and n / 32 compares a lane in shared memory. It counts
// each sample's rank over a warp and sorts nothing (splitter_pick_kernel);
// the design it replaces ran a bitonic sort of the 5-word tuples in one
// CTA of 1024 threads (45 stages at 512 samples, a barrier each, at most a
// quarter of the threads working) and an atomic pad count. M2
// reads 8 + 4 w_route bytes a lane and writes dest (4 bytes): memory-bound,
// so every load of a thread is in flight before its first compare (see
// route_dest_kernel). M3 reads
// the shard's r rows and dest once and writes the [r+1, S*capacity] send
// buffer once (the slots no row lands in hold the pad template):
// memory-bound, about 1.5x as many bytes written as read at the mesh
// job's capacity factor 2.
//
// M3 is one launch (`bucket_scatter_kernel`) over M2's tiles of 4096
// lanes: each CTA sums M2's per-tile counts of the tiles before its own
// from L2 (a warp a destination; at the mesh job's S = 8 and 512 tiles
// 16 KB a CTA, so no scan launch, no look-back and no ticket are needed),
// ranks its lanes by destination in input order (each warp owns 512
// consecutive lanes, __match_any_sync ranks equal dests, a scan over the 8
// warps orders the warps), then per send row stages the tile's words in
// shared memory in destination order and stores each destination's run as
// consecutive lanes on consecutive slots, dropping ranks past capacity;
// the template goes only to the slots [min(rows of d, capacity),
// capacity) of each destination d, spread over the grid in 16-byte
// stores, and CTA 0 writes the overflow word. Every slot is written once.
// Ranks count every row, pads included: pads sit at the shard's tail and
// route to the last shard, so they rank after its real rows, as the JAX
// program's stable argsort ranks them. The tiles of M2 and M3 are the
// same, so M2's per-tile counts are M3's tile bases.

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
constexpr int kSumLoads = 8;               // M3: count loads in flight a lane
// M1's samples in shared memory at most: 8192 x 5 words = 160 KB
constexpr int kMaxSamples = 8192;

__device__ __forceinline__ uint32_t route_mask(int32_t dkl, int q) {
  int nb = dkl - 4 * q;
  nb = nb < 0 ? 0 : (nb > 4 ? 4 : nb);
  if (nb >= 4) return 0xFFFFFFFFu;
  if (nb == 0) return 0u;
  return 0xFFFFFFFFu << ((4 - nb) * 8);
}

// ---------------------------------------------------------------- M1

// M1's CTA: 16 warps, one sample a warp at a time.
constexpr int kPickThreads = 512;
constexpr int kPickWarps = kPickThreads / 32;

// M1. samp: [2 + W, n] (key_len, doc_key_len, key words 0..W-1 of the
// sampled rows); out: [W, n_shards - 1] splitters. No sort: the splitter
// at pick position pos is the sample of rank pos in the lexsort of the
// tuples t = (route words, pad flag), the rank rank(i) = #{j : t_j < t_i}
// + #{j < i : t_j == t_i} (the tie broken by index, so the ranks are a
// permutation). Each CTA loads every sample's tuple once into shared
// memory (row q < W the masked route word, row W the pad flag; no filler
// tuples), one barrier; then each warp takes a sample i, its lanes
// compare (t_i, i) with (t_j, j) for j = lane, lane + 32, ... (n / 32
// compares a lane, conflict-free rows) and count the tuples below and the
// pads, and __reduce_add_sync gives every lane the rank and the pad count
// (every warp passes over all samples, so no atomic and no second
// barrier). n_real = max(n - pads, 1); pads are the largest tuples, so a
// real sample's rank is below n_real and a pad's is not (all pads: the
// first pad has rank 0). The sample whose rank is (q n_real) / S writes
// splitter q - 1, its lanes over q: each splitter has exactly one writer,
// and equal tuples have equal words, so the splitters are the lexsort's
// whatever the tie order.
template <int W>
__global__ void __launch_bounds__(kPickThreads)
splitter_pick_kernel(const uint32_t* __restrict__ samp, int n, int n_shards,
                     uint32_t* __restrict__ out) {
  extern __shared__ uint32_t tup[];  // [W + 1][n]
  for (int i = threadIdx.x; i < n; i += kPickThreads) {
    const bool pad = __ldg(samp + (int64_t)kRowKeyLen * n + i) == kPad;
    const int32_t dkl = (int32_t)__ldg(samp + (int64_t)kRowDkl * n + i);
    uint32_t x[W];
#pragma unroll
    for (int q = 0; q < W; ++q) x[q] = __ldg(samp + (int64_t)(2 + q) * n + i);
#pragma unroll
    for (int q = 0; q < W; ++q) tup[q * n + i] = pad ? kPad : x[q] & route_mask(dkl, q);
    tup[W * n + i] = pad ? 1u : 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kPickWarps + (threadIdx.x >> 5); i < n;
       i += gridDim.x * kPickWarps) {
    uint32_t ti[W + 1];
#pragma unroll
    for (int q = 0; q <= W; ++q) ti[q] = tup[q * n + i];
    unsigned below = 0u, pads = 0u;
    for (int j = lane; j < n; j += 32) {
      bool lt = false, eq = true;
#pragma unroll
      for (int q = 0; q <= W; ++q) {
        const uint32_t y = tup[q * n + j];
        lt = lt || (eq && y < ti[q]);
        eq = eq && y == ti[q];
        if (q == W) pads += y;
      }
      below += (lt || (eq && j < i)) ? 1u : 0u;
    }
    const unsigned rank = __reduce_add_sync(0xFFFFFFFFu, below);
    const int64_t n_pad = __reduce_add_sync(0xFFFFFFFFu, pads);
    const int64_t n_real = n - n_pad < 1 ? 1 : n - n_pad;
    if (rank >= n_real) continue;  // a pad: no pick position is its rank
    for (int q = 1 + lane; q < n_shards; q += 32) {
      if ((int64_t)q * n_real / n_shards != rank) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) out[w * (n_shards - 1) + q - 1] = ti[w];
    }
  }
}

// ---------------------------------------------------------------- M2

// M2's CTA: kTile lanes over 512 threads, 8 lanes a thread, two CTAs an
// SM (at most 64 registers a thread). On the mesh job's shard this ran
// ahead of 256 threads of 16 lanes (one CTA an SM at 128 registers) and
// of 1024 threads of 4.
constexpr int kM2Threads = 512;
constexpr int kM2Items = kTile / kM2Threads;

// Lane of item j (0..kM2Items-1) of this thread in its tile. kVec:
// kM2Items / 4 groups of 4 consecutive lanes, group k at k * 4 * kM2Threads
// + 4t (a 16-byte load a row); else lane j * kM2Threads + t (a 4-byte load
// a row).
template <bool kVec>
__device__ __forceinline__ int64_t m2_lane(int j) {
  return kVec ? (int64_t)(j >> 2) * (4 * kM2Threads) + 4 * threadIdx.x + (j & 3)
              : (int64_t)j * kM2Threads + threadIdx.x;
}

// One row's words at this thread's kM2Items lanes of the tile at tile0,
// every load issued before any is used; a lane at or past n reads nothing
// and holds 0. kVec: n % 4 == 0, so a group lies wholly below n or wholly
// at or past it.
template <bool kVec>
__device__ __forceinline__ void m2_load_row(const uint32_t* __restrict__ row,
                                            int64_t tile0, int64_t n,
                                            uint32_t (&v)[kM2Items]) {
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kM2Items / 4; ++k) {
      const int64_t i = tile0 + m2_lane<true>(4 * k);
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (i < n) q = __ldg(reinterpret_cast<const uint4*>(row + i));
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kM2Items; ++j) {
      const int64_t i = tile0 + m2_lane<false>(j);
      v[j] = i < n ? __ldg(row + i) : 0u;
    }
  }
}

// Splitter s <= route r over 4 words, most significant first (the words
// past w are 0 in both).
__device__ __forceinline__ bool split_le(uint4 s, const uint32_t (&r)[kMaxRoute]) {
  if (s.x != r[0]) return s.x < r[0];
  if (s.y != r[1]) return s.y < r[1];
  if (s.z != r[2]) return s.z < r[2];
  return s.w <= r[3];
}

// M2. cols: [>= 8 + w, n] (the shard, row stride n); split: [w, n_shards -
// 1]; dest: [n]; hist, real_hist: [n_shards][tiles] counts of dest per tile
// over every row and over the real rows. One CTA a tile of kTile lanes,
// kM2Items lanes a thread:
//   1. every load of the thread in flight before any compare: key_len,
//      doc_key_len and the w route words at its 8 lanes (kVec: 2 groups
//      of 4 consecutive lanes, a 16-byte load a group and row, where n % 4
//      == 0 and the matrix and dest are 16-byte aligned; else a load a
//      lane and row);
//   2. dest = the number of splitters <= the route, by a binary search over
//      the splitters in shared memory (one 16-byte word a splitter):
//      ceil(log2 S) compares in place of S - 1. Precondition: the
//      splitters never decrease (M1's are quantiles of the sorted samples),
//      so the splitters <= a route are a prefix and their count is the
//      upper bound, equal splitters and a route equal to one included;
//   3. dest stored (16-byte stores in kVec), then the tile's counts: a warp
//      whose 256 lanes share one (dest, pad) adds them by one shared atomic
//      (a sorted shard's common case), any other warp by one shared atomic
//      per distinct (dest, pad) of each item (__match_any_sync); one write
//      a destination and tile.
template <bool kVec>
__global__ void __launch_bounds__(kM2Threads, 2)
route_dest_kernel(const uint32_t* __restrict__ cols, int64_t n, int w,
                  const uint32_t* __restrict__ split, int n_shards, int tiles,
                  int32_t* __restrict__ dest, int32_t* __restrict__ hist,
                  int32_t* __restrict__ real_hist) {
  constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // a lane at or past n
  __shared__ uint4 sp[kMaxShards];
  __shared__ int cnt[kMaxShards];
  __shared__ int rcnt[kMaxShards];
  const int n_split = n_shards - 1;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;
  uint32_t kl[kM2Items], dk[kM2Items], wd[kMaxRoute][kM2Items];
  m2_load_row<kVec>(cols + (int64_t)kRowKeyLen * n, tile0, n, kl);
  m2_load_row<kVec>(cols + (int64_t)kRowDkl * n, tile0, n, dk);
#pragma unroll
  for (int q = 0; q < kMaxRoute; ++q) {
    if (q < w) {
      m2_load_row<kVec>(cols + (int64_t)(kRowWords + q) * n, tile0, n, wd[q]);
    } else {
#pragma unroll
      for (int j = 0; j < kM2Items; ++j) wd[q][j] = 0u;
    }
  }
  for (int s = threadIdx.x; s < n_split; s += kM2Threads) {
    uint32_t x[kMaxRoute];
#pragma unroll
    for (int q = 0; q < kMaxRoute; ++q) x[q] = q < w ? split[q * n_split + s] : 0u;
    sp[s] = make_uint4(x[0], x[1], x[2], x[3]);
  }
  if (threadIdx.x < n_shards) {
    cnt[threadIdx.x] = 0;
    rcnt[threadIdx.x] = 0;
  }
  __syncthreads();
  int d[kM2Items];
  uint32_t key[kM2Items];
#pragma unroll
  for (int j = 0; j < kM2Items; ++j) {
    const bool pad = kl[j] == kPad;
    uint32_t r[kMaxRoute];
#pragma unroll
    for (int q = 0; q < kMaxRoute; ++q)
      r[q] = q < w ? (pad ? kPad : wd[q][j] & route_mask((int32_t)dk[j], q)) : 0u;
    int lo = 0, len = n_split;
    while (len > 0) {
      const int half = len >> 1;
      if (split_le(sp[lo + half], r)) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    d[j] = lo;
    key[j] = tile0 + m2_lane<kVec>(j) < n ? ((uint32_t)lo << 1) | (pad ? 1u : 0u)
                                          : kNoKey;
  }
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kM2Items / 4; ++k) {
      const int64_t i = tile0 + m2_lane<true>(4 * k);
      if (i < n)
        *reinterpret_cast<int4*>(dest + i) =
            make_int4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kM2Items; ++j) {
      const int64_t i = tile0 + m2_lane<false>(j);
      if (i < n) dest[i] = d[j];
    }
  }
  const int lane = threadIdx.x & 31;
  const uint32_t k0 = __shfl_sync(0xffffffffu, key[0], 0);
  bool same = true;
#pragma unroll
  for (int j = 0; j < kM2Items; ++j) same = same && key[j] == k0;
  if (__all_sync(0xffffffffu, same)) {
    if (lane == 0 && k0 != kNoKey) {
      atomicAdd(&cnt[k0 >> 1], 32 * kM2Items);
      if (!(k0 & 1u)) atomicAdd(&rcnt[k0 >> 1], 32 * kM2Items);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kM2Items; ++j) {
      const unsigned peers = __match_any_sync(0xffffffffu, key[j]);
      if (key[j] != kNoKey && lane == __ffs(peers) - 1) {
        atomicAdd(&cnt[key[j] >> 1], __popc(peers));
        if (!(key[j] & 1u)) atomicAdd(&rcnt[key[j] >> 1], __popc(peers));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < n_shards) {
    hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
    real_hist[(int64_t)threadIdx.x * tiles + blockIdx.x] = rcnt[threadIdx.x];
  }
}

// ---------------------------------------------------------------- M3

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

// The pad template's word in send row `row` (the global index is the last
// row, r >= 9): rows 0-1 (key_len, doc_key_len) PAD_SENTINEL, rows 2-7
// zero, key words and the index row 0xFFFFFFFF.
__device__ __forceinline__ uint32_t template_word(int row) {
  return (row <= kRowDkl || row >= kRowWords) ? 0xFFFFFFFFu : 0u;
}

// M3 in one launch. cols: [r, n] (row stride n); send: [r + 1, n_shards *
// capacity]; grid: max(tiles, a few CTAs an SM) CTAs; CTA t < tiles owns
// tile t of M2's tiling. Each CTA
//   1. sums M2's counts from L2, a warp a destination, kSumLoads loads in
//      flight a lane (one at a time, these round trips cost about 5% of
//      the kernel at the mesh job's 512 tiles): base[d] = rows of d in tiles
//      before t, fill[d] = min(rows of d, capacity), the first slot of
//      d's template; CTA 0 also sums the real rows and writes the
//      overflow word (no init launch, no atomic on it);
//   2. ranks its tile's lanes by destination in input order
//      (__match_any_sync within a warp, a scan over the warps), so each
//      lane has a position in the tile's destination order and each
//      position a slot d * capacity + base[d] + its rank in d, or none past
//      capacity;
//   3. per send row, stages the tile's words in shared memory in
//      destination order (double-buffered: row k + 1's loads are in flight
//      while row k is stored) and stores position p from thread p % 256,
//      so each destination's run goes out as consecutive lanes on
//      consecutive slots (full sectors but at a run's two ends);
//   4. writes its share of the template slots [fill[d], capacity) of every
//      destination and row, 16-byte stores over the aligned body (the
//      grid splits each destination's rows x body evenly), the unaligned
//      heads (at most 3 words) spread over the grid.
// Every send slot is written once, by step 3 or step 4.
__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const uint32_t* __restrict__ cols, int64_t n, int r,
                      const int32_t* __restrict__ dest,
                      const int32_t* __restrict__ hist,
                      const int32_t* __restrict__ real_hist, int tiles,
                      int capacity, int n_shards, uint32_t idx_base,
                      uint32_t* __restrict__ send,
                      uint32_t* __restrict__ overflow) {
  __shared__ uint32_t stage[2][kTile];
  __shared__ int cnt[kWarps][kMaxShards];
  __shared__ int s_base[kMaxShards], s_fill[kMaxShards];
  __shared__ int s_off[kMaxShards + 1];
  __shared__ int64_t s_tpre[kMaxShards + 1];
  __shared__ int s_over;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int64_t width = (int64_t)n_shards * capacity;

  // 1. bases and fills from M2's counts
  if (threadIdx.x == 0) s_over = 0;
  __syncthreads();
  for (int d = warp; d < n_shards; d += kWarps) {
    const int32_t* hr = hist + (int64_t)d * tiles;
    int before = 0, all = 0;
    for (int t0 = lane; t0 < tiles; t0 += 32 * kSumLoads) {
      int c[kSumLoads];  // kSumLoads loads in flight a lane
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u)
        c[u] = t0 + 32 * u < tiles ? hr[t0 + 32 * u] : 0;
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u) {
        all += c[u];
        before += t0 + 32 * u < tile ? c[u] : 0;
      }
    }
    before = __reduce_add_sync(0xffffffffu, before);
    all = __reduce_add_sync(0xffffffffu, all);
    if (lane == 0) {
      s_base[d] = before;
      s_fill[d] = all < capacity ? all : capacity;
    }
    if (blockIdx.x == 0) {
      const int32_t* rr = real_hist + (int64_t)d * tiles;
      int real = 0;
      for (int t = lane; t < tiles; t += 32) real += rr[t];
      real = __reduce_add_sync(0xffffffffu, real);
      if (lane == 0 && real > capacity) s_over = 1;
    }
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) *overflow = (uint32_t)s_over;

  if (tile < tiles) {
    // 2. rank the tile's lanes by destination
    if (threadIdx.x < n_shards)
      for (int w = 0; w < kWarps; ++w) cnt[w][threadIdx.x] = 0;
    __syncthreads();
    const int64_t wbase = (int64_t)tile * kTile + (int64_t)warp * kWarpLanes;
    const unsigned lt_mask = (1u << lane) - 1u;
    int d[kItems], pos[kItems];
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
      pos[j] = b + __popc(peers & lt_mask);
      __syncwarp();
    }
    __syncthreads();
    int tile_cnt = 0;
    if (threadIdx.x < n_shards) {
      for (int w = 0; w < kWarps; ++w) {
        const int c = cnt[w][threadIdx.x];
        cnt[w][threadIdx.x] = tile_cnt;
        tile_cnt += c;
      }
    }
    int valid_lanes;
    const int off = block_exclusive_sum(tile_cnt, valid_lanes);
    if (threadIdx.x < n_shards) s_off[threadIdx.x] = off;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      pos[j] = d[j] < kMaxShards ? s_off[d[j]] + cnt[warp][d[j]] + pos[j]
                                 : -1;
    // the slot of position p = threadIdx.x + k * kThreads, or -1
    int slot[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int p = threadIdx.x + k * kThreads;
      slot[k] = -1;
      if (p < valid_lanes) {
        int lo = 0, hi = n_shards - 1;  // the last dest whose run starts <= p
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_off[mid] <= p)
            lo = mid;
          else
            hi = mid - 1;
        }
        const int rank = s_base[lo] + (p - s_off[lo]);
        if (rank < capacity) slot[k] = lo * capacity + rank;
      }
    }

    // 3. every send row through shared memory, in destination order
    const int64_t i0 = (int64_t)tile * kTile + (int64_t)warp * kWarpLanes + lane;
    uint32_t v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int64_t i = i0 + j * 32;
      v[j] = i < n ? cols[i] : 0u;
    }
    for (int row = 0; row <= r; ++row) {
      uint32_t* buf = stage[row & 1];
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (pos[j] >= 0) buf[pos[j]] = v[j];
      __syncthreads();
      if (row + 1 < r) {
        const uint32_t* src = cols + (int64_t)(row + 1) * n;
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int64_t i = i0 + j * 32;
          v[j] = i < n ? src[i] : 0u;
        }
      } else if (row + 1 == r) {
#pragma unroll
        for (int j = 0; j < kItems; ++j)
          v[j] = idx_base + (uint32_t)(i0 + j * 32);
      }
      uint32_t* out = send + (int64_t)row * width;
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (slot[k] >= 0) out[slot[k]] = buf[threadIdx.x + k * kThreads];
    }
  }

  // 4. this CTA's share of the template slots
  const int rows = r + 1;
  if (threadIdx.x == 0) {
    int64_t acc = 0;
    for (int dd = 0; dd < n_shards; ++dd) {
      s_tpre[dd] = acc;
      acc += (int64_t)rows * ((capacity - ((s_fill[dd] + 3) & ~3)) >> 2);
    }
    s_tpre[n_shards] = acc;
  }
  __syncthreads();
  const int64_t total = s_tpre[n_shards];
  const int64_t lo = total * blockIdx.x / gridDim.x;
  const int64_t hi = total * (blockIdx.x + 1) / gridDim.x;
  for (int dd = 0; dd < n_shards && lo < hi; ++dd) {
    const int64_t a = lo > s_tpre[dd] ? lo : s_tpre[dd];
    const int64_t b = hi < s_tpre[dd + 1] ? hi : s_tpre[dd + 1];
    if (a >= b) continue;
    const int al = (s_fill[dd] + 3) & ~3;
    const int body = (capacity - al) >> 2;  // > 0 here
    uint4* base4 = reinterpret_cast<uint4*>(send + (int64_t)dd * capacity + al);
    const int64_t w4 = width >> 2;
    int64_t e = a - s_tpre[dd] + threadIdx.x;
    const int64_t e_end = b - s_tpre[dd];
    int row = (int)(e / body), q = (int)(e % body);
    const int step_row = kThreads / body, step_q = kThreads % body;
    for (; e < e_end; e += kThreads) {
      const uint32_t t = template_word(row);
      base4[(int64_t)row * w4 + q] = make_uint4(t, t, t, t);
      q += step_q;
      row += step_row;
      if (q >= body) {
        q -= body;
        ++row;
      }
    }
  }
  for (int64_t x = (int64_t)blockIdx.x * kThreads + threadIdx.x;
       x < (int64_t)n_shards * rows * 3; x += (int64_t)gridDim.x * kThreads) {
    const int dd = (int)(x / (rows * 3));
    const int row = (int)(x / 3 % rows);
    const int c = s_fill[dd] + (int)(x % 3);
    if (c < ((s_fill[dd] + 3) & ~3))
      send[(int64_t)row * width + (int64_t)dd * capacity + c] =
          template_word(row);
  }
}

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

// SMs of the current device (counted once per device).
int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int& c = sms[dev & 63];
  if (c == 0) cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
  return c;
}

// M1's grid: a CTA for each kPickWarps samples, at most one an SM (each
// CTA loads every sample).
template <int W>
int launch_pick(const uint32_t* samp, int n, int n_shards, uint32_t* out,
                cudaStream_t st) {
  const size_t smem = (size_t)(W + 1) * n * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        splitter_pick_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int want = (n + kPickWarps - 1) / kPickWarps;
  splitter_pick_kernel<W><<<want < sms ? want : sms, kPickThreads, smem, st>>>(
      samp, n, n_shards, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// M1. samp: device u32 [2 + w, n_samp]; out: device u32 [w, n_shards-1].
// One launch; returns cudaGetLastError().
int ybt_splitter_pick(const uint32_t* samp, int n_samp, int w, int n_shards,
                      uint32_t* out, void* stream) {
  if (n_samp < 1 || n_samp > kMaxSamples || w < 1 || w > kMaxRoute ||
      n_shards < 2 || n_shards > kMaxShards)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (w) {
    case 1: return launch_pick<1>(samp, n_samp, n_shards, out, st);
    case 2: return launch_pick<2>(samp, n_samp, n_shards, out, st);
    case 3: return launch_pick<3>(samp, n_samp, n_shards, out, st);
    default: return launch_pick<4>(samp, n_samp, n_shards, out, st);
  }
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
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(cols) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(dest) & 15) == 0;
  if (vec)
    route_dest_kernel<true><<<(unsigned)tiles, kM2Threads, 0, (cudaStream_t)stream>>>(
        cols, n, w, split, n_shards, (int)tiles, dest, hist, real_hist);
  else
    route_dest_kernel<false><<<(unsigned)tiles, kM2Threads, 0, (cudaStream_t)stream>>>(
        cols, n, w, split, n_shards, (int)tiles, dest, hist, real_hist);
  return (int)cudaGetLastError();
}

// M3. cols: device u32 [r, n]; dest: device i32 [n]; hist, real_hist: M2's
// counts; send: device u32 [r + 1, n_shards * capacity]; overflow: device
// u32 [1]. One launch.
int ybt_bucket_scatter(const uint32_t* cols, int64_t n, int r,
                       const int32_t* dest, const int32_t* hist,
                       const int32_t* real_hist, int64_t capacity,
                       int n_shards, uint32_t idx_base, uint32_t* send,
                       uint32_t* overflow, void* stream) {
  if (n < 1 || n > 0x7FFFFFFF || r < kRowWords + 1 || capacity < 1 ||
      capacity % 4 || n_shards < 1 || n_shards > kMaxShards ||
      capacity * n_shards > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = num_tiles(n);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int64_t grid = tiles > 2 * sms ? tiles : 2 * sms;
  bucket_scatter_kernel<<<(unsigned)grid, kThreads, 0,
                          (cudaStream_t)stream>>>(
      cols, n, r, dest, hist, real_hist, (int)tiles, (int)capacity, n_shards,
      idx_base, send, overflow);
  return (int)cudaGetLastError();
}

}  // extern "C"
