// Kernel G: the LSD radix merge of sort_and_gc, as onesweep passes.
//
// Replaces the `lax.fori_loop` of yugabyte_tpu/ops/merge_gc.py
// `sort_and_gc` (:216-228): for each scheduled row k (least significant
// first) perm <- perm stably sorted by cols[row_k][perm] ^ invert, where
// the ht_hi, ht_lo and write_id rows (2-4) are complemented so that they
// sort descending. The result is the unique stable order, so perm equals
// the JAX package's bit for bit: ties fall to the input index.
//
// Input: cols u32 [R, n] (the merge_gc row layout), the host schedule of
// row ids. Output: perm int32 [n]. A sort is 8-bit LSD passes, least
// significant digit of the least significant row first, in two host calls:
//   ybt_radix_stats   one memset, then two launches over the scheduled
//                     rows, read coalesced and without perm:
//                     tail_compare finds the tail block, the columns
//                     n_prefix..n-1 equal to column n-1 in every scheduled
//                     row (a shape bucket's pad columns), and counts the
//                     keys <= its key; digit_counts (grid.y = row) counts
//                     the 256 buckets of each of the 4 digits of
//                     cols[row] ^ invert over the prefix (a digit's
//                     histogram does not depend on the order).
//   (host)            ops/radix.py `sort_plan`: the block is one run of
//                     ties in index order, so only the prefix is sorted and
//                     the block lands at `at`, the count of prefix keys <=
//                     its key. `pass_plan` drops every pass in which one
//                     bucket holds all the prefix's keys (a stable sort by
//                     a constant key is the identity) and chooses the
//                     buffers of the kept ones, so that the last writes
//                     perm. The statistics come down once (about 28 KB for
//                     7 rows).
//   ybt_radix_passes  one memset of every pass's tile status words and
//                     tickets, one launch per kept pass, then one launch
//                     writing the block's indices (or, with no pass kept,
//                     the whole order: the iota with the block placed).
// A pass (onesweep, Adinets and Merrill 2022): each CTA (256 threads)
// takes a tile of 4096 keys from a global atomic ticket, so every tile it
// looks back on is held by a CTA that runs. It loads its keys: the first
// kept pass of a row gathers them, cols[row][perm_in[i]] ^ invert (the
// iota before the first pass), later passes of the row read the key
// buffer the previous one wrote. Each warp ranks its 512 consecutive keys
// in index order (__match_any_sync, one shared atomic per distinct digit
// of a warp round, warp-private counters; a match built from 8 ballots
// measured slower here). The CTA publishes its 256 digit counts as
// flag-tagged 32-bit status words (2-bit flag: aggregate or inclusive
// prefix; 30-bit count, n < 2^30); thread d looks back over digit d, 8
// tiles a load round (every resident tile starts at once, so a one-tile
// walk chains through the first wave), until an inclusive prefix, adds
// the digit's global base (the exclusive scan of the pass's counts) and
// publishes its own prefix. Keys and perm are staged in shared memory
// sorted by digit (32 KB), so each digit's run leaves as contiguous,
// coalesced stores; the last pass moves every destination from `at` on up
// by the block's length. The last kept pass of a row writes no keys.
// Stability: within a tile by (warp, round, lane), across tiles by the
// ticket order of the look-back.
//
// Bound on an H100: memory. The function must read the scheduled rows and
// write perm. A kept pass moves 16 bytes a prefix key (key and perm in and
// out; 12 on a row's last pass); a row's first kept pass gathers the row
// at random 4-byte places through perm. Measured at the seq-scan's shape
// (2^24 columns, 10M before the pad block, 13 of 28 passes kept): each
// CTA waits most of its time on its loads and its look-back (latency, 3
// CTAs an SM at 80 registers), and a pass over uniformly spread digits
// (runs of about 16 keys a tile) takes longer than one over long runs.
// Left: larger tiles for longer runs, and the perm still moves on every
// pass of a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // keys per thread
constexpr int kWarpKeys = 32 * kItems;     // 512 consecutive keys per warp
constexpr int kTile = kThreads * kItems;   // 4096 keys per CTA
constexpr int kBuckets = 256;
constexpr int kLook = 8;                   // look-back status loads a round
constexpr int kHistItems = 8;              // loads in flight per thread
constexpr int kParts = 8;                  // histogram copies a bucket
constexpr int kPartStride = kParts + 1;    // padded: copies on other banks
constexpr int kHistSpan = 1 << 16;         // keys per histogram CTA
constexpr int kMaxRows = 128;              // rows per launch
constexpr int kTailItems = 8;              // columns per thread, tail compare
constexpr int kRowHtHi = 2, kRowWid = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kFlagAgg = 1u << 30, kFlagPrefix = 2u << 30;
constexpr uint32_t kCountMask = (1u << 30) - 1u;
static_assert(kThreads == kBuckets, "one thread per digit");

// plan codes (ops/radix.py pass_plan)
constexpr int kGather = 0, kIota = 0, kNone = 0, kBufB = 2;
constexpr int kPerm = 1, kTmp = 2;
constexpr int kPlanCols = 7;

__host__ __device__ __forceinline__ uint32_t invert_of(int row) {
  return (row >= kRowHtHi && row <= kRowWid) ? 0xFFFFFFFFu : 0u;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Exclusive scan of one int per thread across the CTA (warp shuffles, then
// a pass over the warp sums).
__device__ int block_exclusive_sum(int v) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_sums[w] : 0;
  __syncthreads();
  return before + x - v;
}

// perm[lo, hi) of the prefix's identity order with the tail block of t
// columns (from n_prefix on) placed at `at`
__global__ void place(int32_t* __restrict__ perm, int64_t lo, int64_t hi,
                      int64_t n_prefix, int64_t at, int64_t t) {
  const int64_t i = lo + (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < hi)
    perm[i] = (int32_t)(i < at ? i : (i < at + t ? n_prefix + (i - at) : i - t));
}

struct Rows {
  int row[kMaxRows];
};

// counts[y][digit][bucket] += keys of cols[rows.row[y]] in this CTA's span
// of the prefix (the columns before *n_prefix).
// Lane l adds into copy l % kParts of its bucket, the copies of a bucket
// on kParts different banks, so a warp's equal digits do not all collide.
__global__ void __launch_bounds__(kThreads)
    digit_counts(const uint32_t* __restrict__ cols, int64_t n, Rows rows,
                 const int32_t* __restrict__ n_prefix,
                 int32_t* __restrict__ counts) {
  __shared__ int h[4][kBuckets * kPartStride];
  const int tid = threadIdx.x;
  const int part = (tid & 31) % kParts;
  for (int i = tid; i < 4 * kBuckets * kPartStride; i += kThreads)
    (&h[0][0])[i] = 0;
  __syncthreads();
  const int row = rows.row[blockIdx.y];
  const uint32_t inv = invert_of(row);
  const uint32_t* __restrict__ col = cols + (int64_t)row * n;
  const int64_t n_keys = *n_prefix;
  const int64_t begin = (int64_t)blockIdx.x * kHistSpan;
  const int64_t end =
      begin + kHistSpan < n_keys ? begin + kHistSpan : n_keys;
  for (int64_t b = begin; b < end; b += kThreads * kHistItems) {
    uint32_t x[kHistItems];
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const int64_t i = b + j * kThreads + tid;
      x[j] = i < end ? __ldcs(col + i) ^ inv : 0u;
    }
#pragma unroll
    for (int j = 0; j < kHistItems; ++j) {
      const bool valid = b + j * kThreads + tid < end;
#pragma unroll
      for (int dg = 0; dg < 4; ++dg) {
        const uint32_t d = (x[j] >> (8 * dg)) & 0xFFu;
        if (valid) atomicAdd(&h[dg][d * kPartStride + part], 1);
      }
    }
  }
  __syncthreads();
  int32_t* out = counts + (int64_t)blockIdx.y * 4 * kBuckets;
#pragma unroll
  for (int dg = 0; dg < 4; ++dg) {
    int c = 0;
#pragma unroll
    for (int q = 0; q < kParts; ++q) c += h[dg][tid * kPartStride + q];
    if (c) atomicAdd(&out[dg * kBuckets + tid], c);
  }
}

// tail[0] = 1 + the last column that differs from column n-1 in a
// scheduled row (0: none), tail[1] += the columns whose key is <= column
// n-1's under the schedule (most significant row last), tail[2 + k] =
// column n-1's key in row k. Rows from the most significant down, each
// thread's columns loaded together, until every column of the thread is
// decided.
__global__ void __launch_bounds__(kThreads)
    tail_compare(const uint32_t* __restrict__ cols, int64_t n, Rows rows,
                 int n_rows, int32_t* __restrict__ tail) {
  __shared__ unsigned sh_last, sh_le;
  const int tid = threadIdx.x;
  if (tid == 0) sh_last = sh_le = 0u;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kThreads * kTailItems + tid;
  int cmp[kTailItems];  // 0 equal so far; -1 / 1 less / greater
  unsigned open = 0;    // bit j: column j in range and undecided
#pragma unroll
  for (int j = 0; j < kTailItems; ++j) {
    cmp[j] = 0;
    if (base + j * kThreads < n) open |= 1u << j;
  }
  const unsigned in_range = open;
  for (int k = n_rows - 1; k >= 0 && open; --k) {
    const uint32_t* col = cols + (int64_t)rows.row[k] * n;
    const uint32_t inv = invert_of(rows.row[k]);
    const uint32_t p = __ldg(col + n - 1) ^ inv;
    uint32_t x[kTailItems];
#pragma unroll
    for (int j = 0; j < kTailItems; ++j)
      x[j] = (open >> j) & 1u ? __ldcs(col + base + j * kThreads) ^ inv : p;
#pragma unroll
    for (int j = 0; j < kTailItems; ++j)
      if (x[j] != p) {
        cmp[j] = x[j] < p ? -1 : 1;
        open &= ~(1u << j);
      }
  }
  unsigned last = 0, le = 0;
#pragma unroll
  for (int j = 0; j < kTailItems; ++j)
    if ((in_range >> j) & 1u) {
      if (cmp[j]) last = (unsigned)(base + j * kThreads + 1);
      le += cmp[j] <= 0;
    }
  last = __reduce_max_sync(kFull, last);
  le = __reduce_add_sync(kFull, le);
  if ((tid & 31) == 0) {
    atomicMax(&sh_last, last);
    atomicAdd(&sh_le, le);
  }
  __syncthreads();
  if (tid == 0) {
    atomicMax(reinterpret_cast<unsigned*>(tail), sh_last);
    atomicAdd(reinterpret_cast<unsigned*>(tail + 1), sh_le);
  }
  if (blockIdx.x == 0 && tid < n_rows)
    tail[2 + tid] = (int32_t)(cols[(int64_t)rows.row[tid] * n + n - 1] ^
                              invert_of(rows.row[tid]));
}

struct PassArgs {
  const uint32_t* col;      // cols[row]: the gather source
  const int32_t* perm_in;   // nullptr: the iota
  const uint32_t* keys_in;  // nullptr: gather col[perm_in[i]] ^ invert
  uint32_t invert;
  int shift;
  const int32_t* counts;    // the pass's 256 digit counts over the prefix
  int64_t ins_at;           // dst >= ins_at moves up by ins_len (last pass)
  int64_t ins_len;
  int64_t n;                // keys sorted: the prefix before the tail
  uint32_t* status;         // [tiles][256], zeroed
  unsigned* ticket;         // zeroed
  uint32_t* keys_out;       // nullptr: the row's last pass
  int32_t* perm_out;
};

__global__ void __launch_bounds__(kThreads, 3) onesweep_pass(PassArgs a) {
  __shared__ uint32_t s_keys[kTile];
  __shared__ int32_t s_vals[kTile];
  __shared__ int cnt[kWarps][kBuckets];  // warp counts -> warp offsets
  __shared__ int s_texcl[kBuckets];      // the tile's exclusive digit scan
  __shared__ int s_goff[kBuckets];       // staged slot k of digit d -> k + this
  __shared__ int sh_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh_tile = (int)atomicAdd(a.ticket, 1u);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cnt[w][tid] = 0;
  __syncthreads();
  const int64_t tile = sh_tile;
  const int64_t wbase = tile * kTile + (int64_t)warp * kWarpKeys;
  const int64_t n = a.n;

  uint32_t key[kItems];
  int32_t val[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    val[j] = i < n ? (a.perm_in ? __ldcs(a.perm_in + i) : (int32_t)i) : 0;
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = wbase + j * 32 + lane;
    key[j] = i >= n       ? 0u
             : a.keys_in ? __ldcs(a.keys_in + i)
                         : __ldg(a.col + val[j]) ^ a.invert;
  }

  // rank each key among the equal digits before it in its warp
  const unsigned lt_mask = (1u << lane) - 1u;
  int off[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = wbase + j * 32 + lane < n;
    const uint32_t d = valid ? (key[j] >> a.shift) & 0xFFu : 0x100u;
    const unsigned peers = __match_any_sync(kFull, d);
    const int leader = __ffs(peers) - 1;
    int b = 0;
    if (lane == leader && valid) b = atomicAdd(&cnt[warp][d], __popc(peers));
    off[j] = __shfl_sync(kFull, b, leader) + __popc(peers & lt_mask);
  }
  __syncthreads();

  // thread d: the tile's count of digit d and each warp's offset in it
  const int d = tid;
  int tile_cnt = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = cnt[w][d];
    cnt[w][d] = tile_cnt;
    tile_cnt += c;
  }
  uint32_t* st = a.status + tile * kBuckets + d;
  st_relaxed(st, (tile == 0 ? kFlagPrefix : kFlagAgg) | (uint32_t)tile_cnt);
  const int t_excl = block_exclusive_sum(tile_cnt);
  const int g_excl = block_exclusive_sum(a.counts[d]);
  int excl = 0;
  if (tile > 0) {
    // decoupled look-back over digit d's status words of earlier tiles,
    // kLook tiles a round: every resident tile starts at once, so a
    // one-tile walk would chain through the whole first wave
    int64_t pred = tile - 1;  // the nearest tile not summed yet
    while (true) {
      uint32_t s[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q)
        s[q] = pred - q >= 0
                   ? ld_relaxed(a.status + (pred - q) * kBuckets + d)
                   : kFlagPrefix;
      int state = 0, stop = kLook;  // 1: a prefix found; 2: an empty word
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        if (state == 0) {
          if ((s[q] & (kFlagAgg | kFlagPrefix)) == 0) {
            state = 2;
            stop = q;
          } else {
            excl += (int)(s[q] & kCountMask);
            if (s[q] & kFlagPrefix) state = 1;
          }
        }
      }
      if (state == 1) break;
      pred -= stop;
    }
    st_relaxed(st, kFlagPrefix | (uint32_t)(excl + tile_cnt));
  }
  s_texcl[d] = t_excl;
  s_goff[d] = g_excl + excl - t_excl;
  __syncthreads();

  // stage keys and perm sorted by digit
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (wbase + j * 32 + lane < n) {
      const uint32_t dj = (key[j] >> a.shift) & 0xFFu;
      const int slot = s_texcl[dj] + cnt[warp][dj] + off[j];
      s_keys[slot] = key[j];
      s_vals[slot] = val[j];
    }
  }
  __syncthreads();
  const int64_t left = n - tile * kTile;
  const int len = left < kTile ? (int)left : kTile;
#pragma unroll 4
  for (int k = tid; k < len; k += kThreads) {
    const uint32_t kk = s_keys[k];
    int64_t dst = (int64_t)s_goff[(kk >> a.shift) & 0xFFu] + k;
    dst += dst >= a.ins_at ? a.ins_len : 0;
    if (a.keys_out) a.keys_out[dst] = kk;
    a.perm_out[dst] = s_vals[k];
  }
}

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

}  // namespace

extern "C" {

// Scratch bytes for n_pass kept passes over n keys: the second perm
// buffer, two key buffers, then per pass the tile status words, then the
// per-pass tickets.
int64_t ybt_radix_scratch_bytes(int64_t n, int n_pass) {
  return 3 * align16(4 * n) +
         align16(4 * (int64_t)n_pass * kBuckets * num_tiles(n)) +
         align16(4 * (int64_t)n_pass);
}

// stats: int32 [n_rows * 1024 + 2 + n_rows], zeroed here: the digit
// counts [n_rows, 4, 256] of cols[rows[k]] ^ invert over the prefix before
// the tail block, then tail_compare's words. n_rows <= kMaxRows. Returns
// cudaGetLastError() after the last launch.
int ybt_radix_stats(const uint32_t* cols, int64_t n, const int32_t* rows,
                    int n_rows, int32_t* stats, void* stream) {
  if (n <= 0 || n >= (int64_t)kCountMask || n_rows <= 0 || n_rows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(
      stats, 0, ((size_t)n_rows * (4 * kBuckets + 1) + 2) * sizeof(int32_t),
      st);
  if (e != cudaSuccess) return (int)e;
  Rows r;
  for (int k = 0; k < n_rows; ++k) r.row[k] = rows[k];
  int32_t* tail = stats + (int64_t)n_rows * 4 * kBuckets;
  const int64_t per = (int64_t)kThreads * kTailItems;
  tail_compare<<<(unsigned)((n + per - 1) / per), kThreads, 0, st>>>(
      cols, n, r, n_rows, tail);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const unsigned spans = (unsigned)((n + kHistSpan - 1) / kHistSpan);
  digit_counts<<<dim3(spans, (unsigned)n_rows), kThreads, 0, st>>>(
      cols, n, r, tail, stats);
  return (int)cudaGetLastError();
}

// Sorts the first n_prefix columns of cols [R, n] and places the tail
// block (columns n_prefix..n-1, all equal) at `at`. plan: host int32
// [n_pass, 7], per kept pass (row, digit, counts slot, key source, key
// destination, perm source, perm destination) as ops/radix.py pass_plan
// writes it; counts: ybt_radix_stats's device counts; scratch:
// ybt_radix_scratch_bytes(n_prefix, n_pass); perm: [n] int32 out.
// Returns cudaGetLastError() after the last launch.
int ybt_radix_passes(const uint32_t* cols, int64_t n, int64_t n_prefix,
                     int64_t at, const int32_t* plan, int n_pass,
                     const int32_t* counts, void* scratch, int32_t* perm,
                     void* stream) {
  if (n <= 0 || n >= (int64_t)kCountMask || n_pass < 0 || n_prefix < 0 ||
      n_prefix > n || at < 0 || at > n_prefix || (n_pass > 0 && n_prefix == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t t = n - n_prefix;
  cudaError_t e;
  if (n_pass == 0) {
    place<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        perm, 0, n, n_prefix, at, t);
    return (int)cudaGetLastError();
  }
  const int64_t tiles = num_tiles(n_prefix);
  char* s = (char*)scratch;
  int32_t* tmp = (int32_t*)s;
  s += align16(4 * n_prefix);
  uint32_t* keys[3] = {nullptr, (uint32_t*)s,
                       (uint32_t*)(s + align16(4 * n_prefix))};
  s += 2 * align16(4 * n_prefix);
  uint32_t* status = (uint32_t*)s;
  const int64_t status_bytes = 4 * (int64_t)n_pass * kBuckets * tiles;
  s += align16(status_bytes);
  unsigned* tickets = (unsigned*)s;
  int32_t* perms[3] = {nullptr, perm, tmp};
  e = cudaMemsetAsync(status, 0,
                      (size_t)(align16(status_bytes) + 4 * (int64_t)n_pass), st);
  if (e != cudaSuccess) return (int)e;
  for (int p = 0; p < n_pass; ++p) {
    const int32_t* q = plan + (int64_t)p * kPlanCols;
    const int row = q[0], digit = q[1], slot = q[2];
    const int ksrc = q[3], kdst = q[4], psrc = q[5], pdst = q[6];
    const bool last = p == n_pass - 1;
    if (digit < 0 || digit > 3 || ksrc < kGather || ksrc > kBufB ||
        kdst < kNone || kdst > kBufB || psrc < kIota || psrc > kTmp ||
        pdst < kPerm || pdst > kTmp || row < 0 || slot < 0 ||
        (last && pdst != kPerm))
      return (int)cudaErrorInvalidValue;
    PassArgs a;
    a.col = cols + (int64_t)row * n;
    a.perm_in = perms[psrc];
    a.keys_in = keys[ksrc];
    a.invert = invert_of(row);
    a.shift = 8 * digit;
    a.counts = counts + (int64_t)slot * kBuckets;
    a.ins_at = last ? at : n;
    a.ins_len = last ? t : 0;
    a.n = n_prefix;
    a.status = status + (int64_t)p * kBuckets * tiles;
    a.ticket = tickets + p;
    a.keys_out = keys[kdst];
    a.perm_out = perms[pdst];
    onesweep_pass<<<(unsigned)tiles, kThreads, 0, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (t > 0)
    place<<<(unsigned)((t + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        perm, at, at + t, n_prefix, at, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
