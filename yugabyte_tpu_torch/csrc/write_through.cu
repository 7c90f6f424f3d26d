// Kernels D and E: the survivor scan and the span gather of write-through
// staging (the device half of the codec job's output path).
//
// Kernel D replaces yugabyte_tpu/ops/run_merge.py `_survivor_positions_impl`
// (:866, jnp.nonzero(keep, size=n_pad, fill_value=n_pad-1)); kernel E
// replaces `_gather_staged_output` (:901). Both were XLA programs.
//
// Kernel D, survivor positions. Input: keep, one byte per merged position
// [n] (n a multiple of 16). Output: pos int32 [n], the kept positions in
// increasing order, then n - 1 in every remaining slot. A single-pass
// stream compaction with decoupled look-back (Merrill and Garland), one
// launch after one memset of the scratch:
//   - each CTA (256 threads) takes its tile of 16,384 positions from a
//     global atomic ticket, so every tile it looks back on is held by a
//     CTA that runs;
//   - each thread loads its 4 words of 16 keep bytes once, up front, as
//     16-byte loads (a warp reads 512 contiguous bytes a load), and makes
//     a 16-bit mask of each; warp shuffle scans of the masks' popcounts
//     and one scan of the 32 (word, warp) totals give the CTA's count;
//   - the CTA publishes its count (flag A) in a flag-tagged 64-bit status
//     word per tile, warp 0 sums its predecessors' words 32 at a time
//     until it meets an inclusive prefix (flag P), and publishes its own;
//   - the kept positions are staged in shared memory as 16-bit offsets
//     from the tile's start (32 KB, so 6 CTAs fit an SM), 32 positions
//     at a time per warp (the group mask of two lanes: consecutive lanes
//     write consecutive halfwords), shifted by prefix mod 4 so that they
//     leave as aligned 16-byte stores to [prefix, prefix + kept);
//   - the tail needs no total: CTA b's nk_b non-kept positions go, as
//     n - 1, to [n - (cbase_b - prefix_b) - nk_b, n - (cbase_b - prefix_b)),
//     and these ranges tile [total, n).
// Every slot of pos is written once and keep is read once: n bytes read
// and 4n bytes written, which is the bound on an H100 (memory). The
// status words are 8 bytes per 16,384 positions. What is left between the
// kernel and its bound is each CTA's chain of dependent steps (ticket,
// loads, scan, look-back, stores) at 1,024 tiles for 2^24 positions.
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
constexpr int kVec = 4;                    // 16-byte keep words a thread
constexpr int kSub = kThreads * 16;        // positions a CTA's word v covers
constexpr int kTile = kSub * kVec;         // positions per scan tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned long long kFlagAgg = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;
static_assert(kVec * kWarps <= 32, "one lane per (word, warp) total");
static_assert(kTile <= 65536, "staged offsets are 16-bit");
constexpr int kRowFlags = 5, kRowWords = 8;
constexpr uint32_t kFlagTombstone = 1;

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Bit k of the result: byte k of the 16 bytes is nonzero.
__device__ __forceinline__ uint32_t nonzero_mask16(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t nz = __vcmpne4(w[k], 0u);  // 0xFF per nonzero byte
    m |= ((nz & 1u) | ((nz >> 7) & 2u) | ((nz >> 14) & 4u) |
          ((nz >> 21) & 8u))
         << (4 * k);
  }
  return m;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// pos[lo, hi) = v, by the whole CTA: 16-byte stores between the ragged
// head and tail.
__device__ void fill_range(int32_t* __restrict__ pos, int64_t lo, int64_t hi,
                           int32_t v) {
  if (lo >= hi) return;
  int64_t a = (lo + 3) & ~(int64_t)3;
  if (a > hi) a = hi;
  int64_t b = hi & ~(int64_t)3;
  if (b < a) b = a;
  if (lo + threadIdx.x < a) pos[lo + threadIdx.x] = v;
  if (b + threadIdx.x < hi) pos[b + threadIdx.x] = v;
  const int4 vv = make_int4(v, v, v, v);
  for (int64_t q = a / 4 + threadIdx.x; q < b / 4; q += kThreads)
    reinterpret_cast<int4*>(pos)[q] = vv;
}

__global__ void __launch_bounds__(kThreads)
    survivor_scan_kernel(const uint8_t* __restrict__ keep, int64_t n,
                         unsigned long long* __restrict__ status,
                         unsigned int* __restrict__ ticket,
                         int32_t* __restrict__ pos) {
  // kept positions as offsets from cbase (kTile <= 65536)
  extern __shared__ __align__(16) uint16_t stage[];  // [kTile + 4]
  __shared__ int warp_excl[kVec][kWarps];
  __shared__ int sh_tile, sh_kept, sh_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t tile = sh_tile;
  const int64_t cbase = tile * kTile;

  // word v of thread t: positions cbase + v * kSub + 16t + [0, 16); n % 16
  // == 0, so a word is all in range or all beyond n
  uint4 words[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int64_t b = cbase + (int64_t)v * kSub + tid * 16;
    words[v] = b < n ? __ldcs(reinterpret_cast<const uint4*>(keep + b))
                     : make_uint4(0, 0, 0, 0);
  }
  uint32_t mask[kVec];
  int cnt[kVec], incl[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    mask[v] = nonzero_mask16(words[v]);
    cnt[v] = __popc(mask[v]);
    incl[v] = cnt[v];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl[v], o);
      if (lane >= o) incl[v] += y;
    }
    if (lane == 31) warp_excl[v][warp] = incl[v];
  }
  __syncthreads();
  if (warp == 0) {
    // lane l: word l / kWarps of warp l % kWarps, in position order
    int* flat = &warp_excl[0][0];
    const int ws = lane < kVec * kWarps ? flat[lane] : 0;
    int wi = ws;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kVec * kWarps) flat[lane] = wi - ws;
    const int kept = __shfl_sync(kFull, wi, 31);
    if (lane == 0) {
      sh_kept = kept;
      st_release(&status[tile], (tile == 0 ? kFlagPrefix : kFlagAgg) |
                                    (unsigned long long)(uint32_t)kept);
    }
    if (tile == 0) {
      if (lane == 0) sh_prefix = 0;
    } else {
      // decoupled look-back over the predecessors, 32 tiles at a time
      int64_t pred = tile - 1 - lane;
      int excl = 0;
      while (true) {
        unsigned long long s;
        do {
          s = pred >= 0 ? ld_acquire(&status[pred]) : kFlagPrefix;
        } while (__any_sync(kFull, (s >> 32) == 0));
        const unsigned pm = __ballot_sync(kFull, (s >> 32) == 2);
        int v = (int)(uint32_t)s;
        if (pm && lane > __ffs(pm) - 1) v = 0;
        excl += warp_sum(v);
        if (pm) break;
        pred -= 32;
      }
      if (lane == 0) {
        st_release(&status[tile],
                   kFlagPrefix | (unsigned long long)(uint32_t)(excl + kept));
        sh_prefix = excl;
      }
    }
  }
  __syncthreads();
  const int kept = sh_kept;
  const int64_t prefix = sh_prefix;

  // stage[s] goes to pos[pa + s]; pa is 16-byte aligned
  const int shift = (int)(prefix & 3);
  const int64_t pa = prefix - shift;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    // group g of the warp's word v: positions [32g, 32g + 32) of its 512,
    // i.e. the masks of lanes 2g and 2g + 1; its offset is lane 2g's
    // exclusive sum
    const uint32_t gmask =
        mask[v] | (__shfl_down_sync(kFull, mask[v], 1) << 16);
    const int off = shift + warp_excl[v][warp] + incl[v] - cnt[v];
    const int64_t wbase = cbase + (int64_t)v * kSub + warp * 512;
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const uint32_t gm = __shfl_sync(kFull, gmask, 2 * g);
      const int goff = __shfl_sync(kFull, off, 2 * g);
      if ((gm >> lane) & 1u)
        stage[goff + __popc(gm & below)] =
            (uint16_t)(wbase - cbase + 32 * g + lane);
    }
  }
  __syncthreads();
  const int end = shift + kept;
  for (int q = tid; q < (end + 3) >> 2; q += kThreads) {
    const int s0 = 4 * q;
    if (s0 >= shift && s0 + 4 <= end) {
      const uint2 w = reinterpret_cast<const uint2*>(stage)[q];
      const int32_t b = (int32_t)cbase;
      reinterpret_cast<int4*>(pos + pa)[q] =
          make_int4(b + (int32_t)(w.x & 0xFFFFu), b + (int32_t)(w.x >> 16),
                    b + (int32_t)(w.y & 0xFFFFu), b + (int32_t)(w.y >> 16));
    } else {
      for (int s = s0 < shift ? shift : s0; s < s0 + 4 && s < end; ++s)
        pos[pa + s] = (int32_t)cbase + stage[s];
    }
  }

  // the non-kept positions, counted from the end
  const int64_t len = n - cbase < kTile ? n - cbase : kTile;
  const int64_t nk_before = cbase - prefix;
  fill_range(pos, n - nk_before - (len - kept), n - nk_before,
             (int32_t)(n - 1));
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

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// Scratch 8-byte words the wrapper allocates for a scan over n positions:
// one status word per tile, then the ticket.
int64_t ybt_survivor_scan_scratch_words(int64_t n) {
  return num_tiles(n) + 1;
}

// keep: [n] bytes (n a multiple of 16, 16-byte aligned); pos: [n] int32
// (16-byte aligned); scratch: see above, zeroed here. Returns
// cudaGetLastError() after the launch.
int ybt_survivor_scan(const uint8_t* keep, int64_t n,
                      unsigned long long* scratch, int32_t* pos,
                      void* stream) {
  if (n <= 0 || n % 16 != 0 || n > 0x7FFFFFFF ||
      reinterpret_cast<uintptr_t>(keep) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(pos) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = num_tiles(n);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (kTile + 4) * sizeof(uint16_t);
  static const cudaError_t attr = cudaFuncSetAttribute(
      survivor_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(nb + 1) * 8, st);
  if (e != cudaSuccess) return (int)e;
  survivor_scan_kernel<<<(unsigned)nb, kThreads, smem, st>>>(
      keep, n, scratch, reinterpret_cast<unsigned int*>(scratch + nb), pos);
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
