// The scan's key bounds [lower, upper), shared by kernels I.2 (scan.cu,
// bound_pack) and J.1 (pushdown.cu, row_flags).
//
// Both compare each lane's key with the bounds in the order of
// yugabyte_tpu/ops/scan.py `_cmp_words` (:481) and the bound mask of
// `_scan_fused` (:59-81): (key words as u32, key_len as int32)
// lexicographically, which is memcmp order on the raw keys.
//
// The bounds reach the kernel by value: a KeyBounds parameter holds both
// bounds' words up to kBoundCap words each (the struct is about 1 KB of the
// 4 KB a launch's parameters may take), so a call makes no host-to-device
// copy. Above the cap the wrapper copies the [2, w] words to the card once
// (pinned, non-blocking) and passes the pointer in `dev`. Each CTA stages
// the 2w words into shared memory once; the compare loops read them there.
//
// The compare is a state machine over 32-bit lane masks, one word row at a
// time: a lane is "tied" with a bound while every word so far equals the
// bound's; the first word that differs decides it; key_len decides a lane
// tied through all w words. A row is read only for lanes still tied with a
// bound they must pass, so each lane reads the leading words the two
// compares share once, and stops at the first word that settles both.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace key_bounds {

constexpr int kBoundCap = 128;  // words of each bound held by value

struct KeyBounds {
  uint32_t words[2 * kBoundCap];  // lower words [0, w), upper [w, 2w)
  const uint32_t* dev;            // [2, w] on the card when w > kBoundCap
  int32_t w, lo_len, hi_len;
};

// Stage the 2w bound words in shared memory (every thread of the CTA
// calls it; ends with a barrier).
__device__ __forceinline__ void stage(const KeyBounds& b, uint32_t* sb) {
  for (int t = threadIdx.x; t < 2 * b.w; t += blockDim.x)
    sb[t] = b.dev != nullptr ? b.dev[t] : b.words[t];
  __syncthreads();
}

// One word row of the compare over L lanes. v[e] is lane e's word (read
// only where `need` has bit e), lo / hi the bounds' words. A lane tied with
// the lower bound whose word differs is settled, and leaves `alive` when
// below it; a lane tied with the upper bound likewise, leaving when above.
template <int L>
__device__ __forceinline__ void compare_row(uint32_t need, const uint32_t (&v)[L],
                                            uint32_t lo, uint32_t hi,
                                            uint32_t& tie_lo, uint32_t& tie_hi,
                                            uint32_t& alive) {
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const uint32_t bit = 1u << e;
    if (!(need & bit)) continue;
    if ((tie_lo & bit) && v[e] != lo) {
      tie_lo &= ~bit;
      if (v[e] < lo) alive &= ~bit;
    }
    if ((tie_hi & bit) && v[e] != hi) {
      tie_hi &= ~bit;
      if (v[e] > hi) alive &= ~bit;
    }
  }
}

// key_len (as int32) of the lanes tied through all w words: below the lower
// bound's length leaves `alive`; the upper bound keeps len < hi_len, and
// len == hi_len too when the bound was truncated to the key stride.
template <int L>
__device__ __forceinline__ void compare_len(uint32_t need, const uint32_t (&len)[L],
                                            int32_t lo_len, int32_t hi_len,
                                            bool up_trunc, uint32_t tie_lo,
                                            uint32_t tie_hi, uint32_t& alive) {
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const uint32_t bit = 1u << e;
    if (!(need & bit)) continue;
    const int32_t l = (int32_t)len[e];
    if ((tie_lo & bit) && l < lo_len) alive &= ~bit;
    if ((tie_hi & bit) && !(l < hi_len || (up_trunc && l == hi_len)))
      alive &= ~bit;
  }
}

// The 16-byte vector of row r at lane i (i a multiple of 4).
__device__ __forceinline__ uint4 ld4(const uint32_t* m, int64_t n, int r,
                                     int64_t i) {
  return __ldg(reinterpret_cast<const uint4*>(m + (int64_t)r * n + i));
}

__device__ __forceinline__ void unpack4(const uint4& q, uint32_t* v) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The grid of a grid-stride launch: blocks_per_sm CTAs (the kernel's
// occupancy) on each of the card's SMs (counted once per device), so every
// CTA is resident and all take equal shares, at most `want`.
inline unsigned sm_grid(int blocks_per_sm, int64_t want) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = sms[dev & 63];
  if (c == 0) cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
  const int64_t full = (int64_t)(c > 0 ? c : 1) * blocks_per_sm;
  return (unsigned)(want < full ? (want > 0 ? want : 1) : full);
}

}  // namespace key_bounds
