// Single-pass scans chained across tiles by decoupled look-back, shared by
// kernels B (gc_pack.cu, two scans) and J.2 (pushdown.cu, segment_or).
//
// Each CTA takes its tile from an atomic ticket (so every tile it looks
// back on is held by a running CTA) and publishes a flag-tagged 64-bit
// status word: bits 62-63 the flag (0 not ready, kStAgg the tile's own
// aggregate, kStPrefix the inclusive prefix through the tile), the scan's
// payload below. Flag and payload sit in one word, so relaxed loads and
// stores suffice. The combine is associative with 0 as its identity.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_chain {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kStAgg = 1ull << 62, kStPrefix = 2ull << 62,
                   kStFlags = 3ull << 62;

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Inclusive scan of one value a lane across the warp, in lane order.
template <class Op>
__device__ __forceinline__ uint64_t warp_inclusive(uint64_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint64_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x = Op::combine(y, x);
  }
  return x;
}

// Publishes the tile's aggregate (lane 0 of the calling warp). `own_prefix`:
// the aggregate does not depend on what precedes the tile (a segmented
// scan's aggregate that holds a segment start), so it is published as the
// tile's inclusive prefix at once and later tiles need not wait for this
// tile's look-back.
__device__ __forceinline__ void publish(uint64_t* status, int64_t tile,
                                        uint64_t agg, bool own_prefix = false) {
  if ((threadIdx.x & 31) == 0)
    st_relaxed(status + tile, (own_prefix || tile == 0 ? kStPrefix : kStAgg) | agg);
}

// After publish: looks back over earlier tiles 32 at a time until an
// inclusive prefix, publishes the tile's own (unless own_prefix); returns
// the exclusive prefix. Called by every lane of one warp.
template <class Op>
__device__ uint64_t wait_prefix(uint64_t* status, int64_t tile, uint64_t agg,
                                bool own_prefix = false) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) return 0;
  uint64_t excl = 0;
  int64_t pred = tile - 1 - lane;
  while (true) {
    uint64_t s;
    do {
      s = pred >= 0 ? ld_relaxed(status + pred) : kStPrefix;
    } while (__any_sync(kFull, (s & kStFlags) == 0));
    const unsigned pm = __ballot_sync(kFull, (s & kStFlags) == kStPrefix);
    uint64_t x = s & ~kStFlags;
    if (pm && lane > __ffs(pm) - 1) x = 0;
    // lane 0 <- lanes 31..0 combined in position order (lane 31 earliest)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint64_t y = __shfl_down_sync(kFull, x, o);
      if (lane + o < 32) x = Op::combine(y, x);
    }
    excl = Op::combine(__shfl_sync(kFull, x, 0), excl);
    if (pm) break;
    pred -= 32;
  }
  if (lane == 0 && !own_prefix)
    st_relaxed(status + tile, kStPrefix | Op::combine(excl, agg));
  return excl;
}

// publish, then wait_prefix.
template <class Op>
__device__ uint64_t look_back(uint64_t* status, int64_t tile, uint64_t agg,
                              bool own_prefix = false) {
  publish(status, tile, agg, own_prefix);
  return wait_prefix<Op>(status, tile, agg, own_prefix);
}

}  // namespace tile_chain
