// Kernels C and F: the device SST block codec (decode and encode).
//
// Kernel C replaces yugabyte_tpu/ops/block_codec.py `_block_decode_impl`
// (:97); kernel F replaces `_block_encode_impl` (:161). Both were XLA
// programs in the JAX package.
//
// Kernel C, block decode. Input: the raw block columns that the host laid
// into the cols layout, u32 [R, n_pad] row-major (R = 8 + w_pad): rows 0..5
// as stored, rows 6..7 the (lo, hi) words of the i64 millisecond TTL, rows
// 8.. the little-endian raw key words; lanes >= n carry the pad template.
// Output: the staged cols [R, n_pad] (rows 0..5 copied; row 6 = bits 20..51
// and row 7 = bits 0..19 of ttl_ms * 1000 mod 2^64; key words byteswapped),
// first[r] = cols[r, 0] and differs[r] = 1 when a valid lane of row r is not
// first[r] (is_const = !differs). The JAX package forms ttl_ms * 1000 from
// 16-bit partial products with a carry; that is the 64-bit product mod
// 2^64, which one `uint64` multiply gives, negative values included.
// Design: one CTA per (row, 1024 lanes), each thread 4 lanes strided by the
// CTA width so that reads and writes coalesce; the stats are one
// __syncthreads_or per CTA and one atomicOr into the row's flag, which is
// order-free for a boolean.
// Bound on an H100: memory, 2 * R * n_pad * 4 bytes (each input word read
// once, each output word written once); the stats add R words.
//
// Kernel F, block encode. Input: a gathered survivor span's cols u32
// [R, n_pad] (n_pad a multiple of 128). Outputs, as the JAX function's:
//   keys  [n_pad, w_pad]  entry-major byteswapped key words (a transpose)
//   kl2, dkl2 [n_pad/2]   (v[2i] & 0xFFFF) | (v[2i+1] << 16) of rows 0, 1
//   fl4   [n_pad/4]       the low bytes of four flags words
//   h_hi, h_lo [n_pad]    FNV-1a-64 over the first doc_key_len bytes of each
//                         key, most significant byte of each word first
// (ht_hi, ht_lo, write_id and the two TTL rows are rows of the input: the
// wrapper returns views of them and the kernel moves no byte for them.)
// `h = (h ^ byte) * 0x100000001B3` in uint64 is bit-identical to the JAX
// package's u32-limb `_mul64_by_prime` mod 2^64.
// Design: one CTA per 128 lanes. The key transpose goes through a shared
// tile of up to 32 key words by 128 lanes, read row by row and written as
// the CTA's contiguous slice of `keys`, so both sides coalesce; each thread
// then hashes its own lane (reads of one key word per 4 bytes, coalesced
// across the warp) and the first half and quarter of the threads pack the
// length pairs and flag quads.
// Bound on an H100: memory. Reads rows 0, 1, 5 and the w_pad key rows once
// ((3 + w_pad) * 4 bytes per lane); writes w_pad * 4 + 2 + 2 + 1 + 8 bytes
// per lane. The hash is up to doc_key_len 64-bit multiplies per lane, far
// below the card's integer rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kDecLanes = kThreads * kItems;   // lanes per decode CTA
constexpr int kEncLanes = 128;                 // lanes per encode CTA
constexpr int kRowWords = 8;

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ uint32_t decoded(const uint32_t* __restrict__ in,
                                            int r, int64_t n_pad,
                                            int64_t i) {
  if (r < 6) return in[(int64_t)r * n_pad + i];
  if (r < kRowWords) {
    const uint64_t ms = ((uint64_t)in[7 * n_pad + i] << 32) |
                        (uint64_t)in[6 * n_pad + i];
    const uint64_t us = ms * 1000ull;
    return r == 6 ? (uint32_t)(us >> 20) : (uint32_t)(us & 0xFFFFFull);
  }
  return bswap32(in[(int64_t)r * n_pad + i]);
}

__global__ void block_decode_kernel(const uint32_t* __restrict__ in,
                                    uint32_t* __restrict__ out,
                                    int64_t n_pad, int64_t n,
                                    uint32_t* __restrict__ first,
                                    int32_t* __restrict__ differs) {
  const int r = blockIdx.y;
  const uint32_t f = decoded(in, r, n_pad, 0);
  const int64_t base = (int64_t)blockIdx.x * kDecLanes + threadIdx.x;
  bool diff = false;
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = base + (int64_t)k * kThreads;
    if (i >= n_pad) break;
    const uint32_t v = decoded(in, r, n_pad, i);
    out[(int64_t)r * n_pad + i] = v;
    diff = diff || (i < n && v != f);
  }
  if (__syncthreads_or(diff) && threadIdx.x == 0) atomicOr(&differs[r], 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) first[r] = f;
}

__global__ void block_encode_kernel(const uint32_t* __restrict__ cols,
                                    int64_t n_pad, int w_pad,
                                    uint32_t* __restrict__ keys,
                                    uint32_t* __restrict__ kl2,
                                    uint32_t* __restrict__ dkl2,
                                    uint32_t* __restrict__ fl4,
                                    uint32_t* __restrict__ h_hi,
                                    uint32_t* __restrict__ h_lo) {
  __shared__ uint32_t tile[32][kEncLanes + 1];
  const int64_t l0 = (int64_t)blockIdx.x * kEncLanes;
  const int t = threadIdx.x;

  // keys: transpose [w_pad, lanes] -> [lanes, w_pad], byteswapped
  for (int c0 = 0; c0 < w_pad; c0 += 32) {
    const int cw = w_pad - c0 < 32 ? w_pad - c0 : 32;
    for (int k = 0; k < cw; ++k)
      tile[k][t] = cols[(int64_t)(kRowWords + c0 + k) * n_pad + l0 + t];
    __syncthreads();
    for (int idx = t; idx < kEncLanes * cw; idx += kEncLanes) {
      const int lane = idx / cw, k = idx - lane * cw;
      keys[(l0 + lane) * w_pad + c0 + k] = bswap32(tile[k][lane]);
    }
    __syncthreads();
  }

  // FNV-1a-64 over the doc key's bytes (a pad lane's dkl reads as -1)
  const int64_t i = l0 + t;
  const int dkl = (int)cols[1 * n_pad + i];
  const int nbytes = dkl < 4 * w_pad ? dkl : 4 * w_pad;
  uint64_t h = 0xCBF29CE484222325ull;
  for (int wi = 0; 4 * wi < nbytes; ++wi) {
    const uint32_t word = cols[(int64_t)(kRowWords + wi) * n_pad + i];
    for (int b = 0; b < 4 && 4 * wi + b < nbytes; ++b)
      h = (h ^ ((word >> (8 * (3 - b))) & 0xFFu)) * 0x100000001B3ull;
  }
  h_hi[i] = (uint32_t)(h >> 32);
  h_lo[i] = (uint32_t)h;

  if (t < kEncLanes / 2) {
    const int64_t q = l0 / 2 + t;
    kl2[q] = (cols[2 * q] & 0xFFFFu) | (cols[2 * q + 1] << 16);
    dkl2[q] = (cols[n_pad + 2 * q] & 0xFFFFu) | (cols[n_pad + 2 * q + 1] << 16);
  }
  if (t < kEncLanes / 4) {
    const int64_t q = l0 / 4 + t;
    const uint32_t* fl = cols + 5 * n_pad + 4 * q;
    fl4[q] = (fl[0] & 0xFFu) | ((fl[1] & 0xFFu) << 8) |
             ((fl[2] & 0xFFu) << 16) | ((fl[3] & 0xFFu) << 24);
  }
}

}  // namespace

extern "C" {

// in, out: [8 + w_pad, n_pad] u32 (distinct); first: [8 + w_pad] u32;
// differs: [8 + w_pad] int32, zeroed here. Returns cudaGetLastError().
int ybt_block_decode(const uint32_t* in, uint32_t* out, int rows,
                     int64_t n_pad, int64_t n, uint32_t* first,
                     int32_t* differs, void* stream) {
  if (rows <= kRowWords || n_pad <= 0 || n <= 0 || n > n_pad)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(differs, 0, (size_t)rows * 4, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n_pad + kDecLanes - 1) / kDecLanes),
                  (unsigned)rows);
  block_decode_kernel<<<grid, kThreads, 0, st>>>(in, out, n_pad, n, first,
                                                 differs);
  return (int)cudaGetLastError();
}

// cols: [8 + w_pad, n_pad] u32, n_pad a multiple of 128. keys: [n_pad,
// w_pad]; kl2, dkl2: [n_pad/2]; fl4: [n_pad/4]; h_hi, h_lo: [n_pad].
// Returns cudaGetLastError() after the launch.
int ybt_block_encode(const uint32_t* cols, int64_t n_pad, int w_pad,
                     uint32_t* keys, uint32_t* kl2, uint32_t* dkl2,
                     uint32_t* fl4, uint32_t* h_hi, uint32_t* h_lo,
                     void* stream) {
  if (n_pad <= 0 || n_pad % kEncLanes != 0 || w_pad <= 0)
    return (int)cudaErrorInvalidValue;
  block_encode_kernel<<<(unsigned)(n_pad / kEncLanes), kEncLanes, 0,
                        (cudaStream_t)stream>>>(cols, n_pad, w_pad, keys,
                                                kl2, dkl2, fl4, h_hi, h_lo);
  return (int)cudaGetLastError();
}

}  // extern "C"
