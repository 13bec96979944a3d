// Batched CRC-32C and xxHash64 of equal-length rows.
//
// Replaces: compress_tpu/ops/checksum.py `crc32c_batch` (:84, GF(2) matrix
// products on the MXU) and `xxh64_batch` (:242, a lax.scan over 32-byte
// stripes, :272, in 16-bit limbs).  Both are XLA functions, not Pallas
// kernels; each is ported as a kernel of its own.
//
// CRC-32C (`ct_crc32c_batch`).  Function: for each row r of `rows` (B rows
// `stride` bytes apart), the CRC-32C (initial and final 0xFFFFFFFF) of its
// first n bytes, as int64.  Design: a CTA of 256 threads a row; thread t
// takes chunk t of 256 chunks of lc bytes aligned to the end of the n
// bytes, [n - (256 - t) lc, n - (255 - t) lc).  Bytes before 0 are leading
// zeros, which leave a raw CRC (state 0, no conditioning) at 0, so a chunk
// cut at 0 still counts as lc bytes.  Each thread runs a slicing-by-8
// table CRC over its chunk (the 8 tables built by the CTA in shared
// memory; 8 words loaded at a time); a tree of 8 levels joins neighbours, raw(AB) = raw(A) *
// x^(8|B|) mod P xor raw(B), from the host's x^(8 lc) squared at each
// level; the conditioning is one xor with the host's constant for n.
// Polynomial products are in the reflected form (bit 31 holds x^0).
//
// xxHash64 (`ct_xxh64_batch`).  Function: for each row of n bytes (n a
// multiple of 32), the xxHash64 digest with `seed`, as its low and high
// 32-bit halves (int64 each).  Design: four threads a row, one lane each:
// lane q folds the q-th 8-byte word of every stripe in order (a quad's
// loads are one 32-byte sector), a batch of 16 stripes' loads in flight
// while the batch before is folded; the quad's accumulators meet by shuffles, and lane 0
// merges, adds the length and avalanches.  Native 64-bit integers: the
// reference's 16-bit limbs are the TPU's, not needed here.
//
// Bound on the H100: memory for both (each input byte read once: 16.8 MB
// at 256 rows of 64 KiB, 0.005 ms at 3.35 TB/s).  Both designs are
// latency-bound well above that: a CRC thread's chunk is a chain of
// dependent table steps, and an xxHash64 lane is a chain of n / 32
// dependent rounds (a 64-bit multiply, rotate and multiply).
#include "ct_common.cuh"

namespace {

constexpr uint32_t CRC_POLY = 0x82F63B78u;
constexpr int CRC_THREADS = 256;  // = chunks a row
constexpr int CRC_LEVELS = 8;     // log2(CRC_THREADS)
constexpr int CRC_AHEAD = 8;      // 8-byte words loaded ahead of their steps

__device__ __forceinline__ uint32_t mulmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll 4
  for (int k = 31; k >= 0; --k) {
    if ((a >> k) & 1u) p ^= b;
    b = (b & 1u) ? (b >> 1) ^ CRC_POLY : b >> 1;
  }
  return p;
}

// Slicing-by-8: the CRC after the 8 bytes of w.
__device__ __forceinline__ uint32_t step8(const uint32_t (*tab)[256],
                                          uint32_t crc, uint2 w) {
  const uint32_t lo = w.x ^ crc, hi = w.y;
  return tab[7][lo & 255] ^ tab[6][(lo >> 8) & 255] ^
         tab[5][(lo >> 16) & 255] ^ tab[4][lo >> 24] ^ tab[3][hi & 255] ^
         tab[2][(hi >> 8) & 255] ^ tab[1][(hi >> 16) & 255] ^ tab[0][hi >> 24];
}

__global__ void __launch_bounds__(CRC_THREADS)
    crc32c_kernel(const uint8_t* __restrict__ rows, long long stride, int n,
                  int lc, uint32_t x1, uint32_t cond,
                  long long* __restrict__ out) {
  __shared__ uint32_t tab[8][256];
  __shared__ uint32_t part[CRC_THREADS];
  const int t = threadIdx.x;
  uint32_t c = t;
  for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ CRC_POLY : c >> 1;
  tab[0][t] = c;
  __syncthreads();
  for (int k = 1; k < 8; ++k) {
    c = (c >> 8) ^ tab[0][c & 255];
    tab[k][t] = c;
  }
  __syncthreads();

  const uint8_t* row = rows + (size_t)blockIdx.x * (size_t)stride;
  const long long b = (long long)n - (long long)(CRC_THREADS - 1 - t) * lc;
  long long p = b - lc < 0 ? 0 : b - lc;
  uint32_t crc = 0;
  while (p < b && (reinterpret_cast<uintptr_t>(row + p) & 7)) {
    crc = tab[0][(crc ^ row[p]) & 255] ^ (crc >> 8);
    ++p;
  }
  // CRC_AHEAD words loaded before their steps: the loads of a batch
  // overlap instead of each step waiting on its own
  for (; p + 8 * CRC_AHEAD <= b; p += 8 * CRC_AHEAD) {
    uint2 w[CRC_AHEAD];
#pragma unroll
    for (int u = 0; u < CRC_AHEAD; ++u)
      w[u] = __ldg(reinterpret_cast<const uint2*>(row + p) + u);
#pragma unroll
    for (int u = 0; u < CRC_AHEAD; ++u) crc = step8(tab, crc, w[u]);
  }
  for (; p + 8 <= b; p += 8)
    crc = step8(tab, crc, __ldg(reinterpret_cast<const uint2*>(row + p)));
  for (; p < b; ++p) crc = tab[0][(crc ^ row[p]) & 255] ^ (crc >> 8);
  part[t] = crc;
  __syncthreads();

  uint32_t x = x1;  // x^(8 lc 2^level)
  for (int level = 0; level < CRC_LEVELS; ++level) {
    const int h = 1 << level;
    if ((t & (2 * h - 1)) == 0) part[t] = mulmodp(part[t], x) ^ part[t + h];
    x = mulmodp(x, x);
    __syncthreads();
  }
  if (t == 0) out[blockIdx.x] = (long long)(part[0] ^ cond);
}

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ull;
constexpr int XXH_THREADS = 128;  // 32 rows a CTA
constexpr int XXH_AHEAD = 16;     // stripes a batch of loads

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  return rotl64(acc, 31) * P1;
}

__device__ __forceinline__ uint64_t xmerge(uint64_t h, uint64_t v) {
  h ^= xround(0, v);
  return h * P1 + P4;
}

__global__ void __launch_bounds__(XXH_THREADS)
    xxh64_kernel(const uint8_t* __restrict__ rows, int B, int n,
                 uint64_t seed, long long* __restrict__ out) {
  const int g = blockIdx.x * XXH_THREADS + threadIdx.x;
  const int r = g >> 2, q = g & 3;
  const int stripes = n / 32;
  uint64_t acc = q == 0 ? seed + P1 + P2 : q == 1 ? seed + P2
                 : q == 2 ? seed : seed - P1;
  if (r < B) {
    const unsigned long long* w =
        reinterpret_cast<const unsigned long long*>(rows + (size_t)r * n) + q;
    // two batches of XXH_AHEAD words in flight: the next batch's loads are
    // issued before this batch's rounds
    const int full_batches = stripes / XXH_AHEAD;
    uint64_t v[XXH_AHEAD];
    if (full_batches > 0) {
#pragma unroll
      for (int u = 0; u < XXH_AHEAD; ++u) v[u] = __ldg(w + 4 * u);
    }
    for (int bi = 0; bi < full_batches; ++bi) {
      uint64_t nv[XXH_AHEAD] = {};
      const int s = (bi + 1) * XXH_AHEAD;
      if (bi + 1 < full_batches) {
#pragma unroll
        for (int u = 0; u < XXH_AHEAD; ++u) nv[u] = __ldg(w + 4 * (s + u));
      }
#pragma unroll
      for (int u = 0; u < XXH_AHEAD; ++u) acc = xround(acc, v[u]);
#pragma unroll
      for (int u = 0; u < XXH_AHEAD; ++u) v[u] = nv[u];
    }
    for (int s = full_batches * XXH_AHEAD; s < stripes; ++s)
      acc = xround(acc, __ldg(w + 4 * s));
  }
  const int base = threadIdx.x & 31 & ~3;
  const unsigned full = 0xffffffffu;
  const unsigned long long a = acc;
  const uint64_t a0 = __shfl_sync(full, a, base);
  const uint64_t a1 = __shfl_sync(full, a, base + 1);
  const uint64_t a2 = __shfl_sync(full, a, base + 2);
  const uint64_t a3 = __shfl_sync(full, a, base + 3);
  if (r >= B || q != 0) return;
  uint64_t h = rotl64(a0, 1) + rotl64(a1, 7) + rotl64(a2, 12) + rotl64(a3, 18);
  h = xmerge(h, a0);
  h = xmerge(h, a1);
  h = xmerge(h, a2);
  h = xmerge(h, a3);
  h += (uint64_t)n;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  out[2 * (size_t)r] = (long long)(h & 0xFFFFFFFFull);
  out[2 * (size_t)r + 1] = (long long)(h >> 32);
}

}  // namespace

extern "C" {

// rows: B rows `stride` bytes apart, any address; n <= the row length;
// lc = max(1, ceil(n / 256)); x1 = x^(8 lc) mod P and cond = x^(8 n) *
// 0xFFFFFFFF mod P xor 0xFFFFFFFF (reflected), from the host; out (B,)
// int64.
int ct_crc32c_batch(const uint8_t* rows, long long stride, int B, int n,
                    int lc, unsigned int x1, unsigned int cond,
                    long long* out, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n < 0 || lc < 1 || (long long)lc * CRC_THREADS < n)
    return (int)cudaErrorInvalidValue;
  crc32c_kernel<<<B, CRC_THREADS, 0, stream>>>(rows, stride, n, lc, x1, cond,
                                                out);
  return (int)cudaGetLastError();
}

// rows: (B, n) u8, contiguous and 8-byte aligned, n a positive multiple
// of 32; out (B, 2) int64.
int ct_xxh64_batch(const uint8_t* rows, int B, int n,
                   unsigned long long seed, long long* out,
                   cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n < 32 || n % 32) return (int)cudaErrorInvalidValue;
  const long long threads = 4LL * B;
  const int grid = (int)((threads + XXH_THREADS - 1) / XXH_THREADS);
  xxh64_kernel<<<grid, XXH_THREADS, 0, stream>>>(rows, B, n, seed, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
