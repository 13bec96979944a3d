// Pieces of the two checkpoint-chunk decoders: copies into shared memory
// with cp.async and the launch's shared-memory limit (huff0dec.cu and
// zseqdec.cu); a tile of chunk windows copied whole, the persistent grid
// and a register bit container that reads a window downward
// (zseqdec.cu).
#pragma once

#include <mutex>

#include "ct_common.cuh"

namespace ct {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the windows of chunks [c0, c0 + n) (one contiguous span
// of n * win bytes, win a multiple of 4) to dst: 16-byte copies for the
// body, 4-byte copies for a tail; one group is committed whether or not
// anything was copied.  src and c0 * win must be 16-byte aligned.
__device__ __forceinline__ void copy_tile(uint32_t* dst, const uint8_t* src,
                                          int c0, int n, int win) {
  if (n > 0) {
    const uint8_t* s = src + (size_t)c0 * win;
    const int bytes = n * win;
    const int n16 = bytes >> 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(dst + 4 * i, s + 16 * i);
    for (int i = 4 * n16 + threadIdx.x; i < (bytes >> 2); i += blockDim.x)
      cp_async4(dst + i, s + 4 * i);
  }
  cp_async_commit();
}

// Start copying the n 32-bit words at src to dst (16-byte aligned): 16
// bytes a copy where src is 16-byte aligned, else 4.  Commits nothing.
__device__ __forceinline__ void copy_words(uint32_t* dst, const void* src,
                                           int n) {
  const uint8_t* s = static_cast<const uint8_t*>(src);
  int i = 0;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    for (int q = threadIdx.x; q < (n >> 2); q += blockDim.x)
      cp_async16(dst + 4 * q, s + 16 * q);
    i = n & ~3;
  }
  for (int q = i + threadIdx.x; q < n; q += blockDim.x)
    cp_async4(dst + q, s + 4 * q);
}

// Let Kernel take up to bytes of dynamic shared memory: the attribute is
// set once on each device.
template <auto Kernel>
inline cudaError_t allow_smem(int bytes) {
  static std::mutex mu;
  static unsigned long long done = 0;  // a bit for each device set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

// The persistent grid of Kernel: as many CTAs as fit on the card at once,
// no more than there are tiles.  The occupancy query runs once for each
// device and shared-memory size (the last GRID_SEEN pairs are kept).
constexpr int GRID_SEEN = 8;

template <auto Kernel>
inline int persistent_grid(int threads, size_t smem, int tiles) {
  struct Seen {
    int dev;
    size_t smem;
    int per_card;
  };
  static std::mutex mu;
  static Seen seen[GRID_SEEN];
  static int n_seen = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return tiles;
  std::lock_guard<std::mutex> lock(mu);
  int per_card = 0;
  for (int i = 0; i < n_seen && i < GRID_SEEN; ++i)
    if (seen[i].dev == dev && seen[i].smem == smem)
      per_card = seen[i].per_card;
  if (!per_card) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      threads, smem) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return tiles;
    per_card = (per_sm > 1 ? per_sm : 1) * sms;
    seen[n_seen++ % GRID_SEEN] = {dev, smem, per_card};
  }
  return tiles < per_card ? tiles : per_card;
}

// A window read downward through four 32-bit words held in registers.
// get32(p) gives the 32 window bits [p, p + 32), with bits below bit 0
// and at or above the window's top (32 * ww) reading 0; p may lie
// anywhere in int32.  A read whose word (p >> 5) is not among words cw ..
// cw + 2 refills the container from words p >> 5 - 2 .. p >> 5 + 1, so a
// refill lets the reads go down at least 64 bits more before the next.
struct BitWindow {
  const uint32_t* w;  // the window's words in shared memory
  int ww;             // its length in words
  int cw;             // the container's lowest word
  uint32_t c0, c1, c2, c3;

  __device__ __forceinline__ uint32_t word(int j) const {
    return (unsigned)j < (unsigned)ww ? w[j] : 0u;
  }

  __device__ __forceinline__ void refill(int wp) {
    cw = wp - 2;
    c0 = word(cw);
    c1 = word(cw + 1);
    c2 = word(cw + 2);
    c3 = word(cw + 3);
  }

  __device__ __forceinline__ uint32_t get32(int p) {
    const int wp = p >> 5;
    int d = wp - cw;
    if ((unsigned)d > 2u) {
      refill(wp);
      d = 2;
    }
    const uint32_t lo = d == 0 ? c0 : d == 1 ? c1 : c2;
    const uint32_t hi = d == 0 ? c1 : d == 1 ? c2 : c3;
    return __funnelshift_r(lo, hi, (unsigned)p & 31u);
  }

  // bits [lbp - n, lbp - n + min(n, 32)) for 0 <= n < 64: the field of n
  // bits below the cursor, its low 32 bits where n > 32
  __device__ __forceinline__ uint32_t field(int lbp, int n) {
    const uint32_t v = get32((int)((unsigned)lbp - (unsigned)n));
    return n >= 32 ? v : v & ((1u << n) - 1u);
  }
};

}  // namespace ct
