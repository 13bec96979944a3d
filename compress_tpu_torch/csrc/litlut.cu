// Huffman code lookup of literal bytes, per 64 KiB block.
//
// Replaces: compress_tpu/ops/zenc2.py `_litlut_kernel` (via `_litlut`).
//
// Function: for every byte x of block r, with the block's packed table
// e = tab[r][x] (tab (R, 256) i32, code | nbits << 16):
// code = e & 0xFFFF, nbits = e >> 16.
//
// Bound on the H100: memory.  It reads 1 byte and writes 8 per literal
// (two int32 outputs).
//
// Design: a grid of (chunks, blocks); each CTA copies its block's 1 KiB
// table into shared memory, then every thread turns 4 consecutive bytes
// (one 32-bit load) into two 16-byte stores.  The TPU kernel needed two
// 128-lane gathers and a select per byte; a shared-memory lookup is one
// load.
#include "ct_common.cuh"

namespace {

constexpr int LUT_THREADS = 256;
constexpr int LUT_BYTES_PER_CTA = 16384;  // 4 bytes per thread, 16 loops

__global__ void __launch_bounds__(LUT_THREADS)
    litlut_kernel(const uint8_t* __restrict__ lits,
                  const int32_t* __restrict__ tabs, int32_t* __restrict__ code,
                  int32_t* __restrict__ nbits, int bs) {
  __shared__ int32_t tab[256];
  const size_t r = blockIdx.y;
  tab[threadIdx.x] = tabs[r * 256 + threadIdx.x];
  __syncthreads();
  const size_t base = r * (size_t)bs + (size_t)blockIdx.x * LUT_BYTES_PER_CTA;
  const int lim = min(LUT_BYTES_PER_CTA, bs - (int)blockIdx.x * LUT_BYTES_PER_CTA);
  for (int i = threadIdx.x * 4; i < lim; i += LUT_THREADS * 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(lits + base + i);
    const int e0 = tab[w & 255], e1 = tab[(w >> 8) & 255];
    const int e2 = tab[(w >> 16) & 255], e3 = tab[w >> 24];
    *reinterpret_cast<int4*>(code + base + i) =
        make_int4(e0 & 0xFFFF, e1 & 0xFFFF, e2 & 0xFFFF, e3 & 0xFFFF);
    *reinterpret_cast<int4*>(nbits + base + i) =
        make_int4(e0 >> 16, e1 >> 16, e2 >> 16, e3 >> 16);
  }
}

}  // namespace

extern "C" {

// lits: (nb, bs) u8, bs a multiple of 4; tabs: (nb, 256) i32;
// code, nbits: (nb, bs) i32.
int ct_litlut(const uint8_t* lits, const int32_t* tabs, int32_t* code,
              int32_t* nbits, int nb, int bs, cudaStream_t stream) {
  if (nb <= 0 || bs <= 0) return 0;
  if (bs % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((bs + LUT_BYTES_PER_CTA - 1) / LUT_BYTES_PER_CTA, nb);
  litlut_kernel<<<grid, LUT_THREADS, 0, stream>>>(lits, tabs, code, nbits, bs);
  return (int)cudaGetLastError();
}

}  // extern "C"
