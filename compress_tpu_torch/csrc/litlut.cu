// Huffman code lookup of literal bytes, per 64 KiB block.
//
// Replaces: compress_tpu/ops/zenc2.py `_litlut_kernel` (via `_litlut`).
//
// Function: for every byte x of row r, with the row's packed table
// e = tab[r][x] (tab (R, 256) i32, code | nbits << 16):
// code = e & 0xFFFF, nbits = e >> 16.
//
// Bound on the H100: memory.  It reads 1 byte and writes 8 per literal
// (two int32 outputs); at 512 rows of 64 KiB that is 302 MB.  The first
// design read one 4-byte word per thread and loop step (a few KiB of loads
// in flight per SM, so the loop ran at load latency) and staged a table
// per 16 KiB of work: about a third of the memory rate.
//
// Design: enough bytes in flight, and every access a full warp-wide line.
// - A CTA of 512 threads covers up to 64 KiB of one row and stages the
//   row's 1 KiB table once.  One copy of the table: a copy per lane
//   (32 KiB, a warp's 32 lookups in 32 banks whatever the bytes) ran no
//   faster on the H100, because the stores bound the kernel, not the banks.
// - Each lane loads 16 input bytes at once (uint4), four loads in flight
//   (64 bytes a thread), so a warp step covers 512 bytes.  Its 512 codes
//   and 512 lengths leave as 8 warp-wide 16-byte streaming stores
//   (__stcs: 268 MB of output never fits L2): for store k, lane l writes
//   elements 128 k + 4 l .. + 3, whose bytes it takes from lane 8 k + l / 4
//   with warp shuffles, so each store instruction writes 512 contiguous
//   bytes.
// - A row start that is not 16-byte aligned, and a row length that is a
//   multiple of 4 but not of 512, go through a scalar head and tail; a row
//   whose address is not a multiple of 4 (its 16-byte outputs could not be
//   aligned) is done by the scalar loop alone.
#include "ct_common.cuh"

namespace {

constexpr int LUT_THREADS = 512;
constexpr int LUT_SPAN = 65536;   // input bytes per CTA
constexpr int LUT_UNROLL = 4;     // 16-byte loads in flight per thread
constexpr int WARP_STEP = 512;    // input bytes per warp and load
constexpr int LUT_WARPS = LUT_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int4 look4(const int32_t* tab, uint32_t v,
                                      int4* nb) {
  const int e0 = tab[v & 255];
  const int e1 = tab[(v >> 8) & 255];
  const int e2 = tab[(v >> 16) & 255];
  const int e3 = tab[v >> 24];
  *nb = make_int4(e0 >> 16, e1 >> 16, e2 >> 16, e3 >> 16);
  return make_int4(e0 & 0xFFFF, e1 & 0xFFFF, e2 & 0xFFFF, e3 & 0xFFFF);
}

__global__ void __launch_bounds__(LUT_THREADS)
    litlut_kernel(const uint8_t* __restrict__ lits,
                  const int32_t* __restrict__ tabs, int32_t* __restrict__ code,
                  int32_t* __restrict__ nbits, int bs) {
  __shared__ int32_t tab[256];
  const size_t r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 256) tab[tid] = tabs[r * 256 + tid];
  __syncthreads();

  const uint8_t* in = lits + r * (size_t)bs;
  int32_t* oc = code + r * (size_t)bs;
  int32_t* on = nbits + r * (size_t)bs;
  const int beg = blockIdx.x * LUT_SPAN;
  const int end = min(bs, beg + LUT_SPAN);
  // [v0, v1): 16-byte aligned input, whole warp steps
  const uintptr_t a = reinterpret_cast<uintptr_t>(in + beg);
  int v0 = end, v1 = end;
  if ((a & 3) == 0) {
    v0 = min(end, beg + (int)((16 - (a & 15)) & 15));
    v1 = v0 + (end - v0) / WARP_STEP * WARP_STEP;
  }
  for (int i = beg + tid; i < v0; i += LUT_THREADS) {
    const int e = tab[in[i]];
    oc[i] = e & 0xFFFF;
    on[i] = e >> 16;
  }
  for (int i = v1 + tid; i < end; i += LUT_THREADS) {
    const int e = tab[in[i]];
    oc[i] = e & 0xFFFF;
    on[i] = e >> 16;
  }

  const int nstep = (v1 - v0) / WARP_STEP;
  const uint4* vin = reinterpret_cast<const uint4*>(in + v0);
  const int sel = lane & 3;
  for (int s0 = 0; s0 < nstep; s0 += LUT_WARPS * LUT_UNROLL) {
    uint4 w[LUT_UNROLL];
#pragma unroll
    for (int u = 0; u < LUT_UNROLL; ++u) {
      const int st = s0 + u * LUT_WARPS + warp;  // warp-uniform
      if (st < nstep) w[u] = __ldcs(vin + st * 32 + lane);
    }
#pragma unroll
    for (int u = 0; u < LUT_UNROLL; ++u) {
      const int st = s0 + u * LUT_WARPS + warp;
      if (st >= nstep) break;
      const int o = v0 + st * WARP_STEP;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int from = 8 * k + (lane >> 2);
        const uint32_t x0 = __shfl_sync(FULL, w[u].x, from);
        const uint32_t x1 = __shfl_sync(FULL, w[u].y, from);
        const uint32_t x2 = __shfl_sync(FULL, w[u].z, from);
        const uint32_t x3 = __shfl_sync(FULL, w[u].w, from);
        const uint32_t v = sel == 0 ? x0 : sel == 1 ? x1 : sel == 2 ? x2 : x3;
        int4 nb;
        const int4 cd = look4(tab, v, &nb);
        const int at = o + 128 * k + 4 * lane;
        __stcs(reinterpret_cast<int4*>(oc + at), cd);
        __stcs(reinterpret_cast<int4*>(on + at), nb);
      }
    }
  }
}

}  // namespace

extern "C" {

// lits: (nb, bs) u8, bs a multiple of 4, any address; tabs: (nb, 256) i32;
// code, nbits: (nb, bs) i32, 16-byte aligned.
int ct_litlut(const uint8_t* lits, const int32_t* tabs, int32_t* code,
              int32_t* nbits, int nb, int bs, cudaStream_t stream) {
  if (nb <= 0 || bs <= 0) return 0;
  if (bs % 4 || nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((bs + LUT_SPAN - 1) / LUT_SPAN, nb);
  litlut_kernel<<<grid, LUT_THREADS, 0, stream>>>(lits, tabs, code, nbits, bs);
  return (int)cudaGetLastError();
}

}  // extern "C"
