// LZ execute over a per-block byte arena (S2 block decode; zstd later).
//
// Replaces: compress_tpu/ops/exec_pallas.py `_exec_kernel` (via
// `execute_rounds_pallas`), the M = 1 case of the XLA round graph
// compress_tpu/ops/execute.py `execute_rounds`; here M is a parameter.
//
// Function: arena of block b = LR * 128 literal bytes (lit, LR = 512 * M)
// then LR * 128 output bytes, zero at the start.  For each round r, the
// slots k in [bounds[r], bounds[r+1]) of the round-major plan (src, dst,
// len: (total, B) i32) copy bytes j < min(len, 128 - (dst & 127)) from
// arena byte src + j to dst + j.  A source byte a outside the arena reads
// row clamp(a >> 7, 0, 2 * LR - 1), lane a & 127; a piece whose dst row is
// outside the arena writes nothing.  out (B, LR, 128) u8 = the output rows.
//
// Bound on the H100: memory.  Per block it reads the literal rows, the
// length of every slot and the src and dst of the live ones, and writes the
// output rows once.
//
// Design: one CTA per block; a warp loads 32 slots at once (a lane each,
// so the strided plan reads are in flight together) and copies their live
// pieces in turn (a piece is at most 128 bytes: 4 bytes a lane); pad slots
// (len 0) are skipped.  The TPU kernel
// gathered rows with one-hot bf16 matmuls, rotated lanes with
// take_along_axis and summed each round into an accumulator; each output
// byte is covered by exactly one piece and a round-r piece reads only bytes
// of earlier rounds, so plain byte stores with a CTA-wide barrier between
// rounds give the same arena.  M = 1: the 128 KiB arena lives in shared
// memory, loaded with 16-byte copies; M > 1: in a global scratch (a CTA's
// global writes are visible to its own threads after __syncthreads).
#include "ct_common.cuh"

namespace {

constexpr int EXEC_THREADS = 512;
constexpr int EXEC_WARPS = EXEC_THREADS / 32;
constexpr int SMEM_ARENA = 2 * 512 * 128;  // M = 1

__global__ void __launch_bounds__(EXEC_THREADS)
    exec_kernel(const uint8_t* __restrict__ lit, const int32_t* __restrict__ src,
                const int32_t* __restrict__ dst, const int32_t* __restrict__ len,
                const int32_t* __restrict__ bounds, int nr, int B, int LR,
                uint8_t* scratch, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int b = blockIdx.x;
  const int lit_bytes = LR * 128;
  const int rows = 2 * LR;
  const int arena_bytes = 2 * lit_bytes;
  uint8_t* arena = scratch ? scratch + (size_t)b * arena_bytes
                           : reinterpret_cast<uint8_t*>(smem);
  uint4* a4 = reinterpret_cast<uint4*>(arena);
  const uint4* l4 = reinterpret_cast<const uint4*>(lit + (size_t)b * lit_bytes);
  for (int i = threadIdx.x; i < lit_bytes / 16; i += EXEC_THREADS) a4[i] = l4[i];
  for (int i = lit_bytes / 16 + threadIdx.x; i < arena_bytes / 16;
       i += EXEC_THREADS)
    a4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = 0; r < nr; ++r) {
    const int hi = bounds[r + 1];
    // each lane loads one slot of the warp's 32, then the warp copies the
    // live pieces one after another, a byte or a few per lane
    for (int p0 = bounds[r] + 32 * warp; p0 < hi; p0 += 32 * EXEC_WARPS) {
      const int p = p0 + lane;
      int n = 0, d = 0, s = 0;
      if (p < hi) {
        const size_t k = (size_t)p * B + b;
        const int ln = len[k];
        if (ln > 0) {
          d = dst[k];
          const int row = d >> 7;
          if (row >= 0 && row < rows) {
            n = min(ln, 128 - (d & 127));
            s = src[k];
          }
        }
      }
      for (unsigned live = __ballot_sync(0xffffffffu, n > 0); live;
           live &= live - 1) {
        const int l = __ffs(live) - 1;
        const int pd = __shfl_sync(0xffffffffu, d, l);
        const int ps = __shfl_sync(0xffffffffu, s, l);
        const int pn = __shfl_sync(0xffffffffu, n, l);
        for (int j = lane; j < pn; j += 32) {
          const long long a = (long long)ps + j;
          const long long ar = min(max(a >> 7, 0LL), (long long)rows - 1);
          arena[pd + j] = arena[ar * 128 + (a & 127)];
        }
      }
    }
    __syncthreads();
  }

  uint4* o4 = reinterpret_cast<uint4*>(out + (size_t)b * lit_bytes);
  for (int i = threadIdx.x; i < lit_bytes / 16; i += EXEC_THREADS)
    o4[i] = a4[lit_bytes / 16 + i];
}

}  // namespace

extern "C" {

// lit: (B, LR, 128) u8, LR a multiple of 512; src, dst, len: (total, B)
// i32; bounds: (nr + 1,) i32 slot bounds of the rounds (non-decreasing,
// <= total); scratch: (B, 2 * LR * 128) u8 when LR > 512, else null (the
// arena is in shared memory); out: (B, LR, 128) u8.  All 16-byte aligned.
int ct_exec_rounds(const uint8_t* lit, const int32_t* src, const int32_t* dst,
                   const int32_t* len, const int32_t* bounds, int nr, int B,
                   int LR, uint8_t* scratch, uint8_t* out,
                   cudaStream_t stream) {
  if (B <= 0) return 0;
  if (LR <= 0 || LR % 512 || (LR > 512 && !scratch) || nr < 0)
    return (int)cudaErrorInvalidValue;
  int smem = 0;
  if (!scratch) {
    if (LR != 512) return (int)cudaErrorInvalidValue;
    smem = SMEM_ARENA;
    const cudaError_t e = cudaFuncSetAttribute(
        exec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  exec_kernel<<<B, EXEC_THREADS, smem, stream>>>(lit, src, dst, len, bounds, nr,
                                                 B, LR, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
