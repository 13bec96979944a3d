// S2 parse + emit for 64 KiB blocks: finder (off, L) -> row-local S2 bytes.
//
// Replaces: compress_tpu/ops/lzemit2.py `_emit_kernel2` (via `emit_blocks`),
// and with it the v1 kernel compress_tpu/ops/lzemit.py `_emit_kernel`, whose
// outputs are identical.
//
// Function, per block: stages A0-C of the TPU kernel (chain extension, run
// probes, greedy tile parse, cross-tile merge; lzparse.cuh), then
//   D.  S2 tag bytes (literal runs cut at tiles, copy1/copy2 + repeat tag
//       past 64 bytes) into 256 slots per 128-position row, 0 past rowlen.
//
// Bound on the H100: memory.  It must read 64 KiB of bytes and 512 KiB of
// (off, L) and write 64 KiB of rows plus 2 KiB of row lengths per block.
//
// Design: one CTA per block and integer arithmetic only.  The TPU kernel
// needed pointer doubling, shift-and-roll run lengths and an output-driven
// binary-search route because a TPU core has no cheap scalar loop or
// scatter; here the parse lives in shared memory (lzparse.cuh describes
// stages A-C and what they keep: two CTAs share an SM), and
//   D  a warp per row: an exclusive warp scan of the per-position byte
//      counts places each op's bytes, which are written position-driven
//      into a 256-byte row buffer (the warp's tile buffer, free after the
//      parse) and stored coalesced; an op's L_t is found in its tile's op
//      list by the ops before its take word plus a popcount, a literal's
//      byte is read from the row's 4 bytes a lane in device memory.
#include "lzparse.cuh"

namespace {

using namespace ct;

constexpr int EMIT_THREADS = PARSE_THREADS;
constexpr int EMIT_WARPS = PARSE_WARPS;
constexpr size_t EMIT_SMEM = PARSE_SMEM;

// consecutive literal positions from g, cut at g's tile end
__device__ __forceinline__ int lit_run(const uint32_t* litb, int g) {
  const int tile_end = (g | (TILE - 1)) + 1;
  const int wend = tile_end >> 5;
  int wi = g >> 5;
  uint32_t w = ~litb[wi] & (FULL << (g & 31));
  while (w == 0 && ++wi < wend) w = ~litb[wi];
  int nz = w ? (wi << 5) + __ffs(w) - 1 : tile_end;
  return nz - g;
}

template <int CAP>
__global__ void __launch_bounds__(EMIT_THREADS, 2)
    emit_kernel(const uint8_t* __restrict__ blocks,
                const int32_t* __restrict__ offs,
                const int32_t* __restrict__ lens, uint8_t* __restrict__ out0,
                uint8_t* __restrict__ out1, int32_t* __restrict__ rowlens,
                int rcap) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ParseSmem s = parse_smem(smem, warp);
  const uint32_t* takeb = s.takeb;
  const uint32_t* litb = s.litb;
  const int* t_abs = s.t_abs;
  const int* t_recv = s.t_recv;
  const int* t_W = s.t_W;
  uint8_t* wbuf = reinterpret_cast<uint8_t*>(s.wlt);
  const size_t b = blockIdx.x;
  const uint8_t* blkg = blocks + b * BS;
  const int32_t* offb = offs + b * BS;

  parse_tiles<false, CAP>(s, blkg, offb, lens + b * BS, rcap);
  if (warp == 0) merge_tiles(s, lane);
  __syncthreads();

  // ---- D: emission, a warp per 128-position row, 4 positions per lane ---
  for (int row = warp; row < ROWS; row += EMIT_WARPS) {
    const int g0 = row * LANES + lane * 4;
    const int t = g0 / TILE;
    const uint32_t bytes4 = __ldg(reinterpret_cast<const uint32_t*>(blkg + g0));
    int ob[4], hl[4];
    uint32_t w0[4], w1[4];
    bool islit[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = g0 + j;
      const int r_t = g & (TILE - 1);
      const bool tk = bit(takeb, g) && !(t_abs[t] && r_t == 0);
      const bool li = bit(litb, g);
      const bool ls = li && !(r_t > 0 && bit(litb, g - 1));
      uint32_t h[7] = {0, 0, 0, 0, 0, 0, 0};
      int n = 0;
      if (ls) {
        const int run = lit_run(litb, g);
        const int x = run - 1;
        n = 1 + (run > 60) + (run > 256);
        h[0] = run <= 60 ? (uint32_t)x << 2 : (run <= 256 ? 240u : 244u);
        if (n >= 2) h[1] = x & 0xFF;
        if (n >= 3) h[2] = x >> 8;
      } else if (tk) {
        const int v = op_at(s, g);
        const int L2 = (v & 0x3FF) + (r_t == t_recv[t] ? t_W[t] : 0);
        const int off = resolve_off(v, offb[g]);
        const int l1 = L2 >= 68 ? 64 : (L2 >= 65 ? L2 - 4 : L2);
        const int l2 = L2 - l1;
        const bool c1 = off < 2048 && l1 <= 11;
        const int r_hl = l2 == 0 ? 0 : (l2 <= 8 ? 2 : (l2 <= 263 ? 3 : 4));
        n = (c1 ? 2 : 3) + r_hl;
        const uint32_t rb0 =
            l2 <= 8 ? ((uint32_t)(l2 - 4) << 2) | 1u : (l2 <= 263 ? 21u : 25u);
        const uint32_t rb2 = l2 <= 263 ? (uint32_t)(l2 - 8) : (uint32_t)(l2 - 260);
        const uint32_t rb3 = (uint32_t)max(l2 - 260, 0) >> 8;
        const bool hasr = l2 > 0;
        h[1] = off & 0xFF;
        if (c1) {
          h[0] = ((uint32_t)(off >> 8) << 5) | ((uint32_t)(l1 - 4) << 2) | 1u;
          if (hasr) {
            h[2] = rb0;
            if (r_hl >= 3) h[4] = rb2;
            if (r_hl >= 4) h[5] = rb3;
          }
        } else {
          h[0] = ((uint32_t)(l1 - 1) << 2) | 2u;
          h[2] = off >> 8;
          if (hasr) {
            h[3] = rb0;
            if (r_hl >= 3) h[5] = rb2;
            if (r_hl >= 4) h[6] = rb3;
          }
        }
      }
      hl[j] = n;
      islit[j] = li;
      ob[j] = n + (li ? 1 : 0);
      w0[j] = (h[0] & 255) | ((h[1] & 255) << 8) | ((h[2] & 255) << 16) |
              ((h[3] & 255) << 24);
      w1[j] = (h[4] & 255) | ((h[5] & 255) << 8) | ((h[6] & 255) << 16);
    }
    const int sum = ob[0] + ob[1] + ob[2] + ob[3];
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int rowlen = __shfl_sync(FULL, incl, 31);
    reinterpret_cast<uint2*>(wbuf)[lane] = make_uint2(0u, 0u);
    __syncwarp();
    int at = incl - sum;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      for (int k = 0; k < hl[j]; ++k) {
        const uint32_t byte = k < 4 ? (w0[j] >> (8 * k)) : (w1[j] >> (8 * (k - 4)));
        if (at + k < ROW_OUT) wbuf[at + k] = (uint8_t)byte;
      }
      if (islit[j] && at + hl[j] < ROW_OUT)
        wbuf[at + hl[j]] = (uint8_t)(bytes4 >> (8 * j));
      at += ob[j];
    }
    __syncwarp();
    const size_t ro = (b * ROWS + row) * LANES;
    reinterpret_cast<uint32_t*>(out0 + ro)[lane] =
        reinterpret_cast<const uint32_t*>(wbuf)[lane];
    reinterpret_cast<uint32_t*>(out1 + ro)[lane] =
        reinterpret_cast<const uint32_t*>(wbuf)[32 + lane];
    if (lane == 0) rowlens[b * ROWS + row] = rowlen;
    __syncwarp();
  }
}

template <int CAP>
int launch_emit(const uint8_t* blocks, const int32_t* off, const int32_t* len,
                uint8_t* out0, uint8_t* out1, int32_t* rowlens, int nb,
                int cap, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      emit_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)EMIT_SMEM);
  if (e != cudaSuccess) return (int)e;
  emit_kernel<CAP><<<nb, EMIT_THREADS, EMIT_SMEM, stream>>>(
      blocks, off, len, out0, out1, rowlens, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks: (nb, BS) u8, 16-byte aligned rows; off, len: (nb, BS) i32 from
// the finder; cap in [1, BS] (the finder's 10 and 6 (slim) have their own
// instantiations, any other takes the run-time one; a cap >= BS never
// continues, so the caller cuts larger caps to BS); out0, out1: (nb, 512,
// 128) u8; rowlens: (nb, 4, 128) i32.
int ct_emit_blocks(const uint8_t* blocks, const int32_t* off,
                   const int32_t* len, uint8_t* out0, uint8_t* out1,
                   int32_t* rowlens, int nb, int cap, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (cap == 10)
    return launch_emit<10>(blocks, off, len, out0, out1, rowlens, nb, cap,
                           stream);
  if (cap == 6)
    return launch_emit<6>(blocks, off, len, out0, out1, rowlens, nb, cap,
                          stream);
  if (cap < 1 || cap > BS) return (int)cudaErrorInvalidValue;
  return launch_emit<0>(blocks, off, len, out0, out1, rowlens, nb, cap,
                        stream);
}

// CTAs of the kernel at cap 10 resident on one SM (< 0: an error).
int ct_emit_occupancy() {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      emit_kernel<10>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)EMIT_SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, emit_kernel<10>, EMIT_THREADS, EMIT_SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
