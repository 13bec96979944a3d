// LZ execute over a per-block byte arena (S2 block decode, zstd frame
// decode), reading the compact plan.
//
// Replaces: compress_tpu/ops/exec_pallas.py `_exec_kernel` (via
// `execute_rounds_pallas`), and the XLA round graph
// compress_tpu/ops/execute.py `execute_rounds` (M a parameter here).
//
// Function: arena of block b = LR * 128 literal bytes (lit, LR = 512 * M)
// then LR * 128 output bytes, zero at the start.  Pieces (P, 2) i32:
// (src, dst | (n - 1) << 24), block-major, each block's sorted by round;
// rstart (B, nr + 1) i32.  Round r of block b runs pieces [lo, hi), lo =
// clamp(rstart[b][r], 0, P), hi = clamp(rstart[b][r + 1], lo, P): piece
// (s, d, n) copies bytes j < min(n, 128 - (d & 127)) from arena byte s + j
// to d + j, reading the arena as it stood at the round's start, if d lies
// in the output half (else it writes nothing).  A source byte a reads row
// clamp(a >> 7, 0, 2 * LR - 1), lane a & 127.  out (B, LR, 128) u8 = the
// output rows.
//
// Bound on the H100: memory.  Per block it must read the literal rows and
// each live piece once and write the output rows once.
//
// Design: one CTA per block.  The plan holds live pieces only, block-major,
// so a warp reads 32 consecutive pieces (256 contiguous bytes) and the
// next 32 are loaded while it copies these.  The warp copies its pieces'
// bytes 32 at a time, one byte a lane, whatever their lengths (most are a
// few bytes): an inclusive warp scan of the lengths places every byte,
// and a lane finds its byte's piece by a 5-step binary search over the
// scan with shuffles.  Only the output half lives in shared memory (64 KiB
// at M = 1, so two CTAs share an SM); source bytes below it are read from
// the literal rows in device memory through L1.  Every output byte is
// covered by one piece and a round-r piece reads only bytes of earlier
// rounds, so plain byte stores with a CTA-wide barrier between rounds give
// the reference's sums.  Output halves above 128 KiB (M = 4) stay in
// device memory: the kernel zeroes `out` and works in it (a CTA's global
// writes are visible to its own threads after __syncthreads).
//
// Multi-block frames (`ct_exec_hist`).  Replaces the XLA scan
// compress_tpu/ops/execute.py `execute_blocks_hist` (no Pallas site):
// 64 KiB blocks decoded in order, each with the frame's history, the
// last hist_rows * 128 output bytes before it.  Each step (b, k) runs
// group 0 (its history pieces: source HIST_BASE + x reads history byte
// x' = clamp(x >> 7, 0, hist_rows - 1) * 128 + (x & 127), 0 before the
// frame's first byte) and then groups 1 .. G - 1 (its rounds, as above
// with M = 1), a barrier after each group; its whole output half is the
// step's output.  Bound: memory, as above, plus the history bytes the
// pieces read.  Design: a CTA per frame walks the frame's blocks in
// order with the output half in shared memory and stores each block's
// output to `out` (B, K, 512, 128), frame-major, before the next block
// starts.  The history is the frame's own earlier output in `out`, which
// equals the reference's carried tensor shifted by 512 rows a step
// because every step stores all its 512 rows: no carried tensor and no
// shift.  Those reads target bytes this launch wrote, so they are plain
// loads (not the read-only path) after the CTA barrier that follows the
// store.  One launch serves a batch of frames with one history size.
//
// The sum kernel (`ct_exec_sum`) computes the reference's sums for every
// plan, those the store cannot take too: a piece that writes the literal
// half, a byte written twice, a piece that reads a byte its own round
// writes.
// Its compact plan keeps every piece whose dst lies in the arena.  One
// CTA per block keeps an int32 arena and an int32 sum buffer in device
// memory (the caller's scratch); in each round the threads first gather
// every piece's bytes as the arena stands and add them into the sum
// buffer (atomics), then, after a barrier, move each sum into the arena
// (the first exchange of a byte takes its whole sum).  `execute_rounds`
// sends it every padded plan; no path of the decoders calls that, so it
// is simple, not fast.
#include "ct_common.cuh"

namespace {

constexpr int EXEC_THREADS = 512;
constexpr int EXEC_WARPS = EXEC_THREADS / 32;
constexpr int SMEM_HALF_MAX = 128 * 1024;  // output halves up to M = 2
constexpr unsigned FULL = 0xFFFFFFFFu;

constexpr int HALF1 = 512 * 128;           // output half at M = 1
constexpr int HIST_BASE = 1024 * 128;      // first history address

// Pieces [lo, hi) of one round: piece (s, d, n) stores read(s + j) at
// output byte d - half + j of o, for j < its live length (0 where d lies
// outside the output half).  A warp takes 32 consecutive pieces (the next
// 32 loading meanwhile) and copies their bytes 32 at a time, one a lane:
// a warp scan of the lengths places every byte, and a lane finds its
// byte's piece by a 5-step binary search over the scan with shuffles.
template <typename Read>
__device__ __forceinline__ void copy_pieces(const int2* __restrict__ pieces,
                                            int lo, int hi, int half,
                                            uint8_t* o, Read read) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int p = lo + 32 * warp + lane;
  int2 w = p < hi ? __ldg(pieces + p) : make_int2(0, 0);
  for (int p0 = lo + 32 * warp; p0 < hi; p0 += 32 * EXEC_WARPS) {
    p += 32 * EXEC_WARPS;
    const int2 wn = p < hi ? __ldg(pieces + p) : make_int2(0, 0);
    // this lane's piece: source, offset of dst in the output half, and
    // live length (0 for a lane past hi: its dst field reads 0)
    const unsigned u = (unsigned)w.y;
    const int d = (int)(u & 0xFFFFFFu) - half;
    int n = min((int)((u >> 24) & 127u) + 1, 128 - (int)(u & 127u));
    if (d < 0 || d >= half) n = 0;
    int incl = n;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, k);
      if (lane >= k) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    const int excl = incl - n;
    for (int c = 0; c < total; c += 32) {
      const int k = c + lane;
      int q = 0;  // the first lane whose scan passes k
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(FULL, incl, q + step - 1) <= k) q += step;
      const int ps = __shfl_sync(FULL, w.x, q);
      const int pd = __shfl_sync(FULL, d, q);
      const int j = k - __shfl_sync(FULL, excl, q);
      if (k < total) o[pd + j] = read((long long)ps + j);
    }
    w = wn;
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(EXEC_THREADS, 2)
    exec_pieces_kernel(const uint8_t* __restrict__ lit,
                       const int2* __restrict__ pieces,
                       const int32_t* __restrict__ rstart, int nr, int P,
                       int LR, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  const int b = blockIdx.x;
  const int half = LR * 128;
  const int rows = 2 * LR;
  uint8_t* o = SMEM ? reinterpret_cast<uint8_t*>(smem) : out + (size_t)b * half;
  const uint8_t* l = lit + (size_t)b * half;
  for (int i = threadIdx.x; i < half / 16; i += EXEC_THREADS)
    reinterpret_cast<uint4*>(o)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const auto read = [&](long long a) -> uint8_t {
    const int ar = (int)min(max(a >> 7, 0LL), (long long)rows - 1);
    const int at = ar * 128 + (int)(a & 127);
    return at < half ? __ldg(l + at) : o[at - half];
  };
  const int32_t* rs = rstart + (size_t)b * (nr + 1);
  for (int r = 0; r < nr; ++r) {
    const int lo = min(max(rs[r], 0), P);
    copy_pieces(pieces, lo, min(max(rs[r + 1], lo), P), half, o, read);
    __syncthreads();
  }

  if (SMEM) {
    uint4* o4 = reinterpret_cast<uint4*>(out + (size_t)b * half);
    for (int i = threadIdx.x; i < half / 16; i += EXEC_THREADS)
      o4[i] = reinterpret_cast<const uint4*>(o)[i];
  }
}

__global__ void __launch_bounds__(EXEC_THREADS, 2)
    exec_hist_kernel(const uint8_t* __restrict__ lit,
                     const int2* __restrict__ pieces,
                     const int32_t* __restrict__ gstart, int G, int P, int K,
                     int hist_rows, uint8_t* out) {
  extern __shared__ uint4 smem[];
  uint8_t* o = reinterpret_cast<uint8_t*>(smem);
  const int b = blockIdx.x;
  // this frame's output, stored step by step and read back as history
  // (so no __restrict__ and no read-only loads on it)
  const uint8_t* frame = out + (size_t)b * K * HALF1;
  const long long hist_cap = (long long)hist_rows * 128;
  for (int k = 0; k < K; ++k) {
    for (int i = threadIdx.x; i < HALF1 / 16; i += EXEC_THREADS)
      reinterpret_cast<uint4*>(o)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    const uint8_t* l = lit + ((size_t)b * K + k) * HALF1;
    const int32_t* gs = gstart + ((size_t)b * K + k) * (G + 1);
    const long long at_k = (long long)k * HALF1 - hist_cap;
    const auto history = [&](long long a) -> uint8_t {
      const long long x = a - HIST_BASE;
      const long long xr = min(max(x >> 7, 0LL), (long long)hist_rows - 1);
      const long long at = at_k + xr * 128 + (x & 127);
      return at < 0 ? (uint8_t)0 : frame[at];
    };
    const auto local = [&](long long a) -> uint8_t {
      const int ar = (int)min(max(a >> 7, 0LL), 1023LL);
      const int at = ar * 128 + (int)(a & 127);
      return at < HALF1 ? __ldg(l + at) : o[at - HALF1];
    };
    for (int g = 0; g < G; ++g) {
      const int lo = min(max(gs[g], 0), P);
      const int hi = min(max(gs[g + 1], lo), P);
      if (g == 0)
        copy_pieces(pieces, lo, hi, HALF1, o, history);
      else
        copy_pieces(pieces, lo, hi, HALF1, o, local);
      __syncthreads();
    }
    uint4* o4 = reinterpret_cast<uint4*>(out + ((size_t)b * K + k) * HALF1);
    for (int i = threadIdx.x; i < HALF1 / 16; i += EXEC_THREADS)
      o4[i] = reinterpret_cast<const uint4*>(o)[i];
    __syncthreads();  // the next step reads these bytes as history
  }
}

constexpr int SUM_THREADS = 256;

__global__ void __launch_bounds__(SUM_THREADS)
    exec_sum_kernel(const uint8_t* __restrict__ lit,
                    const int2* __restrict__ pieces,
                    const int32_t* __restrict__ rstart, int nr, int P, int LR,
                    int* __restrict__ arena, int* __restrict__ sums,
                    uint8_t* __restrict__ out) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int half = LR * 128, rows = 2 * LR;
  int* A = arena + (size_t)b * 2 * half;
  int* S = sums + (size_t)b * 2 * half;
  const uint8_t* l = lit + (size_t)b * half;
  for (int i = tid; i < half; i += SUM_THREADS) {
    A[i] = l[i];
    A[half + i] = 0;
    S[i] = 0;
    S[half + i] = 0;
  }
  __syncthreads();
  const int32_t* rs = rstart + (size_t)b * (nr + 1);
  for (int r = 0; r < nr; ++r) {
    const int lo = min(max(rs[r], 0), P);
    const int hi = min(max(rs[r + 1], lo), P);
    for (int pass = 0; pass < 2; ++pass) {
      for (int p = lo + tid; p < hi; p += SUM_THREADS) {
        const int2 w = pieces[p];
        const unsigned u = (unsigned)w.y;
        const int d = (int)(u & 0xFFFFFFu);
        const int n = min((int)((u >> 24) & 127u) + 1, 128 - (d & 127));
        if (d >= 2 * half) continue;
        for (int j = 0; j < n; ++j) {
          if (pass == 0) {
            const long long a = (long long)w.x + j;
            const int ar = (int)min(max(a >> 7, 0LL), (long long)rows - 1);
            atomicAdd(S + d + j, A[ar * 128 + (int)(a & 127)]);
          } else {
            const int v = atomicExch(S + d + j, 0);
            if (v) atomicAdd(A + d + j, v);
          }
        }
      }
      __syncthreads();
    }
  }
  uint8_t* o = out + (size_t)b * half;
  for (int i = tid; i < half; i += SUM_THREADS)
    o[i] = (uint8_t)(A[half + i] & 255);
}

}  // namespace

extern "C" {

// lit: (B, LR, 128) u8, LR a multiple of 512 with LR * 256 <= 2^24;
// pieces: (P, 2) i32; rstart: (B, nr + 1) i32; out: (B, LR, 128) u8.
// lit and out 16-byte aligned, pieces 8-byte aligned.
int ct_exec_pieces(const uint8_t* lit, const int32_t* pieces,
                   const int32_t* rstart, int nr, int P, int B, int LR,
                   uint8_t* out, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (LR <= 0 || LR % 512 || (long long)LR * 256 > (1 << 24) || nr < 0 ||
      P < 0)
    return (int)cudaErrorInvalidValue;
  const int half = LR * 128;
  const int2* pc = reinterpret_cast<const int2*>(pieces);
  if (half <= SMEM_HALF_MAX) {
    const cudaError_t e = cudaFuncSetAttribute(
        exec_pieces_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        half);
    if (e != cudaSuccess) return (int)e;
    exec_pieces_kernel<true><<<B, EXEC_THREADS, half, stream>>>(
        lit, pc, rstart, nr, P, LR, out);
  } else {
    exec_pieces_kernel<false><<<B, EXEC_THREADS, 0, stream>>>(
        lit, pc, rstart, nr, P, LR, out);
  }
  return (int)cudaGetLastError();
}

// As ct_exec_pieces, with the reference's sums: pieces may write anywhere
// in the arena (dst < 2 * LR * 128); arena, sums: (B, 2 * LR * 128) i32
// scratch.
int ct_exec_sum(const uint8_t* lit, const int32_t* pieces,
                const int32_t* rstart, int nr, int P, int B, int LR,
                int32_t* arena, int32_t* sums, uint8_t* out,
                cudaStream_t stream) {
  if (B <= 0) return 0;
  if (LR <= 0 || LR % 512 || (long long)LR * 256 > (1 << 24) || nr < 0 ||
      P < 0)
    return (int)cudaErrorInvalidValue;
  exec_sum_kernel<<<B, SUM_THREADS, 0, stream>>>(
      lit, reinterpret_cast<const int2*>(pieces), rstart, nr, P, LR, arena,
      sums, out);
  return (int)cudaGetLastError();
}

// Multi-block frames with their history: lit (B, K, 512, 128) u8; pieces
// (P, 2) i32; gstart (B, K, G + 1) i32; out (B, K, 512, 128) u8; hist_rows
// in [512, 65536].  lit and out 16-byte aligned, pieces 8-byte aligned.
int ct_exec_hist(const uint8_t* lit, const int32_t* pieces,
                 const int32_t* gstart, int G, int P, int B, int K,
                 int hist_rows, uint8_t* out, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (G < 1 || P < 0 || hist_rows < 512 || hist_rows > 128 * 512)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      exec_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HALF1);
  if (e != cudaSuccess) return (int)e;
  exec_hist_kernel<<<B, EXEC_THREADS, HALF1, stream>>>(
      lit, reinterpret_cast<const int2*>(pieces), gstart, G, P, K, hist_rows,
      out);
  return (int)cudaGetLastError();
}

// CTAs of the history kernel resident on one SM (< 0: an error).
int ct_exec_hist_occupancy() {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      exec_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, HALF1);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exec_hist_kernel,
                                                      EXEC_THREADS, HALF1);
  return e == cudaSuccess ? n : -(int)e;
}

// CTAs of the kernel resident on one SM at arena rows LR (< 0: an error).
int ct_exec_occupancy(int LR) {
  const int half = LR * 128;
  int n = 0;
  cudaError_t e;
  if (half <= SMEM_HALF_MAX) {
    e = cudaFuncSetAttribute(exec_pieces_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, half);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, exec_pieces_kernel<true>, EXEC_THREADS, half);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, exec_pieces_kernel<false>, EXEC_THREADS, 0);
  }
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
