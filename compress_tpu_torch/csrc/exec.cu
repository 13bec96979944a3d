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
// with M = 1), a barrier after each; its whole output half is the step's
// output.  Bound: memory, as above, plus the history bytes the pieces
// read.  Design: a thread-block cluster of C CTAs (on C SMs) a frame
// walks the frame's blocks in order.  The step's 64 KiB output half lives
// in the cluster's distributed shared memory, 512 / C rows a CTA: a piece
// never crosses a 128-byte row, so each writes into one owner's rows
// (`map_shared_rank`), and a round's reads of output bytes go to the
// owner likewise.  Each group's pieces are split by index into C
// contiguous ranges, one a CTA, which is right for pieces in any order;
// on the planner's plans dst ascends within a group, so a CTA's stores
// fall mostly into its own rows or its neighbour's.  One cluster barrier
// (release / acquire at cluster scope) ends each group, as the CTA
// barrier did.  Each CTA zeroes its rows at a step's start and stores
// them to `out` (B, K, 512, 128), frame-major, at its end.  The history is
// the frame's own earlier output in `out`, which equals the reference's
// carried tensor shifted by 512 rows a step because every step stores all
// its 512 rows: no carried tensor and no shift.  Those reads target bytes
// other CTAs of the cluster wrote in this launch, ordered by the cluster
// barrier that starts the step; they read through L2 (`__ldcg`: the
// coherent path, no `__restrict__` and no read-only loads).  Within a
// CTA the copy is balanced by bytes, not pieces (`copy_bytes`): a
// repeated stretch of history is a run of 128-byte pieces, which a
// warp-per-32-pieces copy left to a few warps for many rounds.  Bytes
// this CTA owns are stored and read with plain shared-memory accesses,
// the others through the cluster's window.  Empty groups (the same for
// every CTA of the cluster) take no barrier.  One launch serves a batch of
// frames with one history size.
//
// Built with -DCT_HIST_CLOCK (compress_tpu_torch/tools/hist_group_clock.py)
// the history kernel records frame 0's cycles a group; the library's build
// does not define it.
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
#include <cooperative_groups.h>

#include "ct_common.cuh"

namespace cg = cooperative_groups;

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

// The history kernel's copy of pieces [lo, hi), balanced by bytes over the
// CTA: tiles of HTILE pieces (HPT a thread) are loaded and their live
// lengths scanned CTA-wide into s_off, then thread t copies bytes 4t ..
// 4t + 3 of the tile (and every 4 * EXEC_THREADS after): a binary search
// over s_off finds the first byte's piece, the next bytes step on, the
// four reads issue before the four writes.  A run of long pieces (a
// repeated stretch is 128-byte pieces in a row) spreads over every thread
// instead of holding a few warps for many rounds.
constexpr int HPT = 2;
constexpr int HTILE = HPT * EXEC_THREADS;

// A thread's HPT pieces of the tile that starts at t0 (zero past hi).
__device__ __forceinline__ void tile_words(const int2* __restrict__ pieces,
                                           int t0, int hi, int2* w) {
#pragma unroll
  for (int q = 0; q < HPT; ++q) {
    const int p = t0 + HPT * threadIdx.x + q;
    w[q] = p < hi ? __ldg(pieces + p) : make_int2(0, 0);
  }
}

// first: the thread's words of the first tile (tile_words(pieces, lo, hi)),
// loaded by the caller ahead of its barrier.
template <typename Read, typename Write>
__device__ __forceinline__ void copy_bytes(const int2* __restrict__ pieces,
                                           int lo, int hi, const int2* first,
                                           int* s_src, int* s_dst,
                                           int* s_off, int* s_warp,
                                           Read read, Write write) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int2 words[HPT];
#pragma unroll
  for (int q = 0; q < HPT; ++q) words[q] = first[q];
  for (int t0 = lo; t0 < hi; t0 += HTILE) {
    const int cnt = min(HTILE, hi - t0);
    if (t0 > lo) tile_words(pieces, t0, hi, words);
    int n[HPT], sum = 0;
#pragma unroll
    for (int q = 0; q < HPT; ++q) {
      const int p = HPT * tid + q;
      const int2 w = words[q];
      const unsigned u = (unsigned)w.y;
      const int d = (int)(u & 0xFFFFFFu) - HALF1;
      n[q] = min((int)((u >> 24) & 127u) + 1, 128 - (int)(u & 127u));
      if (p >= cnt || d < 0 || d >= HALF1) n[q] = 0;
      s_src[p] = w.x;
      s_dst[p] = d;
      sum += n[q];
    }
    int incl = sum;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, k);
      if (lane >= k) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < EXEC_WARPS; ++i) {
      const int v = s_warp[i];
      before += i < warp ? v : 0;
      total += v;
    }
    int excl = before + incl - sum;
#pragma unroll
    for (int q = 0; q < HPT; ++q) {
      s_off[HPT * tid + q] = excl;
      excl += n[q];
    }
    if (tid == 0) s_off[cnt] = total;  // pieces past cnt have length 0
    __syncthreads();
    for (int b0 = 4 * tid; b0 < total; b0 += 4 * EXEC_THREADS) {
      int pc = 0;  // the last piece whose offset is <= b0
#pragma unroll
      for (int step = HTILE / 2; step; step >>= 1)
        if (pc + step < cnt && s_off[pc + step] <= b0) pc += step;
      int dst[4];
      uint8_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = min(b0 + e, total - 1);
        while (s_off[pc + 1] <= b) ++pc;
        const int j = b - s_off[pc];
        dst[e] = s_dst[pc] + j;
        v[e] = read((long long)s_src[pc] + j);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (b0 + e < total) write(dst[e], v[e]);
    }
    __syncthreads();  // the tile's arrays are free again
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

#ifdef CT_HIST_CLOCK
// frame 0's (rank, step, group): cycles of the CTA's copy, of the copy and
// the cluster barrier, and the CTA's pieces (tools/hist_group_clock.py)
__device__ long long g_hist_clock[16 * 16 * 8 * 3];
#endif

__global__ void __launch_bounds__(EXEC_THREADS, 2)
    exec_hist_kernel(const uint8_t* __restrict__ lit,
                     const int2* __restrict__ pieces,
                     const int32_t* __restrict__ gstart, int G, int P, int K,
                     int hist_rows, uint8_t* out) {
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int c = (int)cluster.block_rank();
  const int b = blockIdx.x / C;         // the cluster's frame
  const int share = HALF1 / C;          // output bytes this CTA owns
  const int sh = __ffs(share) - 1;
  uint8_t* mine = reinterpret_cast<uint8_t*>(smem);
  int* s_src = reinterpret_cast<int*>(mine + share);  // HTILE each
  int* s_dst = s_src + HTILE;
  int* s_off = s_dst + HTILE;                          // HTILE + 1
  __shared__ int s_warp[EXEC_WARPS];
  // a byte of the output half: this CTA's own by a plain shared-memory
  // access, another's through the cluster's window
  const auto write = [&](int i, uint8_t v) {
    const int r = i >> sh;
    if (r == c)
      mine[i & (share - 1)] = v;
    else
      *(cluster.map_shared_rank(mine, r) + (i & (share - 1))) = v;
  };
  const auto out_byte = [&](int i) -> uint8_t {
    const int r = i >> sh;
    return r == c ? mine[i & (share - 1)]
                  : *(cluster.map_shared_rank(mine, r) + (i & (share - 1)));
  };
  // this frame's output, stored step by step and read back as history
  // (so no __restrict__ and no read-only loads on it)
  const uint8_t* frame = out + (size_t)b * K * HALF1;
  const long long hist_cap = (long long)hist_rows * 128;
  for (int k = 0; k < K; ++k) {
    // zero this CTA's rows (the same lanes stored them at the last step)
    for (int i = threadIdx.x; i < share / 16; i += EXEC_THREADS)
      reinterpret_cast<uint4*>(mine)[i] = make_uint4(0, 0, 0, 0);
    const uint8_t* l = lit + ((size_t)b * K + k) * HALF1;
    const int32_t* gs = gstart + ((size_t)b * K + k) * (G + 1);
    const long long at_k = (long long)k * HALF1 - hist_cap;
    const auto history = [&](long long a) -> uint8_t {
      const long long x = a - HIST_BASE;
      const long long xr = min(max(x >> 7, 0LL), (long long)hist_rows - 1);
      const long long at = at_k + xr * 128 + (x & 127);
      return at < 0 ? (uint8_t)0 : __ldcg(frame + at);
    };
    const auto local = [&](long long a) -> uint8_t {
      const int ar = (int)min(max(a >> 7, 0LL), 1023LL);
      const int at = ar * 128 + (int)(a & 127);
      return at < HALF1 ? __ldg(l + at) : out_byte(at - HALF1);
    };
    // the next group g' >= g with pieces (empty ones are the same in every
    // CTA of the cluster and take no barrier) and this CTA's share of it,
    // whose first tile loads before the barrier that precedes it
    int mlo = 0, mhi = 0;
    int2 first[HPT];
    const auto next = [&](int g) {
      for (; g < G; ++g) {
        const int lo = min(max(gs[g], 0), P);
        const int hi = min(max(gs[g + 1], lo), P);
        if (hi > lo) {
          const long long n = hi - lo;
          mlo = lo + (int)(n * c / C);
          mhi = lo + (int)(n * (c + 1) / C);
          tile_words(pieces, mlo, mhi, first);
          break;
        }
      }
      return g;
    };
    int g = next(0);
    // every CTA's rows are zero, and the last step's stores are visible
    cluster.sync();
    while (g < G) {
#ifdef CT_HIST_CLOCK
      const long long t0 = clock64();
      const int g0 = g, n0 = mhi - mlo;
#endif
      if (g == 0)
        copy_bytes(pieces, mlo, mhi, first, s_src, s_dst, s_off, s_warp,
                   history, write);
      else
        copy_bytes(pieces, mlo, mhi, first, s_src, s_dst, s_off, s_warp,
                   local, write);
#ifdef CT_HIST_CLOCK
      __syncthreads();
      const long long t1 = clock64();
#endif
      g = next(g + 1);
      cluster.sync();
#ifdef CT_HIST_CLOCK
      if (threadIdx.x == 0 && b == 0 && c < 16 && k < 16 && g0 < 8) {
        long long* e = g_hist_clock + ((c * 16 + k) * 8 + g0) * 3;
        e[0] = t1 - t0;
        e[1] = clock64() - t0;
        e[2] = n0;
      }
#endif
    }
    uint4* o4 = reinterpret_cast<uint4*>(out + ((size_t)b * K + k) * HALF1 +
                                         (size_t)c * share);
    for (int i = threadIdx.x; i < share / 16; i += EXEC_THREADS)
      o4[i] = reinterpret_cast<const uint4*>(mine)[i];
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

// Dynamic shared memory of a history CTA: its rows of the output half and
// a tile's piece arrays.
int hist_smem(int C) { return HALF1 / C + 4 * (3 * HTILE + 1); }

// The launch of the history kernel: B clusters of C CTAs.
cudaLaunchConfig_t hist_config(int B, int C, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C), 1, 1);
  cfg.blockDim = dim3(EXEC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = hist_smem(C);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t hist_attributes(int C) {
  cudaError_t e = cudaFuncSetAttribute(
      exec_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      hist_smem(C));
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(exec_hist_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

bool hist_cluster_ok(int C) {
  return C >= 1 && C <= 32 && (C & (C - 1)) == 0;
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
// in [512, 65536]; C the CTAs of a frame's cluster, a power of two up to
// 32 (the card takes up to 8 portably and 16 with the non-portable
// attribute; it refuses a larger cluster, and the error is returned).
// lit and out 16-byte aligned, pieces 8-byte aligned.
int ct_exec_hist(const uint8_t* lit, const int32_t* pieces,
                 const int32_t* gstart, int G, int P, int B, int K,
                 int hist_rows, int C, uint8_t* out, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  if (G < 1 || P < 0 || hist_rows < 512 || hist_rows > 128 * 512 ||
      !hist_cluster_ok(C))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = hist_attributes(C);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = hist_config(B, C, stream, attr);
  e = cudaLaunchKernelEx(&cfg, exec_hist_kernel, lit,
                         reinterpret_cast<const int2*>(pieces), gstart, G, P,
                         K, hist_rows, out);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(e != cudaSuccess ? e : last);
}

// CTAs of the history kernel resident on one SM at cluster size C (< 0: an
// error).
int ct_exec_hist_occupancy(int C) {
  if (!hist_cluster_ok(C)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t e = hist_attributes(C);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, exec_hist_kernel,
                                                      EXEC_THREADS,
                                                      hist_smem(C));
  return e == cudaSuccess ? n : -(int)e;
}

// Clusters of C CTAs of the history kernel the card holds at once
// (cudaOccupancyMaxActiveClusters; < 0: an error).
int ct_exec_hist_clusters(int C) {
  if (!hist_cluster_ok(C)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  cudaError_t e = hist_attributes(C);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = hist_config(1, C, 0, attr);
    e = cudaOccupancyMaxActiveClusters(&n, exec_hist_kernel, &cfg);
  }
  cudaGetLastError();
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

#ifdef CT_HIST_CLOCK
int ct_hist_clock_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_hist_clock, sizeof(g_hist_clock));
}
#endif

}  // extern "C"
