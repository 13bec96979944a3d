// zstd parse + extract for 64 KiB blocks: finder (off, L) -> sequences and
// literals in sequence order.
//
// Replaces: compress_tpu/ops/zparse.py `_zparse_kernel` (via `parse_blocks`).
//
// Function, per block: stages A0-C of lzparse.cuh with the zstd cost gate
// (minimum match 6, +1 at offset >= 1024, +2 at offset >= 65536) between
// the probes and the parse, then
//   D.  at every op (absorbed tile heads excluded): ll = the run of
//       literals that ends just before it (across tiles), ml = L_t plus
//       the merged length, of = its offset;
//   E.  (ll, ml, of) compacted in position order into MAXSEQ slots, 0 past
//       n_seqs;
//   F.  the literal bytes compacted in position order, 0 past lit_cnt.
//
// Bound on the H100: memory.  It must read 64 KiB of bytes and 512 KiB of
// (off, L) and write 144 KiB of sequence fields and 64 KiB of literals per
// block.
//
// Design: one CTA per block, the parse in shared memory as in the S2 emit
// kernel.  The TPU routed E and F through one-hot matmuls (a row binary
// search, an in-tile rotation, a row scatter); here both are one
// block-wide exclusive scan of the take and literal bit counts (each
// thread owns 4 consecutive 32-position words: a warp shuffle scan, then
// the 16 warp totals), after which every op and literal knows its slot
// and is stored there directly.  The literals are gathered in the freed
// L_t area of shared memory and stored coalesced.  The literal run behind
// an op is found by scanning the literal mask backwards for its last zero.
#include "lzparse.cuh"

namespace {

using namespace ct;

constexpr int MAXSEQ = 96 * LANES;                 // 12288 sequence slots
constexpr int SM_SCAN = PARSE_SMEM;                // 2 x 16 warp totals
constexpr size_t ZPARSE_SMEM = PARSE_SMEM + 2 * PARSE_WARPS * 4;
constexpr int WORDS_PER_THREAD = BS / 32 / PARSE_THREADS;  // 4

// literals immediately before position g (a run may cross tiles)
__device__ __forceinline__ int lit_run_before(const uint32_t* litb, int g) {
  if (g == 0) return 0;
  const int p = g - 1;
  int wi = p >> 5;
  uint32_t w = ~litb[wi] & (FULL >> (31 - (p & 31)));
  while (w == 0 && --wi >= 0) w = ~litb[wi];
  const int z = w ? (wi << 5) + 31 - __clz(w) : -1;  // last non-literal < g
  return p - z;
}

// exclusive block-wide prefix of (a, b) per thread; totals in *ta, *tb
__device__ __forceinline__ void block_scan2(int a, int b, int* sc, int& ea,
                                           int& eb, int& ta, int& tb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int va = __shfl_up_sync(FULL, ia, d);
    const int vb = __shfl_up_sync(FULL, ib, d);
    if (lane >= d) {
      ia += va;
      ib += vb;
    }
  }
  if (lane == 31) {
    sc[warp] = ia;
    sc[PARSE_WARPS + warp] = ib;
  }
  __syncthreads();
  int ba = 0, bb = 0;
  ta = 0;
  tb = 0;
  for (int w = 0; w < PARSE_WARPS; ++w) {
    if (w < warp) {
      ba += sc[w];
      bb += sc[PARSE_WARPS + w];
    }
    ta += sc[w];
    tb += sc[PARSE_WARPS + w];
  }
  ea = ba + ia - a;
  eb = bb + ib - b;
}

__global__ void __launch_bounds__(PARSE_THREADS, 1)
    zparse_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ lens, int32_t* __restrict__ ll_out,
                  int32_t* __restrict__ ml_out, int32_t* __restrict__ of_out,
                  uint8_t* __restrict__ lit_out, int32_t* __restrict__ n_seqs,
                  int32_t* __restrict__ lit_cnt, int cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const ParseSmem s = parse_smem(smem, warp);
  int* sc = reinterpret_cast<int*>(smem + SM_SCAN);
  const size_t b = blockIdx.x;
  const int32_t* offb = offs + b * BS;

  parse_block<true>(s, blocks + b * BS, offb, lens + b * BS, cap);

  // an absorbed tile's first op is part of the previous tile's op
  if (tid < NT && s.t_abs[tid]) s.takeb[(tid * TILE) >> 5] &= ~1u;
  __syncthreads();

  const int w0 = tid * WORDS_PER_THREAD;
  uint32_t tw[WORDS_PER_THREAD], lw[WORDS_PER_THREAD];
  int nt = 0, nl = 0;
#pragma unroll
  for (int k = 0; k < WORDS_PER_THREAD; ++k) {
    tw[k] = s.takeb[w0 + k];
    lw[k] = s.litb[w0 + k];
    nt += __popc(tw[k]);
    nl += __popc(lw[k]);
  }
  int rt, rl, ns, nlit;
  block_scan2(nt, nl, sc, rt, rl, ns, nlit);

  // ---- D + E: sequence fields, stored at their rank ---------------------
  int32_t* llb = ll_out + b * MAXSEQ;
  int32_t* mlb = ml_out + b * MAXSEQ;
  int32_t* ofb = of_out + b * MAXSEQ;
#pragma unroll
  for (int k = 0; k < WORDS_PER_THREAD; ++k) {
    uint32_t m = tw[k];
    while (m) {
      const int g = ((w0 + k) << 5) + __ffs(m) - 1;
      m &= m - 1;
      const int t = g / TILE, r_t = g & (TILE - 1);
      const int v = s.lt[g];
      if (rt < MAXSEQ) {
        llb[rt] = lit_run_before(s.litb, g);
        mlb[rt] = (v & 0x3FF) + (r_t == s.t_recv[t] ? s.t_W[t] : 0);
        ofb[rt] = resolve_off(v, offb[g]);
      }
      ++rt;
    }
  }
  for (int i = ns + tid; i < MAXSEQ; i += PARSE_THREADS) {
    llb[i] = 0;
    mlb[i] = 0;
    ofb[i] = 0;
  }
  __syncthreads();  // L_t is read for the last time above

  // ---- F: literals gathered in the L_t area, then stored coalesced ------
  uint8_t* lbuf = reinterpret_cast<uint8_t*>(s.lt);
#pragma unroll
  for (int k = 0; k < WORDS_PER_THREAD; ++k) {
    uint32_t m = lw[k];
    while (m) {
      const int g = ((w0 + k) << 5) + __ffs(m) - 1;
      m &= m - 1;
      lbuf[rl++] = s.blk[g];
    }
  }
  for (int i = nlit + tid; i < BS; i += PARSE_THREADS) lbuf[i] = 0;
  __syncthreads();
  for (int i = tid; i < BS / 16; i += PARSE_THREADS)
    reinterpret_cast<uint4*>(lit_out + b * BS)[i] =
        reinterpret_cast<const uint4*>(lbuf)[i];
  if (tid == 0) {
    n_seqs[b] = ns;
    lit_cnt[b] = nlit;
  }
}

}  // namespace

extern "C" {

// blocks: (nb, BS) u8; off, len: (nb, BS) i32 (finder, merged with the
// long-range channel); ll, ml, of: (nb, MAXSEQ) i32; lits: (nb, BS) u8;
// n_seqs, lit_cnt: (nb,) i32.
int ct_parse_blocks(const uint8_t* blocks, const int32_t* off,
                    const int32_t* len, int32_t* ll, int32_t* ml, int32_t* of,
                    uint8_t* lits, int32_t* n_seqs, int32_t* lit_cnt, int nb,
                    int cap, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      zparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ZPARSE_SMEM);
  if (e != cudaSuccess) return (int)e;
  zparse_kernel<<<nb, PARSE_THREADS, ZPARSE_SMEM, stream>>>(
      blocks, off, len, ll, ml, of, lits, n_seqs, lit_cnt, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
