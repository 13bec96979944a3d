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
// Design: one CTA of 256 threads per block, two CTAs an SM (lzparse.cuh
// describes stages A-C and the shared memory they keep).  The TPU routed E
// and F through one-hot matmuls (a row binary search, an in-tile rotation,
// a row scatter); here one warp turns the tile summaries into each
// tile's first sequence slot, first literal slot and the literal run
// entering it by scans (while another runs C), and then a warp per tile
// writes:
//   D+E the tile's ops in order, a take word at a time: a lane per op, so
//       the warp stores consecutive slots; an op's literal run is the one
//       the walk kept (plus, for the tile's first op, the run entering the
//       tile); the finder's offsets at the tile's ops are all loaded first;
//   F   the tile's literals: each lane loads its 16 bytes and stores its
//       literals at a warp prefix sum of the literal-mask counts.
#include "lzparse.cuh"

namespace {

using namespace ct;

constexpr int MAXSEQ = 96 * LANES;  // 12288 sequence slots
constexpr int ZCAP = 10;            // the finder's cap (L_CAP)
constexpr size_t ZPARSE_SMEM = PARSE_SMEM + 16;  // + n_seqs, lit_cnt

// CAP: 10, the finder's cap on the main path, or 0, any cap (rcap) at run
// time
template <int CAP>
__global__ void __launch_bounds__(PARSE_THREADS, 2)
    zparse_kernel(const uint8_t* __restrict__ blocks,
                  const int32_t* __restrict__ offs,
                  const int32_t* __restrict__ lens, int32_t* __restrict__ ll_out,
                  int32_t* __restrict__ ml_out, int32_t* __restrict__ of_out,
                  uint8_t* __restrict__ lit_out, int32_t* __restrict__ n_seqs,
                  int32_t* __restrict__ lit_cnt, int rcap) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ParseSmem s = parse_smem(smem, warp);
  int* tot = reinterpret_cast<int*>(smem + PARSE_SMEM);
  int *seqb = s.t_x0, *litb0 = s.t_x1, *carry = s.t_x2;
  const size_t b = blockIdx.x;
  const uint8_t* blkg = blocks + b * BS;
  const int32_t* offb = offs + b * BS;

  parse_tiles<true, CAP>(s, blkg, offb, lens + b * BS, rcap);
  if (warp == 0) {
    merge_tiles(s, lane);
  } else if (warp == 1) {
    // each tile's first sequence and literal slot (prefix sums of its
    // sequences and literals), and the literals just before it: those
    // after the last op of the last tile with an op (a prefix maximum),
    // plus every tile since, 4 tiles a lane
    const int t0 = 4 * lane;
    int ns[4], nl[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i;
      ns[i] = s.t_nops[t] - absorbed(s, t);
      nl[i] = s.t_nlit[t];
      lo[i] = s.t_nops[t] ? t : -1;
    }
    int a = ns[0] + ns[1] + ns[2] + ns[3], c = nl[0] + nl[1] + nl[2] + nl[3];
    int m = max(max(lo[0], lo[1]), max(lo[2], lo[3]));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int va = __shfl_up_sync(FULL, a, d);
      const int vc = __shfl_up_sync(FULL, c, d);
      const int vm = __shfl_up_sync(FULL, m, d);
      if (lane >= d) {
        a += va;
        c += vc;
        m = max(m, vm);
      }
    }
    if (lane == 31) {
      tot[0] = a;
      tot[1] = c;
    }
    a -= ns[0] + ns[1] + ns[2] + ns[3];  // exclusive
    c -= nl[0] + nl[1] + nl[2] + nl[3];
    const int mp = __shfl_up_sync(FULL, m, 1);
    m = lane > 0 ? mp : -1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + i;
      seqb[t] = a;
      litb0[t] = c;
      carry[t] = (m < 0 ? 0 : TILE - s.t_end[m]) + (t - m - 1) * TILE;
      a += ns[i];
      c += nl[i];
      m = max(m, lo[i]);
    }
  }
  __syncthreads();
  const int ns = tot[0], nlit = tot[1];

  // ---- D + E: a warp per tile, a lane per op, a take word at a time ------
  int32_t* llb = ll_out + b * MAXSEQ;
  int32_t* mlb = ml_out + b * MAXSEQ;
  int32_t* ofb = of_out + b * MAXSEQ;
  for (int t = warp; t < NT; t += PARSE_WARPS) {
    const int base = seqb[t] - s.t_abs[t], ab = s.t_abs[t];
    const int recv = s.t_recv[t], W = s.t_W[t];
    // the finder's offsets at the tile's ops, all loads in flight at once
    uint32_t words[TILE_WORDS];
    int fo[TILE_WORDS];
#pragma unroll
    for (int w = 0; w < TILE_WORDS; ++w) {
      words[w] = s.takeb[t * TILE_WORDS + w];
      fo[w] = (words[w] >> lane) & 1u ? __ldg(offb + t * TILE + 32 * w + lane)
                                      : 0;
    }
    int k = 0;
#pragma unroll
    for (int w = 0; w < TILE_WORDS; ++w) {
      const uint32_t word = words[w];
      const int idx = k + __popc(word & ((1u << lane) - 1u));
      if (((word >> lane) & 1u) && !(idx == 0 && ab) && base + idx < MAXSEQ) {
        const int v = s.opt[t * TILE_OPS + idx];
        llb[base + idx] = (v >> 16) + (idx == 0 ? carry[t] : 0);
        mlb[base + idx] = (v & 0x3FF) + (32 * w + lane == recv ? W : 0);
        ofb[base + idx] = resolve_off(v & 0xFFFF, fo[w]);
      }
      k += __popc(word);
    }
  }
  for (int i = ns + tid; i < MAXSEQ; i += PARSE_THREADS) {
    llb[i] = 0;
    mlb[i] = 0;
    ofb[i] = 0;
  }

  // ---- F: a warp per tile, 16 positions a lane ---------------------------
  uint8_t* lo = lit_out + b * BS;
  for (int t = warp; t < NT; t += PARSE_WARPS) {
    const uint4 bw =
        __ldg(reinterpret_cast<const uint4*>(blkg + t * TILE + 16 * lane));
    const uint32_t by[4] = {bw.x, bw.y, bw.z, bw.w};
    const uint32_t bits =
        (s.litb[t * TILE_WORDS + (lane >> 1)] >> (16 * (lane & 1))) & 0xFFFFu;
    const int c = __popc(bits);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    uint8_t* dst = lo + litb0[t] + incl - c;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if ((bits >> j) & 1u) *dst++ = (uint8_t)(by[j >> 2] >> (8 * (j & 3)));
  }
  const int a16 = (nlit + 15) & ~15;
  for (int i = nlit + tid; i < a16; i += PARSE_THREADS) lo[i] = 0;
  for (int i = a16 / 16 + tid; i < BS / 16; i += PARSE_THREADS)
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    n_seqs[b] = ns;
    lit_cnt[b] = nlit;
  }
}

template <int CAP>
int launch_parse(const uint8_t* blocks, const int32_t* off,
                 const int32_t* len, int32_t* ll, int32_t* ml, int32_t* of,
                 uint8_t* lits, int32_t* n_seqs, int32_t* lit_cnt, int nb,
                 int cap, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      zparse_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ZPARSE_SMEM);
  if (e != cudaSuccess) return (int)e;
  zparse_kernel<CAP><<<nb, PARSE_THREADS, ZPARSE_SMEM, stream>>>(
      blocks, off, len, ll, ml, of, lits, n_seqs, lit_cnt, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks: (nb, BS) u8; off, len: (nb, BS) i32 (finder, merged with the
// long-range channel); ll, ml, of: (nb, MAXSEQ) i32; lits: (nb, BS) u8;
// n_seqs, lit_cnt: (nb,) i32; cap in [1, BS]: the finder's cap 10 has its
// own instantiation, any other takes the run-time one (a cap >= BS never
// continues, so the caller cuts larger caps to BS).
int ct_parse_blocks(const uint8_t* blocks, const int32_t* off,
                    const int32_t* len, int32_t* ll, int32_t* ml, int32_t* of,
                    uint8_t* lits, int32_t* n_seqs, int32_t* lit_cnt, int nb,
                    int cap, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (cap == ZCAP)
    return launch_parse<ZCAP>(blocks, off, len, ll, ml, of, lits, n_seqs,
                              lit_cnt, nb, cap, stream);
  if (cap < 1 || cap > BS) return (int)cudaErrorInvalidValue;
  return launch_parse<0>(blocks, off, len, ll, ml, of, lits, n_seqs, lit_cnt,
                         nb, cap, stream);
}

// CTAs of the kernel resident on one SM (< 0: an error).
int ct_parse_occupancy() {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      zparse_kernel<ZCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ZPARSE_SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, zparse_kernel<ZCAP>, PARSE_THREADS, ZPARSE_SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
