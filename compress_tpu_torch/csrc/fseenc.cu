// Backward 2-state interleaved tANS chain over byte rows: the FSE batch
// encode's state walk, with its first states and its flush.
//
// Replaces: compress_tpu/ops/entropy.py `fse_encode_blocks`, its lax.scan
// (:223, step :206-221), the first states (:190-200) and the flush item
// (:228-229).  An XLA scan, not a Pallas kernel; ported as a kernel of its
// own.
//
// Function, for each row r of blocks (N, L) u8 (L even) with the row's
// tables st (N, size), dnb and dfs (N, 256) int32, size = 1 << log:
//   first(x): nb = (dnb[x] + 2^15) >> 16, im = (nb << 16) - dnb[x],
//             st[clip((im >> clip(nb, 0, 16)) + dfs[x], 0, size - 1)]
//   enc(s, x): nb = (s + dnb[x]) >> 16, c = clip(nb, 0, 16),
//             bits s & (2^c - 1), next st[clip((s >> c) + dfs[x], 0, size - 1)]
//   s2 = first(b[L-1]), s1 = first(b[L-2]); step j = 0 .. L/2 - 2 encodes
//   b[L-3-2j] with s2 and then b[L-4-2j] with s1, item j = (v2 | v1 << c2,
//   nb1 + nb2); item L/2 - 1 is the flush ((s2 - size) | (s1 - size) << log,
//   2 log); items L/2 .. W - 1 are (0, 0).  int32 arithmetic wraps; the
//   clips are the reference's, which only a hostile table reaches.
//
// Bound on the H100: latency.  A row is a chain of L/2 - 1 dependent steps
// (two independent state chains, each a shared-memory table load and a
// few integer operations a step): 8,191 steps for a 16 KiB row.  The bytes
// (the rows, the tables, 8 bytes an item out) would take a few
// hundredths of a millisecond at the memory rate.
//
// Design (simple): one thread walks one row.  A CTA of FSEE_THREADS threads
// takes FSEE_ROWS rows: all its threads copy the rows' tables into shared
// memory and then the rows' bytes in chunks of FSEE_CHUNK (16-byte copies
// where the rows allow), last chunk first; thread 32 w walks row w's
// chunks, one walker a warp.  Pairs of symbols start at even positions
// and chunks at multiples of FSEE_CHUNK, so no step straddles two chunks.
// A walker loads the next pair's deltas and the symbols of the pair after
// before this pair's state writes: the card issues a warp's instructions
// in order, so a step that loaded its own symbols and deltas first waited
// on two dependent shared-memory loads before its chain could start.  What
// is left is the chain of the two interleaved state writes.
#include "ct_common.cuh"

namespace {

constexpr int FSEE_THREADS = 128;
constexpr int FSEE_ROWS = 4;
constexpr int FSEE_CHUNK = 2048;  // bytes of a row staged at a time
static_assert(FSEE_ROWS * 32 <= FSEE_THREADS, "one walker warp a row");

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// lo <= hi: two min/max instructions, one fewer than a compare and select
__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int first_state(const int* st, const int* dnb,
                                           const int* dfs, int size, int x) {
  const int d = dnb[x];
  const int nb = wadd(d, 1 << 15) >> 16;
  const int im = (int)(((unsigned)nb << 16) - (unsigned)d);
  const int lu = clip(wadd(im >> clip(nb, 0, 16), dfs[x]), 0, size - 1);
  return st[lu];
}

// One row's walk over the staged pairs m = hi .. lo (symbols 2m and 2m + 1
// at sym[2m - c0] and sym[2m + 1 - c0]), writing item npairs - 2 - m of
// each; the states s1, s2 carry from chunk to chunk.
__device__ __forceinline__ void walk(const int* t_st, const int* t_dnb,
                                     const int* t_dfs, int size,
                                     const uint8_t* sym, int c0, int hi,
                                     int lo, int npairs, int* ov, int* on,
                                     int& s1, int& s2) {
  // the deltas of pair hi and the symbols of pair hi - 1: each step loads
  // the next pair's deltas and the symbols of the pair after, none of
  // which its own state writes wait on
  int d2 = t_dnb[sym[2 * hi + 1 - c0]], f2 = t_dfs[sym[2 * hi + 1 - c0]];
  int d1 = t_dnb[sym[2 * hi - c0]], f1 = t_dfs[sym[2 * hi - c0]];
  int y2 = 0, y1 = 0;
  if (hi - 1 >= lo) {
    y2 = sym[2 * hi - 1 - c0];
    y1 = sym[2 * hi - 2 - c0];
  }
  for (int m = hi; m >= lo; --m) {
    int nd2 = 0, nf2 = 0, nd1 = 0, nf1 = 0, z2 = 0, z1 = 0;
    if (m - 1 >= lo) {
      nd2 = t_dnb[y2];
      nf2 = t_dfs[y2];
      nd1 = t_dnb[y1];
      nf1 = t_dfs[y1];
    }
    if (m - 2 >= lo) {
      z2 = sym[2 * m - 3 - c0];
      z1 = sym[2 * m - 4 - c0];
    }
    // the pair's two state writes, written interleaved (the chains are
    // independent): nb = (s + d) >> 16, c = clip(nb, 0, 16), bits
    // s & (2^c - 1), next st[clip((s >> c) + f, 0, size - 1)]
    const int nb2 = wadd(s2, d2) >> 16, nb1 = wadd(s1, d1) >> 16;
    const int c2 = clip(nb2, 0, 16), c1 = clip(nb1, 0, 16);
    const int i2 = clip(wadd(s2 >> c2, f2), 0, size - 1);
    const int i1 = clip(wadd(s1 >> c1, f1), 0, size - 1);
    const unsigned v2 = (unsigned)s2 & ((1u << c2) - 1u);
    const unsigned v1 = (unsigned)s1 & ((1u << c1) - 1u);
    s2 = t_st[i2];
    s1 = t_st[i1];
    const int j = npairs - 2 - m;
    ov[j] = (int)(v2 | (v1 << c2));
    on[j] = wadd(nb1, nb2);
    d2 = nd2;
    f2 = nf2;
    d1 = nd1;
    f1 = nf1;
    y2 = z2;
    y1 = z1;
  }
}

// WIDE: the rows are copied 16 bytes at a time (L a multiple of 16 and
// `blocks` 16-byte aligned), else byte by byte.
template <bool WIDE>
__global__ void __launch_bounds__(FSEE_THREADS)
    fse_encode_kernel(const uint8_t* __restrict__ blocks,
                      const int* __restrict__ st, const int* __restrict__ dnb,
                      const int* __restrict__ dfs, int N, int L, int tlog,
                      int W, int* __restrict__ vals, int* __restrict__ nbs) {
  extern __shared__ int smem[];
  const int size = 1 << tlog;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * FSEE_ROWS;
  const int rows = min(FSEE_ROWS, N - r0);
  int* s_st = smem;                             // FSEE_ROWS * size
  int* s_dnb = s_st + FSEE_ROWS * size;         // FSEE_ROWS * 256
  int* s_dfs = s_dnb + FSEE_ROWS * 256;         // FSEE_ROWS * 256
  uint8_t* s_sym = reinterpret_cast<uint8_t*>(s_dfs + FSEE_ROWS * 256);

  for (int i = tid; i < rows * size; i += FSEE_THREADS)
    s_st[i] = st[(size_t)r0 * size + i];
  for (int i = tid; i < rows * 256; i += FSEE_THREADS) {
    s_dnb[i] = dnb[(size_t)r0 * 256 + i];
    s_dfs[i] = dfs[(size_t)r0 * 256 + i];
  }

  // walker w is thread 32 w: one warp a row, so a walker's stalls do not
  // hold the other rows' walkers in lock step
  const bool walker = (tid & 31) == 0 && (tid >> 5) < rows;
  const int w = walker ? tid >> 5 : 0;
  const int* t_st = s_st + w * size;
  const int* t_dnb = s_dnb + w * 256;
  const int* t_dfs = s_dfs + w * 256;
  const uint8_t* sym = s_sym + w * FSEE_CHUNK;
  int* ov = vals + (size_t)(r0 + w) * W;
  int* on = nbs + (size_t)(r0 + w) * W;
  const int npairs = L / 2;
  int s1 = 0, s2 = 0;

  const int nchunks = (L + FSEE_CHUNK - 1) / FSEE_CHUNK;
  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int c0 = ci * FSEE_CHUNK;
    const int clen = min(FSEE_CHUNK, L - c0);
    __syncthreads();  // the walkers are done with the previous chunk
    if (WIDE) {       // clen is then a multiple of 16
      const int q = clen / 16;
      for (int i = tid; i < rows * q; i += FSEE_THREADS) {
        const int rr = i / q, k = i - rr * q;
        reinterpret_cast<uint4*>(s_sym + rr * FSEE_CHUNK)[k] = __ldg(
            reinterpret_cast<const uint4*>(blocks + (size_t)(r0 + rr) * L +
                                           c0) + k);
      }
    } else {
      for (int i = tid; i < rows * clen; i += FSEE_THREADS) {
        const int rr = i / clen, k = i - rr * clen;
        s_sym[rr * FSEE_CHUNK + k] = blocks[(size_t)(r0 + rr) * L + c0 + k];
      }
    }
    __syncthreads();
    if (walker) {
      int hi = (c0 + clen) / 2 - 1;  // the chunk's last pair
      if (hi == npairs - 1) {        // the row's last pair: first states
        s2 = first_state(t_st, t_dnb, t_dfs, size, sym[2 * hi + 1 - c0]);
        s1 = first_state(t_st, t_dnb, t_dfs, size, sym[2 * hi - c0]);
        --hi;
      }
      if (hi >= c0 / 2)
        walk(t_st, t_dnb, t_dfs, size, sym, c0, hi, c0 / 2, npairs, ov, on,
             s1, s2);
    }
  }
  if (walker) {
    ov[npairs - 1] = (int)(((unsigned)s2 - (unsigned)size) |
                           (((unsigned)s1 - (unsigned)size) << tlog));
    on[npairs - 1] = 2 * tlog;
    for (int j = npairs; j < W; ++j) {
      ov[j] = 0;
      on[j] = 0;
    }
  }
}

size_t encode_smem(int tlog) {
  return sizeof(int) * (size_t)FSEE_ROWS * ((1u << tlog) + 512) +
         (size_t)FSEE_ROWS * FSEE_CHUNK;
}

template <bool WIDE>
int launch(const uint8_t* blocks, const int* st, const int* dnb,
           const int* dfs, int N, int L, int tlog, int W, int* vals, int* nbs,
           cudaStream_t stream) {
  const size_t smem = encode_smem(tlog);
  cudaError_t e = cudaFuncSetAttribute(
      fse_encode_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (N + FSEE_ROWS - 1) / FSEE_ROWS;
  fse_encode_kernel<WIDE><<<grid, FSEE_THREADS, smem, stream>>>(
      blocks, st, dnb, dfs, N, L, tlog, W, vals, nbs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks (N, L) u8, L even >= 2, contiguous; st (N, 1 << tlog), dnb and dfs
// (N, 256) int32, contiguous; 1 <= tlog <= 12; vals, nbs (N, W) int32 with
// W >= L / 2.
int ct_fse_encode(const uint8_t* blocks, const int* st, const int* dnb,
                  const int* dfs, int N, int L, int tlog, int W, int* vals,
                  int* nbs, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 2 || L % 2 || tlog < 1 || tlog > 12 || W < L / 2)
    return (int)cudaErrorInvalidValue;
  if (L % 16 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0)
    return launch<true>(blocks, st, dnb, dfs, N, L, tlog, W, vals, nbs,
                        stream);
  return launch<false>(blocks, st, dnb, dfs, N, L, tlog, W, vals, nbs,
                       stream);
}

}  // extern "C"
