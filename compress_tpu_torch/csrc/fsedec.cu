// Chunked 2-state interleaved FSE decode with one 512-state table a row.
//
// Replaces: compress_tpu/ops/entropy_dec.py `fse_decode_chunks` (:106-189),
// a lax.scan of k / 2 steps (step :164-183) with one-hot table lookups
// and float bit reads (`read9`, `pow2f`, the TPU's workarounds).  An XLA
// scan, not a Pallas kernel; ported as a kernel of its own.
//
// Function, per chunk (row r, chunk c): from window w (win bytes, bit b at
// byte b >> 3, bit b & 7), cursor lbp = lbit, states s1 = st1, s2 = st2,
// for pair j < k / 2: e1 = tab[r][s1], e2 = tab[r][s2] (0 for a state
// outside 0..511), entries sym | nb << 8 | new_state << 16 (nb 4 bits);
// while j < npair: if j < nore1, s1 = new_state1 + bits [lbp - nb1, lbp)
// and lbp -= nb1; then the same for s2 with nore2; emit sym1, sym2.
// Pairs from npair on emit 0 and move nothing.  Bits below window bit 0
// and past its end read 0.  Out: syms (N, C, k) u8, the end cursor.
//
// Bound on the H100: memory at the path's shapes (the windows, 52 bytes a
// chunk, the checkpoints and the symbols out); each chunk is a chain of
// k dependent table loads and bit reads.
//
// Design (simple): one thread a chunk.  A CTA of FSED_THREADS threads
// takes FSED_THREADS consecutive chunks of one row: it copies the row's
// table and the chunks' windows (one contiguous span, 4-byte words) into
// shared memory; each thread then reads its window from shared memory
// (a stride of win / 4 words, 13 at 52 bytes: odd, so no bank conflict
// within a warp) and writes each pair of symbols as one 2-byte store.
// The nearest model in the repository is csrc/huff0dec.cu (the same
// windows and cursor convention).
#include "ct_common.cuh"

namespace {

constexpr int FSED_THREADS = 256;
constexpr int FSED_STATES = 512;
constexpr int FSED_MAX_WORDS = 16;  // windows up to 64 bytes

// Bits [lo, lo + n) of a window of `nw` words, n <= 15.
__device__ __forceinline__ unsigned window_bits(const uint32_t* w, int nw,
                                                int lo, int n) {
  if (n == 0) return 0;
  int sh = 0;
  if (lo < 0) {
    sh = -lo;
    if (sh >= n) return 0;
    n -= sh;
    lo = 0;
  }
  const int wi = lo >> 5;
  if (wi >= nw) return 0;
  uint64_t x = w[wi];
  if (wi + 1 < nw) x |= (uint64_t)w[wi + 1] << 32;
  return (unsigned)((x >> (lo & 31)) & ((1u << n) - 1u)) << sh;
}

__global__ void __launch_bounds__(FSED_THREADS)
    fse_decode_kernel(const uint8_t* __restrict__ windows,
                      const int* __restrict__ lbit, const int* __restrict__ st1,
                      const int* __restrict__ st2,
                      const int* __restrict__ npair,
                      const int* __restrict__ nore1,
                      const int* __restrict__ nore2,
                      const int* __restrict__ tables, int C, int win, int k,
                      uint8_t* __restrict__ syms, int* __restrict__ endl) {
  extern __shared__ uint32_t sm[];
  int* tab = reinterpret_cast<int*>(sm);       // FSED_STATES
  uint32_t* wsm = sm + FSED_STATES;            // FSED_THREADS * win / 4
  const int r = blockIdx.y;
  const int c0 = blockIdx.x * FSED_THREADS;
  const int n = min(FSED_THREADS, C - c0);
  const int nw = win / 4;
  const int tid = threadIdx.x;

  for (int i = tid; i < FSED_STATES; i += FSED_THREADS)
    tab[i] = tables[(size_t)r * FSED_STATES + i];
  const size_t first = (size_t)r * C + c0;  // this CTA's first chunk
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(windows + first * win);
  for (int i = tid; i < n * nw; i += FSED_THREADS) wsm[i] = __ldg(src + i);
  __syncthreads();
  if (tid >= n) return;

  const size_t item = first + tid;
  const uint32_t* w = wsm + tid * nw;
  int lbp = lbit[item], s1 = st1[item], s2 = st2[item];
  const int np = npair[item], n1 = nore1[item], n2 = nore2[item];
  uint16_t* out = reinterpret_cast<uint16_t*>(syms + item * k);
  for (int j = 0; j < k / 2; ++j) {
    const int e1 = (unsigned)s1 < FSED_STATES ? tab[s1] : 0;
    const int e2 = (unsigned)s2 < FSED_STATES ? tab[s2] : 0;
    const bool act = j < np;
    if (act && j < n1) {
      const int nb = (e1 >> 8) & 15;
      s1 = (e1 >> 16) + (int)window_bits(w, nw, lbp - nb, nb);
      lbp -= nb;
    }
    if (act && j < n2) {
      const int nb = (e2 >> 8) & 15;
      s2 = (e2 >> 16) + (int)window_bits(w, nw, lbp - nb, nb);
      lbp -= nb;
    }
    out[j] = act ? (uint16_t)((e1 & 255) | ((e2 & 255) << 8)) : 0;
  }
  endl[item] = lbp;
}

}  // namespace

extern "C" {

// windows (N, C, win) u8, 4-byte aligned, win a multiple of 4 up to 64;
// lbit, st1, st2, npair, nore1, nore2 (N, C) int32; tables (N, 512) int32;
// k even, 2..64; syms (N, C, k) u8, 2-byte aligned; endl (N, C) int32.
int ct_fse_decode(const uint8_t* windows, const int* lbit, const int* st1,
                  const int* st2, const int* npair, const int* nore1,
                  const int* nore2, const int* tables, int N, int C, int win,
                  int k, uint8_t* syms, int* endl, cudaStream_t stream) {
  if (N <= 0 || C <= 0) return 0;
  if (win % 4 || win < 4 || win > 4 * FSED_MAX_WORDS || k < 2 || k % 2 ||
      k > 64 || N > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * (FSED_STATES + FSED_THREADS * win / 4);
  const dim3 grid((C + FSED_THREADS - 1) / FSED_THREADS, N);
  fse_decode_kernel<<<grid, FSED_THREADS, smem, stream>>>(
      windows, lbit, st1, st2, npair, nore1, nore2, tables, C, win, k, syms,
      endl);
  return (int)cudaGetLastError();
}

}  // extern "C"
