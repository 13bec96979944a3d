// Chunked 2-state interleaved FSE decode with one 512-state table a row.
//
// Replaces: compress_tpu/ops/entropy_dec.py `fse_decode_chunks` (:107),
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
// chunk, the checkpoints, the tables and the symbols out: 0.018 ms for
// the FSE batch decode's 1028 x 512 chunks); each chunk is a chain of k
// dependent table loads and bit reads, short beside that.
//
// Design: a CTA of FSED_THREADS threads takes FSED_THREADS consecutive
// chunks of one row, a thread a chunk.
// - Chunks with no pair to decode (rows the batch sends elsewhere, the
//   padding past a container's end) are a third of the batch decode's
//   launch.  A CTA whose chunks all have npair 0 takes a route of its
//   own: no staging and no walk; it writes its span of zero symbols with
//   16-byte streaming stores and copies lbit to the end cursors (what the
//   walk gives there).  `routes` counts the chunks on each route.
// - A live CTA copies the row's table and its chunks' windows (one
//   contiguous span) into shared memory with cp.async (16 bytes a copy
//   where the span is 16-byte aligned, else 4) and loads the states and
//   counts meanwhile.
// - The walk keeps a 64-bit bit container of window bits [32 (q - 1),
//   32 (q + 1)) and rem = lbp - 32 (q - 1), the bits below the cursor
//   that it holds.  Before each pair, fewer than 30 bits left (two reads
//   of up to 15) shifts the next word in (words outside the window read
//   0, so any int32 cursor reads as the plain version's), the next word
//   loaded a refill ahead.  A read is then rem -= nb and a shift and a
//   mask: the pair's chain is one shared-memory table load a state and a
//   few integer operations.
// - The symbols go to a stage in shared memory laid out as the CTA's span
//   of the output (placed so that 16-byte boundaries of the two agree),
//   then leave as 16-byte streaming stores, with 2-byte stores for a head
//   and tail that are not 16-byte aligned (rows are C * k bytes apart).
//   Written a thread a chunk, each store touches a sector a thread for
//   every 2 or 4 bytes: stored so straight from the walk (4 bytes at a
//   time), the batch decode's launch took 1.6 times as long on an H100
//   and its walk stalled behind the stores.  The end cursors are
//   consecutive int32 a thread: whole lines a warp as they are.
// The nearest model in the repository is csrc/huff0dec.cu (the same
// windows and cursor convention).
//
// Built with -DCT_FSEDEC_CLOCK (compress_tpu_torch/tools/fsedec_clock.py)
// the library also exports ct_fse_decode_clock, whose `clk` output
// receives each CTA's cycles (clock64) to its staging done, walking,
// storing and in all, and whether it walked.  The library's build does
// not define it.
#include "ct_tiles.cuh"

namespace {

constexpr int FSED_THREADS = 256;  // chunks a CTA
constexpr int FSED_STATES = 512;
constexpr int FSED_MAX_WORDS = 16;  // windows up to 64 bytes
constexpr int FSED_MAX_K = 64;

__host__ __device__ constexpr size_t fsed_smem(int win, int k) {
  return sizeof(int) * FSED_STATES + (size_t)FSED_THREADS * win +
         (size_t)FSED_THREADS * k + 16;
}

// Write the CTA's span [g0, g1) of the symbols (byte offsets, both even)
// from the stage, where stage[i] holds byte i + (g0 & ~15), or zeros when
// stage is null: 16-byte streaming stores between the first and last
// 16-byte boundaries, 2-byte stores for the head and tail.
__device__ __forceinline__ void store_span(uint8_t* __restrict__ syms,
                                           const uint8_t* stage, size_t g0,
                                           size_t g1) {
  const size_t base = g0 & ~(size_t)15;
  const size_t up = (g0 + 15) & ~(size_t)15, down = g1 & ~(size_t)15;
  const size_t a0 = up < g1 ? up : g1;
  const size_t a1 = down > a0 ? down : a0;
  const int tid = threadIdx.x;
  for (size_t i = a0 + 16 * (size_t)tid; i < a1; i += 16 * FSED_THREADS) {
    const uint4 v = stage ? *reinterpret_cast<const uint4*>(stage + i - base)
                          : make_uint4(0u, 0u, 0u, 0u);
    __stcs(reinterpret_cast<uint4*>(syms + i), v);
  }
  const int head = (int)(a0 - g0) >> 1, tail = (int)(g1 - a1) >> 1;
  if (tid < head + tail) {
    const size_t i = tid < head ? g0 + 2 * tid : a1 + 2 * (tid - head);
    *reinterpret_cast<uint16_t*>(syms + i) =
        stage ? *reinterpret_cast<const uint16_t*>(stage + i - base) : 0;
  }
}

// routes: null or (2,) int32 (chunks on the dead route, chunks walked);
// clk: null, or with CT_FSEDEC_CLOCK (CTAs, 5) int64.
__global__ void __launch_bounds__(FSED_THREADS)
    fse_decode_kernel(const uint8_t* __restrict__ windows,
                      const int* __restrict__ lbit, const int* __restrict__ st1,
                      const int* __restrict__ st2,
                      const int* __restrict__ npair,
                      const int* __restrict__ nore1,
                      const int* __restrict__ nore2,
                      const int* __restrict__ tables, int C, int win, int k,
                      uint8_t* __restrict__ syms, int* __restrict__ endl,
                      int* __restrict__ routes, long long* __restrict__ clk) {
#ifdef CT_FSEDEC_CLOCK
  const long long t0 = clock64();
#endif
  extern __shared__ __align__(16) uint32_t sm[];
  int* tab = reinterpret_cast<int*>(sm);       // FSED_STATES
  uint32_t* wsm = sm + FSED_STATES;            // FSED_THREADS * win / 4
  uint8_t* stage = reinterpret_cast<uint8_t*>(wsm + FSED_THREADS * (win / 4));
  const int r = blockIdx.y;
  const int c0 = blockIdx.x * FSED_THREADS;
  const int n = min(FSED_THREADS, C - c0);
  const int nw = win / 4;
  const int tid = threadIdx.x;
  const size_t first = (size_t)r * C + c0;  // this CTA's first chunk
  const size_t item = first + tid;
  const bool live = tid < n;
  const int np = live ? npair[item] : 0;
  int lbp = live ? lbit[item] : 0;
  const size_t g0 = first * k, g1 = (first + n) * k;
  const bool walk = __syncthreads_or(np > 0);
  if (routes && tid == 0) atomicAdd(routes + (walk ? 1 : 0), n);

  if (!walk) {  // nothing to decode: zero symbols, the cursors unmoved
    store_span(syms, nullptr, g0, g1);
    if (live) endl[item] = lbp;
#ifdef CT_FSEDEC_CLOCK
    __syncthreads();
    if (tid == 0) {
      const long long t = clock64() - t0;
      long long* o = clk + 5 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
      o[0] = 0;
      o[1] = 0;
      o[2] = t;
      o[3] = t;
      o[4] = 0;
    }
#endif
    return;
  }

  ct::copy_words(reinterpret_cast<uint32_t*>(tab),
                 tables + (size_t)r * FSED_STATES, FSED_STATES);
  ct::copy_words(wsm, windows + first * win, n * nw);
  ct::cp_async_commit();
  const int s1i = live ? st1[item] : 0, s2i = live ? st2[item] : 0;
  const int n1 = live ? nore1[item] : 0, n2 = live ? nore2[item] : 0;
  ct::cp_async_wait<0>();
  __syncthreads();
#ifdef CT_FSEDEC_CLOCK
  const long long t1 = clock64();
#endif

  if (live) {
    const uint32_t* w = wsm + tid * nw;
    auto word = [&](int i) { return (unsigned)i < (unsigned)nw ? w[i] : 0u; };
    int q = lbp >> 5;  // the container holds words q - 1 and q
    uint64_t cont = (uint64_t)word(q) << 32 | word(q - 1);
    int rem = (lbp & 31) + 32;
    uint32_t next = word(q - 2);
    int s1 = s1i, s2 = s2i;
    uint8_t* out = stage + (g0 & 15) + (size_t)tid * k;
    const bool words = k % 4 == 0;  // then out is 4-byte aligned
    uint32_t packed = 0;
    for (int j = 0; j < k / 2; ++j) {
      const int e1 = (unsigned)s1 < FSED_STATES ? tab[s1] : 0;
      const int e2 = (unsigned)s2 < FSED_STATES ? tab[s2] : 0;
      if (rem < 30) {
        cont = cont << 32 | next;
        rem += 32;
        --q;
        next = word(q - 2);
      }
      const bool act = j < np;
      if (act && j < n1) {
        const int nb = (e1 >> 8) & 15;
        rem -= nb;
        s1 = (e1 >> 16) + (int)((uint32_t)(cont >> rem) & ((1u << nb) - 1u));
        lbp = (int)((unsigned)lbp - (unsigned)nb);
      }
      if (act && j < n2) {
        const int nb = (e2 >> 8) & 15;
        rem -= nb;
        s2 = (e2 >> 16) + (int)((uint32_t)(cont >> rem) & ((1u << nb) - 1u));
        lbp = (int)((unsigned)lbp - (unsigned)nb);
      }
      const uint32_t pair = act ? (e1 & 255) | (e2 & 255) << 8 : 0u;
      if (!words) {
        reinterpret_cast<uint16_t*>(out)[j] = (uint16_t)pair;
      } else if (j & 1) {
        reinterpret_cast<uint32_t*>(out)[j >> 1] = packed | pair << 16;
      } else {
        packed = pair;
      }
    }
    endl[item] = lbp;
  }
  __syncthreads();
#ifdef CT_FSEDEC_CLOCK
  const long long t2 = clock64();
#endif
  store_span(syms, stage, g0, g1);
#ifdef CT_FSEDEC_CLOCK
  __syncthreads();
  if (tid == 0) {
    const long long t3 = clock64();
    long long* o = clk + 5 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
    o[0] = t1 - t0;  // to the table and windows staged
    o[1] = t2 - t1;  // the walk, symbols to the stage
    o[2] = t3 - t2;  // the stores of the span
    o[3] = t3 - t0;
    o[4] = 1;
  }
#endif
}

}  // namespace

extern "C" {

// windows (N, C, win) u8, 4-byte aligned, win a multiple of 4 up to 64;
// lbit, st1, st2, npair, nore1, nore2 (N, C) int32; tables (N, 512) int32,
// 4-byte aligned; k even, 2..64; syms (N, C, k) u8, 16-byte aligned; endl
// (N, C) int32; routes null or (2,) int32, added to.
static int launch(const uint8_t* windows, const int* lbit, const int* st1,
                  const int* st2, const int* npair, const int* nore1,
                  const int* nore2, const int* tables, int N, int C, int win,
                  int k, uint8_t* syms, int* endl, int* routes,
                  long long* clk, cudaStream_t stream) {
  if (N <= 0 || C <= 0) return 0;
  if (win % 4 || win < 4 || win > 4 * FSED_MAX_WORDS || k < 2 || k % 2 ||
      k > FSED_MAX_K || N > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + FSED_THREADS - 1) / FSED_THREADS, N);
  fse_decode_kernel<<<grid, FSED_THREADS, fsed_smem(win, k), stream>>>(
      windows, lbit, st1, st2, npair, nore1, nore2, tables, C, win, k, syms,
      endl, routes, clk);
  return (int)cudaGetLastError();
}

int ct_fse_decode(const uint8_t* windows, const int* lbit, const int* st1,
                  const int* st2, const int* npair, const int* nore1,
                  const int* nore2, const int* tables, int N, int C, int win,
                  int k, uint8_t* syms, int* endl, int* routes,
                  cudaStream_t stream) {
  return launch(windows, lbit, st1, st2, npair, nore1, nore2, tables, N, C,
                win, k, syms, endl, routes, nullptr, stream);
}

#ifdef CT_FSEDEC_CLOCK
// ct_fse_decode, and clk (CTAs, 5) int64 receives each CTA's cycles: to
// its staging done, walking, storing, in all, and 1 where it walked (a
// CTA on the dead route: 0, 0, its cycles, its cycles, 0).
int ct_fse_decode_clock(const uint8_t* windows, const int* lbit,
                        const int* st1, const int* st2, const int* npair,
                        const int* nore1, const int* nore2, const int* tables,
                        int N, int C, int win, int k, uint8_t* syms,
                        int* endl, int* routes, long long* clk,
                        cudaStream_t stream) {
  return launch(windows, lbit, st1, st2, npair, nore1, nore2, tables, N, C,
                win, k, syms, endl, routes, clk, stream);
}
#endif

}  // extern "C"
