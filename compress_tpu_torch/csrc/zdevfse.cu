// Backward 3-stream FSE encode state chain over per-job tables: the zstd
// v1 engine's sequence-state walk.
//
// Replaces: compress_tpu/ops/zdev.py `_fse_scan`, its lax.scan (:445, step
// :486-500, first states :474-484).  An XLA scan, not a Pallas kernel;
// ported as a kernel of its own.
//
// Function, for each block r (job j = r / (R / nj)) and stream k (ll, of,
// ml) with the job's tables st (512), dnb and dfs (64) and size = 1 if the
// stream is RLE, else 1 << log; n = n_seqs[r]; lookups of a symbol outside
// [0, 64) read 0; int32 arithmetic:
//   first(x): nb = (dnb[x] + 2^15) >> 16, im = (nb << 16) - dnb[x],
//             st[clip((im >> clip(nb, 0, 16)) + dfs[x], 0, 511)] - size
//   enc(s, x): y = s + size, nb = (y + dnb[x]) >> 16, c = clip(nb, 0, 16),
//             bits y & (2^c - 1), next st[clip((y >> c) + dfs[x], 0, 511)]
//             - size
//   the state starts at 0; sequence n - 1 sets it to first(sym[n - 1])
//   (with n > MS every sequence is an enc step); sequences i < n - 1, from
//   the last down, are enc steps whose (bits, nb) land at entry MS - 1 - i
//   (write order); every other entry is 0; an RLE stream keeps state 0 and
//   writes only zeros.  fin = the state after sequence 0.
//
// Bound on the H100: latency.  A stream is a chain of n - 1 dependent
// steps (a shared-memory table load and a few integer operations each):
// up to 2,730 for a 16 KiB block.  The bytes (the codes read, two int32
// outputs written a sequence and stream) take about a hundredth of a
// millisecond at the memory rate for a launch of 512 blocks.
//
// Design: one thread walks one (block, stream) row; a warp takes 32
// consecutive rows of one job and a CTA of ZF_THREADS threads 64, with
// the job's three tables (about 7.5 KiB) in shared memory.  A thread that
// read its own row and wrote its own outputs would touch 32 lines a warp
// instruction, three times a step; so the warp walks its rows in chunks
// of ZF_STEP sequences, from the warp's longest live run down: it loads
// each row's symbols of the next chunk with one coalesced load a row into
// registers while this chunk is walked, and puts them in shared memory;
// each thread walks its row's steps of the chunk (a step
// past its row's live run writes zeros), and the warp stores each row's
// (bits, nb) of the chunk with one coalesced store a row and array.  The
// entries before the warp's longest live run (in write order) are zeros,
// written first by whole warps.
#include "ct_common.cuh"

namespace {

constexpr int ZF_THREADS = 64;
constexpr int ZF_SZ = 512;   // padded state table (1 << max log)
constexpr int ZF_NSYM = 64;  // padded symbol alphabet
constexpr int ZF_STEP = 32;  // sequences a chunk (one a lane when staged)
constexpr int ZF_PITCH = ZF_STEP + 1;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(ZF_THREADS)
zdev_fse_kernel(const int* __restrict__ syms, const int* __restrict__ n_seqs,
                const int* __restrict__ st, const int* __restrict__ dnb,
                const int* __restrict__ dfs, const int* __restrict__ logs,
                const uint8_t* __restrict__ rle, int rows_per_job, int MS,
                int* __restrict__ val, int* __restrict__ nbo,
                int* __restrict__ fin) {
  __shared__ int s_st[3 * ZF_SZ];
  __shared__ int s_dnb[3 * ZF_NSYM];
  __shared__ int s_dfs[3 * ZF_NSYM];
  __shared__ int s_sym[ZF_THREADS * ZF_PITCH];
  __shared__ int s_val[ZF_THREADS * ZF_PITCH];
  __shared__ int s_nb[ZF_THREADS * ZF_PITCH];
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wrow = t - lane;                       // warp's first CTA row
  for (int k = t; k < 3 * ZF_SZ; k += ZF_THREADS)
    s_st[k] = st[(long long)j * 3 * ZF_SZ + k];
  for (int k = t; k < 3 * ZF_NSYM; k += ZF_THREADS) {
    s_dnb[k] = dnb[(long long)j * 3 * ZF_NSYM + k];
    s_dfs[k] = dfs[(long long)j * 3 * ZF_NSYM + k];
  }
  __syncthreads();
  const int rr0 = blockIdx.y * ZF_THREADS;         // CTA's first row
  const int rr = rr0 + t;                          // row within the job
  const bool mine = rr < rows_per_job;
  const long long gr = (long long)j * rows_per_job + rr;  // = r * 3 + k
  const long long grw = (long long)j * rows_per_job + rr0 + wrow;
  const int n_rows_w = max(0, min(32, rows_per_job - (rr0 + wrow)));
  const int k = (int)(gr % 3);
  const int n = mine ? n_seqs[gr / 3] : 0;
  const bool is_rle = rle[j * 3 + k] != 0;
  const int size = is_rle ? 1 : 1 << logs[j * 3 + k];
  const int* tab = s_st + k * ZF_SZ;
  const int* tdnb = s_dnb + k * ZF_NSYM;
  const int* tdfs = s_dfs + k * ZF_NSYM;

  // first state, and the live run: sequences 0 .. live - 1 are enc steps
  int s = 0;
  int live = 0;
  if (mine && !is_rle && n >= 1) {
    if (n <= MS) {
      const int x = __ldg(syms + gr * MS + n - 1);
      const bool ok = (unsigned)x < ZF_NSYM;
      const int d = ok ? tdnb[x] : 0;
      const int f = ok ? tdfs[x] : 0;
      const int nb = wadd(d, 1 << 15) >> 16;
      const int im = (int)(((unsigned)nb << 16) - (unsigned)d);
      s = wadd(tab[clip(wadd(im >> clip(nb, 0, 16), f), 0, ZF_SZ - 1)],
               -size);
      live = n - 1;
    } else {
      live = MS;
    }
  }
  const int top = __reduce_max_sync(0xFFFFFFFFu, live);  // warp's longest

  // entries 0 .. MS - top - 1 of every row of the warp are zeros
  for (int w = 0; w < n_rows_w; ++w) {
    const long long row = (grw + w) * MS;
    for (int e = lane; e < MS - top; e += 32) {
      val[row + e] = 0;
      nbo[row + e] = 0;
    }
  }

  int* my_sym = s_sym + t * ZF_PITCH;
  int* my_val = s_val + t * ZF_PITCH;
  int* my_nb = s_nb + t * ZF_PITCH;
  // the next chunk's symbols, lane e of row w in nxt[w]: loaded while the
  // current chunk is walked
  int nxt[32];
  int hi = top - 1;
  {
    const int lo = max(hi - ZF_STEP + 1, 0);
#pragma unroll
    for (int w = 0; w < 32; ++w)
      nxt[w] = w < n_rows_w && lane < hi - lo + 1
                   ? __ldg(syms + (grw + w) * MS + lo + lane)
                   : 0;
  }
  while (hi >= 0) {
    const int lo = max(hi - ZF_STEP + 1, 0);
    const int cnt = hi - lo + 1;
    __syncwarp();
#pragma unroll
    for (int w = 0; w < 32; ++w)
      s_sym[(wrow + w) * ZF_PITCH + lane] = nxt[w];
    __syncwarp();
    const int nhi = lo - 1;
    const int nlo = max(nhi - ZF_STEP + 1, 0);
#pragma unroll
    for (int w = 0; w < 32; ++w)
      nxt[w] = w < n_rows_w && lane < nhi - nlo + 1
                   ? __ldg(syms + (grw + w) * MS + nlo + lane)
                   : 0;
    for (int e = cnt - 1; e >= 0; --e) {
      const int i = lo + e;
      int v = 0, nb = 0;
      if (i < live) {
        const int x = my_sym[e];
        const bool ok = (unsigned)x < ZF_NSYM;
        const int d = ok ? tdnb[x] : 0;
        const int f = ok ? tdfs[x] : 0;
        const int y = wadd(s, size);
        nb = wadd(y, d) >> 16;
        const int c = clip(nb, 0, 16);
        v = y & (int)((1u << c) - 1u);
        s = wadd(tab[clip(wadd(y >> c, f), 0, ZF_SZ - 1)], -size);
      }
      my_val[e] = v;
      my_nb[e] = nb;
    }
    __syncwarp();
    // sequence lo + e lands at entry MS - 1 - lo - e
#pragma unroll 8
    for (int w = 0; w < 32; ++w)
      if (w < n_rows_w && lane < cnt) {
        const long long at = (grw + w) * MS + MS - 1 - lo - lane;
        val[at] = s_val[(wrow + w) * ZF_PITCH + lane];
        nbo[at] = s_nb[(wrow + w) * ZF_PITCH + lane];
      }
    hi = nhi;
  }
  if (mine) fin[gr] = s;
}

}  // namespace

extern "C" {

// syms (R, 3, MS) int32; n_seqs (R,) int32; st (nj, 3, 512), dnb and dfs
// (nj, 3, 64), logs (nj, 3) int32 (0..9); rle (nj, 3) bytes (torch.bool);
// R a multiple of nj; val and nb (R, 3, MS) and fin (R, 3) int32, all
// contiguous, written in full.
int ct_zdev_fse(const int* syms, const int* n_seqs, const int* st,
                const int* dnb, const int* dfs, const int* logs,
                const uint8_t* rle, int R, int MS, int nj, int* val, int* nb,
                int* fin, cudaStream_t stream) {
  if (R <= 0) return 0;
  if (MS <= 0 || nj <= 0 || R % nj) return (int)cudaErrorInvalidValue;
  const int rows_per_job = R / nj * 3;
  dim3 grid(nj, (rows_per_job + ZF_THREADS - 1) / ZF_THREADS);
  zdev_fse_kernel<<<grid, ZF_THREADS, 0, stream>>>(
      syms, n_seqs, st, dnb, dfs, logs, rle, rows_per_job, MS, val, nb, fin);
  return (int)cudaGetLastError();
}

}  // extern "C"
