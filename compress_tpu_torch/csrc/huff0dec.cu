// Chunked huff0 decode from checkpoint windows (huff0 4X batch decode).
//
// Replaces: compress_tpu/ops/entropy_pallas.py `_kern` (via
// `huff0_decode_chunks_shared`), and serves the per-container-table XLA
// scan compress_tpu/ops/entropy_dec.py `huff0_decode_chunks` through a
// table stride.
//
// Function, per chunk c (its window = win bytes, little-endian bits):
// start from the window-local cursor lbit[c]; for i < min(nsym[c], k):
// peek the mb bits [lbp - mb, lbp) (bits below 0 and above the window read
// 0), look up e = tab[peek] (sym | nb << 8), emit sym, lbp -= nb.  Steps
// past nsym emit 0 and keep the cursor.  syms (nc, k) u8, endl (nc,) i32.
// tab is one shared table (per_row = 0) or row c / per_row of a (rows,
// 2^mb) array.
//
// Bound on the H100: memory.  Each chunk reads its 52-byte window and
// writes k bytes and one cursor; the table is a few KiB.
//
// Design: a CTA of 256 threads decodes a tile of 256 chunks, a thread a
// chunk, and 8 CTAs fit an SM with one staged row (at most 32 registers;
// 21,504 bytes of shared memory at 52-byte windows and an 11-bit row):
// each thread's symbols are a serial chain of table lookups, and the
// other CTAs' copies and chains fill the SM while one waits.  The CTA copies its windows (one contiguous
// span) and the table rows its chunks read (up to `slots` rows from its
// first; one for a shared table or where tiles never cross a row) to
// shared memory with 16-byte cp.async, as they are (int32 entries).  A
// chunk whose row was not staged reads it from device memory.  A step
// peeks from two window words (the window stride is 13 words at 52
// bytes, odd, so the threads' reads fall on distinct banks) and looks up
// the entry; 16 symbols are packed into a 16-byte store.  Measured
// slower on the card (PERF.md §6): a persistent grid of 4 CTAs an SM
// with double-buffered tiles, a register bit container and a pair table
// (two symbols a lookup).  The TPU kernel's NH-way halfword selects and
// TB-way lane gathers are not needed.
#include <algorithm>

#include "ct_tiles.cuh"

namespace {

constexpr int HD_THREADS = 256;  // chunks a CTA, one a thread
constexpr int HD_MAX_WORDS = 16;  // windows of up to 64 bytes
constexpr int HD_MAX_TAB = 2048;  // peeks of up to 11 bits
constexpr int HD_ROWS = 8;        // most table rows staged a CTA

// The table rows a CTA stages: 1 for a shared table (per_row = 0) or
// where tiles never cross a row, else the most rows a tile of 256 spans,
// up to HD_ROWS.
inline int stage_slots(int per_row, int nc) {
  if (!per_row || per_row % HD_THREADS == 0) return 1;
  const int rows = (nc + per_row - 1) / per_row;
  const int span = HD_THREADS % per_row == 0 ? HD_THREADS / per_row
                                             : HD_THREADS / per_row + 2;
  return std::min(HD_ROWS, std::min(span, rows));
}

// dynamic shared memory: the tile's windows, then `slots` int32 tables
constexpr size_t hd_smem(int ww, int mb, int slots) {
  return 4 * ((size_t)HD_THREADS * ww + (size_t)slots * ((size_t)1 << mb));
}

struct Cursor {
  const uint32_t* w;    // the chunk's window in shared memory
  const int32_t* tab;   // its table row, shared or device memory
  int ww, mb, lbp;
  uint32_t mask;

  // one step: the mb bits below the cursor (0 below bit 0 and above the
  // window), their entry's symbol; the cursor moves down by its nb
  __device__ __forceinline__ uint32_t step() {
    const int bp = (int)((unsigned)lbp - (unsigned)mb);
    const int bpc = max(bp, 0);
    const int wi = bpc >> 5;
    const uint64_t lo = wi < ww ? w[wi] : 0u;
    const uint64_t hi = wi + 1 < ww ? w[wi + 1] : 0u;
    const uint32_t v = (uint32_t)((lo | (hi << 32)) >> (bpc & 31));
    const int zs = (int)((unsigned)bpc - (unsigned)bp);
    const uint32_t peek =
        (unsigned)zs >= 32u ? 0u : ((v << zs) & mask);
    const int e = tab[peek];
    lbp = (int)((unsigned)lbp - (unsigned)(e >> 8));
    return (uint32_t)e & 255u;
  }
};

__global__ void __launch_bounds__(HD_THREADS, 8)
    huff0_decode_kernel(const uint8_t* __restrict__ windows,
                        const int32_t* __restrict__ lbit,
                        const int32_t* __restrict__ nsym,
                        const int32_t* __restrict__ tabs, int per_row,
                        int slots, int nc, int win, int k, int mb,
                        uint8_t* __restrict__ syms,
                        int32_t* __restrict__ endl) {
  extern __shared__ __align__(16) uint32_t hd_dyn[];
  const int ww = win >> 2;
  const int size = 1 << mb;
  uint32_t* win_s = hd_dyn;
  int32_t* tab_s = reinterpret_cast<int32_t*>(hd_dyn + HD_THREADS * ww);
  const int c0 = blockIdx.x * HD_THREADS;
  const int n = min(HD_THREADS, nc - c0);
  const int r0 = per_row ? c0 / per_row : 0;
  const int nr = per_row ? min(slots, (c0 + n - 1) / per_row - r0 + 1) : 1;
  ct::copy_words(win_s, windows + (size_t)c0 * win, n * ww);
  ct::copy_words(reinterpret_cast<uint32_t*>(tab_s),
                 tabs + (size_t)r0 * size, nr * size);
  ct::cp_async_commit();
  const int tid = threadIdx.x;
  const int c = c0 + tid;
  const bool live = tid < n;
  const int lb = live ? lbit[c] : 0;
  const int ns = live ? nsym[c] : 0;
  ct::cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  const int slot = (per_row ? c / per_row : 0) - r0;
  Cursor cur;
  cur.w = win_s + tid * ww;
  cur.tab = slot < nr ? tab_s + slot * size
                      : tabs + (size_t)(r0 + slot) * size;
  cur.ww = ww;
  cur.mb = mb;
  cur.lbp = lb;
  cur.mask = (uint32_t)size - 1u;
  uint8_t* out = syms + (size_t)c * k;
  if (k % 16 == 0) {
    for (int i0 = 0; i0 < k; i0 += 16) {
      uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (i0 + j < ns) word[j >> 2] |= cur.step() << (8 * (j & 3));
      __stcs(reinterpret_cast<uint4*>(out + i0),
             make_uint4(word[0], word[1], word[2], word[3]));
    }
  } else {
    for (int i = 0; i < k; ++i) out[i] = i < ns ? (uint8_t)cur.step() : 0;
  }
  endl[c] = cur.lbp;
}

}  // namespace

extern "C" {

// windows: (nc, win) u8, win a multiple of 4 and <= 64, 16-byte aligned;
// lbit, nsym: (nc,) i32; tabs: (rows, 1 << mb) i32, rows = 1 when per_row
// is 0 else ceil(nc / per_row); syms: (nc, k) u8, 16-byte aligned;
// endl: (nc,) i32.  1 <= mb <= 11, k >= 1.
int ct_huff0_decode(const uint8_t* windows, const int32_t* lbit,
                    const int32_t* nsym, const int32_t* tabs, int per_row,
                    int nc, int win, int k, int mb, uint8_t* syms,
                    int32_t* endl, cudaStream_t stream) {
  if (nc <= 0) return 0;
  if (win <= 0 || win % 4 || win > 4 * HD_MAX_WORDS || k <= 0 || mb < 1 ||
      (1 << mb) > HD_MAX_TAB || per_row < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = ct::allow_smem<huff0_decode_kernel>(
      (int)hd_smem(HD_MAX_WORDS, 11, HD_ROWS));
  if (e != cudaSuccess) return (int)e;
  const int slots = stage_slots(per_row, nc);
  huff0_decode_kernel<<<(nc + HD_THREADS - 1) / HD_THREADS, HD_THREADS,
                        hd_smem(win / 4, mb, slots), stream>>>(
      windows, lbit, nsym, tabs, per_row, slots, nc, win, k, mb, syms, endl);
  return (int)cudaGetLastError();
}

// CTAs per SM at the main paths' shapes (52-byte windows): one 8-bit
// table (per_row = 0) or 11-bit tables of per_row chunks each
int ct_huff0_occupancy(int per_row) {
  int n = 0;
  cudaError_t e = ct::allow_smem<huff0_decode_kernel>(
      (int)hd_smem(HD_MAX_WORDS, 11, HD_ROWS));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, huff0_decode_kernel, HD_THREADS,
        hd_smem(13, per_row ? 11 : 8, stage_slots(per_row, 1 << 20)));
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
