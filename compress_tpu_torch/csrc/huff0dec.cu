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
// Design: a thread per chunk.  The CTA copies its 256 windows to shared
// memory with coalesced 4-byte loads (the window stride is 13 words, odd,
// so the per-thread reads spread over the banks), and its table (once per
// CTA; for the per-row variant when all its chunks share a row, else the
// table is read through L1).  A peek is one 64-bit funnel of two window
// words; 16 symbols are packed into a 16-byte store.  The TPU kernel's
// NH-way halfword selects and TB-way lane gathers are not needed.
#include "ct_common.cuh"

namespace {

constexpr int HD_THREADS = 256;
constexpr int HD_MAX_WORDS = 16;  // windows of up to 64 bytes
constexpr int HD_MAX_TAB = 2048;  // peeks of up to 11 bits

struct Cursor {
  const uint32_t* w;
  const int32_t* tab;
  int ww, mb, lbp;
  uint32_t mask;

  __device__ __forceinline__ uint32_t step() {
    const int bp = lbp - mb;
    const int bpc = max(bp, 0);
    const int wi = bpc >> 5;
    const uint64_t lo = wi < ww ? w[wi] : 0u;
    const uint64_t hi = wi + 1 < ww ? w[wi + 1] : 0u;
    const uint32_t v = (uint32_t)((lo | (hi << 32)) >> (bpc & 31));
    const int zs = bpc - bp;
    const uint32_t peek = zs >= 32 ? 0u : ((v << zs) & mask);
    const uint32_t e = (uint32_t)tab[peek];
    lbp -= (int)(e >> 8);
    return e & 255u;
  }
};

__global__ void __launch_bounds__(HD_THREADS)
    huff0_decode_kernel(const uint32_t* __restrict__ windows,
                        const int32_t* __restrict__ lbit,
                        const int32_t* __restrict__ nsym,
                        const int32_t* __restrict__ tabs, int per_row, int nc,
                        int ww, int k, int mb, uint8_t* __restrict__ syms,
                        int32_t* __restrict__ endl) {
  __shared__ uint32_t win_s[HD_THREADS * HD_MAX_WORDS];
  __shared__ int32_t tab_s[HD_MAX_TAB];
  const int c0 = blockIdx.x * HD_THREADS;
  const int n = min(HD_THREADS, nc - c0);
  const uint32_t* wsrc = windows + (size_t)c0 * ww;
  for (int i = threadIdx.x; i < n * ww; i += HD_THREADS) win_s[i] = wsrc[i];
  const int tsize = 1 << mb;
  const int row0 = per_row ? c0 / per_row : 0;
  const bool one_row = !per_row || (c0 + n - 1) / per_row == row0;
  if (one_row) {
    const int32_t* t = tabs + (size_t)row0 * tsize;
    for (int i = threadIdx.x; i < tsize; i += HD_THREADS) tab_s[i] = t[i];
  }
  __syncthreads();
  if ((int)threadIdx.x >= n) return;
  const int c = c0 + threadIdx.x;
  Cursor cur;
  cur.w = win_s + threadIdx.x * ww;
  cur.tab = one_row ? tab_s : tabs + (size_t)(c / per_row) * tsize;
  cur.ww = ww;
  cur.mb = mb;
  cur.lbp = lbit[c];
  cur.mask = (1u << mb) - 1u;
  const int ns = nsym[c];
  uint8_t* out = syms + (size_t)c * k;
  if (k % 16 == 0) {
    for (int i0 = 0; i0 < k; i0 += 16) {
      uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (i0 + j < ns) word[j >> 2] |= cur.step() << (8 * (j & 3));
      *reinterpret_cast<uint4*>(out + i0) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
  } else {
    for (int i = 0; i < k; ++i) out[i] = i < ns ? (uint8_t)cur.step() : 0;
  }
  endl[c] = cur.lbp;
}

}  // namespace

extern "C" {

// windows: (nc, win) u8, win a multiple of 4 and <= 64, 4-byte aligned;
// lbit, nsym: (nc,) i32; tabs: (rows, 1 << mb) i32, rows = 1 when per_row
// is 0 else ceil(nc / per_row); syms: (nc, k) u8, 16-byte aligned;
// endl: (nc,) i32.  1 <= mb <= 11.
int ct_huff0_decode(const uint8_t* windows, const int32_t* lbit,
                    const int32_t* nsym, const int32_t* tabs, int per_row,
                    int nc, int win, int k, int mb, uint8_t* syms,
                    int32_t* endl, cudaStream_t stream) {
  if (nc <= 0) return 0;
  if (win <= 0 || win % 4 || win > 4 * HD_MAX_WORDS || k <= 0 || mb < 1 ||
      (1 << mb) > HD_MAX_TAB || per_row < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (nc + HD_THREADS - 1) / HD_THREADS;
  huff0_decode_kernel<<<grid, HD_THREADS, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(windows), lbit, nsym, tabs, per_row,
      nc, win / 4, k, mb, syms, endl);
  return (int)cudaGetLastError();
}

}  // extern "C"
