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
// steps: up to 2,730 for a 16 KiB block (1,300 at most on the v1 engine's
// corpus).  The bytes (the codes read, two int32 outputs written a
// sequence and stream, nine tenths of them the zeros before each row's
// live run) take about a hundredth of a millisecond at the memory rate
// for a launch of 512 blocks.
//
// Design: the walk carries y = s + size and its step is cut to a shift,
// an add and one shared-memory load where the tables allow it.  For
// symbol x let k = clip((size + dnb[x]) >> 16, 0, 16).  The next y depends
// on y only through (y >> c), and where c takes one value on [size, 2
// size) or steps from k to k + 1 at a multiple of 2^k (every well-formed
// table), it is a function of u = y >> k; so a compact table T[base_x + u
// - (size >> k)] holds it, at most 2 size + 64 u16 entries a stream.  A
// walk CTA takes ZF_BPC blocks of one job and builds the job's three
// compact tables once, with fseenc.cu's exact check made per symbol: the
// step's index is one value on each of the symbol's groups (checked at
// the group's ends and on both sides of the one y where (y + dnb) >> 16
// changes), the states it gives lie in [size, 2 size), and its entries
// fit.  Each block has two warps, paired by a named barrier a chunk of
// ZF_CH sequences, from the block's longest live run down.  The walker
// warp's lanes 0-2 walk the block's ll, of and ml rows through chunk i
// and record each step's y; a lane takes the one-load step through a
// chunk whose symbols all passed the check and whose first y lies in
// [size, 2 size), else the exact step (the reference's arithmetic) in
// the same kernel, with the code and its table word a few steps ahead,
// off the state's chain.  Meanwhile the writer warp loads chunk i + 1's
// codes (coalesced), turns chunk i - 1's recorded y into (val, nb) with
// the exact arithmetic and stores them coalesced in write order, then
// stages chunk i + 1's codes in shared memory and marks the rows whose
// chunk walks a symbol that failed the check: nothing but the barrier
// sits between two chunks of a walk.  The zeros before each row's live
// run (entries 0 .. MS - 1 - (n - 1)) are written by CTAs of their own,
// after the walk CTAs in the grid, with 16-byte streaming stores.
//
// Built with -DCT_ZDEVFSE_CLOCK (compress_tpu_torch/tools/zdevfse_clock.py)
// the library also exports ct_zdev_fse_clock, whose `clk` output receives
// each row's walker cycles (clock64 around its walks), steps walked, route
// (1 one-load, 0 exact, -1 none), and its CTA's cycles from the start to
// the tables built and to the row's end; with -DCT_ZDEVFSE_EXACT every
// chunk takes the exact step.  The library's build defines neither.
#include "ct_common.cuh"

namespace {

constexpr int ZF_BPC = 8;        // blocks a walk CTA
constexpr int ZF_WARPS = 2 * ZF_BPC;  // a walker and a writer warp a block
constexpr int ZF_CH = 64;        // sequences a chunk
constexpr int ZF_PITCH = ZF_CH + 1;  // rows on distinct banks
constexpr int ZF_H = ZF_CH / 32;     // a row's staging loads a lane
constexpr int ZF_THREADS = ZF_WARPS * 32;
constexpr int ZF_SZ = 512;    // padded state table (1 << max log)
constexpr int ZF_NSYM = 64;   // padded symbol alphabet
constexpr int ZF_TCAP = 2 * ZF_SZ + ZF_NSYM;  // compact entries a stream
constexpr int ZF_ZROWS = 2;   // rows a zero-fill warp takes
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(ZF_CH % 32 == 0, "whole warps of codes");

struct Smem {
  int st[3][ZF_SZ];
  int dnb[3][ZF_NSYM + 1];  // entry 64: a code outside [0, 64) reads 0
  int dfs[3][ZF_NSYM + 1];
  int kb[3][ZF_NSYM + 1];   // (T index base) * 32 + k; entry 64 unused
  int base[3][ZF_NSYM];
  int total[3];
  unsigned bad[3][2];       // symbols that failed the check
  unsigned long long okm[3];
  uint16_t T[3 * ZF_TCAP];
  // a block's two chunk buffers: codes (0 .. 64), y before each step, and
  // the rows whose chunk walks a symbol that failed the check
  int sym[ZF_BPC][2][3][ZF_PITCH];
  int rec[ZF_BPC][2][3][ZF_PITCH];
  unsigned cbad[ZF_BPC][2];
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// lo <= hi: two min/max instructions
__device__ __forceinline__ int clip(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// the exact step's state-table index at y
__device__ __forceinline__ int step_index(int y, int d, int f) {
  const int c = clip(wadd(y, d) >> 16, 0, 16);
  return clip(wadd(y >> c, f), 0, ZF_SZ - 1);
}

// Shared-memory accesses of the one-load walk at 32-bit shared-window
// addresses, in program order (volatile): the step's table load issues
// first, and the record and look-ahead loads queue behind it.
__device__ __forceinline__ int lds_u16(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return (int)v;
}
__device__ __forceinline__ int lds_s32(unsigned a) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts_s32(unsigned a, int x) {
  asm volatile("st.shared.s32 [%0], %1;" ::"r"(a), "r"(x) : "memory");
}

// The one-load pass over chunk entries c = hi .. 0 of a row (codes sym[c],
// records rec[c]): y = T[(kb >> 5) + (y >> (kb & 31))].  A code comes
// three steps ahead and its table word two.
__device__ __forceinline__ void walk_fast(const int* kb, const uint16_t* T,
                                          const int* sym, int* rec, int hi,
                                          int& y) {
  const unsigned tb = (unsigned)__cvta_generic_to_shared(T);
  const unsigned kbs = (unsigned)__cvta_generic_to_shared(kb);
  const unsigned ss = (unsigned)__cvta_generic_to_shared(sym);
  const unsigned rs = (unsigned)__cvta_generic_to_shared(rec);
  const auto word = [&](int x) { return lds_s32(kbs + 4u * x); };
  int w = word(lds_s32(ss + 4u * hi)), v = 0, x = 0;
  if (hi >= 1) v = word(lds_s32(ss + 4u * (hi - 1)));
  if (hi >= 2) x = lds_s32(ss + 4u * (hi - 2));
  for (int c = hi; c >= 0; --c) {
    const unsigned p = tb + 2u * (unsigned)(w >> 5);
    const int k = w & 31;
    const int o = y;
    y = lds_u16(p + (((unsigned)o >> k) << 1));
    sts_s32(rs + 4u * c, o);
    w = v;
    if (c >= 2) v = word(x);
    if (c >= 3) x = lds_s32(ss + 4u * (c - 3));
  }
}

// The exact pass (the reference's arithmetic), a code's words one step
// ahead.
__device__ __forceinline__ void walk_exact(const int* t_st, const int* t_dnb,
                                           const int* t_dfs, const int* sym,
                                           int* rec, int hi, int& y) {
  int d = t_dnb[sym[hi]], f = t_dfs[sym[hi]];
  for (int c = hi; c >= 0; --c) {
    const int o = y;
    y = t_st[step_index(o, d, f)];
    rec[c] = o;
    if (c >= 1) {
      const int x = sym[c - 1];
      d = t_dnb[x];
      f = t_dfs[x];
    }
  }
}

// The job's three compact tables, built and checked by the whole CTA; on
// return s.okm[k] has bit x set iff symbol x of stream k may take the
// one-load step.  A stream with no table (RLE, or size past 512) has none.
__device__ void build_tables(Smem& s, const int* sizes, const bool* table) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int k = w; k < 3; k += ZF_WARPS) {
    // symbols lane and lane + 32: the exclusive prefix sum of the group
    // counts gives each symbol's base in T
    const int size = sizes[k];
    int carry = 0;
    unsigned fits[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = lane + 32 * h;
      const int kk = clip(wadd(size, s.dnb[k][x]) >> 16, 0, 16);
      const int cnt = ((2 * size - 1) >> kk) - (size >> kk) + 1;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      const int b = carry + incl - cnt;
      s.base[k][x] = b;
      s.kb[k][x] = (k * ZF_TCAP + b - (size >> kk)) * 32 + kk;
      fits[h] = __ballot_sync(FULL, table[k] && b + cnt <= ZF_TCAP);
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) {
      s.okm[k] = fits[0] | (unsigned long long)fits[1] << 32;
      s.total[k] = table[k] ? min(carry, ZF_TCAP) : 0;
      s.kb[k][ZF_NSYM] = 0;
    }
  }
  __syncthreads();
  for (int e = tid; e < 3 * ZF_TCAP; e += ZF_THREADS) {
    const int k = e / ZF_TCAP, j = e - k * ZF_TCAP;
    if (j >= s.total[k]) continue;
    const int size = sizes[k];
    int x = 0;  // the last symbol whose base is <= j
#pragma unroll
    for (int step = 32; step; step >>= 1)
      if (s.base[k][x + step] <= j) x += step;
    const int d = s.dnb[k][x], f = s.dfs[k][x];
    const int kk = clip(wadd(size, d) >> 16, 0, 16);
    const int u = (size >> kk) + j - s.base[k][x];
    const int lo = max(size, u << kk);
    const int hi = min(2 * size - 1, (int)(((long long)(u + 1) << kk) - 1));
    // the one y past size where (y + d) >> 16 changes, if any
    const long long m = ((((long long)size + d) >> 16) + 1) * 65536 - d;
    const int i = step_index(lo, d, f);
    bool good = step_index(hi, d, f) == i;
    if (m > lo && m <= hi)
      good = good && step_index((int)m - 1, d, f) == i &&
             step_index((int)m, d, f) == i;
    const int v = s.st[k][i];
    good = good && v >= size && v < 2 * size;
    s.T[e] = (uint16_t)v;
    if (!good) atomicOr(&s.bad[k][x >> 5], 1u << (x & 31));
  }
  __syncthreads();
  if (tid < 3) {
    const unsigned long long bad =
        (unsigned long long)s.bad[tid][0] |
        (unsigned long long)s.bad[tid][1] << 32;
    s.okm[tid] &= ~bad;
  }
  __syncthreads();
}

// Zeros at p[0 .. n): 16-byte streaming stores on the aligned body.
__device__ __forceinline__ void zero_span(int* p, int n, int lane) {
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(p) & 15))
                                & 15) >> 2);
  if (lane < head) p[lane] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  const int body = (n - head) >> 2;
  for (int i = lane; i < body; i += 32) __stcs(q + i, make_uint4(0, 0, 0, 0));
  const int t0 = head + 4 * body;
  if (t0 + lane < n) p[t0 + lane] = 0;
}

__device__ __forceinline__ int live_run(int n, int MS, bool rle) {
  return rle || n < 1 ? 0 : (n <= MS ? n - 1 : MS);
}

// routes: null or (2,) int32 (rows wholly on the one-load step, rows with
// a chunk on the exact step); clk: null, or with CT_ZDEVFSE_CLOCK (R, 3, 5)
// int64.
__global__ void __launch_bounds__(ZF_THREADS)
zdev_fse_kernel(const int* __restrict__ syms, const int* __restrict__ n_seqs,
                const int* __restrict__ st, const int* __restrict__ dnb,
                const int* __restrict__ dfs, const int* __restrict__ logs,
                const uint8_t* __restrict__ rle, int bpj, int nj, int MS,
                int n_walk, int* __restrict__ val, int* __restrict__ nbo,
                int* __restrict__ fin, int* __restrict__ routes,
                long long* __restrict__ clk) {
  __shared__ Smem s;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int R = bpj * nj;
  if ((int)blockIdx.x >= n_walk) {  // a zero-fill CTA
    const long long rows = 3LL * R;
    const long long stride = (long long)(gridDim.x - n_walk) * ZF_WARPS;
    for (long long row = (long long)(blockIdx.x - n_walk) * ZF_WARPS + w;
         row < rows; row += stride) {
      const int r = (int)(row / 3), k = (int)(row % 3);
      const int j = r / bpj;
      const int nz = MS - live_run(n_seqs[r], MS, rle[j * 3 + k] != 0);
      zero_span(val + row * MS, nz, lane);
      zero_span(nbo + row * MS, nz, lane);
    }
    return;
  }
#ifdef CT_ZDEVFSE_CLOCK
  const long long t_start = clock64();
#endif
  const int cpj = (bpj + ZF_BPC - 1) / ZF_BPC;
  const int j = blockIdx.x / cpj;
  const int b0 = (blockIdx.x % cpj) * ZF_BPC;  // CTA's first block of job j
  int sizes[3];
  bool table[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const bool r1 = rle[j * 3 + k] != 0;
    const int lg = logs[j * 3 + k];
    sizes[k] = r1 ? 1 : (int)(1u << (lg & 31));
    table[k] = !r1 && lg >= 0 && lg <= 9;
  }
  for (int i = tid; i < 3 * ZF_SZ; i += ZF_THREADS)
    (&s.st[0][0])[i] = st[(long long)j * 3 * ZF_SZ + i];
  for (int i = tid; i < 3 * (ZF_NSYM + 1); i += ZF_THREADS) {
    const int k = i / (ZF_NSYM + 1), x = i - k * (ZF_NSYM + 1);
    const long long g = ((long long)j * 3 + k) * ZF_NSYM + x;
    s.dnb[k][x] = x < ZF_NSYM ? dnb[g] : 0;
    s.dfs[k][x] = x < ZF_NSYM ? dfs[g] : 0;
  }
  if (tid < 6) s.bad[tid / 2][tid % 2] = 0;
  __syncthreads();
  build_tables(s, sizes, table);
#ifdef CT_ZDEVFSE_CLOCK
  const long long t_built = clock64();
#endif

  // block b of the CTA: warp b walks it, warp ZF_BPC + b writes its items;
  // lanes 0-2 of each hold its rows (ll, of, ml)
  const bool writer = w >= ZF_BPC;
  const int b = writer ? w - ZF_BPC : w;
  const int blk = b0 + b;  // block within job j
  const long long gr0 = ((long long)j * bpj + blk) * 3;  // global row
  const bool mine = lane < 3 && blk < bpj;
  const int k = lane < 3 ? lane : 0;
  const int size = k == 0 ? sizes[0] : (k == 1 ? sizes[1] : sizes[2]);
  int live = 0, y = size;
  if (mine) {
    const int n = n_seqs[(int)(gr0 / 3)];
    const bool r1 = rle[j * 3 + k] != 0;
    live = live_run(n, MS, r1);
    if (!writer && !r1 && n >= 1 && n <= MS) {
      const int x0 = __ldg(syms + (gr0 + lane) * MS + n - 1);
      const int x = (unsigned)x0 < ZF_NSYM ? x0 : ZF_NSYM;
      const int d = s.dnb[k][x];
      const int nb = wadd(d, 1 << 15) >> 16;
      const int im = (int)(((unsigned)nb << 16) - (unsigned)d);
      y = s.st[k][clip(wadd(im >> clip(nb, 0, 16), s.dfs[k][x]), 0,
                       ZF_SZ - 1)];
    }
  }
  const int top = __reduce_max_sync(FULL, live);
  const int nch = (top + ZF_CH - 1) / ZF_CH;  // chunk i: hi = top - 1 - i CH
  const unsigned bar_id = 1 + b;               // the pair's named barrier
  const auto pair_sync = [&]() {
    // not .aligned: the walker warp's lanes 0-2 arrive after the rest
    asm volatile("barrier.sync %0, %1;" ::"r"(bar_id), "r"(64) : "memory");
  };
  int (*bsym)[3][ZF_PITCH] = s.sym[b];
  int (*brec)[3][ZF_PITCH] = s.rec[b];

  if (writer) {
    const unsigned long long okm[3] = {s.okm[0], s.okm[1], s.okm[2]};
    int lv[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) lv[r] = __shfl_sync(FULL, live, r);
    // chunk i's codes: load q is row q / ZF_H, entry (q % ZF_H) * 32 + lane
    int nxt[3 * ZF_H];
    const auto load = [&](int i) {
      const int hi = top - 1 - i * ZF_CH, lo = max(hi - ZF_CH + 1, 0);
#pragma unroll
      for (int q = 0; q < 3 * ZF_H; ++q) {
        const int r = q / ZF_H, at = lo + (q % ZF_H) * 32 + lane;
        nxt[q] = at <= hi ? __ldg(syms + (gr0 + r) * MS + at) : 0;
      }
    };
    const auto stage = [&](int i) {
      const int hi = top - 1 - i * ZF_CH, lo = max(hi - ZF_CH + 1, 0);
      unsigned bad = 0;
#pragma unroll
      for (int q = 0; q < 3 * ZF_H; ++q) {
        const int r = q / ZF_H, c = (q % ZF_H) * 32 + lane;
        const int x0 = nxt[q];
        const int x = (unsigned)x0 < ZF_NSYM ? x0 : ZF_NSYM;
        bsym[i & 1][r][c] = x;
        const bool fail = lo + c <= hi && lo + c < lv[r] &&
                          (x == ZF_NSYM || !((okm[r] >> x) & 1));
        if (__ballot_sync(FULL, fail)) bad |= 1u << r;
      }
      if (lane == 0) s.cbad[b][i & 1] = bad;
    };
    // chunk i's items: sequence lo + c lands at entry MS - 1 - lo - c,
    // consecutive lanes on consecutive entries
    const auto convert = [&](int i) {
      const int hi = top - 1 - i * ZF_CH, lo = max(hi - ZF_CH + 1, 0);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int n_c = min(hi, lv[r] - 1) - lo + 1;
        int* ov = val + (gr0 + r) * MS + MS - 1 - lo;
        int* on = nbo + (gr0 + r) * MS + MS - 1 - lo;
        for (int c = lane; c < n_c; c += 32) {
          const int o = brec[i & 1][r][c];
          const int nb = wadd(o, s.dnb[r][bsym[i & 1][r][c]]) >> 16;
          const int cc = clip(nb, 0, 16);
          ov[-c] = (int)((unsigned)o & ((1u << cc) - 1u));
          on[-c] = nb;
        }
      }
    };
    if (nch > 0) {
      load(0);
      stage(0);
      pair_sync();
    }
    for (int i = 0; i < nch; ++i) {
      if (i + 1 < nch) load(i + 1);
      if (i > 0) convert(i - 1);
      __syncwarp();  // chunk i - 1's buffer is read: stage over it
      if (i + 1 < nch) stage(i + 1);
      pair_sync();
    }
    if (nch > 0) convert(nch - 1);
    return;
  }

  bool all_fast = true;
#ifdef CT_ZDEVFSE_CLOCK
  long long cycles = 0;
#endif
  if (nch > 0) pair_sync();  // chunk 0 is staged
  for (int i = 0; i < nch; ++i) {
    const int hi = top - 1 - i * ZF_CH, lo = max(hi - ZF_CH + 1, 0);
    if (mine && live > lo) {
      const int rhi = min(hi, live - 1) - lo;
      bool bad = (s.cbad[b][i & 1] >> lane) & 1;
#ifdef CT_ZDEVFSE_EXACT
      bad = true;
#endif
      const bool fast = !bad && (unsigned)wadd(y, -size) < (unsigned)size;
      all_fast = all_fast && fast;
#ifdef CT_ZDEVFSE_CLOCK
      const long long t0 = clock64();
#endif
      if (fast)
        walk_fast(s.kb[k], s.T, bsym[i & 1][lane], brec[i & 1][lane], rhi,
                  y);
      else
        walk_exact(s.st[k], s.dnb[k], s.dfs[k], bsym[i & 1][lane],
                   brec[i & 1][lane], rhi, y);
#ifdef CT_ZDEVFSE_CLOCK
      // the clock is read once the last step's load has landed
      long long t1;
      asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1) : "r"(y) : "memory");
      cycles += t1 - t0;
#endif
    }
    pair_sync();  // chunk i is recorded, chunk i + 1 staged
  }
  if (mine) {
    const long long row = gr0 + lane;
    fin[row] = wadd(y, -size);
    if (routes != nullptr && live > 0)
      atomicAdd(routes + (all_fast ? 0 : 1), 1);
#ifdef CT_ZDEVFSE_CLOCK
    if (clk != nullptr) {
      long long* c = clk + 5 * row;
      c[0] = cycles;
      c[1] = live;
      c[2] = live > 0 ? (all_fast ? 1 : 0) : -1;
      c[3] = t_built - t_start;
      c[4] = clock64() - t_start;
    }
#endif
  }
}

int launch(const int* syms, const int* n_seqs, const int* st, const int* dnb,
           const int* dfs, const int* logs, const uint8_t* rle, int R, int MS,
           int nj, int* val, int* nb, int* fin, int* routes, long long* clk,
           cudaStream_t stream) {
  if (R <= 0) return 0;
  if (MS <= 0 || nj <= 0 || R % nj) return (int)cudaErrorInvalidValue;
  const int bpj = R / nj;
  const long long n_walk = (long long)nj * ((bpj + ZF_BPC - 1) / ZF_BPC);
  const long long n_zero =
      (3LL * R + ZF_WARPS * ZF_ZROWS - 1) / (ZF_WARPS * ZF_ZROWS);
  if (n_walk + n_zero > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  zdev_fse_kernel<<<(unsigned)(n_walk + n_zero), ZF_THREADS, 0, stream>>>(
      syms, n_seqs, st, dnb, dfs, logs, rle, bpj, nj, MS, (int)n_walk, val,
      nb, fin, routes, clk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// syms (R, 3, MS) int32; n_seqs (R,) int32; st (nj, 3, 512), dnb and dfs
// (nj, 3, 64), logs (nj, 3) int32 (0..9); rle (nj, 3) bytes (torch.bool);
// R a multiple of nj; val and nb (R, 3, MS) and fin (R, 3) int32, all
// contiguous, written in full; routes null or (2,) int32 (the rows walked
// wholly on the one-load step and those with a chunk on the exact step
// are added to it).
int ct_zdev_fse(const int* syms, const int* n_seqs, const int* st,
                const int* dnb, const int* dfs, const int* logs,
                const uint8_t* rle, int R, int MS, int nj, int* val, int* nb,
                int* fin, int* routes, cudaStream_t stream) {
  return launch(syms, n_seqs, st, dnb, dfs, logs, rle, R, MS, nj, val, nb,
                fin, routes, nullptr, stream);
}

#ifdef CT_ZDEVFSE_CLOCK
// ct_zdev_fse, and clk (R, 3, 5) int64 receives each row's walker cycles,
// steps walked, route, and its CTA's cycles to the tables built and to the
// row's end.
int ct_zdev_fse_clock(const int* syms, const int* n_seqs, const int* st,
                      const int* dnb, const int* dfs, const int* logs,
                      const uint8_t* rle, int R, int MS, int nj, int* val,
                      int* nb, int* fin, int* routes, long long* clk,
                      cudaStream_t stream) {
  return launch(syms, n_seqs, st, dnb, dfs, logs, rle, R, MS, nj, val, nb,
                fin, routes, clk, stream);
}
#endif

// The kernel's launch: out[0] CTAs resident on one SM, out[1] registers a
// thread, out[2] static shared memory a CTA in bytes, out[3] sequences a
// chunk, out[4] blocks a walk CTA.
int ct_zdev_fse_info(int* out) {
  cudaFuncAttributes a{};
  int n = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, zdev_fse_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, zdev_fse_kernel,
                                                      ZF_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = n;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = ZF_CH;
  out[4] = ZF_BPC;
  return 0;
}

}  // extern "C"
