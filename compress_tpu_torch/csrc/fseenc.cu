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
// (two independent state chains): 8,191 steps for a 16 KiB row.  The bytes
// (the rows, the tables, 8 bytes an item out) would take a few
// hundredths of a millisecond at the memory rate.
//
// Design: the step's dependent work is cut to a shift, an add and one
// shared-memory load.  For symbol x let k = c at s = size.  The next state
// depends on s only through (s >> c), and where c takes one value on
// [size, 2 size) or steps from k to k + 1 at a multiple of 2^k (every
// well-formed table: dnb = (maxbits << 16) - (norm << maxbits)), (s >> c)
// is a function of u = s >> k.  So a compact table per row, T[base_x + u -
// (size >> k)] = the next state from group u, holds every step: at most
// 2 size + 256 entries for a well-formed table (2.5 KiB of u16 at log 9).
// The row's warp builds it from st, dnb and dfs and checks it exactly:
// every st entry lies in [size, 2 size) (so every state does), and the
// step's table index is one value on each group u of every symbol.  c
// changes at most once on [size, 2 size) (s + dnb crosses one multiple of
// 2^16, the int32 wrap included), and on a stretch of one c the index is
// monotone but for a wrap of (s >> c) + dfs that the ends already show, so
// the index at the group's ends and on both sides of that change decides
// it.  A row that fails the check, or whose table would pass its room,
// walks the exact step instead, in the same kernel.
//
// Two lanes walk, the warp writes.  A CTA of FSEE_THREADS threads takes
// FSEE_ROWS rows, one warp a row; all its threads copy the rows' tables
// and then the rows' bytes in chunks of FSEE_CHUNK into shared memory,
// last chunk first (16-byte copies where the rows allow; the next chunk's
// loads are issued before the walk and land in registers meanwhile).
// Lanes 0 and 1 of the row's warp each run one of the two state
// recurrences (one instruction stream for both: a shared-memory load, a
// table-word load, a symbol load and a record store a step) and record
// the states of each step in shared memory; a symbol comes three steps
// ahead and its table word two.  Then the warp's 32 lanes turn the
// recorded states into items (value and width from the state and the
// symbol alone, with the exact arithmetic) and store them coalesced.
// Pairs start at even positions and chunks at multiples of FSEE_CHUNK, so
// no step straddles two chunks.
//
// Built with -DCT_FSE_CLOCK (compress_tpu_torch/tools/fse_step_clock.py),
// the kernel writes each row's walker cycles (clock64 around its walks)
// and route into `routes` read as (N, 2) int64, and with -DCT_FSE_EXACT
// every row takes the exact step; the library's build defines neither.
#include "ct_common.cuh"

namespace {

constexpr int FSEE_THREADS = 128;
constexpr int FSEE_ROWS = 4;
constexpr int FSEE_CHUNK = 2048;          // bytes of a row staged at a time
constexpr int FSEE_PAIRS = FSEE_CHUNK / 2;
// 16-byte words of a full chunk of every row, a thread's share
constexpr int FSEE_Q = FSEE_ROWS * FSEE_CHUNK / 16 / FSEE_THREADS;
constexpr unsigned FULL = 0xFFFFFFFFu;
static_assert(FSEE_ROWS * 32 == FSEE_THREADS, "one warp a row");
static_assert(FSEE_Q * 16 * FSEE_THREADS == FSEE_ROWS * FSEE_CHUNK, "");

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

// the exact step's state-table index at state s
__device__ __forceinline__ int step_index(int s, int d, int f, int size) {
  const int c = clip(wadd(s, d) >> 16, 0, 16);
  return clip(wadd(s >> c, f), 0, size - 1);
}

// Tables of a row for the one-load step, built and checked by the row's
// warp: kb[x] = (base_x - (size >> k)) * 32 + k and T (tcap entries).
// cnt: 256 ints of scratch.  True (in every lane) iff the row may take it.
__device__ bool build_compact(const int* t_st, const int* t_dnb,
                              const int* t_dfs, int size, int tcap,
                              int* kb, uint16_t* T, int* cnt) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int i = lane; i < size; i += 32) {
    const int v = t_st[i];
    ok = ok && v >= size && v < 2 * size;
  }
  for (int x = lane; x < 256; x += 32) {
    const int k = clip(wadd(size, t_dnb[x]) >> 16, 0, 16);
    cnt[x] = ((2 * size - 1) >> k) - (size >> k) + 1;
  }
  __syncwarp();
  // exclusive prefix sum of the group counts: lane i sums symbols 8i..8i+7
  int e[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    e[j] = cnt[8 * lane + j];
    sum += e[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  int run = incl - sum;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[8 * lane + j] = run;
    run += e[j];
  }
  __syncwarp();
  if (total > tcap) return false;
  for (int x = lane; x < 256; x += 32) {
    const int k = clip(wadd(size, t_dnb[x]) >> 16, 0, 16);
    kb[x] = (cnt[x] - (size >> k)) * 32 + k;
  }
  // entries spread over the lanes (one byte of a row may own 512 of
  // them): entry j belongs to the last byte whose base is <= j
  for (int j = lane; j < total; j += 32) {
    int x = 0;
#pragma unroll
    for (int step = 128; step; step >>= 1)
      if (cnt[x + step] <= j) x += step;
    const int d = t_dnb[x], f = t_dfs[x];
    const int k = clip(wadd(size, d) >> 16, 0, 16);
    const int u = (size >> k) + j - cnt[x];
    const int lo = max(size, u << k);
    const int hi = min(2 * size - 1, (int)(((long long)(u + 1) << k) - 1));
    // the one state past size where (s + d) >> 16 changes, if any
    const long long m = ((((long long)size + d) >> 16) + 1) * 65536 - d;
    const int i = step_index(lo, d, f, size);
    bool same = step_index(hi, d, f, size) == i;
    if (m > lo && m <= hi)
      same = same && step_index((int)m - 1, d, f, size) == i &&
             step_index((int)m, d, f, size) == i;
    ok = ok && same;
    T[j] = (uint16_t)t_st[i];
  }
  return __all_sync(FULL, ok);
}

// Shared-memory accesses of the one-load walk at 32-bit shared-window
// addresses, in program order (volatile): the step's table load issues
// first, and the record and look-ahead loads queue behind it.
__device__ __forceinline__ int lds_u16(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return (int)v;
}
__device__ __forceinline__ int lds_u8(unsigned a) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
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

// The walkers' one-load pass over pairs m = hi .. lo of the staged chunk:
// lane 0 walks state s2 over the symbols 2m + 1, lane 1 state s1 over the
// symbols 2m (at sym[2m + 1 - c0] and sym[2m - c0]), one instruction
// stream for both; rec[hi - m] gets the pair's two states before its
// step, and a state's step is s = T[(kb >> 5) + (s >> (kb & 31))].  A
// symbol comes three steps ahead and its table word two, so the step's
// shift, address and load wait on nothing but the state.
__device__ __forceinline__ void walk_fast(const int* kb, const uint16_t* T,
                                          const uint8_t* sym, int c0, int hi,
                                          int lo, int2* rec, int& s) {
  const int odd = (threadIdx.x & 1) ^ 1;  // lane 0: the odd symbols
  const unsigned tb = (unsigned)__cvta_generic_to_shared(T);
  const unsigned kbs = (unsigned)__cvta_generic_to_shared(kb);
  const unsigned ss = (unsigned)__cvta_generic_to_shared(sym) - c0 + odd;
  const unsigned rs = (unsigned)__cvta_generic_to_shared(rec) + 4u * (1 - odd);
  const auto word = [&](int x) { return lds_s32(kbs + 4u * x); };
  int w = word(lds_u8(ss + 2 * hi)), v = 0, y = 0;
  if (hi - 1 >= lo) v = word(lds_u8(ss + 2 * hi - 2));
  if (hi - 2 >= lo) y = lds_u8(ss + 2 * hi - 4);
  for (int m = hi; m >= lo; --m) {
    const unsigned p = tb + 2u * (unsigned)(w >> 5);
    const int k = w & 31;
    const int o = s;
    s = lds_u16(p + (((unsigned)o >> k) << 1));
    sts_s32(rs + 8u * (hi - m), o);
    w = v;
    if (m - 2 >= lo) v = word(y);
    if (m - 3 >= lo) y = lds_u8(ss + 2 * m - 6);
  }
}

// The walkers' pass with the exact step (the reference's arithmetic), for
// rows whose tables fail the check: as walk_fast, with dnb and dfs as a
// symbol's words, loaded one step ahead.
__device__ __forceinline__ void walk_exact(const int* t_st, const int* t_dnb,
                                           const int* t_dfs, int size,
                                           const uint8_t* sym, int c0, int hi,
                                           int lo, int2* rec, int& s) {
  const int odd = (threadIdx.x & 1) ^ 1;
  const uint8_t* sb = sym - c0 + odd;
  int* r = reinterpret_cast<int*>(rec) + (1 - odd);
  int d = t_dnb[sb[2 * hi]], f = t_dfs[sb[2 * hi]];
  int y = hi - 1 >= lo ? sb[2 * hi - 2] : 0;
  for (int m = hi; m >= lo; --m) {
    const int o = s;
    s = t_st[step_index(o, d, f, size)];
    r[2 * (hi - m)] = o;
    if (m - 1 >= lo) {
      d = t_dnb[y];
      f = t_dfs[y];
    }
    if (m - 2 >= lo) y = sb[2 * m - 4];
  }
}

// WIDE: the rows are copied 16 bytes at a time (L a multiple of 16 and
// `blocks` 16-byte aligned), else byte by byte.  routes (2,) int32, or
// null: the rows that took the one-load step and the exact one are added.
template <bool WIDE>
__global__ void __launch_bounds__(FSEE_THREADS)
    fse_encode_kernel(const uint8_t* __restrict__ blocks,
                      const int* __restrict__ st, const int* __restrict__ dnb,
                      const int* __restrict__ dfs, int N, int L, int tlog,
                      int W, int* __restrict__ vals, int* __restrict__ nbs,
                      int* __restrict__ routes) {
  extern __shared__ int smem[];
  const int size = 1 << tlog;
  const int tcap = 2 * size + 256;             // even
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = blockIdx.x * FSEE_ROWS;
  const int rows = min(FSEE_ROWS, N - r0);
  int* s_st = smem;                              // FSEE_ROWS * size
  int* s_dnb = s_st + FSEE_ROWS * size;          // FSEE_ROWS * 256
  int* s_dfs = s_dnb + FSEE_ROWS * 256;          // FSEE_ROWS * 256
  int* s_kb = s_dfs + FSEE_ROWS * 256;           // FSEE_ROWS * 256
  int2* s_rec = reinterpret_cast<int2*>(s_kb + FSEE_ROWS * 256);
  uint16_t* s_T = reinterpret_cast<uint16_t*>(s_rec + FSEE_ROWS * FSEE_PAIRS);
  uint8_t* s_sym = reinterpret_cast<uint8_t*>(s_T + FSEE_ROWS * tcap);

  for (int i = tid; i < rows * size; i += FSEE_THREADS)
    s_st[i] = st[(size_t)r0 * size + i];
  for (int i = tid; i < rows * 256; i += FSEE_THREADS) {
    s_dnb[i] = dnb[(size_t)r0 * 256 + i];
    s_dfs[i] = dfs[(size_t)r0 * 256 + i];
  }

  const int npairs = L / 2;
  const int nchunks = (L + FSEE_CHUNK - 1) / FSEE_CHUNK;
  // the last chunk (the first walked; it may be short)
  {
    const int c0 = (nchunks - 1) * FSEE_CHUNK, clen = L - c0;
    if (WIDE) {  // clen is then a multiple of 16
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
  }
  __syncthreads();

  const int w = tid >> 5;  // this warp's row
  const bool live = w < rows;
  const int* t_st = s_st + w * size;
  const int* t_dnb = s_dnb + w * 256;
  const int* t_dfs = s_dfs + w * 256;
  int* t_kb = s_kb + w * 256;
  uint16_t* t_T = s_T + w * tcap;
  int2* rec = s_rec + w * FSEE_PAIRS;
  const uint8_t* sym = s_sym + w * FSEE_CHUNK;
  int* ov = vals + (size_t)(r0 + w) * W;
  int* on = nbs + (size_t)(r0 + w) * W;
  bool fast = false;
  if (live) {
    fast = build_compact(t_st, t_dnb, t_dfs, size, tcap, t_kb, t_T,
                         reinterpret_cast<int*>(rec));
#ifdef CT_FSE_EXACT
    fast = false;
#endif
#ifndef CT_FSE_CLOCK
    if (routes != nullptr && lane == 0) atomicAdd(routes + (fast ? 0 : 1), 1);
#endif
  }
  __syncwarp();
  int s = 0;  // lane 0: state s2, lane 1: state s1
#ifdef CT_FSE_CLOCK
  long long cycles = 0;
#endif

  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int c0 = ci * FSEE_CHUNK;
    const int clen = min(FSEE_CHUNK, L - c0);
    // chunk ci - 1 is whole: its loads fly while this chunk is walked
    uint4 next[FSEE_Q];
    if (WIDE && ci > 0) {
#pragma unroll
      for (int q = 0; q < FSEE_Q; ++q) {
        const int i = tid + q * FSEE_THREADS;
        const int rr = i / (FSEE_CHUNK / 16), k = i % (FSEE_CHUNK / 16);
        next[q] = rr < rows
                      ? __ldg(reinterpret_cast<const uint4*>(
                                  blocks + (size_t)(r0 + rr) * L + c0 -
                                  FSEE_CHUNK) + k)
                      : make_uint4(0, 0, 0, 0);
      }
    }
    if (live) {
      int hi = (c0 + clen) / 2 - 1;  // the chunk's last pair
      const int lo = c0 / 2;
      if (lane < 2 && hi == npairs - 1)  // the row's last pair: first states
        s = first_state(t_st, t_dnb, t_dfs, size,
                        sym[2 * hi + (lane ^ 1) - c0]);
      if (hi == npairs - 1) --hi;
      if (lane < 2 && hi >= lo) {
#ifdef CT_FSE_CLOCK
        const long long t0 = clock64();
#endif
        if (fast)
          walk_fast(t_kb, t_T, sym, c0, hi, lo, rec, s);
        else
          walk_exact(t_st, t_dnb, t_dfs, size, sym, c0, hi, lo, rec, s);
#ifdef CT_FSE_CLOCK
        // the clock is read once the last step's load has landed
        long long t1;
        asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1) : "r"(s)
                     : "memory");
        cycles += t1 - t0;
#endif
      }
      __syncwarp();
      // the warp turns the recorded states into items j = npairs - 2 - m,
      // consecutive lanes on consecutive items
      for (int i = lane; i <= hi - lo; i += 32) {
        const int m = hi - i;
        const int2 r = rec[i];
        const int x2 = sym[2 * m + 1 - c0], x1 = sym[2 * m - c0];
        const int nb2 = wadd(r.x, t_dnb[x2]) >> 16;
        const int nb1 = wadd(r.y, t_dnb[x1]) >> 16;
        const int c2 = clip(nb2, 0, 16), c1 = clip(nb1, 0, 16);
        const unsigned v2 = (unsigned)r.x & ((1u << c2) - 1u);
        const unsigned v1 = (unsigned)r.y & ((1u << c1) - 1u);
        const int j = npairs - 2 - m;
        ov[j] = (int)(v2 | (v1 << c2));
        on[j] = wadd(nb1, nb2);
      }
    }
    __syncthreads();  // every warp is done with this chunk's symbols
    if (ci > 0) {
      if (WIDE) {
#pragma unroll
        for (int q = 0; q < FSEE_Q; ++q) {
          const int i = tid + q * FSEE_THREADS;
          reinterpret_cast<uint4*>(s_sym)[i] = next[q];
        }
      } else {
        const int p0 = c0 - FSEE_CHUNK;
        for (int i = tid; i < rows * FSEE_CHUNK; i += FSEE_THREADS) {
          const int rr = i / FSEE_CHUNK, k = i - rr * FSEE_CHUNK;
          s_sym[i] = blocks[(size_t)(r0 + rr) * L + p0 + k];
        }
      }
      __syncthreads();
    }
  }
  const int s2 = __shfl_sync(FULL, s, 0), s1 = __shfl_sync(FULL, s, 1);
  if (live) {
#ifdef CT_FSE_CLOCK
    if (lane == 0) {
      reinterpret_cast<long long*>(routes)[2 * (r0 + w)] = cycles;
      reinterpret_cast<long long*>(routes)[2 * (r0 + w) + 1] = fast;
    }
#endif
    if (lane == 0) {
      ov[npairs - 1] = (int)(((unsigned)s2 - (unsigned)size) |
                             (((unsigned)s1 - (unsigned)size) << tlog));
      on[npairs - 1] = 2 * tlog;
    }
    for (int j = npairs + lane; j < W; j += 32) {
      ov[j] = 0;
      on[j] = 0;
    }
  }
}

size_t encode_smem(int tlog) {
  const size_t size = 1u << tlog;
  return sizeof(int) * FSEE_ROWS * (size + 3 * 256) +
         sizeof(int2) * FSEE_ROWS * FSEE_PAIRS +
         sizeof(uint16_t) * FSEE_ROWS * (2 * size + 256) +
         (size_t)FSEE_ROWS * FSEE_CHUNK;
}

template <bool WIDE>
int launch(const uint8_t* blocks, const int* st, const int* dnb,
           const int* dfs, int N, int L, int tlog, int W, int* vals, int* nbs,
           int* routes, cudaStream_t stream) {
  const size_t smem = encode_smem(tlog);
  cudaError_t e = cudaFuncSetAttribute(
      fse_encode_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (N + FSEE_ROWS - 1) / FSEE_ROWS;
  fse_encode_kernel<WIDE><<<grid, FSEE_THREADS, smem, stream>>>(
      blocks, st, dnb, dfs, N, L, tlog, W, vals, nbs, routes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks (N, L) u8, L even >= 2, contiguous; st (N, 1 << tlog), dnb and dfs
// (N, 256) int32, contiguous; 1 <= tlog <= 12; vals, nbs (N, W) int32 with
// W >= L / 2; routes null or (2,) int32 (rows on the one-load step and on
// the exact step are added to it).
int ct_fse_encode(const uint8_t* blocks, const int* st, const int* dnb,
                  const int* dfs, int N, int L, int tlog, int W, int* vals,
                  int* nbs, int* routes, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 2 || L % 2 || tlog < 1 || tlog > 12 || W < L / 2)
    return (int)cudaErrorInvalidValue;
  if (L % 16 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0)
    return launch<true>(blocks, st, dnb, dfs, N, L, tlog, W, vals, nbs,
                        routes, stream);
  return launch<false>(blocks, st, dnb, dfs, N, L, tlog, W, vals, nbs, routes,
                       stream);
}

// CTAs of the encode chain resident on one SM at table log tlog (< 0: an
// error).
int ct_fse_encode_occupancy(int tlog) {
  const int smem = (int)encode_smem(tlog);
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      fse_encode_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fse_encode_kernel<true>, FSEE_THREADS, smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
