// Per-row entropy-table builds: the Huffman code lengths of a 256-symbol
// histogram limited to `maxlog` bits, and the FSE normalised counts of an
// NSYM-symbol histogram.
//
// Replaces: compress_tpu/ops/zdev.py `_huff_build` (:139; its `pass_`
// step :169, a lax.scan over the 256 sorted symbols at :181, 12 passes)
// and `_normalize_count` (:357; its `steal` step :384, a lax.scan at
// :389), whose scan compress_tpu/ops/entropy.py `_fse_tables_bytes`
// (:110, scan :137) repeats inline.  They are XLA scans, not Pallas
// kernels; these are kernels of their own.
//
// Function.  `ct_huff_build`: for each row of J rows of 256 counts, the
// code lengths l0 = ceil(log2(total / h)) clipped to [1, maxlog] (0 for
// an absent symbol), then 12 passes, each of which orders the symbols
// with l > 1 by h << l descending (the lower symbol first on ties) and
// walks them in that order, shortening a code by one level wherever its
// cost 2^(maxlog - l) fits the Kraft deficit d = 2^maxlog - sum
// 2^(maxlog - l), which the step spends; then max_bits (the longest
// length) and ok (d == 0 and at least two symbols present).
// `ct_normalize_count`: for each row of N rows of NSYM counts, the floor
// shares base = h 2^log / total (at least 1 for a present symbol); a
// surplus goes one each to the symbols with the largest remainders (the
// lower symbol first on ties); a deficit is stolen from the counts in
// descending order (the lower symbol first on ties), each giving all it
// has above 1 until the deficit is paid.
//
// Bound on the H100: neither bytes nor operations.  A row reads 256
// counts and writes 256 lengths (2-3 KB); the work a row needs is a sort
// of at most 256 keys a pass and a walk.  What bounds a row is the rank
// (the stable order of its keys) and the Huffman walk's serial chain:
// whether a symbol takes a step depends on the deficit the previous step
// left.
//
// Design.  A CTA a row, a thread a symbol (NSYM up to 1024 for the
// normalisation: a CTA of 256 threads up to 256 symbols, of 1024 past
// that).  32 registers, so that 8 CTAs of 256 threads fit an SM and a
// batch of 1024 rows runs in one wave.
// - Totals, the Kraft sum and max_bits are block reductions (warp
//   shuffles or `redux`, then one word a warp, one barrier each); l0 is
//   the least l with h << l >= total, from two `__clzll` (the plain
//   version's division past 2^62); counts are 64-bit, as the plain
//   version's.
// - The stable order is one routine, `sorted_rank`, shared by both
//   kernels: each warp sorts its 32 (key, tag) pairs in registers by a
//   bitonic network of shuffles (15 compare-exchange steps), the key
//   descending and the tag ascending, so that a tag holding the symbol
//   gives the lower symbol first on ties; the runs go to shared memory,
//   and the rank of the pair a lane holds is its place in its run plus,
//   for each other run, the count of that run's pairs that sort before
//   it, by binary lifting over the run's 32 pairs (6 loads), 4 runs in
//   lock step with no branch.  A pair that takes no rank (a symbol that
//   cannot step, absent, or outside NSYM) has the tag's top bit set and
//   counts as key 0, so it sorts after every live pair and no search
//   needs a bound; a run with no live pair, and the warp's own, are read
//   as a run of such pairs.  Pairs are compared exactly.  Where a row's
//   keys are below 2^(32 - TB) or 2^(64 - TB) (the widest key's bit
//   length, by `redux` a warp) key << TB | ~tag is one 32-bit or 64-bit
//   word and a compare one or two instructions; elsewhere the 64-bit key
//   and the tag are compared in turn, so a key of any width keeps its
//   bits.
// - The Huffman walk: the ranked symbols write their costs' exponents
//   (maxlog - l, at most 13) in rank order, 8 to a word, and one thread
//   walks them from registers, 32 a 16-byte load.  A step is d = min(d -
//   cost, d) in unsigned arithmetic (a cost that does not fit wraps past
//   2^31), two dependent instructions and no branch; 2^e comes from one
//   funnel shift of the exponents split into even and odd bytes, and the
//   wrap bits gather into a chunk's mask, written once.  The stop is
//   checked once a chunk: once d is 0 no cost (at least 1) fits, so the
//   rest of the chunk takes nothing and the result is the plain
//   version's.  Ranks past the ranked symbols read exponent 15, which
//   costs more than any deficit.  Each symbol reads its step from the
//   masks at its rank.  A pass that starts with nothing to spend, or that
//   takes no step, changes nothing, and neither would any later pass: the
//   passes stop there, so most rows rank and walk once or twice.
// - The surplus needs no walk (rank < surplus).  The deficit needs none
//   either: with a_i = max(c_i - 1, 0) in rank order and P_i the sum of
//   a_j over j < i, the walk's take at rank i is min(a_i, max(d - P_i,
//   0)), so a block exclusive scan of a gives every take at once, a
//   deficit that cannot be paid included; each rank writes its symbol's
//   count.
// A launch is one kernel for the whole batch; there is no host sync.
// With `stats` each row also writes its walk steps (for the deficit, the
// steps the walk would take: the first rank where P_i + a_i >= d, plus
// one, or NSYM) and the SM cycles of its walks or its scan (clock64), from
// which a caller gets the cycles a step and the serial floor of the
// longest row.  Built with -DCT_TABLEBUILD_CLOCK, the entries
// `ct_huff_build_clock` / `ct_normalize_count_clock` also write each
// row's cycles before its ranks, in its ranks, in its walks or scan, in
// all, and its passes (the normalisation: 0 with nothing to move, 1 a
// surplus, 2 a deficit).
#include "ct_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int HB_SYMS = 256;   // symbols a Huffman row; a thread each
constexpr int HB_PASSES = 12;  // the reference's Kraft-repair passes
constexpr int NC_MAX = 1024;   // largest NSYM of the normalisation

#ifdef CT_TABLEBUILD_CLOCK
constexpr bool CLOCKED = true;
#else
constexpr bool CLOCKED = false;
#endif

// The minimum of v over the CTA, returned to every thread, with `red` (a
// word a warp) used for nothing else.
__device__ int block_min(int v, int* red) {
  v = __reduce_min_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = min(r, red[w]);
  return r;
}

// The sum of v over the CTA, returned to every thread, with `red` (a word
// a warp) used for nothing else: no leading barrier.
__device__ unsigned long long block_sum(unsigned long long v,
                                        unsigned long long* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long r = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  return r;
}

// The sum of v over the threads before this one, for every thread.
// `part` holds a word a warp.
__device__ long long block_exclusive_scan(long long v, long long* part) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) part[w] = x;
  __syncthreads();
  if (w == 0) {
    long long t = lane < nw ? part[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) part[lane] = t;
  }
  __syncthreads();
  return x - v + (w ? part[w - 1] : 0);
}

// floor(a / b) for b >= 1, as PyTorch's integer floor division.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}

// The CTA's sorted runs: a warp's 32 pairs in order, then one run of dead
// pairs that the searches read in place of a run they skip; and each
// run's live pairs.  The exact route keeps keys and tags; the packed
// routes their words, 32-bit in tag and 64-bit in key.
template <int NT>
struct Runs {
  unsigned long long key[NT + 32];
  unsigned tag[NT + 32];
  int live[NT / 32];
};

// The routes of the rank's pairs.  A pair is a key and a tag of TB bits
// (the symbol, and a payload below it); the tag's top bit marks a pair
// that takes no rank, whose key counts as 0, so that it sorts after every
// live pair.  All compare exactly: the larger key first, the lower tag on
// equal keys.
//
// The exact route: the 64-bit key and the tag, compared in turn.
template <int TB>
struct WidePair {
  static constexpr unsigned DEAD = 1u << (TB - 1);
  unsigned long long key;
  unsigned tag;
  __device__ static WidePair make(unsigned long long k, unsigned t) {
    return {t & DEAD ? 0ull : k, t};
  }
  __device__ static WidePair dead() { return {0ull, ~0u}; }
  __device__ unsigned long long k() const { return key; }
  __device__ unsigned t() const { return tag; }
  __device__ bool before(const WidePair& b) const {
    return key > b.key || (key == b.key && tag < b.tag);
  }
  __device__ WidePair shfl_xor(int j) const {
    return {__shfl_xor_sync(FULL, key, j), __shfl_xor_sync(FULL, tag, j)};
  }
  template <int NT>
  __device__ void store(Runs<NT>& r, int i) const {
    r.key[i] = key;
    r.tag[i] = tag;
  }
  template <int NT>
  __device__ static WidePair load(const Runs<NT>& r, int i) {
    return {r.key[i], r.tag[i]};
  }
};

// The packed routes, for keys below 2^(32 - TB) (W 32-bit) or 2^(64 - TB)
// (W 64-bit): key << TB | ~tag in one word, the larger word first (one
// compare, one shuffle and one load a word).
template <int TB, typename W>
struct PackedPair {
  static constexpr unsigned DEAD = 1u << (TB - 1);
  static constexpr unsigned MASK = (1u << TB) - 1;
  W w;
  __device__ static PackedPair make(unsigned long long k, unsigned t) {
    return {(t & DEAD ? W(0) : (W)k << TB) | (W)(~t & MASK)};
  }
  __device__ static PackedPair dead() { return {W(0)}; }
  __device__ unsigned long long k() const { return w >> TB; }
  __device__ unsigned t() const { return ~(unsigned)w & MASK; }
  __device__ bool before(const PackedPair& b) const { return w > b.w; }
  __device__ PackedPair shfl_xor(int j) const {
    return {__shfl_xor_sync(FULL, w, j)};
  }
  template <int NT>
  __device__ void store(Runs<NT>& r, int i) const {
    if constexpr (sizeof(W) == 4) r.tag[i] = w; else r.key[i] = w;
  }
  template <int NT>
  __device__ static PackedPair load(const Runs<NT>& r, int i) {
    if constexpr (sizeof(W) == 4) return {r.tag[i]}; else return {r.key[i]};
  }
};

// The stable rank shared by both kernels.  Every thread of the CTA gives
// one pair.  On return the lane holds the pair at its place in its warp's
// sorted run, and the result is that pair's rank among the CTA's live
// pairs (meaningless for a dead pair); n gets the live pairs' count.  One
// barrier; the caller orders any reuse of `runs`.
template <int NT, typename P>
__device__ int sorted_rank(P& p, Runs<NT>& runs, int& n) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const P q = p.shfl_xor(j);
      // this lane keeps the pair that sorts first, or the one after
      const bool first = ((lane & j) == 0) == ((lane & k) == 0);
      if (q.before(p) == first) p = q;
    }
  }
  p.store(runs, threadIdx.x);
  if (w == 0) P::dead().store(runs, NT + lane);
  const bool live = !(p.t() & P::DEAD);
  const unsigned lives = __ballot_sync(FULL, live);
  if (lane == 0) runs.live[w] = __popc(lives);
  n = __syncthreads_count(live);
  int r = lane;
  if (!lives) return r;
  // Each search reads all 32 pairs of its run by binary lifting: a dead
  // pair never sorts before a live one, so no bound is needed.  A run that
  // is this warp's own, or has no live pair, reads the dead run at NT.
  // Up to RG searches go in lock step, with no branch, so that their loads
  // are in flight together.
  constexpr int RG = 4;
  const int nruns = blockDim.x >> 5;
  for (int v0 = 0; v0 < nruns; v0 += RG) {
    int base[RG], pos[RG];
#pragma unroll
    for (int u = 0; u < RG; ++u) {
      const int v = v0 + u;
      base[u] = v < nruns && v != w && runs.live[v] ? 32 * v : NT;
      pos[u] = 0;
    }
#pragma unroll
    for (int st = 16; st; st >>= 1) {
#pragma unroll
      for (int u = 0; u < RG; ++u)
        pos[u] += P::load(runs, base[u] + pos[u] + st - 1).before(p) ? st : 0;
    }
#pragma unroll
    for (int u = 0; u < RG; ++u)
      r += pos[u] + P::load(runs, base[u] + pos[u]).before(p);
  }
  return r;
}

// The rank of (key, tag) on route P; key and tag come back as the pair the
// lane holds after the sort.
template <typename P, int NT>
__device__ __forceinline__ int rank_pair(unsigned long long& key,
                                         unsigned& tag, Runs<NT>& runs,
                                         int& n) {
  P p = P::make(key, tag);
  const int r = sorted_rank<NT>(p, runs, n);
  key = p.k();
  tag = p.t();
  return r;
}

// The rank on the route a CTA's row takes: 0 packed in 32 bits, 1 packed
// in 64 bits, 2 exact.
template <int TB, int NT>
__device__ __forceinline__ int rank_on(int route, unsigned long long& key,
                                       unsigned& tag, Runs<NT>& runs,
                                       int& n) {
  if (route == 0)
    return rank_pair<PackedPair<TB, unsigned>>(key, tag, runs, n);
  if (route == 1)
    return rank_pair<PackedPair<TB, unsigned long long>>(key, tag, runs, n);
  return rank_pair<WidePair<TB>>(key, tag, runs, n);
}

constexpr int HB_TB = 13;  // a Huffman tag: dead bit, symbol, exponent
constexpr int NC_TB = 11;  // a normalisation tag: dead bit, symbol

// 32 registers: 8 CTAs an SM, so that batches of 1024 rows run in one wave
template <typename C>
__global__ void __launch_bounds__(HB_SYMS, 8)
huff_build_kernel(const C* __restrict__ hist, int maxlog,
                  int* __restrict__ nbits, int* __restrict__ max_bits,
                  uint8_t* __restrict__ ok, long long* __restrict__ stats,
                  long long* __restrict__ clk) {
  constexpr unsigned DEAD = 1u << (HB_TB - 1);
  __shared__ Runs<HB_SYMS> runs;
  __shared__ short rank_of[HB_SYMS];
  // the ranked symbols' cost exponents in rank order, 8 to a word
  __shared__ __align__(16) unsigned expw[HB_SYMS / 8];
  __shared__ unsigned takes[HB_SYMS / 32];  // the walk's steps, a bit a rank
  // a word a warp: the counts' sum, the symbols present, the Kraft sum,
  // the longest length
  __shared__ unsigned long long red64[HB_SYMS / 32];
  __shared__ unsigned red_nz[HB_SYMS / 32], red_kraft[HB_SYMS / 32],
      red_max[HB_SYMS / 32], red_bits[HB_SYMS / 32];
  __shared__ int walked;  // chunks of 32 ranks the walk wrote
  __shared__ bool again;
  const long long t_start = CLOCKED ? clock64() : 0;
  const int s = threadIdx.x, lane = s & 31, wp = s >> 5;
  const size_t row = blockIdx.x;
  const long long h = (long long)hist[row * HB_SYMS + s];
  const bool present = h > 0;
  const unsigned pw = __ballot_sync(FULL, present);
  if (lane == 0) red_nz[wp] = __popc(pw);
  const long long total = (long long)block_sum((unsigned long long)h, red64);
  int nz = 0;
  for (int i = 0; i < HB_SYMS / 32; ++i) nz += red_nz[i];
  // l0 = ceil(log2(total / h)), at least 1: the least l with h << l >=
  // total, which is floor_log2(total) - floor_log2(h) or one more; past
  // 2^62 (where the plain version's total + h - 1 can wrap) by its
  // division, floor_log2(ceil(total / h) - 1) + 1
  const long long hh = present ? h : 1;
  int l;
  if ((unsigned long long)total < 1ull << 62) {
    l = __clzll((unsigned long long)hh) - __clzll((unsigned long long)total);
    l += (hh << max(l, 0)) < total;
    l = max(l, 1);
  } else {
    const long long ratio = floor_div(
        (long long)((unsigned long long)total + (unsigned long long)hh - 1ull),
        hh);
    l = ratio > 1 ? 64 - __clzll((unsigned long long)(ratio - 1)) : 1;
  }
  l = present ? min(l, maxlog) : 0;
  const unsigned kraft = __reduce_add_sync(
      FULL, present ? 1u << (maxlog - l) : 0u);
  // the widest key h << l of a symbol that can step (later passes only
  // shorten keys)
  const unsigned bits = __reduce_max_sync(
      FULL, present && l > 1 ? 64 - __clzll((unsigned long long)h << l) : 0);
  if (lane == 0) {
    red_kraft[wp] = kraft;
    red_bits[wp] = bits;
  }
  __syncthreads();
  int d = 1 << maxlog;
  unsigned kb = 0;
  for (int i = 0; i < HB_SYMS / 32; ++i) {
    d -= (int)red_kraft[i];
    kb = max(kb, red_bits[i]);
  }
  const int route = kb <= 32 - HB_TB ? 0 : kb <= 64 - HB_TB ? 1 : 2;
  const long long t_passes = CLOCKED ? clock64() : 0;

  // A pass that starts with d <= 0, or that takes no step, leaves the
  // lengths and d as they were, so every later pass would repeat it: the
  // passes stop there.
  long long steps = 0, cycles = 0, rank_cycles = 0;
  int passes = 0;
  bool more = d > 0;
  for (; passes < HB_PASSES && more; ++passes) {
    const long long t0 = CLOCKED ? clock64() : 0;
    const bool elig = present && l > 1;
    unsigned long long key = (unsigned long long)h << l;
    unsigned tag = (elig ? 0u : DEAD) | (unsigned)s << 4
                   | (unsigned)((maxlog - l) & 15);
    if (s < HB_SYMS / 8) expw[s] = 0;
    int n;
    const int r = rank_on<HB_TB>(route, key, tag, runs, n);
    if (!(tag & DEAD)) {
      rank_of[(tag >> 4) & (HB_SYMS - 1)] = (short)r;
      atomicOr(&expw[r >> 3], (tag & 15u) << (4 * (r & 7)));
    }
    __syncthreads();
    if (s == 0) {
      const long long t1 = (stats || CLOCKED) ? clock64() : 0;
      if (CLOCKED) rank_cycles += t1 - t0;
      const int nch = (n + 31) >> 5;
      int c = 0, stop = n;
      unsigned any = 0;
      // 0 < d < 2^15 here: a step is d = min(d - cost, d) in unsigned
      // arithmetic (d - cost wraps past 2^31 where the cost does not fit),
      // two dependent instructions
      unsigned du = d;
      for (; c < nch; ++c) {
        const uint4 q = reinterpret_cast<const uint4*>(expw)[c];
        unsigned wd[4] = {q.x, q.y, q.z, q.w};
        unsigned skips = 0;  // a bit a step that took nothing, first step
                             // highest
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // ranks at n and past take nothing: exponent 15
          const int v = n - 32 * c - 8 * k;
          if (v < 8) wd[k] |= v <= 0 ? ~0u : ~0u << (4 * v);
          // the even and the odd exponents a byte each, so that a funnel
          // shift (which reads 5 bits of its amount) makes 2^e of the low
          // byte in one instruction; each word then moves down a byte
          unsigned e[2] = {wd[k] & 0x0f0f0f0fu, (wd[k] >> 4) & 0x0f0f0f0fu};
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const unsigned t = du - __funnelshift_l(0u, 1u, e[b & 1]);
            e[b & 1] >>= 8;
            skips = skips * 2 + (t >> 31);  // t wraps where it does not fit
            du = min(t, du);
          }
        }
        const unsigned mask = ~__brev(skips);
        takes[c] = mask;
        any |= mask;
        if (du == 0) {
          stop = 32 * c + 32 - __clz(mask);  // the step that paid d, + 1
          ++c;
          break;
        }
      }
      d = (int)du;
      walked = c;
      again = d > 0 && any;
      steps += stop;
      if (stats || CLOCKED) cycles += clock64() - t1;
    }
    __syncthreads();
    if (elig) {
      const int rr = rank_of[s];
      if ((rr >> 5) < walked) l -= (takes[rr >> 5] >> (rr & 31)) & 1;
    }
    more = again;
  }
  const unsigned mw = __reduce_max_sync(FULL, (unsigned)l);
  if (lane == 0) red_max[wp] = mw;
  nbits[row * HB_SYMS + s] = l;
  __syncthreads();
  if (s == 0) {
    unsigned mb = 0;
    for (int i = 0; i < HB_SYMS / 32; ++i) mb = max(mb, red_max[i]);
    max_bits[row] = (int)mb;
    ok[row] = d == 0 && nz >= 2;
    if (stats) {
      stats[2 * row] = steps;
      stats[2 * row + 1] = cycles;
    }
    if (CLOCKED && clk) {
      clk[5 * row] = t_passes - t_start;
      clk[5 * row + 1] = rank_cycles;
      clk[5 * row + 2] = cycles;
      clk[5 * row + 3] = clock64() - t_start;
      clk[5 * row + 4] = passes;
    }
  }
}

template <typename C, int NT>
__global__ void __launch_bounds__(NT, 2048 / NT)
normalize_count_kernel(const C* __restrict__ hist, int nsym, int log,
                       int* __restrict__ norm_out,
                       long long* __restrict__ stats,
                       long long* __restrict__ clk) {
  constexpr unsigned DEAD = 1u << (NC_TB - 1);
  __shared__ Runs<NT> runs;
  __shared__ long long vals[NT];  // a deficit: the counts in rank order
  // a surplus: each symbol's rank; a deficit: the symbol at each rank
  __shared__ short at[NT];
  __shared__ unsigned long long red_total[NT / 32], red_norm[NT / 32];
  __shared__ long long part[NT / 32];
  __shared__ int red32[NT / 32];
  __shared__ unsigned red_bits[NT / 32];
  const long long t_start = CLOCKED ? clock64() : 0;
  const int s = threadIdx.x;
  const bool in = s < nsym;
  const size_t row = blockIdx.x;
  const long long h = in ? (long long)hist[row * nsym + s] : 0;
  const long long size = 1ll << log;
  const long long total = max(
      (long long)block_sum((unsigned long long)h, red_total), 1ll);
  const bool present = h > 0;
  const long long scaled =
      (long long)((unsigned long long)h * (unsigned long long)size);
  const long long base = floor_div(scaled, total);
  const long long rem = scaled - base * total;
  long long norm = present ? max(base, 1ll) : 0;
  // the widest key either rank could take: a remainder or a count
  const unsigned bits = __reduce_max_sync(
      FULL, 64 - __clzll((unsigned long long)(present ? rem : 0)
                         | (unsigned long long)norm));
  if ((s & 31) == 0) red_bits[s >> 5] = bits;
  const long long diff =
      size - (long long)block_sum((unsigned long long)norm, red_norm);
  unsigned kb = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) kb = max(kb, red_bits[i]);
  const int route = kb <= 32 - NC_TB ? 0 : kb <= 64 - NC_TB ? 1 : 2;
  const long long t_rank = CLOCKED ? clock64() : 0;
  long long steps = 0, cycles = 0;
  int n;
  if (diff > 0) {
    // the surplus, one each to the largest remainders (fewer than the
    // symbols present, so no walk)
    unsigned long long key = (unsigned long long)rem;
    unsigned tag = (present ? 0u : DEAD) | (unsigned)s;
    const int r = rank_on<NC_TB>(route, key, tag, runs, n);
    if (!(tag & DEAD)) at[tag] = (short)r;
    __syncthreads();
    if (present) norm += at[s] < diff;
  } else if (diff < 0) {
    // the deficit, stolen from the counts in descending order
    unsigned long long key = (unsigned long long)norm;
    unsigned tag = (in ? 0u : DEAD) | (unsigned)s;
    const int r = rank_on<NC_TB>(route, key, tag, runs, n);
    if (!(tag & DEAD)) {
      vals[r] = (long long)key;
      at[r] = (short)tag;
    }
    __syncthreads();
    const long long t1 = (stats || CLOCKED) ? clock64() : 0;
    // thread s takes rank s: the walk's take there is min(a, max(d - P,
    // 0)), P the sum of a over the ranks before it
    const long long c = in ? vals[s] : 0;
    const long long a = max(c - 1, 0ll);
    const long long P = block_exclusive_scan(a, part);
    const long long d = -diff;
    if (in) norm_out[row * nsym + at[s]] = (int)(c - min(a, max(d - P, 0ll)));
    if (stats) {
      const int first = block_min(in && P + a >= d ? s : nsym, red32);
      steps = first < nsym ? first + 1 : nsym;
    }
    if (stats || CLOCKED) cycles = clock64() - t1;
  }
  const long long t_end = CLOCKED ? clock64() : 0;
  if (in && diff >= 0) norm_out[row * nsym + s] = (int)norm;
  if (s == 0) {
    if (stats) {
      stats[2 * row] = steps;
      stats[2 * row + 1] = cycles;
    }
    if (CLOCKED && clk) {
      clk[5 * row] = t_rank - t_start;
      clk[5 * row + 1] = t_end - t_rank - cycles;
      clk[5 * row + 2] = cycles;
      clk[5 * row + 3] = clock64() - t_start;
      clk[5 * row + 4] = diff > 0 ? 1 : diff < 0 ? 2 : 0;
    }
  }
}

template <typename C>
int huff_launch(const void* hist, int J, int maxlog, int* nbits,
                int* max_bits, uint8_t* ok, long long* stats, long long* clk,
                cudaStream_t stream) {
  huff_build_kernel<C><<<J, HB_SYMS, 0, stream>>>(
      static_cast<const C*>(hist), maxlog, nbits, max_bits, ok, stats, clk);
  return (int)cudaGetLastError();
}

template <typename C>
int normalize_launch(const void* hist, int N, int nsym, int log, int* norm,
                     long long* stats, long long* clk, cudaStream_t stream) {
  const int threads = (nsym + 31) / 32 * 32;
  if (threads <= 256)
    normalize_count_kernel<C, 256><<<N, threads, 0, stream>>>(
        static_cast<const C*>(hist), nsym, log, norm, stats, clk);
  else
    normalize_count_kernel<C, NC_MAX><<<N, threads, 0, stream>>>(
        static_cast<const C*>(hist), nsym, log, norm, stats, clk);
  return (int)cudaGetLastError();
}

int huff_entry(const void* hist, int kind, int J, int maxlog, int* nbits,
               int* max_bits, uint8_t* ok, long long* stats, long long* clk,
               cudaStream_t stream) {
  if (J < 0 || maxlog < 1 || maxlog > 15) return (int)cudaErrorInvalidValue;
  if (J == 0) return 0;
  switch (kind) {
    case 3: return huff_launch<int32_t>(hist, J, maxlog, nbits, max_bits, ok,
                                        stats, clk, stream);
    case 4: return huff_launch<long long>(hist, J, maxlog, nbits, max_bits,
                                          ok, stats, clk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int normalize_entry(const void* hist, int kind, int N, int nsym, int log,
                    int* norm, long long* stats, long long* clk,
                    cudaStream_t stream) {
  if (N < 0 || nsym < 1 || nsym > NC_MAX || log < 1 || log > 30)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  switch (kind) {
    case 3: return normalize_launch<int32_t>(hist, N, nsym, log, norm, stats,
                                             clk, stream);
    case 4: return normalize_launch<long long>(hist, N, nsym, log, norm,
                                               stats, clk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// hist: (J, 256) counts, contiguous, kind 3 int32 or 4 int64; maxlog
// 1..15; nbits (J, 256) int32, max_bits (J,) int32, ok (J,) bool; stats:
// null, or (J, 2) int64 that gets each row's walk steps (over its 12
// passes) and the SM cycles of its walks.
int ct_huff_build(const void* hist, int kind, int J, int maxlog, int* nbits,
                  int* max_bits, uint8_t* ok, long long* stats,
                  cudaStream_t stream) {
  return huff_entry(hist, kind, J, maxlog, nbits, max_bits, ok, stats,
                    nullptr, stream);
}

// hist: (N, nsym) counts, contiguous, kind 3 int32 or 4 int64; nsym
// 1..1024; log 1..30; norm (N, nsym) int32; stats: null, or (N, 2) int64
// that gets each row's deficit-walk steps (the steps the serial walk
// would take) and the SM cycles of its scan (0 and 0 for a row with no
// deficit).
int ct_normalize_count(const void* hist, int kind, int N, int nsym, int log,
                       int* norm, long long* stats, cudaStream_t stream) {
  return normalize_entry(hist, kind, N, nsym, log, norm, stats, nullptr,
                         stream);
}

#ifdef CT_TABLEBUILD_CLOCK
// As the entries above, with clk: (rows, 5) int64 that gets each row's SM
// cycles before its ranks, in its ranks, in its walks (or its scan), in
// all, and its passes (the normalisation: 0 nothing to move, 1 a surplus,
// 2 a deficit).
int ct_huff_build_clock(const void* hist, int kind, int J, int maxlog,
                        int* nbits, int* max_bits, uint8_t* ok,
                        long long* stats, long long* clk,
                        cudaStream_t stream) {
  return huff_entry(hist, kind, J, maxlog, nbits, max_bits, ok, stats, clk,
                    stream);
}

int ct_normalize_count_clock(const void* hist, int kind, int N, int nsym,
                             int log, int* norm, long long* stats,
                             long long* clk, cudaStream_t stream) {
  return normalize_entry(hist, kind, N, nsym, log, norm, stats, clk, stream);
}
#endif

// out: the Huffman build's registers, static shared bytes and CTAs an SM,
// then the normalisation's at 256 symbols (int64 counts).
int ct_tablebuild_info(int* out) {
  cudaFuncAttributes a{}, b{};
  int na = 0, nb = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, huff_build_kernel<long long>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&b, normalize_count_kernel<long long, 256>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &na, huff_build_kernel<long long>, HB_SYMS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, normalize_count_kernel<long long, 256>, 256, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = na;
  out[3] = b.numRegs;
  out[4] = (int)b.sharedSizeBytes;
  out[5] = nb;
  return 0;
}

}  // extern "C"
