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
// of at most 256 keys a pass.  What bounds a row is its serial walk: the
// step that decides whether a symbol takes a step depends on the deficit
// the previous step left.
//
// Design.  A CTA a row, a thread a symbol, the row in shared memory.
// - Totals, the Kraft sum and max_bits are block reductions (warp
//   shuffles, then one word a warp); l0 is an exact integer floor_log2
//   (`__clzll`); counts are 64-bit, as the plain version's.
// - A stable order is a comparison-count rank: each thread counts the
//   keys that sort before its own (the same address for every lane, so a
//   broadcast), which is the position a stable sort gives it.  Only the
//   symbols that can take a step are ranked; the others keep their
//   lengths (a symbol with l = 1, or absent, costs 2^30 in the plain
//   version, more than any deficit).
// - Thread 0 walks the costs in rank order from shared memory.  The chain
//   is a compare, a select and a subtract in 32 bits (|d| < 2^23), but
//   the early stop puts each step's shared load behind the previous
//   step's branch, so a step costs about a shared-memory round trip.
//   The walk stops where the deficit reaches 0: no later symbol can take
//   a step (every cost is at least 1), so the result is the plain
//   version's.  A pass that starts with nothing to spend, or that takes
//   no step, changes nothing, and neither would any later pass: the
//   passes stop there, so most rows rank and walk once or twice.
// - The surplus needs no walk (rank < surplus); the deficit is one walk
//   over the counts in descending order, also stopped at 0, then each
//   thread reads its count back from its rank.
// A launch is one kernel for the whole batch; there is no host sync.
// With `stats` each row also writes its walk steps and the SM cycles its
// walks took (clock64 around each walk), from which a caller gets the
// cycles a step and the serial floor of the longest row.
#include "ct_common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int HB_SYMS = 256;   // symbols a Huffman row; a thread each
constexpr int HB_PASSES = 12;  // the reference's Kraft-repair passes
constexpr int NC_MAX = 1024;   // largest NSYM of the normalisation

struct Sum {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a + b; }
};
struct Max {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a > b ? a : b; }
};

// The reduction of v over the CTA, returned to every thread.  `red` holds
// a word a warp; the leading barrier lets a CTA reuse it.
template <typename V, typename Op>
__device__ V block_reduce(V v, V* red, Op op) {
  for (int o = 16; o; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  V r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = op(r, red[w]);
  return r;
}

// floor(a / b) for b >= 1, as PyTorch's integer floor division.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}

template <typename C>
__global__ void __launch_bounds__(HB_SYMS)
huff_build_kernel(const C* __restrict__ hist, int maxlog,
                  int* __restrict__ nbits, int* __restrict__ max_bits,
                  uint8_t* __restrict__ ok, long long* __restrict__ stats) {
  __shared__ unsigned long long key[HB_SYMS];  // h << l, 0 if it cannot step
  __shared__ int cost[HB_SYMS];                // the costs in rank order
  __shared__ uint8_t take[HB_SYMS];            // the walk's steps, by rank
  __shared__ unsigned long long red64[HB_SYMS / 32];
  __shared__ int red32[HB_SYMS / 32];
  __shared__ int walked;
  __shared__ bool again;
  const int s = threadIdx.x;
  const size_t row = blockIdx.x;
  const long long h = (long long)hist[row * HB_SYMS + s];
  const bool present = h > 0;
  const long long total = (long long)block_reduce<unsigned long long>(
      (unsigned long long)h, red64, Sum());
  const int nz = __syncthreads_count(present);
  // l0 = ceil(log2(total / h)): floor_log2(ceil(total / h) - 1) + 1
  const long long hh = present ? h : 1;
  const long long ratio = floor_div(
      (long long)((unsigned long long)total + (unsigned long long)hh - 1ull),
      hh);
  int l = ratio > 1 ? 64 - __clzll((unsigned long long)(ratio - 1)) : 1;
  l = present ? min(l, maxlog) : 0;
  int d = (1 << maxlog)
          - block_reduce<int>(present ? 1 << (maxlog - l) : 0, red32, Sum());

  // A pass that starts with d <= 0, or that takes no step, leaves the
  // lengths and d as they were, so every later pass would repeat it: the
  // passes stop there.
  long long steps = 0, cycles = 0;
  bool more = d > 0;
  for (int p = 0; p < HB_PASSES && more; ++p) {
    const bool elig = present && l > 1;
    const unsigned long long ks = elig ? (unsigned long long)h << l : 0ull;
    key[s] = ks;
    const int n = __syncthreads_count(elig);
    int rank = 0;
    if (elig) {
      for (int t = 0; t < HB_SYMS; ++t) {
        const unsigned long long kt = key[t];
        rank += (kt > ks) | ((kt == ks) & (t < s));
      }
      cost[rank] = 1 << (maxlog - l);
    }
    __syncthreads();
    if (s == 0) {
      const long long t0 = stats ? clock64() : 0;
      int i = 0;
      bool took = false;
      while (i < n) {
        const int c = cost[i];
        const bool tk = c <= d;
        d -= tk ? c : 0;
        took |= tk;
        take[i++] = tk;
        if (d == 0) break;
      }
      walked = i;
      again = d > 0 && took;
      steps += i;
      if (stats) cycles += clock64() - t0;
    }
    __syncthreads();
    if (elig && rank < walked) l -= take[rank];
    more = again;
  }
  const int mb = block_reduce<int>(l, red32, Max());
  nbits[row * HB_SYMS + s] = l;
  if (s == 0) {
    max_bits[row] = mb;
    ok[row] = d == 0 && nz >= 2;
    if (stats) {
      stats[2 * row] = steps;
      stats[2 * row + 1] = cycles;
    }
  }
}

template <typename C>
__global__ void __launch_bounds__(NC_MAX)
normalize_count_kernel(const C* __restrict__ hist, int nsym, int log,
                       int* __restrict__ norm_out,
                       long long* __restrict__ stats) {
  __shared__ long long key[NC_MAX];   // remainders, or the counts
  __shared__ long long vals[NC_MAX];  // the counts in rank order
  __shared__ unsigned long long red64[NC_MAX / 32];
  const int s = threadIdx.x;
  const bool in = s < nsym;
  const size_t row = blockIdx.x;
  const long long h = in ? (long long)hist[row * nsym + s] : 0;
  const long long size = 1ll << log;
  const long long total = max((long long)block_reduce<unsigned long long>(
      (unsigned long long)h, red64, Sum()), 1ll);
  const bool present = h > 0;
  const long long scaled =
      (long long)((unsigned long long)h * (unsigned long long)size);
  const long long base = floor_div(scaled, total);
  const long long rem = scaled - base * total;
  long long norm = present ? max(base, 1ll) : 0;
  const long long diff = size - (long long)block_reduce<unsigned long long>(
      (unsigned long long)norm, red64, Sum());
  long long steps = 0, cycles = 0;
  if (diff > 0) {
    // the surplus, one each to the largest remainders (fewer than the
    // symbols present, so no walk)
    key[s] = present ? rem : -1;
    __syncthreads();
    if (present) {
      int rank = 0;
      for (int t = 0; t < nsym; ++t) {
        const long long kt = key[t];
        rank += (kt > rem) | ((kt == rem) & (t < s));
      }
      norm += rank < diff;
    }
  } else if (diff < 0) {
    // the deficit, stolen from the counts in descending order
    key[s] = norm;
    __syncthreads();
    int rank = 0;
    if (in) {
      for (int t = 0; t < nsym; ++t) {
        const long long kt = key[t];
        rank += (kt > norm) | ((kt == norm) & (t < s));
      }
      vals[rank] = norm;
    }
    __syncthreads();
    if (s == 0) {
      const long long t0 = stats ? clock64() : 0;
      long long d = -diff;
      int i = 0;
      while (i < nsym) {
        const long long c = vals[i];
        const long long tk = min(max(c - 1, 0ll), d);
        d -= tk;
        vals[i++] = c - tk;
        if (d == 0) break;
      }
      steps = i;
      if (stats) cycles = clock64() - t0;
    }
    __syncthreads();
    if (in) norm = vals[rank];
  }
  if (in) norm_out[row * nsym + s] = (int)norm;
  if (s == 0 && stats) {
    stats[2 * row] = steps;
    stats[2 * row + 1] = cycles;
  }
}

template <typename C>
int huff_launch(const void* hist, int J, int maxlog, int* nbits,
                int* max_bits, uint8_t* ok, long long* stats,
                cudaStream_t stream) {
  huff_build_kernel<C><<<J, HB_SYMS, 0, stream>>>(
      static_cast<const C*>(hist), maxlog, nbits, max_bits, ok, stats);
  return (int)cudaGetLastError();
}

template <typename C>
int normalize_launch(const void* hist, int N, int nsym, int log, int* norm,
                     long long* stats, cudaStream_t stream) {
  const int threads = (nsym + 31) / 32 * 32;
  normalize_count_kernel<C><<<N, threads, 0, stream>>>(
      static_cast<const C*>(hist), nsym, log, norm, stats);
  return (int)cudaGetLastError();
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
  if (J < 0 || maxlog < 1 || maxlog > 15) return (int)cudaErrorInvalidValue;
  if (J == 0) return 0;
  switch (kind) {
    case 3: return huff_launch<int32_t>(hist, J, maxlog, nbits, max_bits, ok,
                                        stats, stream);
    case 4: return huff_launch<long long>(hist, J, maxlog, nbits, max_bits,
                                          ok, stats, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// hist: (N, nsym) counts, contiguous, kind 3 int32 or 4 int64; nsym
// 1..1024; log 1..30; norm (N, nsym) int32; stats: null, or (N, 2) int64
// that gets each row's deficit-walk steps and its SM cycles (0 and 0 for
// a row with no deficit).
int ct_normalize_count(const void* hist, int kind, int N, int nsym, int log,
                       int* norm, long long* stats, cudaStream_t stream) {
  if (N < 0 || nsym < 1 || nsym > NC_MAX || log < 1 || log > 30)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  switch (kind) {
    case 3: return normalize_launch<int32_t>(hist, N, nsym, log, norm, stats,
                                             stream);
    case 4: return normalize_launch<long long>(hist, N, nsym, log, norm,
                                               stats, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: the Huffman build's registers, static shared bytes and CTAs an SM,
// then the normalisation's at 256 symbols (int64 counts).
int ct_tablebuild_info(int* out) {
  cudaFuncAttributes a{}, b{};
  int na = 0, nb = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, huff_build_kernel<long long>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&b, normalize_count_kernel<long long>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &na, huff_build_kernel<long long>, HB_SYMS, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, normalize_count_kernel<long long>, 256, 0);
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
