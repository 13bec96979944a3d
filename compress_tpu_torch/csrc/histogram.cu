// Byte histograms: the 256-bin count of each row of a batch of byte rows
// (with an optional mask), and the 256-bin count of a whole input of any
// integer type.
//
// Replaces: compress_tpu/utils/histogram.py `histogram256_jax` (:22, a
// lax.scan of one-hot compares over 16 KiB segments) and the per-row
// one-hot einsums of compress_tpu/ops/entropy.py:175-177 (`fse_encode_blocks`),
// zenc2.py:257 (the v2 literal stage, masked by the literal count) and
// zdev.py:619-620 (the v1 engine's literals, masked by `lit`).  Those are
// XLA reductions, not Pallas kernels; this is a kernel of their own.
//
// Function.  `ct_byte_histograms`: for each of N rows of L bytes (`stride`
// bytes apart, any address), the count of each byte value among the bytes
// whose mask byte is not 0 (every byte without a mask), as int32.
// `ct_histogram256`: the count of each value 0..255 among `numel` elements
// of uint8, int8, int16, int32 or int64 (values outside 0..255 are not
// counted), as int32.
//
// Bound on the H100: memory (each input byte read once: 16.8 MB for 1024
// rows of 16 KiB, 0.005 ms at 3.35 TB/s).  What is left above it is the
// shared-memory atomics, one a byte (16.8 million for those rows).  The
// hazard the design had to answer was contention: in a row of one value
// (zeros) or of few (rand4, period3, period7) the lanes of a warp all
// count into one or a few counters.
//
// Design.  Each warp has 256 int32 counters in shared memory, updated with
// one shared-memory atomic a byte and merged once a CTA.  A lane reads 16
// bytes at a time (H_UNROLL words in flight); the head and tail bytes of a
// row that does not start on a 16-byte boundary, or is not a whole number
// of 16 bytes, are counted one a thread.  Per-row entry: a CTA a row
// writes its 256 counts.  Whole-input entry: a grid sized to the SMs takes
// a strided share of the 16-byte words a CTA and adds its 256 partial
// counts into the zeroed result with one atomicAdd a bin (integers, so the
// order does not matter); counts wrap modulo 2^32, as the int32 result of
// the plain version does.
//
// Contention.  On the H100 a warp's shared-memory atomics to one address
// take no more time than to 32 addresses: 1024 rows of zeros, of rand4 and
// of rand256 each took the same device time (PERF.md §6 keeps the A/B
// numbers of the layouts below).  So
// the lanes do not merge equal bytes before their atomics: merging the
// runs of a lane's 16 bytes, merging equal values across the warp
// (__match_any_sync), both, and four copies of a warp's counters were
// each measured slower on the mixed rows and on every class but zeros.
#include <type_traits>

#include "ct_common.cuh"

namespace {

constexpr int H_THREADS = 256;
constexpr int H_WARPS = H_THREADS / 32;
constexpr int H_UNROLL = 4;  // 16-byte words a lane loads before it counts
constexpr int H_WORDS = H_WARPS * 256;
constexpr uint32_t H_NONE = 256;  // a value that is not counted

__device__ __forceinline__ uint32_t word_at(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// value k of the 16 bytes w read as T: its bin, or H_NONE outside 0..255
template <typename T>
__device__ __forceinline__ uint32_t value_at(const uint4& w, int k) {
  if constexpr (sizeof(T) == 8) {
    const uint32_t lo = word_at(w, 2 * k), hi = word_at(w, 2 * k + 1);
    return hi == 0 && lo < 256 ? lo : H_NONE;
  } else if constexpr (sizeof(T) == 4) {
    const uint32_t u = word_at(w, k);
    return u < 256 ? u : H_NONE;
  } else if constexpr (sizeof(T) == 2) {
    const uint32_t u = (word_at(w, k >> 1) >> (16 * (k & 1))) & 0xFFFFu;
    return u < 256 ? u : H_NONE;
  } else {
    const uint32_t u = (word_at(w, k >> 2) >> (8 * (k & 3))) & 0xFFu;
    return std::is_signed<T>::value && u >= 128 ? H_NONE : u;
  }
}

template <typename T>
__device__ __forceinline__ uint32_t bin_of(T x) {
  if constexpr (std::is_unsigned<T>::value)
    return (uint32_t)x;
  else
    return x >= 0 && x < 256 ? (uint32_t)x : H_NONE;
}

// Count one lane's V values (H_NONE: not counted) into its warp's
// counters h: an atomic a value.
template <int V>
__device__ __forceinline__ void count_values(uint32_t* h,
                                             const uint32_t (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (v[k] != H_NONE) atomicAdd(h + v[k], 1u);
}

__device__ __forceinline__ void zero_counters(uint32_t* sh) {
  for (int i = threadIdx.x; i < H_WORDS; i += H_THREADS) sh[i] = 0;
  __syncthreads();
}

// bin t summed over the CTA's counters (after a barrier)
__device__ __forceinline__ uint32_t merged(const uint32_t* sh, int t) {
  uint32_t s = 0;
#pragma unroll
  for (int w = 0; w < H_WARPS; ++w) s += sh[w * 256 + t];
  return s;
}

// One CTA a row.  mask: null, or N rows `mstride` apart whose address is
// the row's modulo 16.
template <bool MASKED>
__global__ void __launch_bounds__(H_THREADS)
    row_hist_kernel(const uint8_t* __restrict__ rows, long long stride, int L,
                    const uint8_t* __restrict__ mask, long long mstride,
                    int* __restrict__ out) {
  __shared__ uint32_t sh[H_WORDS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  zero_counters(sh);
  uint32_t* h = sh + warp * 256;
  const uint8_t* row = rows + (size_t)blockIdx.x * (size_t)stride;
  const uint8_t* mrow = MASKED ? mask + (size_t)blockIdx.x * (size_t)mstride
                               : nullptr;
  const int head =
      min(L, (int)((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
  const int nw = (L - head) >> 4;
  const int tail = head + 16 * nw;
  if (t < head && (!MASKED || mrow[t])) atomicAdd(h + row[t], 1u);
  if (t < L - tail && (!MASKED || mrow[tail + t]))
    atomicAdd(h + row[tail + t], 1u);
  const uint4* w4 = reinterpret_cast<const uint4*>(row + head);
  const uint4* m4 =
      MASKED ? reinterpret_cast<const uint4*>(mrow + head) : nullptr;
  // warp w takes 32 H_UNROLL consecutive words of every H_THREADS H_UNROLL
  for (int c0 = warp * 32 * H_UNROLL; c0 < nw; c0 += H_THREADS * H_UNROLL) {
    uint4 w[H_UNROLL], m[H_UNROLL];
#pragma unroll
    for (int u = 0; u < H_UNROLL; ++u) {
      const int c = c0 + 32 * u + lane;
      w[u] = m[u] = make_uint4(0, 0, 0, 0);
      if (c < nw) {
        w[u] = __ldg(w4 + c);
        if (MASKED) m[u] = __ldg(m4 + c);
      }
    }
#pragma unroll
    for (int u = 0; u < H_UNROLL; ++u) {
      const int c = c0 + 32 * u + lane;
      const bool live =
          c < nw && (!MASKED || (m[u].x | m[u].y | m[u].z | m[u].w));
      if (!__any_sync(0xffffffffu, live)) continue;
      uint32_t v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const bool on =
            live && (!MASKED || ((word_at(m[u], k >> 2) >> (8 * (k & 3))) &
                                 0xFFu));
        v[k] = on ? value_at<uint8_t>(w[u], k) : H_NONE;
      }
      count_values(h, v);
    }
  }
  __syncthreads();
  out[(size_t)blockIdx.x * 256 + t] = (int)merged(sh, t);
}

// A grid-strided share of the input a CTA; out zeroed before the launch.
template <typename T>
__global__ void __launch_bounds__(H_THREADS)
    hist256_kernel(const T* __restrict__ x, long long numel,
                   int* __restrict__ out) {
  constexpr int V = 16 / sizeof(T);
  __shared__ uint32_t sh[H_WORDS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  zero_counters(sh);
  uint32_t* h = sh + warp * 256;
  const long long head = min(
      numel,
      (long long)(((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) /
                  sizeof(T)));
  const long long nw = (numel - head) / V;
  const long long tail = head + nw * V;
  if (blockIdx.x == 0) {
    const uint32_t a = t < head ? bin_of(x[t]) : H_NONE;
    if (a != H_NONE) atomicAdd(h + a, 1u);
    const uint32_t b = t < numel - tail ? bin_of(x[tail + t]) : H_NONE;
    if (b != H_NONE) atomicAdd(h + b, 1u);
  }
  const uint4* w4 = reinterpret_cast<const uint4*>(x + head);
  const long long step = (long long)gridDim.x * H_THREADS * H_UNROLL;
  for (long long c0 = ((long long)blockIdx.x * H_WARPS + warp) * 32 *
                      H_UNROLL;
       c0 < nw; c0 += step) {
    uint4 w[H_UNROLL];
#pragma unroll
    for (int u = 0; u < H_UNROLL; ++u) {
      const long long c = c0 + 32 * u + lane;
      w[u] = c < nw ? __ldg(w4 + c) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < H_UNROLL; ++u) {
      const bool live = c0 + 32 * u + lane < nw;
      uint32_t v[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = live ? value_at<T>(w[u], k) : H_NONE;
      count_values(h, v);
    }
  }
  __syncthreads();
  const uint32_t s = merged(sh, t);
  if (s) atomicAdd(reinterpret_cast<unsigned*>(out) + t, s);
}

template <typename T>
int hist256_launch(const void* x, long long numel, int* out,
                   cudaStream_t stream) {
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, hist256_kernel<T>,
                                                  H_THREADS, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long words = numel * (long long)sizeof(T) / 16;
  const long long need =
      (words + H_THREADS * H_UNROLL - 1) / (H_THREADS * H_UNROLL);
  const long long most = (long long)(sms > 0 ? sms : 1) * per_sm;
  const int grid = (int)(need < 1 ? 1 : need < most ? need : most);
  hist256_kernel<T><<<grid, H_THREADS, 0, stream>>>(
      static_cast<const T*>(x), numel, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows: N rows of L bytes `stride` bytes apart, any address; mask: null, or
// N rows of L bytes (nonzero: counted) `mstride` apart, each at the address
// of its row modulo 16; out (N, 256) int32.
int ct_byte_histograms(const uint8_t* rows, long long stride, int N, int L,
                       const uint8_t* mask, long long mstride, int* out,
                       cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  if (mask)
    row_hist_kernel<true><<<N, H_THREADS, 0, stream>>>(rows, stride, L, mask,
                                                       mstride, out);
  else
    row_hist_kernel<false><<<N, H_THREADS, 0, stream>>>(rows, stride, L,
                                                        nullptr, 0, out);
  return (int)cudaGetLastError();
}

// x: numel elements of kind 0 uint8, 1 int8, 2 int16, 3 int32 or 4 int64,
// contiguous, at an address aligned to the element; out (256,) int32,
// zeroed here.
int ct_histogram256(const void* x, long long numel, int kind, int* out,
                    cudaStream_t stream) {
  if (numel < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(out, 0, 256 * sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  switch (kind) {
    case 0: return hist256_launch<uint8_t>(x, numel, out, stream);
    case 1: return hist256_launch<int8_t>(x, numel, out, stream);
    case 2: return hist256_launch<int16_t>(x, numel, out, stream);
    case 3: return hist256_launch<int32_t>(x, numel, out, stream);
    case 4: return hist256_launch<long long>(x, numel, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
