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
// rows of 16 KiB, 0.005 ms at 3.35 TB/s).  Above it, the shared-memory
// instructions a byte, which share one pipe of the SM.  The first design
// did one shared-memory atomic a byte into counters a warp: about 5 SM
// cycles a warp-wide atomic, whatever the bytes (zeros, rand4 and rand256
// rows took the same 0.0154-0.0156 ms: contention costs nothing on this
// card, a warp's atomics to one address take one pass).  A private
// counter's load and store take about 3.3 cycles a warp, so the atomics
// went; what the private counters cost instead is zeroing and merging
// 256 bytes of them a thread, which sets the layout below.
//
// Design.  Every thread counts into 256 counters of its own, 8 bits wide:
// a byte is an ordinary shared load, add and store of one byte, no atomic.
// Thread tid of a CTA of T threads keeps bin b in byte b & 3 of shared
// word (b >> 2) * T + tid, so the lanes of a warp touch 32 different banks
// whatever bytes they read.  A counter must not pass 255: in a pass a
// thread reads at most 16 of its 16-byte words (256 bytes), and the first
// byte of each pass, and the head and tail bytes of a row off a 16-byte
// boundary (one a thread), go to the CTA's 256 totals with a shared-memory
// atomic instead (at most T + 30 a pass of 256 T bytes).  A pass ends in a
// merge: thread t reads the 64 counter words from 64 t (four bins of 64
// threads) 16 bytes at a time, rotated by lane so that a quarter-warp
// meets no bank twice, sums them as 16-bit pairs (at most 64 x 255) and
// adds them into the totals; a row longer than a pass zeroes its counters
// as it merges.  A lane reads 16 bytes at a time, H_UNROLL words in flight
// (the next iteration's loaded before the current are counted, but for a
// mask's at 64 threads a row); a warp skips words with no live mask byte.
// Per-row entry: a CTA a row writes its 256 totals.  The counters are
// 256 T bytes a CTA to zero and merge, and a batch runs fastest in one
// wave: T = 64 (16 KiB of counters, no more than a 16 KiB row; 12 CTAs an
// SM, so 1024 rows run at once), or 128 for a batch the card holds at
// once (fewer, longer rows) where a CTA still has two iterations of
// words.  Whole-input entry: a grid of CTAs
// of 256 threads, at most the CTAs the card holds, takes a strided share
// of the 16-byte words a CTA and adds its 256 totals into the zeroed
// result with one atomicAdd a bin (a warp's 32 bins one line, each CTA
// starting on another line); counts wrap modulo 2^32, as the int32 result
// of the plain version does.
//
// A build with -DCT_BYTE_HIST_CLOCK also has `ct_byte_histograms_clock`,
// which writes a CTA's SM cycles by part (zero, count, merge, in all), its
// SM and its start and end on the global timer.
#include <type_traits>

#include "ct_common.cuh"

namespace {

constexpr int H_UNROLL = 4;   // 16-byte words a lane loads at a time
constexpr uint32_t H_NONE = 256;  // a value that is not counted

#ifdef CT_BYTE_HIST_CLOCK
constexpr bool H_CLOCK = true;
#else
constexpr bool H_CLOCK = false;
#endif
constexpr int H_CLK = 7;  // int64 a CTA of the clock build's record

// A CTA of T threads: its shared bytes (256 counters a thread, 256
// totals) and the CTAs an SM its launch bound asks for.
template <int T>
constexpr int H_SMEM = 256 * T + 1024;
template <int T>
constexpr int H_CTAS = 768 / T;

// Iterations of H_UNROLL words a pass, for V values a word: 256 values a
// thread, the first of which goes to the totals.
template <int V>
constexpr int H_PASS = 256 / (H_UNROLL * V);

__device__ __forceinline__ uint32_t word_at(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// value k of the 16 bytes w read as E: its bin, or H_NONE outside 0..255
template <typename E>
__device__ __forceinline__ uint32_t value_at(const uint4& w, int k) {
  if constexpr (sizeof(E) == 8) {
    const uint32_t lo = word_at(w, 2 * k), hi = word_at(w, 2 * k + 1);
    return hi == 0 && lo < 256 ? lo : H_NONE;
  } else if constexpr (sizeof(E) == 4) {
    const uint32_t u = word_at(w, k);
    return u < 256 ? u : H_NONE;
  } else {
    const uint32_t u = (word_at(w, k >> 1) >> (16 * (k & 1))) & 0xFFFFu;
    return u < 256 ? u : H_NONE;
  }
}

template <typename E>
__device__ __forceinline__ uint32_t bin_of(E x) {
  if constexpr (std::is_unsigned<E>::value)
    return (uint32_t)x;
  else
    return x >= 0 && x < 256 ? (uint32_t)x : H_NONE;
}

// byte k of x, alone
__device__ __forceinline__ uint32_t byte_of(uint32_t x, int k) {
  return __byte_perm(x, 0u, 0x4440u + k);
}

// thread `mine`'s counter of bin b: byte b & 3 of word (b >> 2) T + tid,
// that is byte b + (b & ~3) (T - 1) from the thread's first
template <int T>
__device__ __forceinline__ uint8_t* counter(uint8_t* mine, uint32_t b) {
  return mine + b + (b & 0xFCu) * (T - 1);
}

// Count the four bytes of x; with MASKED only those whose byte of y is
// not 0; with FIRST byte 0 into the totals.
template <int T, bool MASKED, bool FIRST = false>
__device__ __forceinline__ void bump4(uint8_t* mine, uint32_t x, uint32_t y,
                                      uint32_t* tot) {
  if (FIRST && (!MASKED || byte_of(y, 0)))
    atomicAdd(tot + byte_of(x, 0), 1u);
#pragma unroll
  for (int k = FIRST ? 1 : 0; k < 4; ++k)  // a select, no branch
    *counter<T>(mine, byte_of(x, k)) += !MASKED || byte_of(y, k) ? 1 : 0;
}

// the counters and the totals
template <int T>
__device__ __forceinline__ void zero_counters(uint4* sh) {
  for (int i = threadIdx.x; i < H_SMEM<T> / 16; i += T)
    sh[i] = make_uint4(0, 0, 0, 0);
}

// Add the counters into the totals (after a barrier); with ZERO also zero
// them.  Thread t reads the 64 counter words from 64 t (of bin group
// 64 t / T: bins 4g..4g+3 of 64 threads) 16 bytes at a time, rotated by
// lane so that a quarter-warp meets no bank twice.
template <int T, bool ZERO>
__device__ __forceinline__ void merge(uint4* sh, uint32_t* tot) {
  const int t = threadIdx.x, lane = t & 31;
  uint4* base = sh + 16 * t;
  uint32_t lo = 0, hi = 0;  // bytes 0 and 2, 1 and 3, as 16-bit pairs
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = (i + lane) & 15;
    const uint4 v = base[j];
    if (ZERO) base[j] = make_uint4(0, 0, 0, 0);
    lo += (v.x & 0x00FF00FFu) + (v.y & 0x00FF00FFu) + (v.z & 0x00FF00FFu) +
          (v.w & 0x00FF00FFu);
    hi += ((v.x >> 8) & 0x00FF00FFu) + ((v.y >> 8) & 0x00FF00FFu) +
          ((v.z >> 8) & 0x00FF00FFu) + ((v.w >> 8) & 0x00FF00FFu);
  }
  uint32_t* b = tot + 4 * (64 * t / T);
  if (T == 64) {  // the group's bins are this thread's alone
    b[0] += lo & 0xFFFFu;
    b[1] += hi & 0xFFFFu;
    b[2] += lo >> 16;
    b[3] += hi >> 16;
  } else {
    atomicAdd(b, lo & 0xFFFFu);
    atomicAdd(b + 1, hi & 0xFFFFu);
    atomicAdd(b + 2, lo >> 16);
    atomicAdd(b + 3, hi >> 16);
  }
}

struct Clock {
  long long start = 0, mark = 0, part[3] = {0, 0, 0}, ns = 0;
  __device__ __forceinline__ static long long now_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ __forceinline__ void begin() {
    if (H_CLOCK && threadIdx.x == 0) {
      ns = now_ns();
      start = mark = clock64();
    }
  }
  // close part i (0 zero, 1 count, 2 merge) after a barrier
  __device__ __forceinline__ void close(int i) {
    if (H_CLOCK && threadIdx.x == 0) {
      const long long now = clock64();
      part[i] += now - mark;
      mark = now;
    }
  }
  // the parts, in all, the SM, the global start and end (ns)
  __device__ __forceinline__ void write(long long* clk) {
    if (H_CLOCK && threadIdx.x == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      long long* c = clk + H_CLK * (size_t)blockIdx.x;
      c[0] = part[0];
      c[1] = part[1];
      c[2] = part[2];
      c[3] = mark - start;
      c[4] = sm;
      c[5] = ns;
      c[6] = now_ns();
    }
  }
};

// A CTA of T threads a row.  mask: null, or N rows `mstride` apart
// whose address is the row's modulo 16.  clk: a CTA's record (clock build
// only).
template <int T, bool MASKED>
__global__ void __launch_bounds__(T, H_CTAS<T>)
    row_hist_kernel(const uint8_t* __restrict__ rows, long long stride, int L,
                    const uint8_t* __restrict__ mask, long long mstride,
                    int* __restrict__ out, long long* __restrict__ clk) {
  constexpr int U = H_UNROLL, P = H_PASS<16>;
  // the next words loaded before these are counted, but for a mask's
  // words at 64 threads (its 12 CTAs an SM gain nothing from them)
  constexpr bool PREFETCH = !MASKED || T == 128;
  extern __shared__ uint4 h_sh[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  Clock ck;
  ck.begin();
  uint8_t* mine = reinterpret_cast<uint8_t*>(h_sh) + 4 * t;
  uint32_t* tot = reinterpret_cast<uint32_t*>(h_sh) + 64 * T;
  const uint8_t* row = rows + (size_t)blockIdx.x * (size_t)stride;
  const uint8_t* mrow = MASKED ? mask + (size_t)blockIdx.x * (size_t)mstride
                               : nullptr;
  const int head =
      min(L, (int)((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15));
  const int nw = (L - head) >> 4;
  const int tail = head + 16 * nw;
  // iteration k: warp w takes the 32 U words from k T U + 32 U w, lane l
  // word 32 u + l of them
  const int iters = (nw + T * U - 1) / (T * U);
  const uint4* w4 = reinterpret_cast<const uint4*>(row + head);
  const uint4* m4 =
      MASKED ? reinterpret_cast<const uint4*>(mrow + head) : nullptr;
  const int c_lane = warp * 32 * U + lane;
  uint4 w[U], m[U];
  auto load = [&](int k, uint4 (&a)[U], uint4 (&b)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c_lane + k * T * U + 32 * u;
      a[u] = b[u] = make_uint4(0, 0, 0, 0);
      if (c < nw) {
        a[u] = __ldg(w4 + c);
        if (MASKED) b[u] = __ldg(m4 + c);
      }
    }
  };
  load(0, w, m);
  zero_counters<T>(h_sh);
  __syncthreads();
  ck.close(0);
  // the head and tail bytes, one a thread
  if (t < head && (!MASKED || mrow[t])) atomicAdd(tot + row[t], 1u);
  if (t < L - tail && (!MASKED || mrow[tail + t]))
    atomicAdd(tot + row[tail + t], 1u);
  for (int k = 0; k < iters; ++k) {
    uint4 nx[U], nm[U];
    if (PREFETCH) load(k + 1, nx, nm);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c_lane + k * T * U + 32 * u;
      const bool live =
          c < nw && (!MASKED || (m[u].x | m[u].y | m[u].z | m[u].w));
      if (!__any_sync(0xffffffffu, live)) continue;
      if (live) {
        if (u == 0 && k % P == 0)  // a pass's first byte: to the totals
          bump4<T, MASKED, true>(mine, w[u].x, m[u].x, tot);
        else
          bump4<T, MASKED>(mine, w[u].x, m[u].x, tot);
        bump4<T, MASKED>(mine, w[u].y, m[u].y, tot);
        bump4<T, MASKED>(mine, w[u].z, m[u].z, tot);
        bump4<T, MASKED>(mine, w[u].w, m[u].w, tot);
      }
    }
    if ((k + 1) % P == 0 && k + 1 < iters) {  // a pass ends: merge, zero
      __syncthreads();
      ck.close(1);
      merge<T, true>(h_sh, tot);
      __syncthreads();
      ck.close(2);
    }
    if (PREFETCH) {
#pragma unroll
      for (int u = 0; u < U; ++u) w[u] = nx[u], m[u] = nm[u];
    } else {
      load(k + 1, w, m);
    }
  }
  __syncthreads();
  ck.close(1);
  merge<T, false>(h_sh, tot);
  __syncthreads();
  ck.close(2);
  int* o = out + (size_t)blockIdx.x * 256;
  for (int i = t; i < 256; i += T) o[i] = (int)tot[i];
  if (H_CLOCK && clk) ck.write(clk);
}

// A grid-strided share of the input a CTA of T threads; out zeroed before
// the launch.
template <int T, typename E>
__global__ void __launch_bounds__(T, H_CTAS<T>)
    hist256_kernel(const E* __restrict__ x, long long numel,
                   int* __restrict__ out) {
  constexpr int U = H_UNROLL, V = 16 / sizeof(E), P = H_PASS<V>;
  extern __shared__ uint4 h_sh[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint8_t* mine = reinterpret_cast<uint8_t*>(h_sh) + 4 * t;
  uint32_t* tot = reinterpret_cast<uint32_t*>(h_sh) + 64 * T;
  const long long head = min(
      numel,
      (long long)(((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) /
                  sizeof(E)));
  const long long nw = (numel - head) / V;
  const long long tail = head + nw * V;
  const uint4* w4 = reinterpret_cast<const uint4*>(x + head);
  // iteration k: CTA b's words from (k grid + b) T U, warp w's 32 U of
  // them from 32 U w, lane l word 32 u + l
  const long long per = (long long)T * U;
  const long long first = (long long)blockIdx.x * per;
  const long long step = (long long)gridDim.x * per;
  const int iters = first < nw ? (int)((nw - first + step - 1) / step) : 0;
  const long long c_lane = first + warp * 32 * U + lane;
  uint4 w[U];
  auto load = [&](int k, uint4 (&a)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = c_lane + k * step + 32 * u;
      a[u] = c < nw ? __ldg(w4 + c) : make_uint4(0, 0, 0, 0);
    }
  };
  load(0, w);
  zero_counters<T>(h_sh);
  __syncthreads();
  if (blockIdx.x == 0) {  // the head and tail elements, one a thread
    const uint32_t a = t < head ? bin_of(x[t]) : H_NONE;
    if (a != H_NONE) atomicAdd(tot + a, 1u);
    const uint32_t b = t < numel - tail ? bin_of(x[tail + t]) : H_NONE;
    if (b != H_NONE) atomicAdd(tot + b, 1u);
  }
  for (int k = 0; k < iters; ++k) {
    uint4 nx[U];
    load(k + 1, nx);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c_lane - lane + k * step + 32 * u >= nw) break;  // the warp's
      if (c_lane + k * step + 32 * u >= nw) continue;
      const bool lead = u == 0 && k % P == 0;  // a pass's first value
      if constexpr (sizeof(E) == 1) {
        constexpr bool SIGNED = std::is_signed<E>::value;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = word_at(w[u], j);
          const uint32_t y = SIGNED ? ~v & 0x80808080u : 0u;  // bytes < 128
          if (j == 0 && lead)
            bump4<T, SIGNED, true>(mine, v, y, tot);
          else
            bump4<T, SIGNED>(mine, v, y, tot);
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const uint32_t v = value_at<E>(w[u], j);
          if (v == H_NONE) continue;
          if (j == 0 && lead)
            atomicAdd(tot + v, 1u);
          else
            *counter<T>(mine, v) += 1;
        }
      }
    }
    if ((k + 1) % P == 0 && k + 1 < iters) {  // a pass ends: merge, zero
      __syncthreads();
      merge<T, true>(h_sh, tot);
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < U; ++u) w[u] = nx[u];
  }
  __syncthreads();
  merge<T, false>(h_sh, tot);
  __syncthreads();
  // a warp's 32 bins are one line; CTAs start on different lines
  unsigned* o = reinterpret_cast<unsigned*>(out);
  for (int i = t; i < 256; i += T) {
    const int bin = (i + 32 * blockIdx.x) & 255;
    if (tot[bin]) atomicAdd(o + bin, tot[bin]);
  }
}

// Let kernel K of T threads take its shared bytes on the current device
// (before each launch: the attribute is the device's).
template <int T, auto K>
cudaError_t prepare() {
  return H_SMEM<T> > 48 * 1024
             ? cudaFuncSetAttribute(
                   K, cudaFuncAttributeMaxDynamicSharedMemorySize, H_SMEM<T>)
             : cudaSuccess;
}

// CTAs of kernel K of T threads the current device holds at once (the
// CTAs an SM queried once).
template <int T, auto K>
int slots() {
  static const int per = [] {
    int n = 0;
    if (prepare<T, K>() == cudaSuccess)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, K, T, H_SMEM<T>);
    return n;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per * (sms > 0 ? sms : 1);
}

// Threads a row for N rows of L bytes: 128 where the batch still runs in
// one wave of CTAs and a CTA has two iterations of words, else 64 (16 KiB
// of counters a CTA, 12 CTAs an SM).
int row_threads(int N, int L) {
  return N <= slots<128, row_hist_kernel<128, false>>() &&
                 L / 16 >= 2 * 128 * H_UNROLL
             ? 128
             : 64;
}

template <int T>
int rows_launch_t(const uint8_t* rows, long long stride, int N, int L,
                  const uint8_t* mask, long long mstride, int* out,
                  long long* clk, cudaStream_t stream) {
  if (mask)
    row_hist_kernel<T, true><<<N, T, H_SMEM<T>, stream>>>(
        rows, stride, L, mask, mstride, out, clk);
  else
    row_hist_kernel<T, false><<<N, T, H_SMEM<T>, stream>>>(
        rows, stride, L, nullptr, 0, out, clk);
  return (int)cudaGetLastError();
}

int rows_launch(const uint8_t* rows, long long stride, int N, int L,
                const uint8_t* mask, long long mstride, int* out,
                long long* clk, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (L < 0) return (int)cudaErrorInvalidValue;
  return row_threads(N, L) == 128
             ? rows_launch_t<128>(rows, stride, N, L, mask, mstride, out, clk,
                                  stream)
             : rows_launch_t<64>(rows, stride, N, L, mask, mstride, out, clk,
                                 stream);
}

// The whole input: CTAs of 256 threads, an iteration of words each at
// least, at most the CTAs the card holds at once.
template <typename E>
int hist256_launch(const void* x, long long numel, int* out,
                   cudaStream_t stream) {
  constexpr int T = 256;
  const cudaError_t e = prepare<T, hist256_kernel<T, E>>();
  if (e != cudaSuccess) return (int)e;
  const long long words = numel * (long long)sizeof(E) / 16;
  long long grid = (words + T * H_UNROLL - 1) / (T * H_UNROLL);
  const int most = slots<T, hist256_kernel<T, E>>();
  grid = grid < most ? grid : most;
  grid = grid > 1 ? grid : 1;
  hist256_kernel<T, E><<<(int)grid, T, H_SMEM<T>, stream>>>(
      static_cast<const E*>(x), numel, out);
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
  return rows_launch(rows, stride, N, L, mask, mstride, out, nullptr,
                     stream);
}

#ifdef CT_BYTE_HIST_CLOCK
// As ct_byte_histograms; clk (N, 7) int64: a CTA's SM cycles zeroing its
// counters, counting, merging, and in all; its SM; its start and end on
// the global timer (ns).
int ct_byte_histograms_clock(const uint8_t* rows, long long stride, int N,
                             int L, const uint8_t* mask, long long mstride,
                             int* out, long long* clk, cudaStream_t stream) {
  return rows_launch(rows, stride, N, L, mask, mstride, out, clk, stream);
}
#endif

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

// out, for N rows of L bytes: the per-row launch's threads a CTA, its
// CTAs an SM (unmasked), registers (unmasked, masked), shared bytes a
// CTA, and the CTAs the card holds at once.
int ct_histogram_info(int N, int L, int* out) {
  const int T = N > 0 && L >= 0 ? row_threads(N, L) : 64;
  cudaFuncAttributes a{}, b{};
  int n = 0, smem = 0;
  cudaError_t e = cudaSuccess;
  auto query = [&](auto kf, auto kt, int threads, int bytes) {
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kf);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&b, kt);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kf, threads,
                                                        bytes);
    smem = bytes;
  };
  if (T == 128)
    query(row_hist_kernel<128, false>, row_hist_kernel<128, true>, 128,
          H_SMEM<128>);
  else
    query(row_hist_kernel<64, false>, row_hist_kernel<64, true>, 64,
          H_SMEM<64>);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = T;
  out[1] = n;
  out[2] = a.numRegs;
  out[3] = b.numRegs;
  out[4] = (int)a.sharedSizeBytes + smem;
  out[5] = n * sms;
  return 0;
}

}  // extern "C"
