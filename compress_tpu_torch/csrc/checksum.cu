// Batched CRC-32C and xxHash64 of equal-length rows.
//
// Replaces: compress_tpu/ops/checksum.py `crc32c_batch` (:84, GF(2) matrix
// products on the MXU) and `xxh64_batch` (:242, a lax.scan over 32-byte
// stripes, :272, in 16-bit limbs).  Both are XLA functions, not Pallas
// kernels; each is ported as a kernel of its own.
//
// CRC-32C (`ct_crc32c_batch`).  Function: for each row r of `rows` (B rows
// `stride` bytes apart), the CRC-32C (initial and final 0xFFFFFFFF) of its
// first n bytes, as int64.  Polynomial products are in the reflected form
// (bit 31 holds x^0).
//
// Design: a CTA of 256 threads a row; thread t takes chunk t of 256 chunks
// of lc bytes aligned to the end of the n bytes, [n - (256 - t) lc, n -
// (255 - t) lc).  Bytes before 0 are leading zeros, which leave a raw CRC
// (state 0, no conditioning) at 0, so a chunk cut at 0 still counts as lc
// bytes.  A CRC is linear, so the row's raw CRC is the XOR over t of
// raw(chunk t) * x^(8 lc (255 - t)) mod P: the host passes those 256
// shift constants (a device buffer cached per n), each thread makes one
// product, and the CTA XORs the 256 terms (a warp reduction, then 8 words
// in shared memory and one barrier); the conditioning is one xor with the
// host's constant for n.  The slicing-by-8 tables (8 KiB) are a constant of
// the device image, copied into shared memory by 16-byte cp.async while
// the first 16-byte words of the chunk load; each thread keeps its chunk's
// next CRC_AHEAD words in flight while it steps through the current ones.
//
// Bound on the H100: memory (each input byte read once: 16.8 MB at 256
// rows of 64 KiB, 0.005 ms at 3.35 TB/s).  What is left above it is the
// table walk: 8 shared-memory lookups at data-dependent addresses a 8
// bytes, one a byte (16.8 million for those rows), with the bank conflicts
// of random indices; tools/checksum_clock.py times the table copy, the
// walk and the combine of each CTA apart.
//
// xxHash64 (`ct_xxh64_batch`).  Function: for each row of n bytes (n a
// multiple of 32), the xxHash64 digest with `seed`, as its low and high
// 32-bit halves (int64 each).  Lane q of a row folds the q-th 8-byte word
// of every stripe in order; the four accumulators merge, the length is
// added and the digest avalanched.  Native 64-bit integers: the
// reference's 16-bit limbs are the TPU's, not needed here.
//
// xxHash64's bound is memory too (16.8 MB at 256 rows of 64 KiB, 0.005
// ms), but a lane is a chain of n / 32 dependent rounds, which no layout
// shortens: 2,048 rounds at 64 KiB, so a round's latency sets the floor
// (tools/checksum_clock.py measures it).
//
// xxHash64's design: a CTA of two warps serves XXH_ROWS rows, lane 4 i +
// q of each warp lane q of row i: 8 rows a CTA, so 256 rows take 32 CTAs
// (measured faster than 1, 2, 4 or 6 rows a CTA on more SMs: the chain,
// not the SM count, sets the time).
// - The fold warp's lanes carry a = acc + in * P2: a round is then a' =
//   rotl(a, 31) * P1 + in' * P2, two funnel shifts and one 64-bit
//   multiply-add whose addend is ready, a shorter chain than the
//   add-rotate-multiply of the definition (a lane starts from a =
//   rotr(acc0 * P1^-1, 31) and ends with acc = rotl(a, 31) * P1).
// - The loader warp, on its own scheduler, loads the words a stage
//   (XXH_SS stripes) ahead, multiplies them by P2 and stores them into a
//   ring of XXH_STAGES slots in shared memory; named barriers FULL and
//   EMPTY a slot hand the stages over.  The fold reads each word two
//   rounds before its round (the next stage's first two during this
//   stage's last two rounds), so its instruction stream holds the chain,
//   one shared-memory load a round and nothing that waits on device
//   memory; neither the loads nor the multiplies by P2 take its issue
//   slots or its multiply pipe.  Each stage boundary still costs the fold
//   about a hundred cycles (the barrier, the loop and the loads ptxas
//   gathers at a stage's start), so stages are as long as registers
//   allow: 48 stripes, 3 slots (216 registers, no spills).
// Built with -DCT_XXH64_CLOCK (tools/checksum_clock.py) the library also
// exports ct_xxh64_batch_clock, whose `clk` output receives each lane's
// cycles (clock64) in its loop, on the same number of rounds with no
// loads (the chain alone) and waiting on FULL; with -DCT_CRC32C_CLOCK,
// ct_crc32c_batch_clock, whose `clk` output receives each CTA's cycles
// for the table copy, the walk and the combine, and thread 0's walk of
// its steps again on words in registers (the chain alone).  The
// library's build defines neither.
#include "ct_tiles.cuh"

namespace {

constexpr uint32_t CRC_POLY = 0x82F63B78u;
constexpr int CRC_THREADS = 256;  // = chunks a row
constexpr int CRC_WARPS = CRC_THREADS / 32;
constexpr int CRC_AHEAD = 8;      // 16-byte words loaded ahead of their steps

struct CrcTables {
  uint32_t t[8][256];
};

// Slicing-by-8: t[0] the byte table, t[k][i] the CRC of byte i followed by
// k zero bytes.
__host__ __device__ constexpr CrcTables crc_tables() {
  CrcTables r{};
  for (int i = 0; i < 256; ++i) {
    uint32_t c = (uint32_t)i;
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ CRC_POLY : c >> 1;
    r.t[0][i] = c;
  }
  for (int k = 1; k < 8; ++k)
    for (int i = 0; i < 256; ++i)
      r.t[k][i] = (r.t[k - 1][i] >> 8) ^ r.t[0][r.t[k - 1][i] & 255];
  return r;
}

__device__ __align__(16) const CrcTables kCrcTables = crc_tables();
static_assert(sizeof(CrcTables) == 16 * 2 * CRC_THREADS,
              "two 16-byte copies a thread");

__device__ __forceinline__ uint32_t mulmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll 4
  for (int k = 31; k >= 0; --k) {
    if ((a >> k) & 1u) p ^= b;
    b = (b & 1u) ? (b >> 1) ^ CRC_POLY : b >> 1;
  }
  return p;
}

// Slicing-by-8: the CRC after the 8 bytes of (lo, hi).
__device__ __forceinline__ uint32_t step8(const uint32_t (*tab)[256],
                                          uint32_t crc, uint32_t lo,
                                          uint32_t hi) {
  lo ^= crc;
  return tab[7][lo & 255] ^ tab[6][(lo >> 8) & 255] ^
         tab[5][(lo >> 16) & 255] ^ tab[4][lo >> 24] ^ tab[3][hi & 255] ^
         tab[2][(hi >> 8) & 255] ^ tab[1][(hi >> 16) & 255] ^ tab[0][hi >> 24];
}

__device__ __forceinline__ uint32_t step16(const uint32_t (*tab)[256],
                                           uint32_t crc, uint4 w) {
  return step8(tab, step8(tab, crc, w.x, w.y), w.z, w.w);
}

__device__ __forceinline__ uint32_t step1(const uint32_t (*tab)[256],
                                          uint32_t crc, uint8_t v) {
  return tab[0][(crc ^ v) & 255] ^ (crc >> 8);
}

// shifts: (256,) uint32, shifts[t] = x^(8 lc (255 - t)) mod P; clk: null,
// or with CT_CRC32C_CLOCK (B, 6) int64.
__global__ void __launch_bounds__(CRC_THREADS)
    crc32c_kernel(const uint8_t* __restrict__ rows, long long stride, int n,
                  int lc, const uint32_t* __restrict__ shifts, uint32_t cond,
                  long long* __restrict__ out, long long* __restrict__ clk) {
  __shared__ __align__(16) uint32_t tab[8][256];
  __shared__ uint32_t part[CRC_WARPS];
  const int t = threadIdx.x;
#ifdef CT_CRC32C_CLOCK
  const long long c0 = clock64();
#endif
  {
    const uint4* src = reinterpret_cast<const uint4*>(&kCrcTables);
    uint4* dst = reinterpret_cast<uint4*>(&tab[0][0]);
    ct::cp_async16(dst + t, src + t);
    ct::cp_async16(dst + CRC_THREADS + t, src + CRC_THREADS + t);
    ct::cp_async_commit();
  }
  const uint32_t shift = __ldg(shifts + t);
  // the chunk [p, e): a head of bytes to a 16-byte boundary, nw 16-byte
  // words from a, a tail of bytes
  const uint8_t* row = rows + (size_t)blockIdx.x * (size_t)stride;
  const long long e = (long long)n - (long long)(CRC_THREADS - 1 - t) * lc;
  long long p = e - lc < 0 ? 0 : e - lc;
  long long a = p + ((16 - (long long)(reinterpret_cast<uintptr_t>(row + p) &
                                       15)) & 15);
  if (a > e) a = e;
  const int nw = (int)((e - a) >> 4);
  const uint4* w4 = reinterpret_cast<const uint4*>(row + a);
  uint4 next[CRC_AHEAD];
#pragma unroll
  for (int u = 0; u < CRC_AHEAD; ++u)
    if (u < nw) next[u] = __ldg(w4 + u);
  ct::cp_async_wait<0>();
  __syncthreads();
#ifdef CT_CRC32C_CLOCK
  const long long c1 = clock64();
#endif
  uint32_t crc = 0;
  for (; p < a; ++p) crc = step1(tab, crc, row[p]);
  for (int i = 0; i < nw; i += CRC_AHEAD) {
    uint4 cur[CRC_AHEAD];
#pragma unroll
    for (int u = 0; u < CRC_AHEAD; ++u) cur[u] = next[u];
#pragma unroll
    for (int u = 0; u < CRC_AHEAD; ++u)
      if (i + CRC_AHEAD + u < nw) next[u] = __ldg(w4 + i + CRC_AHEAD + u);
#pragma unroll
    for (int u = 0; u < CRC_AHEAD; ++u)
      if (i + u < nw) crc = step16(tab, crc, cur[u]);
  }
  for (p = a + 16 * (long long)nw; p < e; ++p) crc = step1(tab, crc, row[p]);
#ifdef CT_CRC32C_CLOCK
  __syncthreads();
  const long long c2 = clock64();
#endif
  // the row's raw CRC: the XOR of every chunk's, each shifted past the
  // chunks after it
  const uint32_t term = __reduce_xor_sync(0xffffffffu, mulmodp(crc, shift));
  if ((t & 31) == 0) part[t >> 5] = term;
  __syncthreads();
#ifdef CT_CRC32C_CLOCK
  const long long c3 = clock64();
  if (t == 0) {
    // thread 0's steps again on words in registers: the chain alone
    uint32_t z = crc;
    uint4 w = make_uint4((uint32_t)c3, (uint32_t)c2, (uint32_t)c1, 0u);
    const int steps = lc / 16;
    const long long c4 = clock64();
    for (int s = 0; s < steps; ++s) {
      z = step16(tab, z, w);
      w.x += 0x9E3779B9u;
    }
    const long long c5 = clock64();
    long long* o = clk + 6 * (size_t)blockIdx.x;
    o[0] = c1 - c0;  // the table copy (with the first loads' issue)
    o[1] = c2 - c1;  // the walk (loads and steps), to the barrier
    o[2] = c3 - c2;  // the combine
    o[3] = c3 - c0;  // in all
    o[4] = c5 - c4;  // thread 0's steps alone, 16 bytes a step
    o[5] = steps + ((long long)z << 32);  // steps; the chain's result kept
  }
#endif
  if (t == 0) {
    uint32_t x = cond;
#pragma unroll
    for (int w = 0; w < CRC_WARPS; ++w) x ^= part[w];
    out[blockIdx.x] = (long long)x;
  }
}

constexpr uint64_t P1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P3 = 0x165667B19E3779F9ull;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t P1_INV = 0x0887493432BADB37ull;  // P1 * P1_INV = 1
static_assert(P1 * P1_INV == 1ull, "P1_INV");
constexpr int XXH_ROWS = 8;  // rows (quads) a CTA
constexpr int XXH_THREADS = 4 * XXH_ROWS;  // lanes of each warp in use
constexpr int XXH_SS = 48;     // stripes a stage
constexpr int XXH_STAGES = 3;  // stages of a row's ring
static_assert(XXH_ROWS >= 1 && XXH_ROWS <= 8, "rows a CTA: 1 to 8");
static_assert(2 * XXH_STAGES < 16, "named barriers: 1 to 2 * XXH_STAGES");
static_assert(XXH_SS >= 2, "a stage of at least 2 stripes");
constexpr int XXH_RING = XXH_STAGES * XXH_SS * 4 + 4;  // a row's ring, padded

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int r) {
  return (x >> r) | (x << (64 - r));
}

// The lane's chain carries a = acc + in * P2, the accumulator with its
// next word already added: a round is then a' = rotl(a, 31) * P1 + in' *
// P2, a rotate (two funnel shifts of the halves) and one multiply-add
// whose addend (the next word times P2) is computed off the chain.  The
// accumulator after the last word is xstep(a, 0), and a lane starts from
// the a that gives its first accumulator: rotr(acc0 * P1^-1, 31).
__device__ __forceinline__ uint64_t xstep(uint64_t a, uint64_t inp2) {
  const uint32_t lo = (uint32_t)a, hi = (uint32_t)(a >> 32);
  const uint64_t r = (uint64_t)__funnelshift_l(lo, hi, 31) << 32 |
                     __funnelshift_l(hi, lo, 31);
  return r * P1 + inp2;
}

__device__ __forceinline__ uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl64(acc + in * P2, 31) * P1;
}

__device__ __forceinline__ uint64_t xmerge(uint64_t h, uint64_t v) {
  h ^= xround(0, v);
  return h * P1 + P4;
}

// named barrier `id` of `threads` threads: wait for it, or arrive and go on
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the fold's wait on a FULL barrier; the clock build sums its cycles
__device__ __forceinline__ void wait_full(int id, long long& waited) {
#ifdef CT_XXH64_CLOCK
  const long long t0 = clock64();
#endif
  bar_sync(id, 64);
#ifdef CT_XXH64_CLOCK
  waited += clock64() - t0;
#endif
}

// One stage of a fold lane: rounds over words w[0 .. cnt) of the ring's
// slot at word offset `cur` (4 apart), w[0] and w[1] given (p0, p1), each
// later word read two rounds ahead.  Unless the stage is the row's last,
// the next stage's FULL barrier is waited on before the last two rounds
// and p0, p1 leave holding the first words of the slot at `next`.  Fully
// unrolled: each word gets a register of its own, so nothing is copied
// from stage to stage but p0 and p1.
template <bool Partial>
__device__ __forceinline__ void fold_stage(uint64_t& a, uint64_t& p0,
                                           uint64_t& p1,
                                           const uint64_t* ring_r, int cur,
                                           int next, bool more, int full_id,
                                           int cnt, long long& waited) {
  uint64_t w[XXH_SS];
  w[0] = p0;
  w[1] = p1;
#pragma unroll
  for (int u = 0; u < XXH_SS; ++u) {
    if (u + 2 < XXH_SS) {
      w[u + 2] = ring_r[cur + 4 * (u + 2)];
    } else if (more) {
      if (u + 2 == XXH_SS) {
        wait_full(full_id, waited);
        p0 = ring_r[next];
      } else {
        p1 = ring_r[next + 4];
      }
    }
    if (!Partial || u < cnt) a = xstep(a, w[u]);
  }
}

// clk: null, or with CT_XXH64_CLOCK (B, 4, 5) int64.
__global__ void __launch_bounds__(64)
    xxh64_kernel(const uint8_t* __restrict__ rows, int B, int n,
                 uint64_t seed, long long* __restrict__ out,
                 long long* __restrict__ clk) {
  // a row's ring, word u of slot k at [(k * XXH_SS + u) * 4 + lane]: each
  // word of a stage times P2; rows 32 bytes apart in the banks
  __shared__ __align__(16) uint64_t ring[XXH_ROWS][XXH_RING];
  const int lane = threadIdx.x & 31, lr = lane >> 2, q = lane & 3;
  const bool chain = threadIdx.x < 32;  // warp 0 folds, warp 1 loads
  const int r = blockIdx.x * XXH_ROWS + lr;
  const bool active = lane < XXH_THREADS && r < B;
  const int stripes = n / 32;
  const int nst = (stripes + XXH_SS - 1) / XXH_SS;
  const auto full = [](int t) { return 1 + t % XXH_STAGES; };
  const auto empty = [](int t) { return 1 + XXH_STAGES + t % XXH_STAGES; };

  if (!chain) {
    // the loader: stage t + 1's words are loaded while stage t's are
    // multiplied by P2 and stored, each slot once the fold has read it
    const unsigned long long* w =
        reinterpret_cast<const unsigned long long*>(rows + (size_t)r * n) + q;
    uint64_t v[XXH_SS];
#pragma unroll
    for (int u = 0; u < XXH_SS; ++u)
      v[u] = active && u < stripes ? __ldg(w + 4 * u) : 0;
    for (int t = 0; t < nst; ++t) {
      uint64_t nv[XXH_SS];
      const int s0 = (t + 1) * XXH_SS;
#pragma unroll
      for (int u = 0; u < XXH_SS; ++u)
        nv[u] = active && s0 + u < stripes ? __ldg(w + 4 * (s0 + u)) : 0;
      if (t >= XXH_STAGES) bar_sync(empty(t), 64);
      uint64_t* slot = ring[lr < XXH_ROWS ? lr : 0] +
                       (t % XXH_STAGES) * XXH_SS * 4 + q;
      if (lane < XXH_THREADS) {
#pragma unroll
        for (int u = 0; u < XXH_SS; ++u) slot[4 * u] = v[u] * P2;
      }
      bar_arrive(full(t), 64);
#pragma unroll
      for (int u = 0; u < XXH_SS; ++u) v[u] = nv[u];
    }
    return;
  }

  const uint64_t acc0 = q == 0 ? seed + P1 + P2 : q == 1 ? seed + P2
                        : q == 2 ? seed : seed - P1;
  uint64_t a = rotr64(acc0 * P1_INV, 31);  // xstep(a, w) = acc0 + w
  long long waited = 0;
#ifdef CT_XXH64_CLOCK
  const long long t0 = clock64();
#endif
  // the fold: stage after stage, each word read from shared memory two
  // rounds before its round; the next stage's first two words are read
  // (after its FULL) during this stage's last two rounds, and a slot is
  // handed back (EMPTY) where the loader will refill it
  const uint64_t* ring_r = ring[lr < XXH_ROWS ? lr : 0] + q;
  const int nfull = stripes / XXH_SS, tail = stripes - nfull * XXH_SS;
  wait_full(full(0), waited);
  uint64_t p0 = ring_r[0], p1 = ring_r[4];
  for (int t = 0; t < nfull; ++t) {
    const int cur = (t % XXH_STAGES) * XXH_SS * 4;
    const int next = ((t + 1) % XXH_STAGES) * XXH_SS * 4;
    fold_stage<false>(a, p0, p1, ring_r, cur, next, t + 1 < nst, full(t + 1),
                      XXH_SS, waited);
    if (t + XXH_STAGES < nst) bar_arrive(empty(t), 64);
  }
  if (tail)
    fold_stage<true>(a, p0, p1, ring_r, (nfull % XXH_STAGES) * XXH_SS * 4, 0,
                     false, 0, tail, waited);
  const uint64_t acc = xstep(a, 0);
#ifdef CT_XXH64_CLOCK
  // the lane's loop as timed, then as many rounds on words in registers:
  // the chain alone (its words depend on t1, its result is stored)
  const long long t1 = clock64();
  uint64_t c = acc, x = seed + (uint64_t)(t1 & 1);
  for (int s = 0; s < stripes; ++s) {
    c = xstep(c, x);
    x += P3;
  }
  const long long t2 = clock64();
  if (active) {
    long long* o = clk + 5 * (4 * (size_t)r + q);
    o[0] = t1 - t0;   // the lane's loop
    o[1] = t2 - t1;   // the chain alone
    o[2] = stripes;   // rounds
    o[3] = waited;    // cycles waiting for its stages
    o[4] = (long long)c;  // the chain's result, kept so it is computed
  }
#endif
  const int base = lane & ~3;
  const unsigned long long av = acc;
  const uint64_t a0 = __shfl_sync(0xffffffffu, av, base);
  const uint64_t a1 = __shfl_sync(0xffffffffu, av, base + 1);
  const uint64_t a2 = __shfl_sync(0xffffffffu, av, base + 2);
  const uint64_t a3 = __shfl_sync(0xffffffffu, av, base + 3);
  if (!active || q != 0) return;
  uint64_t h = rotl64(a0, 1) + rotl64(a1, 7) + rotl64(a2, 12) + rotl64(a3, 18);
  h = xmerge(h, a0);
  h = xmerge(h, a1);
  h = xmerge(h, a2);
  h = xmerge(h, a3);
  h += (uint64_t)n;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  out[2 * (size_t)r] = (long long)(h & 0xFFFFFFFFull);
  out[2 * (size_t)r + 1] = (long long)(h >> 32);
}

}  // namespace

extern "C" {

// rows: B rows `stride` bytes apart, any address; n <= the row length;
// lc = max(1, ceil(n / 256)); shifts (256,) uint32 on the device,
// shifts[t] = x^(8 lc (255 - t)) mod P, and cond = x^(8 n) * 0xFFFFFFFF
// mod P xor 0xFFFFFFFF (reflected), from the host; out (B,) int64.
static int crc32c_launch(const uint8_t* rows, long long stride, int B, int n,
                         int lc, const unsigned int* shifts,
                         unsigned int cond, long long* out, long long* clk,
                         cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n < 0 || lc < 1 || (long long)lc * CRC_THREADS < n)
    return (int)cudaErrorInvalidValue;
  crc32c_kernel<<<B, CRC_THREADS, 0, stream>>>(rows, stride, n, lc, shifts,
                                                cond, out, clk);
  return (int)cudaGetLastError();
}

int ct_crc32c_batch(const uint8_t* rows, long long stride, int B, int n,
                    int lc, const unsigned int* shifts, unsigned int cond,
                    long long* out, cudaStream_t stream) {
  return crc32c_launch(rows, stride, B, n, lc, shifts, cond, out, nullptr,
                       stream);
}

#ifdef CT_CRC32C_CLOCK
// ct_crc32c_batch, and clk (B, 6) int64 receives each CTA's cycles.
int ct_crc32c_batch_clock(const uint8_t* rows, long long stride, int B,
                          int n, int lc, const unsigned int* shifts,
                          unsigned int cond, long long* out, long long* clk,
                          cudaStream_t stream) {
  return crc32c_launch(rows, stride, B, n, lc, shifts, cond, out, clk,
                       stream);
}
#endif

// rows: (B, n) u8, contiguous and 8-byte aligned, n a positive multiple
// of 32; out (B, 2) int64.
static int xxh64_launch(const uint8_t* rows, int B, int n,
                        unsigned long long seed, long long* out,
                        long long* clk, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (n < 32 || n % 32) return (int)cudaErrorInvalidValue;
  const int grid = (B + XXH_ROWS - 1) / XXH_ROWS;
  xxh64_kernel<<<grid, 64, 0, stream>>>(rows, B, n, seed, out, clk);
  return (int)cudaGetLastError();
}

int ct_xxh64_batch(const uint8_t* rows, int B, int n,
                   unsigned long long seed, long long* out,
                   cudaStream_t stream) {
  return xxh64_launch(rows, B, n, seed, out, nullptr, stream);
}

#ifdef CT_XXH64_CLOCK
// ct_xxh64_batch, and clk (B, 4, 5) int64 receives each lane's cycles.
int ct_xxh64_batch_clock(const uint8_t* rows, int B, int n,
                         unsigned long long seed, long long* out,
                         long long* clk, cudaStream_t stream) {
  return xxh64_launch(rows, B, n, seed, out, clk, stream);
}
#endif

}  // extern "C"
