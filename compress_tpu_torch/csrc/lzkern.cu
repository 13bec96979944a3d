// Exact match finder for 64 KiB blocks.
//
// Replaces: compress_tpu/ops/lzkern.py `_finder_kernel` and
// `_finder_kernel_slim` (via `find_matches_blocks`), the TPU kernel that
// runs two VMEM-resident bitonic sorts per block.
//
// Function: for every position p of a block, off = p - c where c is the
// nearest previous position with the same little-endian 4-byte word, and
// L = 4 + the equal suffix bytes at offsets 4..CAP-1 (read wrapped past the
// block end), L = min(L, BS - p).  No match (and the last 3 positions,
// as source or as candidate): off = L = 0.
//
// Bound on the H100: memory.  It must read 64 KiB and write 512 KiB of
// (off, L) per block.  What keeps a block's work above that is ordering
// 65533 positions by (word, position) on chip: a comparison sort of 48-bit
// keys (the first design: bitonic chunks in shared memory, merge passes
// through a 1 MiB global scratch per block) costs millions of
// compare-exchanges and spills the keys to L2.
//
// Design: a stable LSD radix sort of 16-bit positions, no keys stored.
// Pass d (d = 0..3) orders positions by the byte s[p + d], digit d of the
// word, least significant first; the sort starts in position order and is
// stable, so after four passes positions are in (word, position) order.
// The 3 tail positions never match and stay out of the sort.
//
// A block's bytes (64 KiB) and two position buffers (2 x 128 KiB) do not
// fit one CTA's 227 KB, so a cluster of 2 CTAs (Hopper's distributed
// shared memory) sorts one block: each CTA holds all the bytes, one half of
// each position buffer (sorted ranks [c * HALF, (c + 1) * HALF)) and its
// warps' digit counts, about 210 KiB, with no global scratch.  In a pass
// each warp owns a contiguous segment of 1024 entries of its CTA's half:
//   1. it counts its segment's digits into its own 256-bin row, equal
//      digits of a 32-entry step aggregated by __match_any_sync (an
//      all-zeros block puts no more than one update a step on a bin);
//   2. the counts are scanned in (digit, CTA, warp) order: a warp scan per
//      digit inside each CTA, then the two CTAs' digit totals, exchanged
//      through distributed shared memory;
//   3. it walks its segment again, 32 at a time: an entry's rank is its
//      warp's running base for the digit plus the lower lanes with the same
//      digit; the leader advances the base.  A rank in the other CTA's half
//      is a remote shared-memory store.  cluster.sync() ends the pass.
// The sorted predecessor with an equal word is the candidate; its 16-bit
// offset is scattered by position into the buffer the sort no longer
// needs (position p lives in CTA p / HALF), and each CTA compares suffix
// bytes for its half of the positions and writes (off, L) coalesced.
#include <cooperative_groups.h>

#include "ct_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ct;

constexpr int FIND_THREADS = 1024;
constexpr int NWARP = FIND_THREADS / 32;
constexpr int HALF = BS / 2;          // sorted entries and positions per CTA
constexpr int SENT_BASE = BS - 3;     // positions that never match
constexpr int SEG = HALF / NWARP;     // entries per warp segment
constexpr int RADIX = 256;
// counts, [warp][digit]: a warp's lanes touch its own row at random digits,
// and the scan reads one digit of all 32 rows; a row of 258 entries (129
// words) puts both in distinct banks
constexpr int CROW = RADIX + 2;
constexpr int NCNT = NWARP * CROW;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t FIND_SMEM = BS                      // the block's bytes
                             + 2 * HALF * sizeof(uint16_t)  // two halves
                             + NCNT * sizeof(uint16_t)      // warp counts
                             + 2 * RADIX * sizeof(uint32_t)  // totals, bases
                             + NWARP * sizeof(uint32_t);     // scan carries

static_assert(SEG % 32 == 0, "a warp segment is whole 32-entry steps");
static_assert(SENT_BASE - HALF <= HALF, "the second CTA's half fits");

__device__ __forceinline__ uint32_t word_at(const uint8_t* s, int p) {
  return (uint32_t)s[p] | ((uint32_t)s[(p + 1) & (BS - 1)] << 8) |
         ((uint32_t)s[(p + 2) & (BS - 1)] << 16) |
         ((uint32_t)s[(p + 3) & (BS - 1)] << 24);
}

template <int CAP>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(FIND_THREADS, 1)
    finder_kernel(const uint8_t* __restrict__ blocks, int32_t* __restrict__ off,
                  int32_t* __restrict__ len) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s = smem;                                       // the block's bytes
  uint16_t* bufA = reinterpret_cast<uint16_t*>(smem + BS);  // this CTA's half
  uint16_t* bufB = bufA + HALF;                             // of each buffer
  uint16_t* cnt = bufB + HALF;
  uint32_t* tot = reinterpret_cast<uint32_t*>(cnt + NCNT);  // digit totals
  uint32_t* gbase = tot + RADIX;                            // digit bases
  uint32_t* carry = gbase + RADIX;

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1;
  const size_t b = blockIdx.x >> 1;
  const int n_c = c == 0 ? HALF : SENT_BASE - HALF;  // entries of this half
  uint16_t* rA = cluster.map_shared_rank(bufA, c ^ 1);
  uint16_t* rB = cluster.map_shared_rank(bufB, c ^ 1);
  const uint32_t* rtot = cluster.map_shared_rank(tot, c ^ 1);

  const uint8_t* src = blocks + b * BS;
  for (int i = tid; i < BS / 16; i += FIND_THREADS)
    reinterpret_cast<uint4*>(s)[i] = reinterpret_cast<const uint4*>(src)[i];
  cluster.sync();  // both CTAs run and hold the bytes

  for (int d = 0; d < 4; ++d) {
    // pass 0 reads position order itself; then A -> B -> A -> B
    const uint16_t* from = (d & 1) ? bufA : bufB;
    uint16_t* to_here = (d & 1) ? bufB : bufA;
    uint16_t* to_there = (d & 1) ? rB : rA;
    for (int i = tid; i < NCNT / 2; i += FIND_THREADS)
      reinterpret_cast<uint32_t*>(cnt)[i] = 0;
    __syncthreads();

    // 1. each warp counts its segment's digits into its row
    for (int j = lane; j < SEG; j += 32) {
      const int e = warp * SEG + j;
      const bool valid = e < n_c;
      const int p = valid ? (d == 0 ? c * HALF + e : from[e]) : 0;
      const int dig = valid ? s[(p + d) & (BS - 1)] : -1;
      const unsigned peers = __match_any_sync(FULL, dig);
      if (valid && (peers & below) == 0)
        cnt[warp * CROW + dig] += (uint16_t)__popc(peers);
      __syncwarp();
    }
    __syncthreads();

    // 2. exclusive scan in (digit, CTA, warp) order.  Inside the CTA: a
    // warp scan over the 32 warps of each digit, and the digit's total.
    for (int dg = warp; dg < RADIX; dg += NWARP) {
      const uint32_t v = cnt[lane * CROW + dg];
      uint32_t incl = v;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, incl, k);
        if (lane >= k) incl += y;
      }
      cnt[lane * CROW + dg] = (uint16_t)(incl - v);
      if (lane == 31) tot[dg] = incl;
    }
    cluster.sync();  // both CTAs' totals are visible
    // digit bases over both halves: digits in order, CTA 0 before CTA 1
    uint32_t oth = 0, all = 0, incl = 0;
    if (tid < RADIX) {
      oth = rtot[tid];
      all = tot[tid] + oth;
      incl = all;
#pragma unroll
      for (int k = 1; k < 32; k <<= 1) {
        const uint32_t y = __shfl_up_sync(FULL, incl, k);
        if (lane >= k) incl += y;
      }
      if (lane == 31) carry[warp] = incl;
    }
    __syncthreads();
    if (tid < RADIX) {
      uint32_t pre = 0;
      for (int w = 0; w < warp; ++w) pre += carry[w];
      gbase[tid] = pre + incl - all + (c == 1 ? oth : 0);
    }
    __syncthreads();
    for (int i = tid; i < NWARP * RADIX; i += FIND_THREADS) {
      uint16_t* c = &cnt[(i / RADIX) * CROW + i % RADIX];
      *c = (uint16_t)(*c + gbase[i % RADIX]);  // ranks < 65533
    }
    __syncthreads();

    // 3. stable scatter: rank = the warp's base for the digit + lower peers
    for (int j = lane; j < SEG; j += 32) {
      const int e = warp * SEG + j;
      const bool valid = e < n_c;
      const int p = valid ? (d == 0 ? c * HALF + e : from[e]) : 0;
      const int dig = valid ? s[(p + d) & (BS - 1)] : -1;
      const unsigned peers = __match_any_sync(FULL, dig);
      int base = 0;
      if (valid) {
        base = cnt[warp * CROW + dig];
        const int rank = base + __popc(peers & below);
        uint16_t* to = (rank / HALF) == c ? to_here : to_there;
        to[rank & (HALF - 1)] = (uint16_t)p;
      }
      __syncwarp();
      if (valid && (peers & below) == 0)
        cnt[warp * CROW + dig] = (uint16_t)(base + __popc(peers));
      __syncwarp();
    }
    cluster.sync();  // both halves of the pass's order are written
  }

  // 4. sorted predecessor with an equal word -> 16-bit offset, scattered by
  // position into the A halves (free after the last pass, which read them)
  for (int e = tid; e < n_c; e += FIND_THREADS) {
    const int p = bufB[e];
    int q = -1;
    if (e > 0)
      q = bufB[e - 1];
    else if (c == 1)
      q = rB[HALF - 1];  // the last entry of the first half
    uint16_t o = 0;
    if (q >= 0 && word_at(s, p) == word_at(s, q)) o = (uint16_t)(p - q);
    uint16_t* to = (p / HALF) == c ? bufA : rA;
    to[p & (HALF - 1)] = o;
  }
  if (c == 1 && tid < BS - SENT_BASE) bufA[SENT_BASE - HALF + tid] = 0;
  cluster.sync();  // every offset is in place; no remote access after this

  // 5. suffix compare for this CTA's positions; coalesced (off, L) writes
  int32_t* offb = off + b * BS + c * HALF;
  int32_t* lenb = len + b * BS + c * HALF;
  for (int i = tid; i < HALF; i += FIND_THREADS) {
    const int p = c * HALF + i;
    const int o = bufA[i];
    int L = 0;
    if (o) {
      const int q = p - o;
      L = 4;
#pragma unroll
      for (int k = 4; k < CAP; ++k) {
        if (s[(p + k) & (BS - 1)] != s[(q + k) & (BS - 1)]) break;
        ++L;
      }
      L = min(L, BS - p);
    }
    offb[i] = o;
    lenb[i] = L;
  }
}

template <int CAP>
int launch_finder(const uint8_t* blocks, int32_t* off, int32_t* len, int nb,
                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      finder_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FIND_SMEM);
  if (e != cudaSuccess) return (int)e;
  finder_kernel<CAP><<<2 * nb, FIND_THREADS, FIND_SMEM, stream>>>(blocks, off,
                                                                  len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks: (nb, BS) u8; off, len: (nb, BS) i32.  cap: 10 (full) or 6
// (slim).  A cluster of 2 CTAs per block.
int ct_find_matches(const uint8_t* blocks, int32_t* off, int32_t* len, int nb,
                    int cap, cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (nb > (1 << 30)) return (int)cudaErrorInvalidValue;
  if (cap == 10) return launch_finder<10>(blocks, off, len, nb, stream);
  if (cap == 6) return launch_finder<6>(blocks, off, len, nb, stream);
  return (int)cudaErrorInvalidValue;
}

const char* ct_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
