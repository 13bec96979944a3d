// Greedy parse of each tile: the S2 XLA engine's and the zstd v1 engine's
// position scan.
//
// Replaces: compress_tpu/ops/lz2.py `_parse`, its lax.scan (:123, step
// :134-141).  An XLA scan, not a Pallas kernel; ported as a kernel of its
// own.
//
// Function, for each tile of `tile` positions of L_t (int32, already capped
// by the caller at the tile end): a cursor p starts at the tile's first
// position; at position r == p, L_t[r] >= 4 takes an op (take[r] = 1) and
// moves p to r + L_t[r] (the tile end if that passes it), any other value
// is a literal (lit[r] = 1) and moves p to r + 1; a position the cursor
// jumps over is neither.
//
// Bound on the H100: memory.  Each L_t is read once and two byte masks are
// written once (6 bytes a position).  A serial walk of a tile is up to
// `tile` dependent shared-memory steps (about 200 of 512 on the S2
// corpus, 512 at most).  The three phases below cut that chain to at most
// S + 32 + S steps but issue some thousand warp instructions a 512-tile,
// so the SM's schedulers, not the memory, set this kernel's time
// (tools/tileparse_clock.py).
//
// Design (the warp route, tiles up to TP_WARP_MAX): the tile is cut into
// segments of S = max(ceil(tile / 32), min(16, tile)) positions (16 at
// tile 512; at least 16, since a tile's phase-2 hops take the issue of
// its whole warp, and all of a shorter tile), G = the power of two at or
// above their number lanes take a tile, one segment each, and a warp
// takes 32 / G consecutive tiles side by side (1 at tile 512, 2 at 256).
// Position r's next cursor is nx[r] = r + 1 for a literal, else r +
// L_t[r] capped at the tile end.  Three exact phases take at most S + 32
// + S dependent steps:
//   1. each lane builds its segment's exits backwards, ex[e] = the first
//      position at or past the segment's end that the cursor reaches from
//      e: ex[e] = nx[e] >= end ? nx[e] : ex[nx[e]];
//   2. each tile's lanes follow the exits from its position 0 (one load a
//      hop, at most one hop a segment), and each lane keeps the position
//      where the cursor enters its segment, if it does;
//   3. each lane walks its segment forward from that entry and marks the
//      flags.
// A warp walks its groups of tiles of a persistent grid in turn.  A
// group's L_t is copied into shared memory with cp.async (16 bytes a copy
// where it is aligned); the warp turns it into each position's next
// cursor, kept at lane l's slots l * (S + 1) + (p mod S) (one slot apart
// a segment, so the lanes' steps fall on distinct banks) as the slot it
// leads to with a bit for an op, and the next group's copies fly during
// this one's phases.  The phases then step from slot to slot with one
// load each, phase 1 keeps the exits as slots, and the flags go out as
// 16-byte streaming stores of the two masks where the tile allows.  A
// tile past TP_WARP_MAX (whose L_t, cursors, exits and flags would pass a
// warp's share of shared memory) takes the chunked route: one thread
// walks a tile, 64 tiles a CTA, staged in chunks of 64 positions.
// `routes` counts the tiles on each route.
//
// Built with -DCT_TILEPARSE_CLOCK (compress_tpu_torch/tools/
// tileparse_clock.py), the library also exports ct_tile_parse_clock, the
// warp route with a `clk` output: each warp writes there its cycles in six
// parts (the next cursors, the flags zeroed and the next group's copies
// issued; waiting for this group's copies; phase 1; phase 2; phase 3; the
// stores) and its tile count.  The library's build does not define it.
#include "ct_tiles.cuh"

namespace {

constexpr int TP_WARPS = 4;          // warps a CTA on the warp route
constexpr int TP_WARP_MAX = 2048;    // largest tile on the warp route
constexpr int TC_THREADS = 64;       // chunked route: tiles a CTA
constexpr int TC_CHUNK = 64;         // positions of a tile staged at a time
constexpr int TC_PITCH = TC_CHUNK + 1;  // odd pitch: walkers spread banks
constexpr int TC_LOADS = 16;         // staging loads in flight a thread
static_assert(TC_THREADS == TC_CHUNK, "a thread stages one position");
static_assert(TC_THREADS % TC_LOADS == 0, "whole batches of rows");

// The warp route's shape at `tile`: S positions a segment, G lanes a tile
// (a power of two), 32 / G tiles a warp.
struct Shape {
  int S, G, tpw;
  __host__ __device__ explicit Shape(int tile) {
    const int s32 = (tile + 31) >> 5;
    S = s32 > 16 ? s32 : (tile < 16 ? tile : 16);
    const int nseg = (tile + S - 1) / S;
    G = 1;
    while (G < nseg) G <<= 1;
    tpw = 32 / G;
  }
};

// A warp's share of shared memory at `tile`, each part a multiple of 16
// bytes: the copy of its tiles' L_t (int32, as it lies in memory), then
// each position's next cursor (u16: its slot, bit 15 set where the
// position takes an op) and exit (u16 slot), 32 (S + 1) slots each, and
// the flags (u8).
__host__ __device__ inline int warp_share(int tile) {
  const Shape sh(tile);
  const int pos = sh.tpw * tile;
  return 4 * ((pos + 3) & ~3) + 4 * 32 * (sh.S + 1) + ((pos + 15) & ~15);
}
constexpr int TP_END = 0x7FFF;  // the slot of the tile's end
constexpr int TP_OP = 0x8000;   // next-cursor bit: the position takes an op

// p / S for 0 <= p < 2^12: a shift where S is a power of two (POW2), else
// p * M >> 32 with M = ceil(2^32 / S), exact since S <= 64 and so p * (M S
// - 2^32) < 2^32.
__host__ __device__ inline unsigned log2_of(int S) {
  unsigned m = 0;
  while ((1 << m) < S) ++m;
  return m;
}

template <bool POW2>
struct SegDiv {
  unsigned m;
  __device__ explicit SegDiv(int S)
      : m(POW2 ? log2_of(S) : 0xFFFFFFFFu / (unsigned)S + 1u) {}
  __device__ __forceinline__ int operator()(int p) const {
    return POW2 ? p >> m : (int)__umulhi((unsigned)p, m);
  }
};

// Start copying n L_t values at src into buf (16-byte aligned): 16 bytes a
// copy where src is 16-byte aligned, else 4.  Commits nothing.
__device__ __forceinline__ void load_span(int* buf, const int* src, int n,
                                          int lane) {
  int i = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int q = lane; q < (n >> 2); q += 32)
      ct::cp_async16(buf + 4 * q, src + 4 * q);
    i = n & ~3;
  }
  for (int q = i + lane; q < n; q += 32) ct::cp_async4(buf + q, src + q);
}

__device__ __forceinline__ int next_cursor(int v, int p, int tile) {
  return v >= 4 ? (v > tile - p ? tile : p + v) : p + 1;
}

template <bool POW2>
__global__ void __launch_bounds__(TP_WARPS * 32, 8)
tile_parse_warp_kernel(const int* __restrict__ L, long long n_tiles,
                       int tile, uint8_t* __restrict__ take,
                       uint8_t* __restrict__ lit, int* __restrict__ routes,
                       long long* __restrict__ clk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const Shape sh(tile);
  const int S = sh.S, P = S + 1, tpw = sh.tpw;
  const int span = tpw * tile;  // positions of a group of tiles
  unsigned char* share = smem + (size_t)w * warp_share(tile);
  int* const stg = reinterpret_cast<int*>(share);  // the cp.async copy
  uint16_t* const nxs = reinterpret_cast<uint16_t*>(stg + ((span + 3) & ~3));
  uint16_t* const ex = nxs + 32 * P;
  uint8_t* const flag = reinterpret_cast<uint8_t*>(ex + 32 * P);
  const SegDiv<POW2> seg(S);
  // this lane: tile g of the group, its segment sg, the segment's slots
  // [s0, s1) (empty past the tile), and slot q's position in the group
  const int g = lane / sh.G, sg = lane % sh.G;
  const int s0 = lane * P;
  const int s1 = s0 + max(0, min(S, tile - sg * S));
  const int g_slot = g * sh.G * P;  // the slot of tile g's position 0
  const int fpos = g * tile + sg * S - s0;
  const long long n_groups = (n_tiles + tpw - 1) / tpw;
  const long long stride = (long long)gridDim.x * TP_WARPS;
  long long u = (long long)blockIdx.x * TP_WARPS + w;
  const bool wide_store = (tile & 15) == 0 &&
      ((reinterpret_cast<uintptr_t>(take) |
        reinterpret_cast<uintptr_t>(lit)) & 15) == 0;
  int done = 0;
#ifdef CT_TILEPARSE_CLOCK
  long long ck[6] = {0, 0, 0, 0, 0, 0};
  long long c0 = clock64(), c1;
  // the cycles since the last mark go to part i
#define TP_MARK(i) (c1 = clock64(), ck[i] += c1 - c0, c0 = c1)
#else
#define TP_MARK(i) ((void)0)
#endif
  const auto tiles_in = [&](long long grp) {
    return (int)min((long long)tpw, n_tiles - grp * tpw);
  };
  if (u < n_groups) load_span(stg, L + u * span, tiles_in(u) * tile, lane);
  ct::cp_async_commit();
  for (; u < n_groups; u += stride) {
    const int nt = tiles_in(u), n = nt * tile;
    ct::cp_async_wait<0>();  // this group's copies have landed
    __syncwarp();
    TP_MARK(1);
    // each position's next cursor, as a slot, at its own slot
    for (int t = 0; t < nt; ++t) {
      const int base = t * sh.G * P;
      for (int p = lane; p < tile; p += 32) {
        const int v = stg[t * tile + p];
        const int nx = next_cursor(v, p, tile);
        nxs[base + p + seg(p)] = (uint16_t)(
            (nx < tile ? base + nx + seg(nx) : TP_END) |
            (v >= 4 ? TP_OP : 0));
      }
    }
    for (int i = lane; i < ((n + 15) >> 4); i += 32)
      reinterpret_cast<uint4*>(flag)[i] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    if (u + stride < n_groups)  // the next group's copies fly meanwhile
      load_span(stg, L + (u + stride) * span, tiles_in(u + stride) * tile,
                lane);
    ct::cp_async_commit();
    TP_MARK(0);

    const bool live = g < nt;
    // phase 1: the segment's exits, from its last slot down (the next
    // slot's cursor is loaded before this step's exit load and store)
    if (live && s0 < s1) {
      int c = nxs[s1 - 1];
      for (int e = s1 - 1; e >= s0; --e) {
        const int cn = e > s0 ? nxs[e - 1] : 0;
        const int nx = c & TP_END;
        ex[e] = (uint16_t)(nx < s1 ? ex[nx] : nx);
        c = cn;
      }
    }
    __syncwarp();
    TP_MARK(2);
    // phase 2: the cursor's entry into this lane's segment, if any (a
    // tile's lanes read the same slot: a broadcast)
    int entry = TP_END;
    for (int q = live ? g_slot : TP_END; q != TP_END; q = ex[q])
      if (q >= s0 && q < s1) entry = q;
    TP_MARK(3);
    // phase 3: the segment's walk from its entry
    for (int q = entry; q < s1;) {
      const int c = nxs[q];
      flag[q + fpos] = c & TP_OP ? 1 : 2;
      q = c & TP_END;
    }
    __syncwarp();
    TP_MARK(4);

    const long long g0 = u * span;
    if (wide_store) {
      uint4* tk = reinterpret_cast<uint4*>(take + g0);
      uint4* lt = reinterpret_cast<uint4*>(lit + g0);
      for (int i = lane; i < (n >> 4); i += 32) {
        const uint4 f = reinterpret_cast<const uint4*>(flag)[i];
        const unsigned m = 0x01010101u;
        __stcs(tk + i, make_uint4(f.x & m, f.y & m, f.z & m, f.w & m));
        __stcs(lt + i, make_uint4((f.x >> 1) & m, (f.y >> 1) & m,
                                  (f.z >> 1) & m, (f.w >> 1) & m));
      }
    } else {
      for (int i = lane; i < n; i += 32) {
        const uint8_t f = flag[i];
        take[g0 + i] = f & 1;
        lit[g0 + i] = f >> 1;
      }
    }
    __syncwarp();  // the flags are free for the next group
    TP_MARK(5);
    done += nt;
  }
  ct::cp_async_wait<0>();
  if (routes != nullptr && lane == 0 && done) atomicAdd(routes, done);
#ifdef CT_TILEPARSE_CLOCK
  if (clk != nullptr && lane == 0) {
    long long* out = clk + 7 * ((long long)blockIdx.x * TP_WARPS + w);
    for (int i = 0; i < 6; ++i) out[i] = ck[i];
    out[6] = done;
  }
#endif
#undef TP_MARK
}

// The chunked route: one thread walks one tile; a CTA of TC_THREADS threads
// takes TC_THREADS consecutive tiles, staged in chunks of TC_CHUNK
// positions (thread t copies position t of each tile, TC_LOADS loads in
// flight), each thread marking a shared flag byte a position, and the CTA
// storing the chunk's flags with coalesced byte stores.
__global__ void __launch_bounds__(TC_THREADS)
tile_parse_chunked_kernel(const int* __restrict__ L, long long n_tiles,
                          int tile, uint8_t* __restrict__ take,
                          uint8_t* __restrict__ lit,
                          int* __restrict__ routes) {
  __shared__ int s_len[TC_THREADS * TC_PITCH];
  __shared__ uint8_t s_flag[TC_THREADS * TC_CHUNK];
  const int t = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * TC_THREADS;
  const int n_here = (int)min((long long)TC_THREADS, n_tiles - tile0);
  const long long base = tile0 * tile;
  int p = 0;  // this thread's cursor, relative to its tile
  for (int c0 = 0; c0 < tile; c0 += TC_CHUNK) {
    const int cl = min(TC_CHUNK, tile - c0);
    __syncthreads();  // the previous chunk's flags are stored
    if (t < cl) {
      for (int r0 = 0; r0 < n_here; r0 += TC_LOADS) {
        int v[TC_LOADS];
#pragma unroll
        for (int u = 0; u < TC_LOADS; ++u)
          v[u] = r0 + u < n_here
                     ? __ldg(L + base + (long long)(r0 + u) * tile + c0 + t)
                     : 0;
#pragma unroll
        for (int u = 0; u < TC_LOADS; ++u) {
          s_len[(r0 + u) * TC_PITCH + t] = v[u];
          s_flag[(r0 + u) * TC_CHUNK + t] = 0;
        }
      }
    }
    __syncthreads();
    if (t < n_here) {
      const int end = c0 + cl;
      while (p < end) {
        const int v = s_len[t * TC_PITCH + (p - c0)];
        s_flag[t * TC_CHUNK + (p - c0)] = v >= 4 ? 1 : 2;
        p = next_cursor(v, p, tile);
      }
    }
    __syncthreads();
    for (int k = t; k < n_here * TC_CHUNK; k += TC_THREADS) {
      const int row = k / TC_CHUNK, j = k % TC_CHUNK;
      if (j < cl) {
        const long long g = base + (long long)row * tile + c0 + j;
        const uint8_t f = s_flag[k];
        take[g] = f & 1;
        lit[g] = f >> 1;
      }
    }
  }
  if (routes != nullptr && t == 0) atomicAdd(routes + 1, n_here);
}

int warp_smem(int tile) { return TP_WARPS * warp_share(tile); }

bool pow2_seg(int tile) {
  const int S = Shape(tile).S;
  return (S & (S - 1)) == 0;
}

template <bool POW2>
int launch_warp(const int* L, long long n_tiles, int tile, uint8_t* take,
                uint8_t* lit, int* routes, long long* clk,
                cudaStream_t stream) {
  const int smem = warp_smem(tile);
  cudaError_t e = ct::allow_smem<tile_parse_warp_kernel<POW2>>(
      warp_smem(TP_WARP_MAX));
  if (e != cudaSuccess) return (int)e;
  const int tpw = Shape(tile).tpw;
  const long long ctas = ((n_tiles + tpw - 1) / tpw + TP_WARPS - 1) /
                         TP_WARPS;
  const int grid = ct::persistent_grid<tile_parse_warp_kernel<POW2>>(
      TP_WARPS * 32, smem, (int)min(ctas, (long long)0x7FFFFFFF));
  tile_parse_warp_kernel<POW2><<<grid, TP_WARPS * 32, smem, stream>>>(
      L, n_tiles, tile, take, lit, routes, clk);
  return (int)cudaGetLastError();
}

int launch_warp_route(const int* L, long long n_tiles, int tile,
                      uint8_t* take, uint8_t* lit, int* routes,
                      long long* clk, cudaStream_t stream) {
  return pow2_seg(tile)
             ? launch_warp<true>(L, n_tiles, tile, take, lit, routes, clk,
                                 stream)
             : launch_warp<false>(L, n_tiles, tile, take, lit, routes, clk,
                                  stream);
}

template <bool POW2>
cudaError_t warp_info(int tile, cudaFuncAttributes* a, int* n) {
  cudaError_t e = ct::allow_smem<tile_parse_warp_kernel<POW2>>(
      warp_smem(TP_WARP_MAX));
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(a, tile_parse_warp_kernel<POW2>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, tile_parse_warp_kernel<POW2>, TP_WARPS * 32, warp_smem(tile));
  return e;
}

}  // namespace

extern "C" {

// L (n_tiles * tile) int32, contiguous; take and lit (n_tiles * tile)
// bytes (torch.bool), written in full; routes null or (2,) int32 (the
// tiles on the warp route and on the chunked route are added to it).
int ct_tile_parse(const int* L, long long n_tiles, int tile, uint8_t* take,
                  uint8_t* lit, int* routes, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (tile <= 0) return (int)cudaErrorInvalidValue;
  if (tile <= TP_WARP_MAX)
    return launch_warp_route(L, n_tiles, tile, take, lit, routes, nullptr,
                             stream);
  const long long grid = (n_tiles + TC_THREADS - 1) / TC_THREADS;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  tile_parse_chunked_kernel<<<(unsigned)grid, TC_THREADS, 0, stream>>>(
      L, n_tiles, tile, take, lit, routes);
  return (int)cudaGetLastError();
}

// The launch of tile `tile`: out[0] its route (0 warp, 1 chunked), out[1]
// CTAs resident on one SM, out[2] registers a thread, out[3] dynamic
// shared memory a CTA in bytes, out[4] tiles a warp (0 on the chunked
// route).
int ct_tile_parse_info(int tile, int* out) {
  if (tile <= 0) return (int)cudaErrorInvalidValue;
  const bool warp = tile <= TP_WARP_MAX;
  cudaFuncAttributes a{};
  int n = 0;
  cudaError_t e =
      !warp ? cudaFuncGetAttributes(&a, tile_parse_chunked_kernel)
      : pow2_seg(tile) ? warp_info<true>(tile, &a, &n)
                       : warp_info<false>(tile, &a, &n);
  if (e == cudaSuccess && !warp)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, tile_parse_chunked_kernel, TC_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = warp ? 0 : 1;
  out[1] = n;
  out[2] = a.numRegs;
  out[3] = warp ? warp_smem(tile) : 0;
  out[4] = warp ? Shape(tile).tpw : 0;
  return 0;
}

#ifdef CT_TILEPARSE_CLOCK
// ct_tile_parse on the warp route (tile <= TP_WARP_MAX), and clk (int64,
// 7 a warp of the grid; n_tiles rounded up to whole CTAs rows suffice)
// receives each warp's cycles in six parts and its tile count.
int ct_tile_parse_clock(const int* L, long long n_tiles, int tile,
                        uint8_t* take, uint8_t* lit, int* routes,
                        long long* clk, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (tile <= 0 || tile > TP_WARP_MAX) return (int)cudaErrorInvalidValue;
  return launch_warp_route(L, n_tiles, tile, take, lit, routes, clk, stream);
}
#endif

}  // extern "C"
