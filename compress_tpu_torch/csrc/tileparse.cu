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
// moves p to r + L_t[r], any other value is a literal (lit[r] = 1) and
// moves p to r + 1; a position the cursor jumps over is neither.
//
// Bound on the H100: memory.  Each L_t is read once and two byte masks are
// written once (6 bytes a position); a tile's walk is at most `tile`
// dependent shared-memory steps.
//
// Design (simple): one thread walks one tile; a CTA of TP_THREADS threads
// takes TP_THREADS consecutive tiles.  Thread t reading its own tile from
// global memory would stride by 4 * tile bytes across the warp, so the
// tiles are staged in chunks of TP_CHUNK positions: the CTA copies chunk c
// of all its tiles into shared memory with coalesced loads (thread t takes
// position t of each tile, TP_LOADS loads in flight), each thread
// walks its tile's part of the chunk and marks a shared flag byte a
// position, and the CTA stores the chunk's flags as the two masks with
// coalesced byte stores.
#include "ct_common.cuh"

namespace {

constexpr int TP_THREADS = 64;   // tiles a CTA, one thread each
constexpr int TP_CHUNK = 64;     // positions of a tile staged at a time
constexpr int TP_PITCH = TP_CHUNK + 1;  // odd pitch: walkers spread banks
constexpr int TP_LOADS = 16;     // staging loads in flight a thread
static_assert(TP_THREADS == TP_CHUNK, "a thread stages one position");
static_assert(TP_THREADS % TP_LOADS == 0, "whole batches of rows");

__global__ void __launch_bounds__(TP_THREADS)
tile_parse_kernel(const int* __restrict__ L, long long n_tiles, int tile,
                  uint8_t* __restrict__ take, uint8_t* __restrict__ lit) {
  __shared__ int s_len[TP_THREADS * TP_PITCH];
  __shared__ uint8_t s_flag[TP_THREADS * TP_CHUNK];
  const int t = threadIdx.x;
  const long long tile0 = (long long)blockIdx.x * TP_THREADS;
  const int n_here = (int)min((long long)TP_THREADS, n_tiles - tile0);
  const long long base = tile0 * tile;
  int p = 0;  // this thread's cursor, relative to its tile
  for (int c0 = 0; c0 < tile; c0 += TP_CHUNK) {
    const int cl = min(TP_CHUNK, tile - c0);
    __syncthreads();  // the previous chunk's flags are stored
    // thread t stages position c0 + t of every tile: TP_LOADS independent
    // loads in flight before the first store to shared memory (a loop of
    // load-then-store waits out the memory latency at every row)
    if (t < cl) {
      for (int r0 = 0; r0 < n_here; r0 += TP_LOADS) {
        int v[TP_LOADS];
#pragma unroll
        for (int u = 0; u < TP_LOADS; ++u)
          v[u] = r0 + u < n_here
                     ? __ldg(L + base + (long long)(r0 + u) * tile + c0 + t)
                     : 0;
#pragma unroll
        for (int u = 0; u < TP_LOADS; ++u) {
          s_len[(r0 + u) * TP_PITCH + t] = v[u];
          s_flag[(r0 + u) * TP_CHUNK + t] = 0;
        }
      }
    }
    __syncthreads();
    if (t < n_here) {
      const int end = c0 + cl;
      while (p < end) {
        const int v = s_len[t * TP_PITCH + (p - c0)];
        if (v >= 4) {
          s_flag[t * TP_CHUNK + (p - c0)] = 1;
          p = v > tile - p ? tile : p + v;
        } else {
          s_flag[t * TP_CHUNK + (p - c0)] = 2;
          ++p;
        }
      }
    }
    __syncthreads();
    for (int k = t; k < n_here * TP_CHUNK; k += TP_THREADS) {
      const int row = k / TP_CHUNK, j = k % TP_CHUNK;
      if (j < cl) {
        const long long g = base + (long long)row * tile + c0 + j;
        const uint8_t f = s_flag[k];
        take[g] = f & 1;
        lit[g] = f >> 1;
      }
    }
  }
}

}  // namespace

extern "C" {

// L (n_tiles * tile) int32, contiguous; take and lit (n_tiles * tile)
// bytes (torch.bool), written in full.
int ct_tile_parse(const int* L, long long n_tiles, int tile, uint8_t* take,
                  uint8_t* lit, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (tile <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (n_tiles + TP_THREADS - 1) / TP_THREADS;
  if (grid > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  tile_parse_kernel<<<(unsigned)grid, TP_THREADS, 0, stream>>>(
      L, n_tiles, tile, take, lit);
  return (int)cudaGetLastError();
}

}  // extern "C"
