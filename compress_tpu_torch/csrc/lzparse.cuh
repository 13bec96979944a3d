// Parse stages shared by the S2 emit kernel (lzemit.cu) and the zstd parse
// kernel (zparse.cu): one CTA of PARSE_THREADS per 64 KiB block.
//
//   A0. chain extension at the finder's suffix cap: L' = cap * links + 4
//       where L == cap and off repeats every cap positions;
//   A.  run probes at offsets 1, 2, 3, 4, 8 (in that order; a probe wins
//       with a strictly longer run of >= 4 bytes), runs cut at the tile;
//   (zstd only) cost gate: L = 0 where L < 6 + (off >= 1024) + (off >= 65536);
//   B.  greedy parse of each 512-position tile with L_t = min(L, 512 - r_t);
//   C.  cross-tile chain merge: a tile whose first op continues the
//       previous tile's final op (same offset) is absorbed into it, with
//       the terminal tile's length added only when its offset matches.
//
// The block's bytes, L_t (with the winning probe in its top bits) and the
// take/literal bit masks stay in shared memory (216 KiB):
//   A  a warp per tile: chain links are walked over a per-tile bit mask of
//      chain continuations (a walk never leaves the tile, since the tile
//      caps L), run lengths come from find-first-zero on 16-position masks
//      plus a warp suffix-min;
//   B  one thread per tile walks the greedy parse (at most 512 steps);
//   C  one thread merges the 128 tile summaries.
#pragma once

#include "ct_common.cuh"

namespace ct {

constexpr int PARSE_THREADS = 512;
constexpr int PARSE_WARPS = PARSE_THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// shared-memory layout (bytes)
constexpr int SM_LT = BS;                      // u16 L_t | probe << 12
constexpr int SM_TAKE = SM_LT + 2 * BS;        // u32 take bits
constexpr int SM_LIT = SM_TAKE + BS / 8;       // u32 literal bits
constexpr int SM_TILE = SM_LIT + BS / 8;       // 8 int arrays of NT
constexpr int SM_WARP = SM_TILE + 8 * NT * 4;  // 256 B per warp
constexpr int PARSE_SMEM = SM_WARP + PARSE_WARPS * 256;

struct ParseSmem {
  uint8_t* blk;
  uint16_t* lt;
  uint32_t* takeb;
  uint32_t* litb;
  int *t_op0, *t_off0, *t_L0, *t_eoff, *t_epos, *t_abs, *t_recv, *t_W;
  uint8_t* wbuf;  // this warp's 256 bytes
};

__device__ __forceinline__ ParseSmem parse_smem(uint8_t* smem, int warp) {
  ParseSmem s;
  s.blk = smem;
  s.lt = reinterpret_cast<uint16_t*>(smem + SM_LT);
  s.takeb = reinterpret_cast<uint32_t*>(smem + SM_TAKE);
  s.litb = reinterpret_cast<uint32_t*>(smem + SM_LIT);
  s.t_op0 = reinterpret_cast<int*>(smem + SM_TILE);
  s.t_off0 = s.t_op0 + NT;
  s.t_L0 = s.t_off0 + NT;
  s.t_eoff = s.t_L0 + NT;
  s.t_epos = s.t_eoff + NT;
  s.t_abs = s.t_epos + NT;
  s.t_recv = s.t_abs + NT;
  s.t_W = s.t_recv + NT;
  s.wbuf = smem + SM_WARP + warp * 256;
  return s;
}

__device__ __forceinline__ int probe_off(int id) {
  return id == 1 ? 1 : id == 2 ? 2 : id == 3 ? 3 : id == 4 ? 4 : 8;
}

// offset of the op at a position: its winning probe's, else the finder's
__device__ __forceinline__ int resolve_off(int ltv, int finder_off) {
  int id = ltv >> 12;
  return id ? probe_off(id) : finder_off;
}

__device__ __forceinline__ bool bit(const uint32_t* m, int g) {
  return (m[g >> 5] >> (g & 31)) & 1u;
}

// Stages A0-C for block b.  On return (after a __syncthreads) the shared
// memory holds the parse: take/literal bits (the take bit of an absorbed
// tile's first op still set: see t_abs), L_t and the probe per position,
// and the tile summaries t_abs, t_recv (the position in the tile that
// receives t_W more length, or -1) and t_W.
template <bool ZSTD_GATE>
__device__ __forceinline__ void parse_block(const ParseSmem& s,
                                            const uint8_t* __restrict__ blkg,
                                            const int32_t* __restrict__ offb,
                                            const int32_t* __restrict__ lenb,
                                            int cap) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < BS / 16; i += PARSE_THREADS)
    reinterpret_cast<uint4*>(s.blk)[i] = reinterpret_cast<const uint4*>(blkg)[i];
  for (int i = tid; i < BS / 32; i += PARSE_THREADS) {
    s.takeb[i] = 0;
    s.litb[i] = 0;
  }
  __syncthreads();

  // ---- A0 + A: a warp per tile, 16 consecutive positions per lane -------
  uint16_t* contm = reinterpret_cast<uint16_t*>(s.wbuf);
  for (int t = warp; t < NT; t += PARSE_WARPS) {
    const int T0 = t * TILE;
    const int rt0 = lane * 16;
    uint32_t cm = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int g = T0 + rt0 + j;
      const int og = offb[g];
      if (lenb[g] == cap && og > 0 && g + cap < BS && offb[g + cap] == og &&
          lenb[g + cap] >= 4)
        cm |= 1u << j;
    }
    contm[lane] = (uint16_t)cm;
    __syncwarp();

    int Lc[16], pr[16], Lu[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r_t = rt0 + j;
      int Lg = lenb[T0 + r_t];
      if (Lg == cap) {
        // links: the walk stops once the tile cap is reached, which is
        // all that min(L, TILE - r_t) below can see (and the gate too: a
        // cut walk already has L >= 14)
        int r = 0, q = r_t;
        while (cap * r + 4 < TILE - r_t && ((contm[q >> 4] >> (q & 15)) & 1)) {
          ++r;
          q += cap;
        }
        if (r > 0) Lg = cap * r + 4;
      }
      Lu[j] = Lg;
      Lc[j] = min(Lg, TILE - r_t);
      pr[j] = 0;
    }

#pragma unroll
    for (int id = 1; id <= 5; ++id) {
      const int o = probe_off(id);
      uint32_t m = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int g = T0 + rt0 + j;
        if (g >= o && s.blk[g] == s.blk[g - o]) m |= 1u << j;
      }
      const uint32_t inv = ~m & 0xFFFFu;
      int sm = inv ? rt0 + __ffs(inv) - 1 : TILE;  // first mismatch
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        int v = __shfl_down_sync(FULL, sm, d);
        if (lane + d < 32) sm = min(sm, v);
      }
      int after = __shfl_down_sync(FULL, sm, 1);
      if (lane == 31) after = TILE;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t sh = inv >> j;
        const int Lr = sh ? __ffs(sh) - 1 : after - (rt0 + j);
        if (Lr > Lc[j] && Lr >= 4) {
          Lc[j] = Lr;
          Lu[j] = Lr;
          pr[j] = id;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (ZSTD_GATE) {
        // the gate reads the match before the tile cap, with its offset
        const int og = pr[j] ? probe_off(pr[j]) : offb[T0 + rt0 + j];
        const int min_l = 6 + (og >= 1024) + (og >= 65536);
        if (Lu[j] < min_l) Lc[j] = 0;
      }
      s.lt[T0 + rt0 + j] = Lc[j] >= 4 ? (uint16_t)(Lc[j] | (pr[j] << 12)) : 0;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- B: greedy parse, one thread per tile ------------------------------
  if (tid < NT) {
    const int t = tid, T0 = t * TILE;
    int p = 0, epos = -1;
    while (p < TILE) {
      const int g = T0 + p;
      const int Lt = s.lt[g] & 0x3FF;
      if (Lt >= 4) {
        s.takeb[g >> 5] |= 1u << (g & 31);
        if (p + Lt == TILE) epos = p;
        p += Lt;
      } else {
        s.litb[g >> 5] |= 1u << (g & 31);
        p += 1;
      }
    }
    const int v0 = s.lt[T0];
    const int op0 = (v0 & 0x3FF) >= 4;  // the walk starts at position 0
    s.t_op0[t] = op0;
    s.t_L0[t] = v0 & 0x3FF;
    s.t_off0[t] = op0 ? resolve_off(v0, offb[T0]) : 0;
    s.t_epos[t] = epos;
    s.t_eoff[t] = epos >= 0 ? resolve_off(s.lt[T0 + epos], offb[T0 + epos]) : -1;
  }
  __syncthreads();

  // ---- C: cross-tile chain merge over the tile summaries ----------------
  if (tid == 0) {
    int kn = NT, Ln = 0;  // terminal tile and its length, seen from t + 1
    int an = 0;           // tile t + 1 absorbed
    for (int t = NT - 1; t >= 0; --t) {
      const int a = s.t_op0[t] && t >= 1 && s.t_eoff[t - 1] > 0 &&
                    s.t_off0[t] == s.t_eoff[t - 1];
      const int c = a && s.t_L0[t] == TILE;
      s.t_W[t] = (kn - (t + 1)) * TILE + Ln;
      s.t_recv[t] = (an && !c) ? s.t_epos[t] : -1;
      s.t_abs[t] = a;
      if (!c) {
        kn = t;
        Ln = a ? min(s.t_L0[t], 1023) : 0;  // the terminal gate on a_t
      }
      an = a;
    }
  }
  __syncthreads();
}

}  // namespace ct
