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
// Design: a warp takes a tile through A0, A and B at a time, so only the
// tile lives in the warp's shared memory, and the block keeps what the
// later stages read: the take/literal bit masks, each tile's ops in order
// (L_t, the probe and the literals before the op, 4 bytes an op: an op
// covers >= 4 positions, so a tile has at most 128), the ops before each
// take word, and the tile summaries.  That is 103,936 bytes a CTA
// (PARSE_SMEM); the registers of 256 threads let two CTAs share an SM.  The block's bytes and (off, L)
// stay in device memory.
//   load  each lane loads its 16 consecutive positions of (off, L) and
//         bytes with 16-byte loads, all in flight together; the positions
//         cap ahead come from the next lane by shuffles (cap a template
//         parameter, 6 or 10: the finder's two caps, on the main paths);
//         CAP = 0 takes any positive cap at run time instead, loading the
//         positions cap ahead from device memory where a chain can start;
//   A0    the chain links of every position come from one backward pass
//         per residue class mod cap over the tile's continuation bits (a
//         lane per class, 32 classes at a time at a run-time cap), not a
//         walk per position; a tile without a continuation bit skips it;
//   A     equal bytes are compared 4 at a time (__vcmpeq4 on funnel-shifted
//         words); run lengths come from find-first-zero on 16-position
//         masks and, past a lane's end, the next lane with a mismatch (a
//         ballot), and only in lanes where a run of >= 4 can start;
//   B     the warp walks the greedy parse 32 positions at a time: a
//         ballot gives the window's ops, and the walk steps from op to op
//         (the next op at or after the current position by find-first-set,
//         the literals before it, its successor by one shuffle) until it
//         leaves the window; each op keeps the literals since the op
//         before it in the tile;
//   C     one warp merges the 128 tile summaries with a suffix-minimum
//         scan (4 tiles a lane).
#pragma once

#include "ct_common.cuh"

namespace ct {

constexpr int PARSE_THREADS = 256;
constexpr int PARSE_WARPS = PARSE_THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TILE_OPS = TILE / 4;     // ops a tile can hold
constexpr int TILE_WORDS = TILE / 32;  // bit-mask words a tile
constexpr int N_TILE_ARRAYS = 14;

// shared-memory layout (bytes)
constexpr int SM_TAKE = 0;                           // u32 take bits
constexpr int SM_LIT = SM_TAKE + BS / 8;             // u32 literal bits
constexpr int SM_OPT = SM_LIT + BS / 8;              // u32 per op, per tile
constexpr int SM_WPRE = SM_OPT + NT * TILE_OPS * 4;  // u8 per take word
constexpr int SM_TILE = SM_WPRE + BS / 32;           // int arrays of NT
constexpr int SM_WARP = SM_TILE + N_TILE_ARRAYS * NT * 4;
constexpr int WARP_BYTES = 2 * TILE + TILE + 64;     // L_t | runs | cont bits
constexpr int PARSE_SMEM = SM_WARP + PARSE_WARPS * WARP_BYTES;

struct ParseSmem {
  uint32_t* takeb;  // take bits (an absorbed tile's first op still set)
  uint32_t* litb;   // literal bits
  // tile t's ops in order at t * TILE_OPS: L_t | probe << 12 | lits << 16,
  // lits the literals between the op before it in the tile (or the tile
  // start) and it
  uint32_t* opt;
  uint8_t* wpre;    // per take word: the ops of its tile before it
  // tile summaries: from B (ops, literals, first op, its offset and L_t,
  // the op ending at the tile end and its offset, the end of the last op)
  int *t_nops, *t_nlit, *t_op0, *t_off0, *t_L0, *t_epos, *t_eoff, *t_end;
  // from C (absorbed, the position that receives t_W more length or -1)
  int *t_abs, *t_recv, *t_W;
  // free for the kernels (zparse: sequence and literal bases, carries)
  int *t_x0, *t_x1, *t_x2;
  uint16_t* wlt;    // this warp's tile: L_t | probe << 12, 0 where no op
  uint8_t* wrun;    // this warp's tile: continuation runs along the chain
  uint16_t* contm;  // this warp's tile: continuation bits, 16 per lane
};

__device__ __forceinline__ ParseSmem parse_smem(uint8_t* smem, int warp) {
  ParseSmem s;
  s.takeb = reinterpret_cast<uint32_t*>(smem + SM_TAKE);
  s.litb = reinterpret_cast<uint32_t*>(smem + SM_LIT);
  s.opt = reinterpret_cast<uint32_t*>(smem + SM_OPT);
  s.wpre = smem + SM_WPRE;
  int* ta = reinterpret_cast<int*>(smem + SM_TILE);
  s.t_nops = ta;
  s.t_nlit = ta + NT;
  s.t_op0 = ta + 2 * NT;
  s.t_off0 = ta + 3 * NT;
  s.t_L0 = ta + 4 * NT;
  s.t_epos = ta + 5 * NT;
  s.t_eoff = ta + 6 * NT;
  s.t_end = ta + 7 * NT;
  s.t_abs = ta + 8 * NT;
  s.t_recv = ta + 9 * NT;
  s.t_W = ta + 10 * NT;
  s.t_x0 = ta + 11 * NT;
  s.t_x1 = ta + 12 * NT;
  s.t_x2 = ta + 13 * NT;
  uint8_t* w = smem + SM_WARP + warp * WARP_BYTES;
  s.wlt = reinterpret_cast<uint16_t*>(w);
  s.wrun = w + 2 * TILE;
  s.contm = reinterpret_cast<uint16_t*>(w + 3 * TILE);
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

// L_t | probe << 12 of the op at position g (its take bit set)
__device__ __forceinline__ int op_at(const ParseSmem& s, int g) {
  const int wi = g >> 5;
  const int k = s.wpre[wi] + __popc(s.takeb[wi] & ((1u << (g & 31)) - 1u));
  return s.opt[(g / TILE) * TILE_OPS + k] & 0xFFFF;
}

// Stages A0-B for block b, a warp per tile; ends with a __syncthreads.
// CAP = 0: the cap is rcap, in [1, BS] (a cap >= BS never continues).
template <bool ZSTD_GATE, int CAP>
__device__ __forceinline__ void parse_tiles(const ParseSmem& s,
                                            const uint8_t* __restrict__ blkg,
                                            const int32_t* __restrict__ offb,
                                            const int32_t* __restrict__ lenb,
                                            int rcap = CAP) {
  static_assert(CAP >= 0 && CAP <= 16, "the next lane holds the cap ahead");
  const int cap = CAP ? CAP : rcap;
  // chain runs along a residue class: 8 bits hold them at the finder's
  // caps; a run-time cap down to 1 needs 16, in the tile's L_t slots,
  // which are written only after the runs are read
  uint8_t* const run8 = s.wrun;
  uint16_t* const run16 = s.wlt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rt0 = lane * 16;
  for (int t = warp; t < NT; t += PARSE_WARPS) {
    const int T0 = t * TILE;
    const int g0 = T0 + rt0;
    // ---- load: 16 positions a lane -----------------------------------
    int off[16], L[16];
    const int4* o4 = reinterpret_cast<const int4*>(offb + g0);
    const int4* l4 = reinterpret_cast<const int4*>(lenb + g0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int4 a = __ldg(o4 + k), c = __ldg(l4 + k);
      off[4 * k] = a.x, off[4 * k + 1] = a.y, off[4 * k + 2] = a.z,
              off[4 * k + 3] = a.w;
      L[4 * k] = c.x, L[4 * k + 1] = c.y, L[4 * k + 2] = c.z,
            L[4 * k + 3] = c.w;
    }
    const uint4 bw = __ldg(reinterpret_cast<const uint4*>(blkg + g0));
    uint32_t by[8];  // the 16 bytes before this lane's, then its own
    by[0] = __shfl_up_sync(FULL, bw.x, 1);
    by[1] = __shfl_up_sync(FULL, bw.y, 1);
    by[2] = __shfl_up_sync(FULL, bw.z, 1);
    by[3] = __shfl_up_sync(FULL, bw.w, 1);
    if (lane == 0) {
      const uint4 q = T0 > 0
                          ? __ldg(reinterpret_cast<const uint4*>(blkg + T0 - 16))
                          : make_uint4(0, 0, 0, 0);
      by[0] = q.x, by[1] = q.y, by[2] = q.z, by[3] = q.w;
    }
    by[4] = bw.x, by[5] = bw.y, by[6] = bw.z, by[7] = bw.w;
    // ---- A0: continuation bits, then one backward pass per residue ----
    uint32_t cm = 0;
    if constexpr (CAP > 0) {
      // (off, L) cap positions ahead: the next lane's first, or past the
      // tile
      int offn[CAP > 0 ? CAP : 1], Ln[CAP > 0 ? CAP : 1];
#pragma unroll
      for (int k = 0; k < CAP; ++k) {
        offn[k] = __shfl_down_sync(FULL, off[k], 1);
        Ln[k] = __shfl_down_sync(FULL, L[k], 1);
        if (lane == 31) {
          const int g = T0 + TILE + k;
          offn[k] = g < BS ? __ldg(offb + g) : 0;
          Ln[k] = g < BS ? __ldg(lenb + g) : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int on = j + CAP < 16 ? off[min(j + CAP, 15)]
                                    : offn[max(j + CAP - 16, 0)];
        const int ln = j + CAP < 16 ? L[min(j + CAP, 15)]
                                    : Ln[max(j + CAP - 16, 0)];
        if (L[j] == CAP && off[j] > 0 && on == off[j] && ln >= 4)
          cm |= 1u << j;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int g = g0 + j;
        if (L[j] == cap && off[j] > 0 && cap < BS - g &&
            __ldg(offb + g + cap) == off[j] && __ldg(lenb + g + cap) >= 4)
          cm |= 1u << j;
      }
    }
    const bool chains = __any_sync(FULL, cm != 0);
    if (chains) {
      s.contm[lane] = (uint16_t)cm;
      __syncwarp();
      if constexpr (CAP > 0) {
        if (lane < CAP) {
          int run = 0;
          for (int q = lane + (TILE - 1 - lane) / CAP * CAP; q >= 0;
               q -= CAP) {
            run = ((s.contm[q >> 4] >> (q & 15)) & 1) ? run + 1 : 0;
            run8[q] = (uint8_t)run;
          }
        }
      } else {
        for (int c = lane; c < min(cap, TILE); c += 32) {
          int run = 0;
          for (int q = c + (TILE - 1 - c) / cap * cap; q >= 0; q -= cap) {
            run = ((s.contm[q >> 4] >> (q & 15)) & 1) ? run + 1 : 0;
            run16[q] = (uint16_t)run;
          }
        }
      }
      __syncwarp();
    }

    int Lc[16], pr[16], Lu[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int r_t = rt0 + j;
      int Lg = L[j];
      if ((cm >> j) & 1u) {
        // the links of the chain from r_t, cut at the tile end, which is
        // all min(L, TILE - r_t) below can see (a chain cut there already
        // reaches past it, and past the gate's 8 wherever r_t <= 508; past
        // that no op fits the tile)
        Lg = cap * (CAP ? (int)run8[r_t] : (int)run16[r_t]) + 4;
      }
      Lu[j] = Lg;
      Lc[j] = min(Lg, TILE - r_t);
      pr[j] = 0;
    }

    // ---- A: run probes ---------------------------------------------------
#pragma unroll
    for (int id = 1; id <= 5; ++id) {
      const int o = probe_off(id);
      // equal-byte bits, 4 positions a word: this lane's bytes against the
      // bytes o before them (a funnel shift of two words), compared 4 at a
      // time; the 0/1 byte results gather into bits 28-31 by a multiply
      uint32_t m = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int w = 4 + k;
        const uint32_t y = (o & 3) ? __funnelshift_l(by[w - 1 - (o >> 2)],
                                                     by[w - (o >> 2)], 8 * (o & 3))
                                   : by[w - (o >> 2)];
        const uint32_t e = __vcmpeq4(by[w], y) & 0x01010101u;
        m |= ((e * 0x10204080u) >> 28) << (4 * k);
      }
      if (g0 < o) m &= ~0u << (o - g0);  // no byte before the block
      const uint32_t inv = ~m & 0xFFFFu;
      // the first mismatch after this lane's positions: in the next lane
      // that has one, else the tile end
      const uint32_t has = __ballot_sync(FULL, inv != 0) & (~1u << lane);
      const int nl = has ? __ffs(has) - 1 : lane;
      const int fm = __shfl_sync(FULL, rt0 + __ffs(inv) - 1, nl);
      const int after = has ? fm : TILE;
      // can a run of >= 4 start here: inside the lane, or in its top ones
      // continued into the next lanes
      const int top = __clz(~(m << 16));
      if ((m & (m >> 1) & (m >> 2) & (m >> 3)) ||
          (top && top + after - (rt0 + 16) >= 4)) {
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
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (ZSTD_GATE) {
        // the gate reads the match before the tile cap, with its offset
        const int og = pr[j] ? probe_off(pr[j]) : off[j];
        const int min_l = 6 + (og >= 1024) + (og >= 65536);
        if (Lu[j] < min_l) Lc[j] = 0;
      }
      s.wlt[rt0 + j] = Lc[j] >= 4 ? (uint16_t)(Lc[j] | (pr[j] << 12)) : 0;
    }
    __syncwarp();

    // ---- B: the greedy walk, 32 positions at a time ----------------------
    uint32_t acc = 0;  // lanes 0-15: take word `lane`; 16-31: literal word
    int p = 0, nops = 0, nlit = 0, epos = -1, end = 0;
    int pend = 0;      // literals since the last op (or the tile start)
    while (p < TILE) {
      const int lim = min(32, TILE - p);
      const int v = lane < lim ? s.wlt[p + lane] : 0;
      const bool valid = (v & 0x3FF) >= 4;
      const uint32_t ops = __ballot_sync(FULL, valid);
      const int nx = lane + (v & 0x3FF);  // an op's successor
      // from the window's first position to its next op: literals, then
      // the op, whose successor is the next step; a shuffle an op
      uint32_t vis = 0, tb = 0;
      int cur = 0, f = -1, lits = 0;  // lits: this lane's op's literal run
      while (cur < lim) {
        const uint32_t rest = ops & (~0u << cur);
        if (!rest) {  // literals to the window's end
          vis |= (lim == 32 ? FULL : (1u << lim) - 1u) & (~0u << cur);
          pend += lim - cur;
          cur = lim;
          f = -1;
          break;
        }
        f = __ffs(rest) - 1;
        vis |= ((2u << f) - 1u) & (~0u << cur);
        tb |= 1u << f;
        if (lane == f) lits = pend + f - cur;
        pend = 0;
        cur = __shfl_sync(FULL, nx, f);
      }
      const uint32_t lb = vis & ~tb;
      if ((tb >> lane) & 1u)
        s.opt[t * TILE_OPS + nops + __popc(tb & ((1u << lane) - 1u))] =
            (uint32_t)v | (uint32_t)lits << 16;
      if (tb) end = p + __shfl_sync(FULL, nx, 31 - __clz(tb));
      if (f >= 0 && p + cur == TILE) epos = p + f;
      const int ex = cur;
      nops += __popc(tb);
      nlit += __popc(lb);
      const uint32_t bits = lane < 16 ? tb : lb;
      const int w = lane & 15, pw = p >> 5, sh = p & 31;
      if (w == pw) acc |= bits << sh;
      if (w == pw + 1 && sh) acc |= bits >> (32 - sh);
      p += ex;
    }
    if (lane < 16)
      s.takeb[t * TILE_WORDS + lane] = acc;
    else
      s.litb[t * TILE_WORDS + lane - 16] = acc;
    const int c = lane < 16 ? __popc(acc) : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane < 16) s.wpre[t * TILE_WORDS + lane] = (uint8_t)(incl - c);

    // ---- tile summary (lane 0 holds the tile's first positions) --------
    if (lane == 0) {
      const int v0 = s.wlt[0];
      const int op0 = (v0 & 0x3FF) >= 4;  // the walk starts at position 0
      s.t_nops[t] = nops;
      s.t_nlit[t] = nlit;
      s.t_end[t] = end;
      s.t_op0[t] = op0;
      s.t_L0[t] = v0 & 0x3FF;
      s.t_off0[t] = op0 ? resolve_off(v0, off[0]) : 0;
      s.t_epos[t] = epos;
      s.t_eoff[t] =
          epos >= 0 ? resolve_off(s.wlt[epos], __ldg(offb + T0 + epos)) : -1;
    }
    __syncwarp();
  }
  __syncthreads();
}

// tile t's first op continues tile t - 1's final op (same offset)
__device__ __forceinline__ int absorbed(const ParseSmem& s, int t) {
  return t >= 1 && t < NT && s.t_op0[t] && s.t_eoff[t - 1] > 0 &&
         s.t_off0[t] == s.t_eoff[t - 1];
}

// Stage C, by one warp, 4 tiles a lane: the cross-tile chain merge.  Tile
// t is absorbed (a) when its first op continues tile t - 1's final op, and
// a chain link (c) when that op also covers the whole tile.  The chain
// from tile t's final op ends at k, the first tile after t that is not a
// link (a suffix minimum over the tiles), and gains (k - t - 1) * TILE
// plus k's first op when k is absorbed (the terminal gate); tile t's final
// op receives it when tile t + 1 is absorbed and t is no link itself.
__device__ __forceinline__ void merge_tiles(const ParseSmem& s, int lane) {
  const int t0 = 4 * lane;
  int nc[4];  // t0 + i where tile t0 + i is not a link, else NT
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + i;
    nc[i] = absorbed(s, t) && s.t_L0[t] == TILE ? NT : t;
  }
  // the first non-link tile after this lane's tiles
  int after = min(min(nc[0], nc[1]), min(nc[2], nc[3]));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(FULL, after, d);
    if (lane + d < 32) after = min(after, v);
  }
  const int later = __shfl_down_sync(FULL, after, 1);
  after = lane < 31 ? later : NT;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    const int t = t0 + i;
    const int k = after;  // the chain's terminal tile, seen from t + 1
    const int Ln = k < NT && absorbed(s, k) ? min(s.t_L0[k], 1023) : 0;
    s.t_W[t] = (k - (t + 1)) * TILE + Ln;
    s.t_recv[t] = absorbed(s, t + 1) && nc[i] == t ? s.t_epos[t] : -1;
    s.t_abs[t] = absorbed(s, t);
    after = min(after, nc[i]);
  }
}

}  // namespace ct
