// Chunked zstd sequence decode from checkpoints (3 interleaved FSE states).
//
// Replaces: compress_tpu/ops/zseq_pallas.py `_kern` (via
// `zseq_decode_chunks_shared`, one table set for the batch), and serves
// the XLA scans compress_tpu/ops/entropy_dec.py `zseq_decode_chunks` and
// `zseq_decode_chunks_rep` (one table set per item) through a table
// stride.
//
// Function, per chunk c (its window = win bytes, little-endian bits): from
// the window-local cursor lbit[c], the states (ll, of, ml) and the repeat
// offsets (r0, r1, r2), for i < min(nsym[c], k):
//   look up the three state entries (sym | nb << 6 | new_state << 10);
//   read the extra bits below the cursor, offset then match then literal
//   length (bits below bit 0 and above the window read 0; a field of more
//   than 32 bits gives its low 32);
//   of_val = 1 << min(of_code, 31) plus its extras (1 for code 0); ml and
//   ll are their code's baseline plus extras (code entries xbits | base <<
//   5);
//   resolve the repeat offset in the carry (RFC 8878 §3.1.1.5; repeat
//   code 3 gives r0 - 1, floored at 1 when rep3_floor is set, where an
//   r0 of INT32_MIN wraps to INT32_MAX first, as the XLA scan's int32
//   arithmetic does);
//   unless i >= nore, reload the states, ll then ml then of.
// Steps past nsym write 0 and keep the carry.  nore is nore[c], or
// nsym[c] - (last[c] > 0) where the caller passes last (no reload after a
// block's last sequence).  The states and repeat offsets are read from
// three arrays each with a stride (the repeat offsets are 1, 4, 8 where
// none are given).  Outputs ll, ml, and where asked of_val and the
// resolved offset, (nc, k) int32, and the end cursor (nc,) int32.  tabs
// is one table set (per_row = 0) or row c / per_row of a (rows, ZTAB)
// array; a set is three 512-entry state rows (ll, of, ml) and two
// 64-entry code rows (ll, ml).
//
// Arithmetic: the values and the carry are 32-bit, as the outputs keep
// their low 32 bits.  Only two comparisons need more range.  of_val > 3
// holds exactly when the offset code is 2 or more.  The floor of repeat
// code 3 compares r0 with 2: a carried offset of_val - 3 can pass 2^31
// (offset code 31 and above), so each carried offset keeps a flag for
// "2^31 or more", set where of_val - 3 passes it and kept while r0 - 1
// stays there; offsets passed in are exact int32 values, negative and
// INT32_MIN included.
//
// Bound on the H100: memory.  Each chunk reads its window (80 or 96
// bytes) and 32 bytes of checkpoint, and writes up to 4 x k int32 and a
// cursor; the table sets are 6.5 KiB each.
//
// Design: a persistent grid of a few CTAs an SM walks tiles of 256
// chunks, a thread a chunk.  A tile's windows are one contiguous span,
// copied to shared memory with 16-byte cp.async while the tile before is
// decoded (two buffers).  Every table set a tile reads is staged in
// shared memory (two at a time; a tile that spans more, where a table's
// rows hold fewer than 128 chunks, takes them in turns), and stays there
// while the next tile reads it (the shared mode stages its one set once a
// CTA), so no lookup leaves the SM.  Each field comes from a register bit
// container refilled from the staged window (ct::BitWindow), not from two
// dependent shared loads.  The outputs leave as streaming 16-byte stores
// (they are not read again by this kernel).
#include "ct_tiles.cuh"

namespace {

constexpr int DEC_TILE = 256;  // chunks a tile, one a thread

constexpr int ZS_THREADS = DEC_TILE;
constexpr int ZS_MAX_WORDS = 24;  // windows of up to 96 bytes
constexpr int ZS_MAX_K = 8;
constexpr int ZS_SLOTS = 2;  // table sets staged at once
constexpr int ZTAB = 3 * 512 + 2 * 64;
constexpr int LL_ROW = 0, OF_ROW = 512, ML_ROW = 1024, LLX_ROW = 1536,
              MLX_ROW = 1600;
constexpr uint32_t BIG = 0x80000000u;

// dynamic shared memory: the staged table sets, two window buffers of
// DEC_TILE * ww words, the slots' rows
constexpr size_t zs_smem(int ww) {
  return 4 * (ZS_SLOTS * ZTAB + 2 * DEC_TILE * ww) + 4 * ZS_SLOTS;
}

struct Params {
  const uint8_t* windows;
  const int32_t *lbit, *nsym, *nore;
  const int32_t *sll, *sof, *sml;
  const int32_t *r0, *r1, *r2;
  const int32_t* tabs;
  int win, nore_is_last, st_stride, rp_stride, per_row, nc, k, rep3_floor;
  int32_t *ll, *ml, *ofv, *off, *endl;
};

// Stage table set r into slot s (all threads; returns after a barrier).
__device__ __forceinline__ void stage_set(int32_t* tab_s, int* slot_row,
                                          const int32_t* __restrict__ tabs,
                                          int r, int s) {
  const int4* src = reinterpret_cast<const int4*>(tabs + (size_t)r * ZTAB);
  int4* dst = reinterpret_cast<int4*>(tab_s + s * ZTAB);
  for (int i = threadIdx.x; i < ZTAB / 4; i += ZS_THREADS) dst[i] = src[i];
  if (threadIdx.x == 0) slot_row[s] = r;
  __syncthreads();
}

__device__ __forceinline__ void decode_chunk(const Params& p, int c,
                                             const int32_t* tab,
                                             ct::BitWindow& bw) {
  const int k = p.k;
  int lbp = p.lbit[c];
  const int ns = p.nsym[c];
  const int nr = p.nore_is_last ? ns - (p.nore[c] > 0) : p.nore[c];
  const size_t so = (size_t)c * p.st_stride;
  int s_ll = p.sll[so], s_of = p.sof[so], s_ml = p.sml[so];
  uint32_t r0 = 1u, r1 = 4u, r2 = 8u;
  if (p.r0) {
    const size_t ro = (size_t)c * p.rp_stride;
    r0 = (uint32_t)p.r0[ro];
    r1 = (uint32_t)p.r1[ro];
    r2 = (uint32_t)p.r2[ro];
  }
  bool b0 = false, b1 = false, b2 = false;  // carried value >= 2^31
  bw.refill((int)((unsigned)lbp - 1u) >> 5);
  int o_ll[ZS_MAX_K], o_ml[ZS_MAX_K], o_ofv[ZS_MAX_K], o_off[ZS_MAX_K];
#pragma unroll
  for (int i = 0; i < ZS_MAX_K; ++i) {
    o_ll[i] = o_ml[i] = o_ofv[i] = o_off[i] = 0;
    if (i >= k || i >= ns) continue;
    const int e_ll = tab[LL_ROW + (s_ll & 511)];
    const int e_of = tab[OF_ROW + (s_of & 511)];
    const int e_ml = tab[ML_ROW + (s_ml & 511)];
    const int of_c = e_of & 63;
    const int x_ml = tab[MLX_ROW + (e_ml & 63)];
    const int x_ll = tab[LLX_ROW + (e_ll & 63)];
    int cur = lbp;
    const uint32_t of_x = bw.field(cur, of_c);
    cur = (int)((unsigned)cur - (unsigned)of_c);
    const uint32_t ml_x = bw.field(cur, x_ml & 31);
    cur = (int)((unsigned)cur - (unsigned)(x_ml & 31));
    const uint32_t ll_x = bw.field(cur, x_ll & 31);
    cur = (int)((unsigned)cur - (unsigned)(x_ll & 31));
    const uint32_t of_val = of_c ? (1u << min(of_c, 31)) + of_x : 1u;
    const uint32_t ml = (uint32_t)(x_ml >> 5) + ml_x;
    const uint32_t ll = (uint32_t)(x_ll >> 5) + ll_x;
    // repeat-offset resolution in the carry
    uint32_t off;
    bool b_off = false;
    if (of_c >= 2) {  // of_val > 3
      off = of_val - 3u;
      b_off = of_c >= 31 && of_x >= 3u;
      r2 = r1;
      b2 = b1;
      r1 = r0;
      b1 = b0;
      r0 = off;
      b0 = b_off;
    } else {
      const int code = (int)of_val - 1 + (ll == 0u);
      if (code == 0) {
        off = r0;
      } else if (code == 1) {
        off = r1;
        b_off = b1;
        r1 = r0;
        b1 = b0;
        r0 = off;
        b0 = b_off;
      } else if (code == 2) {
        off = r2;
        b_off = b2;
        r2 = r1;
        b2 = b1;
        r1 = r0;
        b1 = b0;
        r0 = off;
        b0 = b_off;
      } else {
        if (!p.rep3_floor) {
          off = r0 - 1u;
          b_off = false;
        } else if (b0) {
          off = r0 - 1u;
          b_off = r0 != BIG;
        } else {
          // r0 - 1 in int32, floored at 1: INT32_MIN wraps to INT32_MAX
          off = (int)r0 >= 2 || r0 == 0x80000000u ? r0 - 1u : 1u;
          b_off = false;
        }
        r2 = r1;
        b2 = b1;
        r1 = r0;
        b1 = b0;
        r0 = off;
        b0 = b_off;
      }
    }
    if (i < nr) {  // state reloads: ll, ml, of
      const int nb_ll = (e_ll >> 6) & 15, nb_ml = (e_ml >> 6) & 15,
                nb_of = (e_of >> 6) & 15;
      s_ll = (e_ll >> 10) + (int)bw.field(cur, nb_ll);
      cur = (int)((unsigned)cur - (unsigned)nb_ll);
      s_ml = (e_ml >> 10) + (int)bw.field(cur, nb_ml);
      cur = (int)((unsigned)cur - (unsigned)nb_ml);
      s_of = (e_of >> 10) + (int)bw.field(cur, nb_of);
      cur = (int)((unsigned)cur - (unsigned)nb_of);
    }
    lbp = cur;
    o_ll[i] = (int)ll;
    o_ml[i] = (int)ml;
    o_ofv[i] = (int)of_val;
    o_off[i] = (int)off;
  }
  const size_t o = (size_t)c * k;
  if (k == ZS_MAX_K) {
    int4* d;
    d = reinterpret_cast<int4*>(p.ll + o);
    __stcs(d, make_int4(o_ll[0], o_ll[1], o_ll[2], o_ll[3]));
    __stcs(d + 1, make_int4(o_ll[4], o_ll[5], o_ll[6], o_ll[7]));
    d = reinterpret_cast<int4*>(p.ml + o);
    __stcs(d, make_int4(o_ml[0], o_ml[1], o_ml[2], o_ml[3]));
    __stcs(d + 1, make_int4(o_ml[4], o_ml[5], o_ml[6], o_ml[7]));
    if (p.ofv) {
      d = reinterpret_cast<int4*>(p.ofv + o);
      __stcs(d, make_int4(o_ofv[0], o_ofv[1], o_ofv[2], o_ofv[3]));
      __stcs(d + 1, make_int4(o_ofv[4], o_ofv[5], o_ofv[6], o_ofv[7]));
    }
    if (p.off) {
      d = reinterpret_cast<int4*>(p.off + o);
      __stcs(d, make_int4(o_off[0], o_off[1], o_off[2], o_off[3]));
      __stcs(d + 1, make_int4(o_off[4], o_off[5], o_off[6], o_off[7]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < ZS_MAX_K; ++i) {
      if (i < k) {
        p.ll[o + i] = o_ll[i];
        p.ml[o + i] = o_ml[i];
        if (p.ofv) p.ofv[o + i] = o_ofv[i];
        if (p.off) p.off[o + i] = o_off[i];
      }
    }
  }
  p.endl[c] = lbp;
}

__global__ void __launch_bounds__(ZS_THREADS, 3)
    zseq_decode_kernel(const Params p) {
  extern __shared__ __align__(16) int32_t zs_smem_base[];
  const int ww = p.win >> 2;
  int32_t* tab_s = zs_smem_base;
  uint32_t* win_s = reinterpret_cast<uint32_t*>(tab_s + ZS_SLOTS * ZTAB);
  int* slot_row = reinterpret_cast<int*>(win_s + 2 * DEC_TILE * ww);
  const int nc = p.nc;
  const int tiles = (nc + DEC_TILE - 1) / DEC_TILE;
  const int tid = threadIdx.x;
  if (tid < ZS_SLOTS) slot_row[tid] = -1;
  int t = blockIdx.x;
  ct::copy_tile(win_s, p.windows, t * DEC_TILE,
                min(DEC_TILE, nc - t * DEC_TILE), p.win);
  for (int buf = 0; t < tiles; t += gridDim.x, buf ^= 1) {
    const int tn = t + gridDim.x;
    ct::copy_tile(win_s + (buf ^ 1) * DEC_TILE * ww, p.windows,
                  tn * DEC_TILE,
                  tn < tiles ? min(DEC_TILE, nc - tn * DEC_TILE) : 0, p.win);
    const int c0 = t * DEC_TILE;
    const int n = min(DEC_TILE, nc - c0);
    const int c = c0 + tid;
    ct::cp_async_wait<1>();
    __syncthreads();
    const uint32_t* wtile = win_s + buf * DEC_TILE * ww;
    const int per_row = p.per_row;
    const int rfirst = per_row ? c0 / per_row : 0;
    const int rlast = per_row ? (c0 + n - 1) / per_row : 0;
    const int my_row = per_row ? c / per_row : 0;
    for (int rg = rfirst; rg <= rlast; rg += ZS_SLOTS) {
      // every thread reads the slots' rows before any slot is restaged
      bool stale[ZS_SLOTS];
      for (int s = 0; s < ZS_SLOTS; ++s)
        stale[s] = rg + s <= rlast && slot_row[s] != rg + s;
      __syncthreads();
      for (int s = 0; s < ZS_SLOTS; ++s)
        if (stale[s]) stage_set(tab_s, slot_row, p.tabs, rg + s, s);
      if (tid < n && my_row >= rg && my_row < rg + ZS_SLOTS) {
        ct::BitWindow bw;
        bw.w = wtile + tid * ww;
        bw.ww = ww;
        decode_chunk(p, c, tab_s + (my_row - rg) * ZTAB, bw);
      }
      __syncthreads();
    }
  }
  ct::cp_async_wait<0>();
}

}  // namespace

extern "C" {

// windows: (nc, win) u8, win a multiple of 4 and <= 96, 16-byte aligned;
// lbit, nsym, nore: (nc,) i32, nore holding last when nore_is_last;
// sll, sof, sml: chunk c's states at c * st_stride; r0, r1, r2: its repeat
// offsets at c * rp_stride, or all three null (1, 4, 8); tabs: (rows,
// ZTAB) i32, 16-byte aligned, rows = 1 when per_row is 0 else
// ceil(nc / per_row); ll, ml, ofv, off: (nc, k) i32, 16-byte aligned, ofv
// and off null where not wanted; endl: (nc,) i32.  1 <= k <= 8.
int ct_zseq_decode(const uint8_t* windows, const int32_t* lbit,
                   const int32_t* nsym, const int32_t* nore,
                   const int32_t* sll, const int32_t* sof,
                   const int32_t* sml, const int32_t* r0, const int32_t* r1,
                   const int32_t* r2, const int32_t* tabs, int win,
                   int nore_is_last, int st_stride, int rp_stride,
                   int per_row, int nc, int k, int rep3_floor, int32_t* ll,
                   int32_t* ml, int32_t* ofv, int32_t* off, int32_t* endl,
                   cudaStream_t stream) {
  if (nc <= 0) return 0;
  if (win <= 0 || win % 4 || win > 4 * ZS_MAX_WORDS || k < 1 ||
      k > ZS_MAX_K || per_row < 0 || (r0 && (!r1 || !r2)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      ct::allow_smem<zseq_decode_kernel>((int)zs_smem(ZS_MAX_WORDS));
  if (e != cudaSuccess) return (int)e;
  Params p{windows, lbit, nsym, nore, sll, sof, sml, r0, r1, r2, tabs,
           win, nore_is_last, st_stride, rp_stride, per_row, nc, k,
           rep3_floor, ll, ml, ofv, off, endl};
  const size_t smem = zs_smem(win / 4);
  const int tiles = (nc + DEC_TILE - 1) / DEC_TILE;
  const int grid =
      ct::persistent_grid<zseq_decode_kernel>(ZS_THREADS, smem, tiles);
  zseq_decode_kernel<<<grid, ZS_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// CTAs per SM at windows of win bytes (the paths' 96 per item, 80 shared)
int ct_zseq_occupancy(int win) {
  int n = 0;
  cudaError_t e =
      ct::allow_smem<zseq_decode_kernel>((int)zs_smem(ZS_MAX_WORDS));
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, zseq_decode_kernel, ZS_THREADS, zs_smem(win / 4));
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
