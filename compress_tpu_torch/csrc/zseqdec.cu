// Chunked zstd sequence decode from checkpoints (3 interleaved FSE states).
//
// Replaces: compress_tpu/ops/zseq_pallas.py `_kern` (via
// `zseq_decode_chunks_shared`, one table set for the batch), and serves
// the XLA scans compress_tpu/ops/entropy_dec.py `zseq_decode_chunks` and
// `zseq_decode_chunks_rep` (one table set per item) through a table
// stride.
//
// Function, per chunk c (its window = win bytes, little-endian bits): from
// the window-local cursor lbit[c], the states (ll, of, ml) = states[c] and
// the repeat offsets (r0, r1, r2) = reps[c], for i < min(nsym[c], k):
//   look up the three state entries (sym | nb << 6 | new_state << 10);
//   read the extra bits below the cursor, offset then match then literal
//   length (bits below bit 0 and above the window read 0);
//   of_val = 1 << of_code plus its extras (1 for code 0); ml and ll are
//   their code's baseline plus extras (code entries xbits | base << 5);
//   resolve the repeat offset in the carry (RFC 8878 §3.1.1.5; repeat
//   code 3 gives r0 - 1, floored at 1 when rep3_floor is set);
//   unless i >= nore[c], reload the states, ll then ml then of.
// Steps past nsym write 0 and keep the carry.  Outputs ll, ml, of_val and
// the resolved offset (nc, k) int32, and the end cursor (nc,) int32.
// tabs is one table set (per_row = 0) or row c / per_row of a (rows,
// ZTAB) array; a set is three 512-entry state rows (ll, of, ml) and two
// 64-entry code rows (ll, ml).
//
// Bound on the H100: memory.  Each chunk reads its window (80 or 96
// bytes) and 32 bytes of checkpoint, and writes 4 x k int32 and a cursor;
// the table sets are 6.5 KiB each.
//
// Design: a thread walks one chunk.  The CTA copies its 256 windows to
// shared memory with coalesced 4-byte loads (an odd word stride keeps the
// threads' reads on distinct banks) and, when all its chunks read one
// table set, that set; otherwise the set is read through L1.  A read is a
// 64-bit funnel of two window words.  Integers only: the XLA scan's
// float32 arithmetic and its 24-bit read limit, and the Pallas kernel's
// halfword selects and lane gathers, are TPU artefacts.
#include "ct_common.cuh"

namespace {

constexpr int ZS_THREADS = 256;
constexpr int ZS_MAX_WORDS = 24;  // windows of up to 96 bytes
constexpr int ZS_MAX_K = 8;
constexpr int ZTAB = 3 * 512 + 2 * 64;
constexpr int LL_ROW = 0, OF_ROW = 512, ML_ROW = 1024, LLX_ROW = 1536,
              MLX_ROW = 1600;

// bits [lbp - n, lbp) of the window; bits below 0 and above it read 0
__device__ __forceinline__ uint32_t read_bits(const uint32_t* w, int ww,
                                              int lbp, int n) {
  const int bp = lbp - n;
  const int bpc = max(bp, 0);
  const int wi = bpc >> 5;
  const uint64_t lo = wi < ww ? w[wi] : 0u;
  const uint64_t hi = wi + 1 < ww ? w[wi + 1] : 0u;
  const uint32_t v = (uint32_t)((lo | (hi << 32)) >> (bpc & 31));
  const int zs = bpc - bp;
  const uint32_t z = zs >= 32 ? 0u : (v << zs);
  return n >= 32 ? z : (z & ((1u << n) - 1u));
}

__global__ void __launch_bounds__(ZS_THREADS)
    zseq_decode_kernel(const uint32_t* __restrict__ windows, int ww,
                       const int32_t* __restrict__ lbit,
                       const int32_t* __restrict__ nsym,
                       const int32_t* __restrict__ nore,
                       const int32_t* __restrict__ states,
                       const int32_t* __restrict__ reps,
                       const int32_t* __restrict__ tabs, int per_row, int nc,
                       int k, int rep3_floor, int32_t* __restrict__ ll_o,
                       int32_t* __restrict__ ml_o, int32_t* __restrict__ ofv_o,
                       int32_t* __restrict__ off_o,
                       int32_t* __restrict__ endl) {
  __shared__ uint32_t win_s[ZS_THREADS * (ZS_MAX_WORDS + 1)];
  __shared__ int32_t tab_s[ZTAB];
  const int c0 = blockIdx.x * ZS_THREADS;
  const int n = min(ZS_THREADS, nc - c0);
  const int ws = ww | 1;
  const uint32_t* wsrc = windows + (size_t)c0 * ww;
  for (int i = threadIdx.x; i < n * ww; i += ZS_THREADS) {
    const int r = i / ww;
    win_s[r * ws + (i - r * ww)] = wsrc[i];
  }
  const int row0 = per_row ? c0 / per_row : 0;
  const bool one_row = !per_row || (c0 + n - 1) / per_row == row0;
  if (one_row) {
    const int32_t* t = tabs + (size_t)row0 * ZTAB;
    for (int i = threadIdx.x; i < ZTAB; i += ZS_THREADS) tab_s[i] = t[i];
  }
  __syncthreads();
  if ((int)threadIdx.x >= n) return;
  const int c = c0 + threadIdx.x;
  const uint32_t* w = win_s + threadIdx.x * ws;
  const int32_t* tab = one_row ? tab_s : tabs + (size_t)(c / per_row) * ZTAB;
  int lbp = lbit[c];
  const int ns = nsym[c];
  const int nr = nore[c];
  int s_ll = states[3 * c], s_of = states[3 * c + 1],
      s_ml = states[3 * c + 2];
  // the values and repeat offsets are carried in 64 bits, as the plain
  // version does, so that no input (an offset code of 31 with its 31
  // extra bits included) overflows; the outputs keep their low 32 bits
  long long r0 = reps[3 * c], r1 = reps[3 * c + 1], r2 = reps[3 * c + 2];
  int o_ll[ZS_MAX_K], o_ml[ZS_MAX_K], o_ofv[ZS_MAX_K], o_off[ZS_MAX_K];
#pragma unroll
  for (int i = 0; i < ZS_MAX_K; ++i) {
    o_ll[i] = o_ml[i] = o_ofv[i] = o_off[i] = 0;
    if (i >= k || i >= ns) continue;
    const int e_ll = tab[LL_ROW + (s_ll & 511)];
    const int e_of = tab[OF_ROW + (s_of & 511)];
    const int e_ml = tab[ML_ROW + (s_ml & 511)];
    const int of_c = e_of & 63, ml_c = e_ml & 63, ll_c = e_ll & 63;
    const int x_ml = tab[MLX_ROW + ml_c];
    const int x_ll = tab[LLX_ROW + ll_c];
    int cur = lbp;
    const uint32_t of_x = read_bits(w, ww, cur, of_c);
    cur -= of_c;
    const uint32_t ml_x = read_bits(w, ww, cur, x_ml & 31);
    cur -= x_ml & 31;
    const uint32_t ll_x = read_bits(w, ww, cur, x_ll & 31);
    cur -= x_ll & 31;
    const long long of_val =
        of_c ? (1LL << min(of_c, 31)) + (long long)of_x : 1LL;
    const int ml = (x_ml >> 5) + (int)ml_x;
    const int ll = (x_ll >> 5) + (int)ll_x;
    // repeat-offset resolution in the carry
    long long off;
    if (of_val > 3) {
      off = of_val - 3;
      r2 = r1;
      r1 = r0;
      r0 = off;
    } else {
      const int code = (int)of_val - 1 + (ll == 0);
      if (code == 0) {
        off = r0;
      } else if (code == 1) {
        off = r1;
        r1 = r0;
        r0 = off;
      } else if (code == 2) {
        off = r2;
        r2 = r1;
        r1 = r0;
        r0 = off;
      } else {
        off = rep3_floor ? max(r0 - 1, 1LL) : r0 - 1;
        r2 = r1;
        r1 = r0;
        r0 = off;
      }
    }
    if (i < nr) {  // state reloads: ll, ml, of
      const int nb_ll = (e_ll >> 6) & 15, nb_ml = (e_ml >> 6) & 15,
                nb_of = (e_of >> 6) & 15;
      s_ll = (e_ll >> 10) + (int)read_bits(w, ww, cur, nb_ll);
      cur -= nb_ll;
      s_ml = (e_ml >> 10) + (int)read_bits(w, ww, cur, nb_ml);
      cur -= nb_ml;
      s_of = (e_of >> 10) + (int)read_bits(w, ww, cur, nb_of);
      cur -= nb_of;
    }
    lbp = cur;
    o_ll[i] = ll;
    o_ml[i] = ml;
    o_ofv[i] = (int)of_val;
    o_off[i] = (int)off;
  }
  const size_t o = (size_t)c * k;
  if (k == ZS_MAX_K) {
    int4* d;
    d = reinterpret_cast<int4*>(ll_o + o);
    d[0] = make_int4(o_ll[0], o_ll[1], o_ll[2], o_ll[3]);
    d[1] = make_int4(o_ll[4], o_ll[5], o_ll[6], o_ll[7]);
    d = reinterpret_cast<int4*>(ml_o + o);
    d[0] = make_int4(o_ml[0], o_ml[1], o_ml[2], o_ml[3]);
    d[1] = make_int4(o_ml[4], o_ml[5], o_ml[6], o_ml[7]);
    d = reinterpret_cast<int4*>(ofv_o + o);
    d[0] = make_int4(o_ofv[0], o_ofv[1], o_ofv[2], o_ofv[3]);
    d[1] = make_int4(o_ofv[4], o_ofv[5], o_ofv[6], o_ofv[7]);
    d = reinterpret_cast<int4*>(off_o + o);
    d[0] = make_int4(o_off[0], o_off[1], o_off[2], o_off[3]);
    d[1] = make_int4(o_off[4], o_off[5], o_off[6], o_off[7]);
  } else {
#pragma unroll
    for (int i = 0; i < ZS_MAX_K; ++i) {
      if (i < k) {
        ll_o[o + i] = o_ll[i];
        ml_o[o + i] = o_ml[i];
        ofv_o[o + i] = o_ofv[i];
        off_o[o + i] = o_off[i];
      }
    }
  }
  endl[c] = lbp;
}

}  // namespace

extern "C" {

// windows: (nc, win) u8, win a multiple of 4 and <= 96, 4-byte aligned;
// lbit, nsym, nore: (nc,) i32; states, reps: (nc, 3) i32 (states in ll,
// of, ml order); tabs: (rows, ZTAB) i32, rows = 1 when per_row is 0 else
// ceil(nc / per_row); ll, ml, ofv, off: (nc, k) i32, 16-byte aligned;
// endl: (nc,) i32.  1 <= k <= 8.
int ct_zseq_decode(const uint8_t* windows, const int32_t* lbit,
                   const int32_t* nsym, const int32_t* nore,
                   const int32_t* states, const int32_t* reps,
                   const int32_t* tabs, int per_row, int nc, int win, int k,
                   int rep3_floor, int32_t* ll, int32_t* ml, int32_t* ofv,
                   int32_t* off, int32_t* endl, cudaStream_t stream) {
  if (nc <= 0) return 0;
  if (win <= 0 || win % 4 || win > 4 * ZS_MAX_WORDS || k < 1 ||
      k > ZS_MAX_K || per_row < 0)
    return (int)cudaErrorInvalidValue;
  const int grid = (nc + ZS_THREADS - 1) / ZS_THREADS;
  zseq_decode_kernel<<<grid, ZS_THREADS, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(windows), win / 4, lbit, nsym, nore,
      states, reps, tabs, per_row, nc, k, rep3_floor, ll, ml, ofv, off, endl);
  return (int)cudaGetLastError();
}

}  // extern "C"
