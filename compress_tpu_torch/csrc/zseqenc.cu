// zstd sequence-encode chains for 64 KiB blocks: the repeat-offset state
// machine and the 3-stream FSE encode chain.
//
// Replaces: compress_tpu/ops/zseqenc.py `_rep_kernel` (via `rep_scan`) and
// `_fse_kernel` (via `fse_chain`).
//
// rep_scan, forward over a block's n_seqs sequences: each raw offset
// becomes a repeat code 1-3 or off + 3 under the decoder's repeat-offset
// rules (state 1, 4, 8 at the block start; the first 3 sequences are
// always off + 3, so every block's state is its own).
//
// fse_chain, backward from sequence n_seqs - 1: that step only sets the
// three states from the init rule (cinit); every earlier step writes the
// current states' low bits (of, then ml, then ll, fused LSB-first into one
// (value, nbits) item) and moves each state through its stream's 128-entry
// table, with the per-sequence (delta_nb, delta_fs) packed in one int32.
// A doped RLE stream (dnb = dfs = -128, table all 128) emits no bits.
// Where n_seqs exceeds the row, every step of the row is live and the
// chain starts from state 0 (the plain version's rule).  Outputs past the
// last live step are 0; the final states are returned.
//
// Bound on the H100: bytes (read the fields once, write the results
// once), far below the time a serial walk of the longest chain takes;
// both designs below cut that walk's length.
//
// Design, repeat scan: one CTA of 512 threads per block, 2048 sequences a
// chunk (4 a thread), the state (r1, r2, r3) carried between chunks.
// Where every live offset of a chunk is >= 1, every step makes r1 its
// offset, so r1_t = off_{t-1}; a step keeps r2 and r3 (KEEP: t >= 3,
// ll != 0, off == r1) or swaps r1 and r2 (SWAP: t >= 3, not KEEP, off ==
// r2), and else pushes.  So r2_t is r1 at the last non-KEEP step before t
// and r3_t is r2 at the last step before t that is neither: two block-wide
// prefix-maximum scans of step indices (thread, warp shuffles, warps)
// and gathers from shared memory, no serial chain.  That needs off + 3 >
// 3, so a chunk with a live offset <= 0 or within 3 of INT32_MAX (where
// off + 3 wraps negative and the step moves no state) is walked serially
// by one thread from the carried state (a block-wide vote).  All of it is
// int32 arithmetic with the reference's wrap.
//
// Design, FSE chain: one CTA of three warps per block, a warp per stream
// (the streams are independent until the fused write), the chain cut into
// chunks of 2048 sequences from the top and each chunk into 32 segments,
// one a lane.  The CTA first stages the chunk's packed deltas in shared
// memory, all copies in flight at once (cp.async): a lane walking its own
// segment from device memory would wait at every new sector.  Pass 1:
// each lane walks its segment from a guessed entry state (the init rule
// at the step before it in chain order; the top lane's entry is exact)
// and records every state in shared memory.  Pass 2, in rounds until no
// lane changes: a lane whose recorded entry differs from the exit of the
// lane before it re-walks from that exit and stops at the first state
// equal to its record (from there on the record is right).  That is exact
// by construction, and its worst case (no two trajectories merge) is the
// serial walk.  Trajectories mostly merge within tens of steps, so a
// round is short and few rounds run.  The records and the staged deltas
// sit lane-interleaved (step s of lane k at s * 33 + k), so the lanes'
// walks and the output pass's consecutive steps hit distinct banks.
// A walk step is a chain of dependent integer operations and one table
// load, so the walks take 8 steps' deltas ahead of the stores, carry
// st + SIZE (one add less a step) and branch once per 8 steps; and where
// a stream's table and every delta of the chunk leave the step's clamps
// no work (pass 1 checks that off the chain), pass 2 steps without them.
// Then all three warps compute every step's (value, nbits) from the
// recorded states with fse_step and store them coalesced.
#include "ct_common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SIZE = 128;  // 1 << FSE_LOG

// ---- repeat scan --------------------------------------------------------

constexpr int REP_THREADS = 512;
constexpr int REP_WARPS = REP_THREADS / 32;
constexpr int REP_PER = 4;
constexpr int REP_CHUNK = REP_THREADS * REP_PER;

// int32 addition with the two's complement wrap the reference's has
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// a step's value from the state before it (off + 3 and r1 - 1 wrap)
__device__ __forceinline__ int rep_val(int off, bool ll0, int r1, int r2,
                                       int r3, int t) {
  const int o3 = add_wrap(off, 3);
  if (t < 3) return o3;
  if (!ll0) return off == r1 ? 1 : off == r2 ? 2 : off == r3 ? 3 : o3;
  return off == r2 ? 1
         : off == r3 ? 2
         : (off == add_wrap(r1, -1) && off > 0) ? 3
         : o3;
}

// exclusive block-wide prefix maximum of v (thread order); -1 before the
// first thread.  Every thread of the CTA calls it; s_w holds REP_WARPS.
__device__ __forceinline__ int block_excl_max(int v, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc = max(inc, u);
  }
  if (lane == 31) s_w[warp] = inc;
  int ex = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) ex = -1;
  __syncthreads();
  for (int w = 0; w < warp; ++w) ex = max(ex, s_w[w]);
  return ex;
}

__global__ void __launch_bounds__(REP_THREADS)
    rep_kernel(const int32_t* __restrict__ of_in,
               const int32_t* __restrict__ ll_in,
               const int32_t* __restrict__ n_seqs, int32_t* __restrict__ out,
               int ms) {
  __shared__ int32_t s_off[REP_CHUNK], s_ll[REP_CHUNK], s_r2[REP_CHUNK];
  __shared__ int s_wp[REP_WARPS], s_wq[REP_WARPS];
  __shared__ int s_state[3];  // (r1, r2, r3) before the chunk
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * ms;
  const int n = max(0, min(n_seqs[blockIdx.x], ms));
  if (tid == 0) s_state[0] = 1, s_state[1] = 4, s_state[2] = 8;
  for (int c0 = 0; c0 < n; c0 += REP_CHUNK) {
    const int len = min(REP_CHUNK, n - c0);
    __syncthreads();  // the last chunk's readers are done, its state set
    const int r1c = s_state[0], r2c = s_state[1], r3c = s_state[2];
    bool bad = false;
#pragma unroll
    for (int k = 0; k < REP_PER; ++k) {
      const int j = k * REP_THREADS + tid;
      if (j < len) {
        s_off[j] = of_in[row + c0 + j];
        s_ll[j] = ll_in[row + c0 + j];
        // the scan form holds where off + 3 > 3 without a wrap
        bad |= s_off[j] <= 0 || s_off[j] > INT32_MAX - 3;
      }
    }
    if (__syncthreads_or(bad)) {
      // ---- serial route: thread 0 walks the chunk (s_ll -> values) ----
      if (tid == 0) {
        int r1 = r1c, r2 = r2c, r3 = r3c;
        for (int j = 0; j < len; ++j) {
          const int off = s_off[j];
          const bool ll0 = s_ll[j] == 0;
          const int val = rep_val(off, ll0, r1, r2, r3, c0 + j);
          const bool swap = (!ll0 && val == 2) || (ll0 && val == 1);
          const bool rot = (!ll0 && val == 3) || (ll0 && val == 2);
          const bool push = val > 3 || (ll0 && val == 3);
          const int n1 = swap ? r2 : rot ? r3 : push ? off : r1;
          const int n2 = (swap || rot || push) ? r1 : r2;
          const int n3 = (rot || push) ? r2 : r3;
          r1 = n1, r2 = n2, r3 = n3;
          s_ll[j] = val;
        }
        s_state[0] = r1, s_state[1] = r2, s_state[2] = r3;
      }
    } else {
      // ---- scan route: 4 consecutive sequences a thread ---------------
      const int j0 = tid * REP_PER;
      int off[REP_PER], r1[REP_PER], r2[REP_PER];
      bool ll0[REP_PER], keep[REP_PER], swap[REP_PER];
      int pv = -1, pl[REP_PER];  // this thread's non-KEEP prefix maximum
#pragma unroll
      for (int k = 0; k < REP_PER; ++k) {
        const int j = j0 + k;
        const bool live = j < len;
        off[k] = live ? s_off[j] : 0;
        ll0[k] = live && s_ll[j] == 0;
        r1[k] = k ? off[k - 1] : (j0 ? (live ? s_off[j0 - 1] : 0) : r1c);
        keep[k] = live && c0 + j >= 3 && !ll0[k] && off[k] == r1[k];
        pl[k] = pv;
        if (live && !keep[k]) pv = j;
      }
      const int pre = block_excl_max(pv, s_wp);
      int qv = -1, ql[REP_PER];
#pragma unroll
      for (int k = 0; k < REP_PER; ++k) {
        const int j = j0 + k;
        const int p = max(pre, pl[k]);
        // r1 at step p: the offset before it (the carried r1 at 0)
        r2[k] = p < 0 ? r2c : (p == 0 ? r1c : s_off[p - 1]);
        swap[k] = j < len && c0 + j >= 3 && !keep[k] && off[k] == r2[k];
        ql[k] = qv;
        if (j < len && !keep[k] && !swap[k]) qv = j;
        if (j < len) s_r2[j] = r2[k];
      }
      const int qre = block_excl_max(qv, s_wq);  // its barrier orders s_r2
#pragma unroll
      for (int k = 0; k < REP_PER; ++k) {
        const int j = j0 + k;
        if (j >= len) break;
        const int q = max(qre, ql[k]);
        const int r3 = q < 0 ? r3c : s_r2[q];
        s_ll[j] = rep_val(off[k], ll0[k], r1[k], r2[k], r3, c0 + j);
        if (j == len - 1) {
          // the state after the chunk: the same rules one step past its
          // end (no step after it in this thread is live)
          const int pe = max(pre, pv), qe = max(qre, qv);
          s_state[0] = off[k];
          s_state[1] = pe < 0 ? r2c : (pe == 0 ? r1c : s_off[pe - 1]);
          s_state[2] = qe < 0 ? r3c : s_r2[qe];
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < REP_PER; ++k) {
      const int j = k * REP_THREADS + tid;
      if (j < len) out[row + c0 + j] = s_ll[j];
    }
  }
  for (int i = n + tid; i < ms; i += REP_THREADS) out[row + i] = 0;
}

// ---- FSE chain -----------------------------------------------------------

constexpr int FSE_LANES = 32;
constexpr int FSE_THREADS = 3 * 32;  // a warp per stream
constexpr int FSE_CHUNK = 2048;
constexpr int FSE_SEG = FSE_CHUNK / FSE_LANES;  // the longest segment
constexpr int FSE_REC = FSE_SEG * (FSE_LANES + 1);
// records, then staged deltas, of the three streams; then the tables
constexpr size_t FSE_SMEM = (6 * FSE_REC + 3 * SIZE) * sizeof(int);

struct Step {
  uint32_t val;
  int nb, st_enc;
};

// one stream's step from state st with packed deltas pk
__device__ __forceinline__ Step fse_step(int st, int pk, const int* table) {
  const int dfs = (pk & 511) - 128;
  const int dnb = (pk >> 9) - 128;
  const int nb = (st + SIZE + dnb) >> 16;
  const int nbc = min(max(nb, 0), 16);
  Step r;
  r.val = (uint32_t)(st + SIZE) & ((1u << nbc) - 1u);
  r.nb = nb;
  const int lu = min(max(((st + SIZE) >> nbc) + dfs, 0), SIZE - 1);
  r.st_enc = table[lu] - SIZE;
  return r;
}

// a stream's state at its last sequence (the init rule)
__device__ __forceinline__ int fse_init(int pk, const int* table) {
  const int dfs = (pk & 511) - 128;
  const int dnb = (pk >> 9) - 128;
  const int nb0 = min(max((dnb + (1 << 15)) >> 16, 0), 16);
  const int im = (nb0 << 16) - dnb;
  const int lu0 = min(max((im >> nb0) + dfs, 0), SIZE - 1);
  return table[lu0] - SIZE;
}

// The walks carry x = st + SIZE, the table entry itself, in place of st:
// fse_step's next state from st is table[lu] - SIZE with nb = (x + dnb)
// >> 16 and lu from x >> nbc, so from x the next x is table[lu] with the
// same clamps and shifts (st + SIZE wraps to x exactly), one add shorter
// on the chain.  dnb1 = dnb, dfs1 = dfs, computed off the chain.
__device__ __forceinline__ int fse_next_x(int x, int dnb, int dfs,
                                          const int* table) {
  const int nb = (x + dnb) >> 16;
  const int nbc = min(max(nb, 0), 16);
  const int lu = min(max((x >> nbc) + dfs, 0), SIZE - 1);
  return table[lu];
}

// Where no clamp binds, the step is shorter: states x in [SIZE, 2 * SIZE)
// (every table entry there), nb = (x + dnb) >> 16 in [0, 16] and (x >>
// nb) + dfs in [0, SIZE) for every such x.  clamp_free says whether a
// step's deltas guarantee that for every x in [SIZE, 2 * SIZE).  Over 128
// consecutive x, nb takes at most two values, lo = nb(SIZE) and hi =
// nb(2 * SIZE - 1); x >> nb grows with x within each, so the ends of the
// two ranges of x decide (without a branch; dnb < 2^22 by the packing).
__device__ __forceinline__ bool clamp_free(int pk) {
  const int dfs = (pk & 511) - 128;
  const int dnb = (pk >> 9) - 128;
  const int lo = (SIZE + dnb) >> 16, hi = (2 * SIZE - 1 + dnb) >> 16;
  const int edge = hi > lo ? (hi << 16) - dnb : SIZE;  // first x of hi
  const int top_lo = hi > lo ? edge - 1 : 2 * SIZE - 1;   // last x of lo
  return lo >= 0 && hi <= 16 && (SIZE >> lo) + dfs >= 0 &&
         (top_lo >> lo) + dfs <= SIZE - 1 && (edge >> hi) + dfs >= 0 &&
         ((2 * SIZE - 1) >> hi) + dfs <= SIZE - 1;
}

// the step of fse_next_x where clamp_free holds; table_dfs = table + dfs
__device__ __forceinline__ int fse_next_fast(int x, int dnb,
                                             const int* table_dfs) {
  return table_dfs[x >> ((x + dnb) >> 16)];
}

constexpr int REC_STRIDE = FSE_LANES + 1;  // lane k's step s at s * 33 + k
constexpr int GROUP = 8;  // steps whose deltas are loaded ahead together

// u / seg for u < FSE_CHUNK and 1 <= seg <= FSE_SEG, by a multiply: the
// reciprocal's error stays below 2^-9 < 1 / seg at these sizes
__device__ __forceinline__ int div_seg(int u, unsigned inv) {
  return (int)(((unsigned)u * inv) >> 20);
}

// record slot of chain position u (step top - 1 - u) of a chunk cut into
// segments of seg steps: lane u / seg, its step u % seg
__device__ __forceinline__ int rec_at(int u, int seg, unsigned inv) {
  const int k = div_seg(u, inv);
  return (u - k * seg) * REC_STRIDE + k;
}

constexpr int PAD_DELTA = 128 << 9;  // dnb = 0, dfs = -128: clamp-free

// the group of steps [s, s + GROUP) of this lane from x (st + SIZE): the
// states it records (st), whether one equals the record r (met, rewalk
// only), whether all its deltas are clamp-free (ok, pass 1 only: off the
// chain), and the x after the group (past len it is not used: the walk
// ends with this group).  Every step is computed (past len with a
// clamp-free delta; the clamped step takes any delta) and only the
// records before len are stored, so the group has no branch.
template <bool REWALK, bool FAST>
__device__ __forceinline__ int walk_group(int x, int s, int len,
                                          const int (&p)[GROUP],
                                          const int (&r)[GROUP], int* rec,
                                          const int* tw, int lane,
                                          bool& met, bool& ok) {
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const bool in = s + j < len;
    const int pj = in ? p[j] : PAD_DELTA;
    const int dfs = (pj & 511) - 128;
    const int dnb = (pj >> 9) - 128;
    if (!REWALK) ok &= clamp_free(pj);
    x = FAST ? fse_next_fast(x, dnb, tw + dfs) : fse_next_x(x, dnb, dfs, tw);
    if (REWALK) met |= in && x - SIZE == r[j];
    if (in) rec[(s + j) * REC_STRIDE + lane] = x - SIZE;
  }
  return x;
}

// this lane's steps [s0, len) from state st, recording each state (pass
// 1, clamped; returns whether all its deltas are clamp-free); or (REWALK)
// its steps [0, len) from st until a state equals the one recorded (from
// there on the record is right, and the steps past it in the group store
// what was there).  The next group's deltas (and records) are loaded
// before this group's records are stored: shared loads would otherwise
// wait on the stores.
template <bool REWALK, bool FAST>
__device__ __forceinline__ bool walk(int st, int s0, int len, const int* pkw,
                                     int* rec, const int* tw, int lane) {
  int p[GROUP], r[GROUP];
#pragma unroll
  for (int j = 0; j < GROUP; ++j) {
    const int t = min(s0 + j, FSE_SEG - 1);
    p[j] = pkw[t * REC_STRIDE + lane];
    r[j] = REWALK ? rec[t * REC_STRIDE + lane] : 0;
  }
  int x = st + SIZE;
  bool ok = true;
  for (int s = s0; s < len; s += GROUP) {
    int q[GROUP], o[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const int t = min(s + GROUP + j, FSE_SEG - 1);
      q[j] = pkw[t * REC_STRIDE + lane];
      o[j] = REWALK ? rec[t * REC_STRIDE + lane] : 0;
    }
    bool met = false;
    x = walk_group<REWALK, FAST>(x, s, len, p, r, rec, tw, lane, met, ok);
    if (REWALK && met) return ok;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      p[j] = q[j];
      r[j] = o[j];
    }
  }
  return ok;
}

__global__ void __launch_bounds__(FSE_THREADS)
    fse_kernel(const int32_t* __restrict__ pk_ll,
               const int32_t* __restrict__ pk_of,
               const int32_t* __restrict__ pk_ml,
               const int32_t* __restrict__ n_seqs,
               const int32_t* __restrict__ tables, int32_t* __restrict__ val_out,
               int32_t* __restrict__ nb_out, int32_t* __restrict__ fin,
               int ms, int clamped_only) {
  extern __shared__ int fse_smem[];
  int* spk = fse_smem + 3 * FSE_REC;  // staged deltas, as the records
  int* tab = fse_smem + 6 * FSE_REC;  // (ll, of, ml) tables
  __shared__ int s_above[3];           // the state entering the chunk
  __shared__ int s_tab_ok[3];         // a stream's table in [SIZE, 2 SIZE)
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t row = (size_t)blockIdx.x * ms;
  const int n_raw = n_seqs[blockIdx.x];
  const int n = max(0, min(n_raw, ms));
  // past the row every step is live, from state 0; else step n - 1 inits
  const bool over = n_raw > ms;
  const int last = over ? n : n - 1;  // steps that write bits
  if (tid < 3) s_above[tid] = 0, s_tab_ok[tid] = 1;
  __syncthreads();
  for (int i = tid; i < 3 * SIZE; i += FSE_THREADS) {
    tab[i] = tables[i];
    if (tables[i] < SIZE || tables[i] >= 2 * SIZE) s_tab_ok[i / SIZE] = 0;
  }
  __syncthreads();
  const bool tab_ok = s_tab_ok[w];
  const int* tw = tab + w * SIZE;
  int* rec = fse_smem + w * FSE_REC;
  const int* pkw = spk + w * FSE_REC;  // this stream's deltas, staged
  for (int top = n; top > 0;) {
    const int lo_c = max(top - FSE_CHUNK, 0), m = top - lo_c;
    const int seg = (m + FSE_LANES - 1) / FSE_LANES;
    const unsigned inv = (1u << 20) / seg + 1;
    const bool init = top == n && !over;
    // ---- stage the chunk's deltas: step i at rec_at(top - 1 - i), all
    // copies in flight at once (cp.async; three warps would otherwise
    // wait on device memory at every load)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int32_t* pkk = (k == 0 ? pk_ll : k == 1 ? pk_of : pk_ml) + row;
      for (int i = lo_c + tid; i < top; i += FSE_THREADS) {
        const unsigned dst = (unsigned)__cvta_generic_to_shared(
            spk + k * FSE_REC + rec_at(top - 1 - i, seg, inv));
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(pkk + i)
                     : "memory");
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    // ---- pass 1: lane k walks steps top - 1 - k * seg downward ---------
    const int hi = top - lane * seg;
    const int lo = max(hi - seg, lo_c);
    const bool live = hi > lo;
    // lane k's step s (step hi - 1 - s) at s * 33 + k; the step before
    // its segment in chain order is lane k - 1's last, seg - 1
    int ent, s0 = 0;  // the (guessed) state entering the segment
    if (lane == 0 && init) {
      ent = fse_init(pkw[0], tw);
      rec[0] = ent;
      s0 = 1;
    } else if (lane == 0) {
      ent = s_above[w];
    } else {
      ent = live ? fse_init(pkw[(seg - 1) * REC_STRIDE + lane - 1], tw) : 0;
    }
    const int len = live ? hi - lo : 0;
    // pass 1 also checks its deltas: pass 2 walks without the clamps where
    // the stream's tables and every delta of the chunk allow it (and the
    // caller does not ask for the clamped walk, to time it)
    const bool fast =
        __all_sync(FULL, walk<false, false>(ent, s0, len, pkw, rec, tw, lane) &&
                             tab_ok) &&
        !clamped_only;
    __syncwarp();
    // ---- pass 2: re-walk from the exit before until the record is met --
    for (;;) {
      // the lane before's last state: its step seg - 1
      const int ex =
          lane > 0 && live ? rec[(seg - 1) * REC_STRIDE + lane - 1] : 0;
      __syncwarp();
      const bool need = lane > 0 && live && ent != ex;
      if (!__any_sync(FULL, need)) break;
      if (need) {
        ent = ex;
        if (fast)
          walk<true, true>(ex, 0, len, pkw, rec, tw, lane);
        else
          walk<true, false>(ex, 0, len, pkw, rec, tw, lane);
      }
      __syncwarp();
    }
    __syncthreads();
    // ---- every step's (value, nbits) from the state before it -----------
    for (int i = lo_c + tid; i < top; i += FSE_THREADS) {
      uint32_t vv = 0;
      int nn = 0;
      if (i < last) {
        const int u = top - 2 - i;  // the state after step i + 1
        const int ai = rec_at(u + 1, seg, inv);  // step i's deltas
        const int au = u < 0 ? 0 : rec_at(u, seg, inv);
        Step st[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int s = u < 0 ? s_above[k] : fse_smem[k * FSE_REC + au];
          st[k] = fse_step(s, spk[k * FSE_REC + ai], tab + k * SIZE);
        }
        const Step &a = st[0], &o = st[1], &mm = st[2];
        const int sh1 = min(max(o.nb, 0), 16);
        const int sh2 = min(max(o.nb + mm.nb, 0), 26);
        vv = o.val | (mm.val << sh1) | (a.val << sh2);
        nn = o.nb + mm.nb + a.nb;
      }
      val_out[row + i] = (int32_t)vv;
      nb_out[row + i] = nn;
    }
    __syncthreads();
    // the state after step lo_c enters the next chunk
    if (tid < 3)
      s_above[tid] = fse_smem[tid * FSE_REC + rec_at(m - 1, seg, inv)];
    __syncthreads();
    top = lo_c;
  }
  for (int i = n + tid; i < ms; i += FSE_THREADS) {
    val_out[row + i] = 0;
    nb_out[row + i] = 0;
  }
  if (tid < 3) fin[3 * blockIdx.x + tid] = n > 0 ? s_above[tid] : 0;
}

}  // namespace

extern "C" {

// of, ll, out: (nb, ms) i32; n_seqs: (nb,) i32.
int ct_rep_scan(const int32_t* of, const int32_t* ll, const int32_t* n_seqs,
                int32_t* out, int nb, int ms, cudaStream_t stream) {
  if (nb <= 0) return 0;
  rep_kernel<<<nb, REP_THREADS, 0, stream>>>(of, ll, n_seqs, out, ms);
  return (int)cudaGetLastError();
}

// pk_ll, pk_of, pk_ml, val, nbits: (nb, ms) i32; n_seqs: (nb,) i32;
// tables: (3, 128) i32 (ll, of, ml); fin: (nb, 3) i32.  clamped_only:
// re-walk with the step's clamps everywhere (the same results).
int ct_fse_chain(const int32_t* pk_ll, const int32_t* pk_of,
                 const int32_t* pk_ml, const int32_t* n_seqs,
                 const int32_t* tables, int32_t* val, int32_t* nbits,
                 int32_t* fin, int nb, int ms, int clamped_only,
                 cudaStream_t stream) {
  if (nb <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FSE_SMEM);
  if (e != cudaSuccess) return (int)e;
  fse_kernel<<<nb, FSE_THREADS, FSE_SMEM, stream>>>(
      pk_ll, pk_of, pk_ml, n_seqs, tables, val, nbits, fin, ms, clamped_only);
  return (int)cudaGetLastError();
}

// CTAs of each chain kernel resident on one SM (< 0: an error).
int ct_rep_occupancy() {
  int n = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, rep_kernel, REP_THREADS, 0);
  return e == cudaSuccess ? n : -(int)e;
}

int ct_fse_occupancy() {
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(
      fse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FSE_SMEM);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fse_kernel,
                                                      FSE_THREADS, FSE_SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
