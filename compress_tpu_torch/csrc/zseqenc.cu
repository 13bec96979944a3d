// zstd sequence-encode chains for 64 KiB blocks: the repeat-offset state
// machine and the 3-stream FSE encode chain, one serial chain per block.
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
// Outputs past the last live step are 0; the final states are returned.
//
// Bound on the H100: the chains are serial, so the bound is latency: the
// longest chain (max n_seqs) steps of dependent shared-memory loads and
// integer operations.  The bytes bound (read the fields once, write the
// results once) is far below it.
//
// Design: one CTA per block.  Its threads stage a chunk of the block's
// fields in shared memory with coalesced loads, thread 0 walks the chunk
// (for fse_chain with the three tables in shared memory too) and writes
// its results back into the staged arrays, and the CTA stores them
// coalesced.  Many blocks run at once, one chain each; only the block's
// own n_seqs steps are walked (the TPU kernel masks all 12288).
#include "ct_common.cuh"

namespace {

constexpr int CHAIN_THREADS = 128;
constexpr int CHUNK = 2048;
constexpr int SIZE = 128;  // 1 << FSE_LOG

__global__ void __launch_bounds__(CHAIN_THREADS)
    rep_kernel(const int32_t* __restrict__ of_in,
               const int32_t* __restrict__ ll_in,
               const int32_t* __restrict__ n_seqs, int32_t* __restrict__ out,
               int ms) {
  __shared__ int32_t s_of[CHUNK], s_ll[CHUNK];
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * ms;
  const int n = max(0, min(n_seqs[blockIdx.x], ms));
  int r1 = 1, r2 = 4, r3 = 8, cnt = 0;  // thread 0's chain state
  for (int lo = 0; lo < n; lo += CHUNK) {
    const int len = min(CHUNK, n - lo);
    for (int i = tid; i < len; i += CHAIN_THREADS) {
      s_of[i] = of_in[row + lo + i];
      s_ll[i] = ll_in[row + lo + i];
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < len; ++i) {
        const int off = s_of[i];
        const bool ll0 = s_ll[i] == 0;
        int val;
        if (!ll0)
          val = off == r1 ? 1 : off == r2 ? 2 : off == r3 ? 3 : off + 3;
        else
          val = off == r2 ? 1
                : off == r3 ? 2
                : (off == r1 - 1 && off > 0) ? 3
                : off + 3;
        if (cnt < 3) val = off + 3;
        const bool swap = (!ll0 && val == 2) || (ll0 && val == 1);
        const bool rot = (!ll0 && val == 3) || (ll0 && val == 2);
        const bool push = val > 3 || (ll0 && val == 3);
        const int n1 = swap ? r2 : rot ? r3 : push ? off : r1;
        const int n2 = (swap || rot || push) ? r1 : r2;
        const int n3 = (rot || push) ? r2 : r3;
        r1 = n1;
        r2 = n2;
        r3 = n3;
        ++cnt;
        s_of[i] = val;
      }
    }
    __syncthreads();
    for (int i = tid; i < len; i += CHAIN_THREADS) out[row + lo + i] = s_of[i];
    __syncthreads();
  }
  for (int i = n + tid; i < ms; i += CHAIN_THREADS) out[row + i] = 0;
}

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

__global__ void __launch_bounds__(CHAIN_THREADS)
    fse_kernel(const int32_t* __restrict__ pk_ll,
               const int32_t* __restrict__ pk_of,
               const int32_t* __restrict__ pk_ml,
               const int32_t* __restrict__ n_seqs,
               const int32_t* __restrict__ tables, int32_t* __restrict__ val_out,
               int32_t* __restrict__ nb_out, int32_t* __restrict__ fin,
               int ms) {
  __shared__ int32_t s_ll[CHUNK], s_of[CHUNK], s_ml[CHUNK];
  __shared__ int32_t tab[3 * SIZE];
  const int tid = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * ms;
  const int n = max(0, min(n_seqs[blockIdx.x], ms));
  for (int i = tid; i < 3 * SIZE; i += CHAIN_THREADS) tab[i] = tables[i];
  int sll = 0, sof = 0, sml = 0;  // thread 0's states (ll, of, ml)
  for (int hi = n; hi > 0; hi -= CHUNK) {
    const int lo = max(hi - CHUNK, 0), len = hi - lo;
    __syncthreads();
    for (int i = tid; i < len; i += CHAIN_THREADS) {
      s_ll[i] = pk_ll[row + lo + i];
      s_of[i] = pk_of[row + lo + i];
      s_ml[i] = pk_ml[row + lo + i];
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = len - 1; i >= 0; --i) {
        uint32_t vv = 0;
        int nn = 0;
        if (lo + i == n - 1) {
          sll = fse_init(s_ll[i], tab);
          sof = fse_init(s_of[i], tab + SIZE);
          sml = fse_init(s_ml[i], tab + 2 * SIZE);
        } else {
          const Step a = fse_step(sll, s_ll[i], tab);
          const Step o = fse_step(sof, s_of[i], tab + SIZE);
          const Step m = fse_step(sml, s_ml[i], tab + 2 * SIZE);
          const int sh1 = min(max(o.nb, 0), 16);
          const int sh2 = min(max(o.nb + m.nb, 0), 26);
          vv = o.val | (m.val << sh1) | (a.val << sh2);
          nn = o.nb + m.nb + a.nb;
          sll = a.st_enc;
          sof = o.st_enc;
          sml = m.st_enc;
        }
        s_ll[i] = (int32_t)vv;  // results overwrite the consumed fields
        s_of[i] = nn;
      }
    }
    __syncthreads();
    for (int i = tid; i < len; i += CHAIN_THREADS) {
      val_out[row + lo + i] = s_ll[i];
      nb_out[row + lo + i] = s_of[i];
    }
  }
  for (int i = n + tid; i < ms; i += CHAIN_THREADS) {
    val_out[row + i] = 0;
    nb_out[row + i] = 0;
  }
  if (tid == 0) {
    fin[3 * blockIdx.x + 0] = sll;
    fin[3 * blockIdx.x + 1] = sof;
    fin[3 * blockIdx.x + 2] = sml;
  }
}

}  // namespace

extern "C" {

// of, ll, out: (nb, ms) i32; n_seqs: (nb,) i32.
int ct_rep_scan(const int32_t* of, const int32_t* ll, const int32_t* n_seqs,
                int32_t* out, int nb, int ms, cudaStream_t stream) {
  if (nb <= 0) return 0;
  rep_kernel<<<nb, CHAIN_THREADS, 0, stream>>>(of, ll, n_seqs, out, ms);
  return (int)cudaGetLastError();
}

// pk_ll, pk_of, pk_ml, val, nbits: (nb, ms) i32; n_seqs: (nb,) i32;
// tables: (3, 128) i32 (ll, of, ml); fin: (nb, 3) i32.
int ct_fse_chain(const int32_t* pk_ll, const int32_t* pk_of,
                 const int32_t* pk_ml, const int32_t* n_seqs,
                 const int32_t* tables, int32_t* val, int32_t* nbits,
                 int32_t* fin, int nb, int ms, cudaStream_t stream) {
  if (nb <= 0) return 0;
  fse_kernel<<<nb, CHAIN_THREADS, 0, stream>>>(pk_ll, pk_of, pk_ml, n_seqs,
                                               tables, val, nbits, fin, ms);
  return (int)cudaGetLastError();
}

}  // extern "C"
