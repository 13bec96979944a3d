// zstd encoder levels 1-4 — host-side native core (RFC 8878).
//
// Level ladder (the reference's enc_fast.go / enc_dfast.go / enc_better.go /
// enc_best.go roles, re-designed rather than translated):
//   L1: single hash-table greedy with rep1 probe, skip acceleration.
//   L2: two-table (5-byte short + 8-byte long hash) greedy with full
//       rep-offset codes.
//   L3: hash-chain lazy (one-position lookahead), rep codes.
//   L4: deep hash-chain lazy with a bit-cost score (6*len - offsetbits,
//       the estBits-lite analogue of enc_best.go:29-60), rep codes.
// Rep-offset state mirrors the decoder exactly (RFC 8878 repeat offsets,
// including the ll==0 code shift); when encoding job blocks that join a
// larger frame, the first 3 sequences are forced plain so the job's rep
// state is self-contained (same invariant as ops/zdev.py).
// Literals: huff0 4X with a raw-nibble weight table; sequences use
// per-stream FSE/RLE/predefined chosen by estimated bit cost (the
// chooseComp role, blockenc.go:633). The pure-Python encoder
// (zstd/encoder.py) remains the differential oracle.

#include <cstdint>
#include <cstdlib>
#include <cstring>

// phase timers for tools/prof_enc.cpp (-DCT_PROF): rdtsc deltas into
// ct_phase_cycles[] — compiled out of the production .so
#ifdef CT_PROF
#include <x86intrin.h>
extern "C" unsigned long long ct_phase_cycles[16];
unsigned long long ct_phase_cycles[16];
static unsigned long long ct_prof_t0;
#define CT_TIC() (ct_prof_t0 = __rdtsc())
#define CT_TOC(i) (ct_phase_cycles[i] += __rdtsc() - ct_prof_t0, \
                   ct_prof_t0 = __rdtsc())
#else
#define CT_TIC()
#define CT_TOC(i)
#endif

extern "C" {

static inline uint64_t ld64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline uint32_t ld32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline uint32_t zhash(uint64_t v, int bits) {
  return (uint32_t)(((v << 32) * 0x9E3779B185EBCA87ULL) >> (64 - bits));
}
static inline uint32_t zhash5(uint64_t v, int bits) {
  return (uint32_t)(((v << 24) * 0x9E3779B185EBCA87ULL) >> (64 - bits));
}
static inline uint32_t zhash8(uint64_t v, int bits) {
  return (uint32_t)((v * 0xCF1BBCDCB7A56463ULL) >> (64 - bits));
}
static inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// forward LSB-first bit writer with 1-bit end marker (fse/core BitWriter)
// ---------------------------------------------------------------------------

struct BitW {
  uint8_t* out;
  long long n;
  uint64_t acc;
  int bits;
};
static inline void bw_init(BitW* w, uint8_t* out) {
  w->out = out;
  w->n = 0;
  w->acc = 0;
  w->bits = 0;
}
static inline void bw_add(BitW* w, uint32_t v, int nb) {
  w->acc |= ((uint64_t)v & ((1ull << nb) - 1)) << w->bits;
  w->bits += nb;
  while (w->bits >= 8) {
    w->out[w->n++] = (uint8_t)w->acc;
    w->acc >>= 8;
    w->bits -= 8;
  }
}
// hot-loop variant pair: bw_push never spills (caller keeps <= 56 pending
// bits between flushes); bw_flush56 dumps whole bytes with ONE 8-byte
// store (scratch buffers are sized with >= 8 bytes of slack).
static inline void bw_push(BitW* w, uint32_t v, int nb) {
  w->acc |= ((uint64_t)v & ((1ull << nb) - 1)) << w->bits;
  w->bits += nb;
}
static inline void bw_flush56(BitW* w) {
  memcpy(w->out + w->n, &w->acc, 8);
  int by = w->bits >> 3;
  w->n += by;
  w->acc >>= (by << 3);
  w->bits &= 7;
}
static inline long long bw_close(BitW* w) {
  bw_add(w, 1, 1);
  if (w->bits) {
    w->out[w->n++] = (uint8_t)w->acc;
    w->acc = 0;
    w->bits = 0;
  }
  return w->n;
}

// ---------------------------------------------------------------------------
// huff0 encode: Kraft lengths + canonical codes + raw-nibble table
// ---------------------------------------------------------------------------

struct Huf {
  uint16_t code[256];
  uint8_t nbits[256];
  int max_bits;
  uint8_t table[136];
  int table_len;
};

long long ct_huf_write_table(const int32_t* nbits /* 256 */, int max_bits,
                             uint8_t* out, long long cap);

// gain-per-cost greedy (mirrors zdev._huff_build): l0 = ceil(-log2 p),
// then shorten best hist/cost first until the Kraft deficit is zero.
static bool huf_build(const uint32_t* hist, long long total, Huf* h) {
  int l[256];
  int present = 0, last = -1;
  for (int s = 0; s < 256; s++) {
    l[s] = 0;
    if (hist[s]) {
      present++;
      last = s;
      // smallest l with hist*2^l >= total, clamped to [1, 11]
      int v = 1;
      while (v < 11 && ((uint64_t)hist[s] << v) < (uint64_t)total) v++;
      l[s] = v;
    }
  }
  if (present < 2) return false;
  long long kraft = 0;
  for (int s = 0; s < 256; s++)
    if (l[s]) kraft += 1ll << (11 - l[s]);
  long long d = (1ll << 11) - kraft;
  if (d < 0) return false;
  while (d > 0) {
    // best gain-per-cost single-level shortening with cost <= d
    int best = -1;
    double best_score = -1;
    for (int s = 0; s < 256; s++) {
      if (l[s] <= 1) continue;
      long long cost = 1ll << (11 - l[s]);
      if (cost > d) continue;
      double score = (double)hist[s] / (double)cost;
      if (score > best_score) {
        best_score = score;
        best = s;
      }
    }
    if (best < 0) return false;
    d -= 1ll << (11 - l[best]);
    l[best]--;
  }
  int mb = 0;
  for (int s = 0; s < 256; s++)
    if (l[s] > mb) mb = l[s];
  h->max_bits = mb;
  // canonical codes: levels nb descending, symbols ascending
  uint32_t start = 0;
  for (int nb = mb; nb >= 1; nb--) {
    uint32_t span = 1u << (mb - nb);
    for (int s = 0; s < 256; s++) {
      if (l[s] != nb) continue;
      h->code[s] = (uint16_t)(start >> (mb - nb));
      h->nbits[s] = (uint8_t)nb;
      start += span;
    }
  }
  if (start != (1u << mb)) return false;
  for (int s = 0; s < 256; s++)
    if (!l[s]) h->nbits[s] = 0;
  // serialize the weight table via the shared writer: FSE-compressed
  // weights or raw nibbles, whichever is smaller. The old inline
  // raw-nibble-only path REJECTED alphabets with > 128 explicit weights,
  // silently downgrading full-alphabet literals (already-compressed-
  // looking data) to raw — measured 38% of the literal section on the
  // reference benchdecoder's comp-data.bin.
  (void)last;
  int32_t nb32[256];
  for (int s = 0; s < 256; s++) nb32[s] = l[s];
  long long tl = ct_huf_write_table(nb32, mb, h->table, sizeof(h->table));
  if (tl <= 0) return false;
  h->table_len = (int)tl;
  return true;
}

static long long huf_stream(const Huf* h, const uint8_t* p, long long n,
                            uint8_t* out) {
  // packed (code | nbits<<12) entries; 4 symbols (<= 44 bits) per flush
  uint32_t pk[256];
  for (int s = 0; s < 256; s++)
    pk[s] = h->code[s] | ((uint32_t)h->nbits[s] << 12);
  BitW w;
  bw_init(&w, out);
  long long i = n - 1;
  for (; i >= 3; i -= 4) {
    uint32_t a = pk[p[i]], b = pk[p[i - 1]], c = pk[p[i - 2]],
             e = pk[p[i - 3]];
    bw_push(&w, a & 0xFFF, a >> 12);
    bw_push(&w, b & 0xFFF, b >> 12);
    bw_push(&w, c & 0xFFF, c >> 12);
    bw_push(&w, e & 0xFFF, e >> 12);
    bw_flush56(&w);
  }
  for (; i >= 0; i--) bw_add(&w, h->code[p[i]], h->nbits[p[i]]);
  return bw_close(&w);
}

// ---------------------------------------------------------------------------
// predefined FSE encode tables (built once)
// ---------------------------------------------------------------------------

struct CTab {
  uint16_t state_table[512];
  int32_t delta_nb[64];
  int32_t delta_fs[64];
  int log;
};

static void ctab_build(const int16_t* norm, int nsym, int log, CTab* t) {
  int size = 1 << log;
  t->log = log;
  uint8_t spread[512];
  int high = size - 1;
  for (int s = 0; s < nsym; s++)
    if (norm[s] == -1) spread[high--] = (uint8_t)s;
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++)
    for (int i = 0; i < norm[s]; i++) {
      spread[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  int cumul[65];
  cumul[0] = 0;
  for (int s = 0; s < nsym; s++)
    cumul[s + 1] = cumul[s] + (norm[s] == -1 ? 1 : (norm[s] < 0 ? 0 : norm[s]));
  int cpos[64];
  for (int s = 0; s < nsym; s++) cpos[s] = cumul[s];
  for (int u = 0; u < size; u++) t->state_table[cpos[spread[u]]++] = (uint16_t)(size + u);
  int total = 0;
  for (int s = 0; s < nsym; s++) {
    int c = norm[s];
    if (c == 0) {
      t->delta_nb[s] = ((log + 1) << 16) - size;
      t->delta_fs[s] = 0;
    } else if (c == -1 || c == 1) {
      t->delta_nb[s] = (log << 16) - size;
      t->delta_fs[s] = total - 1;
      total += 1;
    } else {
      int mbo = log - highbit((uint32_t)(c - 1));
      t->delta_nb[s] = (mbo << 16) - (c << mbo);
      t->delta_fs[s] = total - c;
      total += c;
    }
  }
}

static const int16_t PRE_LL[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                   2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                   2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t PRE_OF[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1,
                                   -1, -1};
static const int16_t PRE_ML[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static CTab g_ll, g_of, g_ml;
static bool g_init = false;

// largest-remainder normalization (fse/core.py normalize_count semantics;
// no -1 low-prob entries for simplicity — every present symbol gets >= 1)
static bool normalize_c(const uint32_t* hist, int nsym, long long total,
                        int log, int16_t* norm) {
  int size = 1 << log;
  int present = 0;
  for (int s = 0; s < nsym; s++) {
    norm[s] = 0;
    if (hist[s]) present++;
  }
  if (present < 2 || present > size) return false;
  long long acc = 0;
  double fr[64];
  for (int s = 0; s < nsym; s++) {
    if (!hist[s]) { fr[s] = -1; continue; }
    double ideal = (double)hist[s] * size / (double)total;
    long long b = (long long)ideal;
    if (b < 1) b = 1;
    norm[s] = (int16_t)b;
    fr[s] = ideal - (double)b;
    acc += b;
  }
  long long diff = size - acc;
  while (diff > 0) {  // hand out by largest remainder
    int best = -1;
    double bf = -2;
    for (int s = 0; s < nsym; s++)
      if (hist[s] && fr[s] > bf) { bf = fr[s]; best = s; }
    norm[best]++; fr[best] -= 1.0; diff--;
  }
  while (diff < 0) {  // steal from the largest
    int best = -1;
    for (int s = 0; s < nsym; s++)
      if (norm[s] > 1 && (best < 0 || norm[s] > norm[best])) best = s;
    if (best < 0) return false;
    norm[best]--; diff++;
  }
  return true;
}

// serialize NCount (fse/core.py write_ncount)
static int write_ncount_c(const int16_t* norm, int max_sym, int log,
                          uint8_t* out) {
  long long bs = 0;
  int bc = 0, n = 0;
  auto put = [&](int v, int nb) {
    bs |= (long long)(v & ((1 << nb) - 1)) << bc;
    bc += nb;
    while (bc >= 16) {
      out[n++] = (uint8_t)bs;
      out[n++] = (uint8_t)(bs >> 8);
      bs >>= 16;
      bc -= 16;
    }
  };
  int size = 1 << log;
  put(log - 5, 4);
  int remaining = size + 1, threshold = size, nb_bits = log + 1;
  int s = 0;
  bool prev0 = false;
  while (remaining > 1 && s <= max_sym) {
    if (prev0) {
      int start = s;
      while (s <= max_sym && norm[s] == 0) s++;
      int run = s - start;
      while (run >= 24) { put(0xFFFF, 16); run -= 24; }
      while (run >= 3) { put(3, 2); run -= 3; }
      put(run, 2);
      if (s > max_sym) break;
    }
    int count = norm[s];
    s++;
    int mx = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count += 1;
    if (count >= threshold) count += mx;
    put(count, nb_bits - (count < mx ? 1 : 0));
    prev0 = count == 1;
    while (remaining < threshold) { nb_bits--; threshold >>= 1; }
  }
  while (bc > 0) {
    out[n++] = (uint8_t)bs;
    bs >>= 8;
    bc -= 8;
  }
  return n;
}

static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
static const uint8_t LL_XBITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                     0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                     4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                                     16};
static const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
static const uint8_t ML_XBITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                     0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,
                                     3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14,
                                     15, 16};

static inline int ll_code(uint32_t ll) {
  static const uint8_t small[64] = {
      0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
      16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21,
      22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23, 23, 23, 23, 23,
      24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24};
  return ll < 64 ? small[ll] : highbit(ll) + 19;
}
static inline int ml_code(uint32_t ml) {
  uint32_t v = ml - 3;
  static const uint8_t small[64] = {
      0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
      16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
      32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37,
      38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39};
  if (v < 64) return small[v];
  if (v < 128) return v < 80 ? 40 : (v < 96 ? 41 : 42);
  return highbit(v) + 36;
}

static inline int cinit(const CTab* t, int sym) {
  int nb = (t->delta_nb[sym] + (1 << 15)) >> 16;
  int im = (nb << 16) - t->delta_nb[sym];
  return t->state_table[(im >> nb) + t->delta_fs[sym]];
}
static inline int cenc(const CTab* t, BitW* w, int state, int sym) {
  int nb = (state + t->delta_nb[sym]) >> 16;
  bw_add(w, (uint32_t)state, nb);
  return t->state_table[(state >> nb) + t->delta_fs[sym]];
}
// no-spill twin for the batched sequence loop (caller flushes)
static inline int cenc2(const CTab* t, BitW* w, int state, int sym) {
  int nb = (state + t->delta_nb[sym]) >> 16;
  bw_push(w, (uint32_t)state, nb);
  return t->state_table[(state >> nb) + t->delta_fs[sym]];
}

// ---------------------------------------------------------------------------
// the encoder
// ---------------------------------------------------------------------------

#define HBITS 16
#define MAXSEQ_PER_BLOCK ((1 << 17) / 4 + 8)

struct Seq {
  uint32_t ll, ml, ofv;
};

// ---- rep-offset state (mirrors the decoder, RFC 8878 §3.1.1.5) ------------

struct Reps {
  uint32_t r[3];
};

// Map actual offset -> offset_value, updating rep state exactly as the
// decoder will. force_plain bypasses rep codes (still updates state).
static inline uint32_t rep_ofv(Reps* R, uint32_t off, uint32_t ll,
                               bool force_plain) {
  uint32_t r0 = R->r[0], r1 = R->r[1], r2 = R->r[2];
  if (!force_plain) {
    if (ll != 0) {
      if (off == r0) return 1;
      if (off == r1) {
        R->r[0] = r1;
        R->r[1] = r0;
        return 2;
      }
      if (off == r2) {
        R->r[0] = r2;
        R->r[1] = r0;
        R->r[2] = r1;
        return 3;
      }
    } else {
      if (off == r1) {
        R->r[0] = r1;
        R->r[1] = r0;
        return 1;
      }
      if (off == r2) {
        R->r[0] = r2;
        R->r[1] = r0;
        R->r[2] = r1;
        return 2;
      }
      if (r0 > 1 && off == r0 - 1) {
        R->r[2] = r1;
        R->r[1] = r0;
        R->r[0] = r0 - 1;
        return 3;
      }
    }
  }
  R->r[2] = r1;
  R->r[1] = r0;
  R->r[0] = off;
  return off + 3;
}

// shared sequence/literal emitter for the L2-L4 searches
struct Emit {
  Seq* seqs;
  long long nseq;
  uint8_t* lits;
  long long lit_n;
  const uint8_t* src;
  long long next_emit;
  Reps R;
  int force_plain;  // countdown: first N sequences emitted plain
};

static inline void emit_seq(Emit* E, long long s, long long m, uint32_t off) {
  long long ll = s - E->next_emit;
  // wild copy: every search keeps s <= bend-16, so reading 16 bytes from
  // src+next_emit+q (q < ll <= s-next_emit) stays inside the buffer; lits
  // has 64 bytes of slack (typical ll is < 16 -> ONE unconditional copy
  // instead of a variable-length memcpy call)
  const uint8_t* lp = E->src + E->next_emit;
  uint8_t* od = E->lits + E->lit_n;
  memcpy(od, lp, 16);
  if (ll > 16)
    for (long long q = 16; q < ll; q += 16) memcpy(od + q, lp + q, 16);
  E->lit_n += ll;
  E->seqs[E->nseq].ll = (uint32_t)ll;
  E->seqs[E->nseq].ml = (uint32_t)m;
  E->seqs[E->nseq].ofv =
      rep_ofv(&E->R, off, (uint32_t)ll, E->force_plain > 0);
  if (E->force_plain > 0) E->force_plain--;
  E->nseq++;
  E->next_emit = s + m;
}

static inline long long zmatch_fwd(const uint8_t* src, long long c,
                                   long long s, long long maxm) {
  long long m = 0;
  while (m + 8 <= maxm) {
    uint64_t x = ld64(src + c + m) ^ ld64(src + s + m);
    if (x) return m + (__builtin_ctzll(x) >> 3);
    m += 8;
  }
  while (m < maxm && src[c + m] == src[s + m]) m++;
  return m;
}

// ---- L2: two-table greedy (enc_dfast.go role) ------------------------------

#define LBITS 17
#define SBITS 16

static void search_dfast(Emit* E, const uint8_t* src, long long pos,
                         long long bend, long long window, int32_t* tlong,
                         int32_t* tshort) {
  long long s = pos == 0 ? 1 : pos;
  long long limit = bend - 16;
  while (s < limit) {
    uint64_t v = ld64(src + s);
    uint32_t hl = zhash8(v, LBITS), hs = zhash5(v, SBITS);
    long long cl = tlong[hl], cs = tshort[hs];
    tlong[hl] = (int32_t)s;
    tshort[hs] = (int32_t)s;
    long long cand = -1;
    uint32_t r0 = E->R.r[0];
    // rep-first probe (cheapest code)
    if (s >= (long long)r0 && r0 > 0 &&
        ld32(src + s) == ld32(src + s - r0)) {
      cand = s - r0;
    } else if (cl >= 0 && s - cl <= window && ld64(src + cl) == v) {
      cand = cl;
    } else if (cs >= 0 && s - cs <= window &&
               ld32(src + cs) == (uint32_t)v) {
      // short hit: prefer a long-table hit at s+1 when it is longer
      cand = cs;
      uint64_t v1 = ld64(src + s + 1);
      long long cl1 = tlong[zhash8(v1, LBITS)];
      if (cl1 >= 0 && s + 1 - cl1 <= window && ld64(src + cl1) == v1) {
        long long m0 = 4 + zmatch_fwd(src, cand + 4, s + 4, bend - s - 4);
        long long m1 =
            8 + zmatch_fwd(src, cl1 + 8, s + 1 + 8, bend - s - 1 - 8);
        if (m1 > m0 + 1) {
          s += 1;
          cand = cl1;
          tshort[zhash5(v1, SBITS)] = (int32_t)s;
        }
      }
    }
    if (cand < 0) {
      s += 1 + ((s - E->next_emit) >> 7);
      continue;
    }
    while (s > E->next_emit && cand > 0 && src[s - 1] == src[cand - 1]) {
      s--;
      cand--;
    }
    long long m = 4 + zmatch_fwd(src, cand + 4, s + 4, bend - s - 4);
    // same profitability gate as L1: a minimal match at a far offset
    // costs more bits than its literals (rep offsets exempt)
    if (m == 4 && (uint64_t)(s - cand) >= 4096 &&
        (uint32_t)(s - cand) != E->R.r[0]) {
      s++;
      continue;
    }
    emit_seq(E, s, m, (uint32_t)(s - cand));
    long long mstart = s;
    s += m;
    if (s + 16 > bend || E->nseq >= MAXSEQ_PER_BLOCK - 2) break;
    // interior anchors: stride-4 through the match body plus the last two
    // positions, both tables (coverage for later overlapping matches)
    for (long long q = mstart + 1; q < s - 2; q += 4) {
      uint64_t vq = ld64(src + q);
      tlong[zhash8(vq, LBITS)] = (int32_t)q;
      tshort[zhash5(vq, SBITS)] = (int32_t)q;
    }
    uint64_t v1 = ld64(src + s - 2);
    tlong[zhash8(v1, LBITS)] = (int32_t)(s - 2);
    tshort[zhash5(v1, SBITS)] = (int32_t)(s - 2);
    uint64_t v2 = ld64(src + s - 1);
    tlong[zhash8(v2, LBITS)] = (int32_t)(s - 1);
    tshort[zhash5(v2, SBITS)] = (int32_t)(s - 1);
  }
}

// ---- L3/L4: hash-chain lazy with bit-cost score (enc_better/enc_best) ------

struct ZCfg {
  int chain, nice, lazy_thresh;
};

// best candidate at s: walks the chain from `c0` (pre-insert head) and
// probes all 3 reps. Score is in HALF-BITS of estimated saving vs emitting
// literals: lp2 = 2*(estimated bits/literal from the block's byte entropy),
// so score = lp2*len - 2*offset_bits - overhead (estBits analogue of
// enc_best.go:29-60, with the literal price adaptive instead of fixed —
// the r4 fixed 6 bits/lit overpriced text literals and took unprofitable
// short far matches).
static inline int zfind(const uint8_t* src, const int32_t* prev, long long s,
                        long long bend, long long c0, long long window,
                        const Reps* R, int chain, int nice, int lp2,
                        long long c4, long long* out_off, int* out_score) {
  long long maxm = bend - s;
  if (maxm > (1 << 17)) maxm = 1 << 17;
  if (maxm < 4) return 0;
  int best_len = 0, best_score = 0;
  long long best_off = 0;
  // rep probes (match length >= 4): rep0 codes in ~2-4 bits
  for (int k = 0; k < 3; k++) {
    uint32_t rk = R->r[k];
    if (rk == 0 || s < (long long)rk) continue;
    if (ld32(src + s) != ld32(src + s - rk)) continue;
    long long m = 4 + zmatch_fwd(src, s - rk + 4, s + 4, maxm - 4);
    int sc = (int)(lp2 * m) - 4 - 2 * k;
    if (sc > best_score) {
      best_score = sc;
      best_len = (int)m;
      best_off = rk;
    }
  }
  uint32_t v = ld32(src + s);
  long long lo = s - window;
  // 4-byte short-table probe (enc_best.go's short 4B table role): len-4/5
  // matches whose 5th byte differs are invisible to the 5-byte chain
  if (c4 >= 0 && c4 > lo && ld32(src + c4) == v) {
    long long m = 4 + zmatch_fwd(src, c4 + 4, s + 4, maxm - 4);
    int sc = (int)(lp2 * m) - 2 * highbit((uint32_t)(s - c4) + 3) - 12;
    if (sc > best_score && m > best_len) {
      best_score = sc;
      best_len = (int)m;
      best_off = s - c4;
    }
  }
  long long c = c0;
  int qlen = best_len > 3 ? best_len : 3;
  while (c >= 0 && c > lo && chain-- > 0) {
    if (s + qlen < bend && src[c + qlen] == src[s + qlen] &&
        ld32(src + c) == v) {
      long long m = 4 + zmatch_fwd(src, c + 4, s + 4, maxm - 4);
      if (m >= 4) {
        int sc = (int)(lp2 * m) - 2 * highbit((uint32_t)(s - c) + 3) - 12;
        if (sc > best_score && m > best_len) {
          best_score = sc;
          best_len = (int)m;
          best_off = s - c;
          qlen = best_len;
          if (best_len >= nice || s + qlen >= bend) break;
        }
      }
    }
    c = prev[c];
  }
  *out_off = best_off;
  *out_score = best_score;
  return best_len;
}

// ---- L4 binary-tree matcher (libzstd btlazy2 role, re-designed) -----------
// bt[2*i]/bt[2*i+1] = left/right child of position i (masked by btmask);
// each bucket of the 5-byte hash heads a tree ordered by suffix. One walk
// searches AND inserts (the classic dual-pointer descent): candidates on
// the path are exactly the tree neighbours of s's suffix, so the longest
// match in the bucket is always on the path.
static inline int btfind(const uint8_t* src, int32_t* head, int32_t* bt,
                         long long btmask, long long s, long long bend,
                         long long lo, const Reps* R, int depth, int nice,
                         int lp2, long long c4, long long* out_off,
                         int* out_score) {
  long long maxm = bend - s;
  if (maxm > (1 << 17)) maxm = 1 << 17;
  int best_len = 0, best_score = 0;
  long long best_off = 0;
  if (maxm >= 4) {
    for (int k = 0; k < 3; k++) {
      uint32_t rk = R->r[k];
      if (rk == 0 || s < (long long)rk) continue;
      if (ld32(src + s) != ld32(src + s - rk)) continue;
      long long m = 4 + zmatch_fwd(src, s - rk + 4, s + 4, maxm - 4);
      int sc = (int)(lp2 * m) - 4 - 2 * k;
      if (sc > best_score) {
        best_score = sc;
        best_len = (int)m;
        best_off = rk;
      }
    }
    if (c4 >= 0 && c4 > lo && ld32(src + c4) == ld32(src + s)) {
      long long m = 4 + zmatch_fwd(src, c4 + 4, s + 4, maxm - 4);
      int sc = (int)(lp2 * m) - 2 * highbit((uint32_t)(s - c4) + 3) - 12;
      if (sc > best_score && m > best_len) {
        best_score = sc;
        best_len = (int)m;
        best_off = s - c4;
      }
    }
  }
  uint32_t h = zhash(ld64(src + s), HBITS);  // 4-byte bucket: len-4
  long long c = head[h];                       // matches live in the tree
  head[h] = (int32_t)s;
  int32_t* smaller = &bt[2 * (s & btmask)];
  int32_t* larger = &bt[2 * (s & btmask) + 1];
  long long cls = 0, clg = 0;
  // descent uses the same 2048-capped comparator as btins (consistent
  // BST); scoring extends past the cap separately when it is hit
  long long maxc = maxm < 2048 ? maxm : 2048;
  while (c >= 0 && c > lo && depth-- > 0) {
    int32_t* nxt = &bt[2 * (c & btmask)];
    long long m = cls < clg ? cls : clg;
    m += zmatch_fwd(src, c + m, s + m, maxc - m);
    long long sm = m;
    if (m == maxc && maxc < maxm)
      sm = m + zmatch_fwd(src, c + m, s + m, maxm - m);
    if (sm >= 4 && sm > best_len) {
      int sc = (int)(lp2 * sm) - 2 * highbit((uint32_t)(s - c) + 3) - 12;
      if (sc > best_score) {
        best_score = sc;
        best_len = (int)sm;
        best_off = s - c;
      }
    }
    if (s + m >= bend || (int)sm >= nice) {
      // long enough (or no next byte to compare): cut the tree here
      *smaller = *larger = -1;
      goto done;
    }
    if (src[c + m] < src[s + m]) {
      *smaller = (int32_t)c;
      cls = m;
      smaller = nxt + 1;
      c = nxt[1];
    } else {
      *larger = (int32_t)c;
      clg = m;
      larger = nxt;
      c = nxt[0];
    }
  }
  *smaller = -1;
  *larger = -1;
done:
  *out_off = best_off;
  *out_score = best_score;
  return best_len;
}

// insert-only tree descent (ZSTD_updateTree role) for positions inside
// emitted matches; bounded depth keeps long matches cheap
static inline void btins(const uint8_t* src, int32_t* head, int32_t* bt,
                         long long btmask, long long s, long long bend,
                         long long lo) {
  uint32_t h = zhash(ld64(src + s), HBITS);  // 4-byte bucket: len-4
  long long c = head[h];                       // matches live in the tree
  head[h] = (int32_t)s;
  int32_t* smaller = &bt[2 * (s & btmask)];
  int32_t* larger = &bt[2 * (s & btmask) + 1];
  long long cls = 0, clg = 0;
  // cap the insert-compare length: inside long repeats every interior
  // position shares a huge prefix with every tree node, and uncapped
  // extension makes inserts O(match_len) each (html_x_4: 0.17 MB/s).
  // Ties beyond the cap go consistently to the larger side — the tree
  // stays a valid BST under the capped comparator; search results are
  // verified by extension anyway.
  long long maxm = bend - s;
  if (maxm > 2048) maxm = 2048;
  int depth = 32;
  while (c >= 0 && c > lo && depth-- > 0) {
    int32_t* nxt = &bt[2 * (c & btmask)];
    long long m = cls < clg ? cls : clg;
    m += zmatch_fwd(src, c + m, s + m, maxm - m);
    if (s + m >= bend) {
      *smaller = *larger = -1;
      return;
    }
    if (src[c + m] < src[s + m]) {
      *smaller = (int32_t)c;
      cls = m;
      smaller = nxt + 1;
      c = nxt[1];
    } else {
      *larger = (int32_t)c;
      clg = m;
      larger = nxt;
      c = nxt[0];
    }
  }
  *smaller = -1;
  *larger = -1;
}

static void search_lazy(Emit* E, const uint8_t* src, long long pos,
                        long long bend, long long window, int32_t* head,
                        int32_t* prev, int32_t* t4, const ZCfg* cfg,
                        int32_t* bt = nullptr, long long btmask = 0) {
  long long s = pos == 0 ? 1 : pos;
  long long limit = bend - 16;
  // adaptive literal price: Shannon entropy of the block's bytes, in
  // half-bits, clamped to [4.0, 8.0] bits/literal
  int lp2 = 12;
  {
    uint32_t h[256];
    memset(h, 0, sizeof h);
    for (long long q = pos; q < bend; q++) h[src[q]]++;
    double n = (double)(bend - pos), bits = 0.0;
    for (int c = 0; c < 256; c++)
      if (h[c]) {
        double p = h[c] / n;
        bits -= p * __builtin_log2(p);
      }
    lp2 = (int)(2.0 * bits + 0.5);
    if (lp2 < 8) lp2 = 8;
    if (lp2 > 16) lp2 = 16;
  }
  const bool use_bt = bt != nullptr;
#define ZINS(p)                                              \
  do {                                                       \
    uint64_t vv = ld64(src + (p));                           \
    t4[zhash(vv, SBITS)] = (int32_t)(p);                     \
    if (use_bt) {                                            \
      btins(src, head, bt, btmask, (p), bend, (p) - window); \
    } else {                                                 \
      uint32_t hh = zhash5(vv, HBITS);                       \
      prev[p] = head[hh];                                    \
      head[hh] = (int32_t)(p);                               \
    }                                                        \
  } while (0)
  int prev_len = 0, prev_score = 0;
  long long prev_off = 0, prev_pos = -1;
  while (s < limit) {
    uint64_t v0 = ld64(src + s);
    long long c4 = t4[zhash(v0, SBITS)];
    t4[zhash(v0, SBITS)] = (int32_t)s;
    long long off = 0;
    int score = 0;
    int chain = cfg->chain;
    if (prev_len >= cfg->lazy_thresh) chain >>= 2;
    int mlen;
    if (use_bt) {
      mlen = btfind(src, head, bt, btmask, s, bend, s - window, &E->R,
                    chain, cfg->nice, lp2, c4, &off, &score);
    } else {
      uint32_t hh = zhash5(v0, HBITS);
      long long c0 = head[hh];
      prev[s] = (int32_t)c0;
      head[hh] = (int32_t)s;
      mlen = zfind(src, prev, s, bend, c0, window, &E->R, chain,
                   cfg->nice, lp2, c4, &off, &score);
    }
    if (mlen >= 4 && score <= 0) mlen = 0;  // match costs more than lits
    if (prev_len >= 4) {
      // 2-step lazy (btlazy2 depth): a pending match survives up to two
      // follow-up probes; each deferred position prices one extra literal
      long long gap = s - prev_pos;
      if (mlen >= 4 && score > prev_score + (int)(lp2 * gap)) {
        prev_len = mlen;
        prev_off = off;
        prev_score = score;
        prev_pos = s;
        s++;
        continue;
      }
      if (gap < 2) {
        s++;  // give position prev_pos+2 a chance before emitting
        continue;
      }
      long long mp = prev_pos;
      while (mp > E->next_emit && mp - prev_off > 0 &&
             src[mp - 1] == src[mp - prev_off - 1]) {
        mp--;
        prev_len++;
      }
      emit_seq(E, mp, prev_len, (uint32_t)prev_off);
      long long e = mp + prev_len;  // match end: invariant under back-ext
      long long ei = e > limit ? limit : e;
      // stride interior inserts of very long matches (bt inserts cost a
      // tree descent each; interior candidates are largely redundant)
      long long step = (use_bt && prev_len > 128) ? (prev_len >> 7) : 1;
      for (long long p2 = s + 1; p2 < ei; p2 += step) ZINS(p2);
      s = e;
      prev_len = 0;
      prev_pos = -1;
      if (E->nseq >= MAXSEQ_PER_BLOCK - 2) return;
      continue;
    }
    if (mlen >= 4) {
      prev_len = mlen;
      prev_off = off;
      prev_score = score;
      prev_pos = s;
    }
    s++;
  }
  if (prev_len >= 4 && prev_pos >= 0) {
    long long mp = prev_pos;
    while (mp > E->next_emit && mp - prev_off > 0 &&
           src[mp - 1] == src[mp - prev_off - 1]) {
      mp--;
      prev_len++;
    }
    if (E->nseq < MAXSEQ_PER_BLOCK - 2) emit_seq(E, mp, prev_len,
                                                 (uint32_t)prev_off);
  }
#undef ZINS
}

// ---- estimated-bit-cost table choice (chooseComp / estBits analogue) ------

static long long fse_cost(const uint32_t* hist, int maxc, const int16_t* norm,
                          int nnorm, int log) {
  long long bits = 0;
  for (int c = 0; c <= maxc; c++) {
    if (!hist[c]) continue;
    int nv = c < nnorm ? (norm[c] == -1 ? 1 : norm[c]) : 0;
    if (nv <= 0) return -1;
    bits += (long long)hist[c] * (log - highbit((uint32_t)nv));
  }
  return bits;
}

// returns the table mode (0 predefined, 1 RLE, 2 custom FSE); on 1/2 fills
// *ctab (and *ncl / ncb for mode 2, *rle_sym for mode 1)
// accel-profile switch: force predefined sequence tables (mode 0) so the
// shared-table Pallas sequence decoder (ops/zseq_pallas.py) applies to
// every block. The predefined tables cover the full code alphabets, so
// forcing is always encodable; costs ~2-4% of the sequence section.
int ct_g_force_predef = 0;
extern "C" void ct_zstd_force_predef(int on) { ct_g_force_predef = on; }

static int choose_tab(const uint32_t* hist, int maxc, long long nseq,
                      const int16_t* pnorm, int pn, const CTab* ptab, int log,
                      CTab* ctab, uint8_t* ncb, int* ncl, uint8_t* rle_sym) {
  if (ct_g_force_predef) return 0;
  int distinct = 0, sym = 0;
  for (int c = 0; c <= maxc; c++)
    if (hist[c]) { distinct++; sym = c; }
  if (distinct == 1) {
    int16_t nrm[64];
    memset(nrm, 0, sizeof nrm);
    nrm[sym] = 1;
    ctab_build(nrm, sym + 1, 0, ctab);
    *rle_sym = (uint8_t)sym;
    return 1;
  }
  long long pcost = fse_cost(hist, maxc, pnorm, pn, ptab->log);
  int16_t nrm[64];
  if (nseq >= 32 && normalize_c(hist, maxc + 1, nseq, log, nrm)) {
    int len = write_ncount_c(nrm, maxc, log, ncb);
    long long ccost = fse_cost(hist, maxc, nrm, maxc + 1, log) + 8ll * len;
    if (pcost < 0 || ccost < pcost) {
      *ncl = len;
      ctab_build(nrm, maxc + 1, log, ctab);
      return 2;
    }
  }
  return 0;
}

// per-level lazy configs (enc_better/enc_best knobs)
// r3 retune: chain 12 runs ~2x faster than 48 and still beats libzstd -3
// size by ~5% on text (reference enc_better posture: speed class between
// dfast and best, zstd/README.md L3 67 MB/s)
static const ZCfg ZCFG3 = {12, 96, 48};
static const ZCfg ZCFG4 = {64, 512, 32};

// encode the block sequence covering src[start, n) into dst (no frame
// header). Matches may reach back into [0, start) (overlap prefix).
// mark_last sets the last-block flag on the final block.
static long long encode_blocks_(const uint8_t* src, long long n,
                                long long start, uint8_t* dst, long long cap,
                                int mark_last, int level, int block_log = 17,
                                long long max_window = 0) {
  if (n - start <= 0 || n > (1ll << 31) - (1 << 20)) return -1;
  if (level < 1) level = 1;
  if (level > 4) level = 4;
  if (block_log < 10 || block_log > 17) block_log = 17;
  long long bsz = 1ll << block_log;
  if (!g_init) {
    ctab_build(PRE_LL, 36, 6, &g_ll);
    ctab_build(PRE_OF, 29, 5, &g_of);
    ctab_build(PRE_ML, 53, 6, &g_ml);
    g_init = true;
  }
  int32_t* table = nullptr;   // L1 single table
  int32_t* tlong = nullptr;   // L2 tables
  int32_t* tshort = nullptr;
  int32_t* head = nullptr;    // L3/L4 chains
  int32_t* prev = nullptr;
  bool alloc_ok = true;
  long long bt_mask = 0;  // L4 binary-tree index mask (prev doubles as bt)
  if (level <= 1) {
    table = (int32_t*)malloc(sizeof(int32_t) << HBITS);
    alloc_ok = table && (memset(table, -1, sizeof(int32_t) << HBITS), true);
  } else if (level == 2) {
    tlong = (int32_t*)malloc(sizeof(int32_t) << LBITS);
    tshort = (int32_t*)malloc(sizeof(int32_t) << SBITS);
    alloc_ok = tlong && tshort;
    if (alloc_ok) {
      memset(tlong, -1, sizeof(int32_t) << LBITS);
      memset(tshort, -1, sizeof(int32_t) << SBITS);
    }
  } else {
    head = (int32_t*)malloc(sizeof(int32_t) << HBITS);
    // L3: hash chain (prev links). L4: binary tree (2 children/position).
    if (level == 3) {
      prev = (int32_t*)malloc(sizeof(int32_t) * (size_t)n);
    } else {
      long long nbt = n < (1ll << 24) ? n : (1ll << 24);
      long long p2 = 1;
      while (p2 < nbt) p2 <<= 1;
      bt_mask = p2 - 1;
      prev = (int32_t*)malloc(sizeof(int32_t) * 2 * (size_t)p2);
      if (prev) memset(prev, -1, sizeof(int32_t) * 2 * (size_t)p2);
    }
    tshort = (int32_t*)malloc(sizeof(int32_t) << SBITS);  // 4-byte probes
    alloc_ok = head && prev && tshort;
    if (alloc_ok) {
      memset(head, -1, sizeof(int32_t) << HBITS);
      memset(tshort, -1, sizeof(int32_t) << SBITS);
    }
  }
  Seq* seqs = (Seq*)malloc(sizeof(Seq) * MAXSEQ_PER_BLOCK);
  uint8_t* lc_s = (uint8_t*)malloc(3 * MAXSEQ_PER_BLOCK);
  uint8_t* mc_s = lc_s ? lc_s + MAXSEQ_PER_BLOCK : nullptr;
  uint8_t* oc_s = lc_s ? lc_s + 2 * MAXSEQ_PER_BLOCK : nullptr;
  uint8_t* lits = (uint8_t*)malloc((1 << 17) + 64);  // 64 B wild-copy slack
  uint8_t* scratch = (uint8_t*)malloc(1 << 20);  // block body (worst case)
  uint8_t* stage = (uint8_t*)malloc(1 << 19);    // 4X stream staging
  if (!seqs || !lits || !scratch || !stage || !lc_s || !alloc_ok) {
    free(table); free(tlong); free(tshort); free(head); free(prev);
    free(seqs); free(lits); free(scratch); free(stage); free(lc_s);
    return -1;
  }

  long long d = 0;
  long long window = n < (8ll << 20) ? n : (8ll << 20);
  if (max_window > 0 && window > max_window) window = max_window;
  if (window < 1024) window = 1024;

  Emit E;
  E.seqs = seqs;
  E.lits = lits;
  E.src = src;
  E.R.r[0] = 1;
  E.R.r[1] = 4;
  E.R.r[2] = 8;
  // job blocks join a frame whose decoder carries rep state across the job
  // boundary: force the first 3 sequences plain so this job's rep state is
  // self-contained (whole frames start at the decoder's {1,4,8} and need no
  // forcing). Applies to every level now that L1 emits rep codes too.
  E.force_plain = (start > 0 || !mark_last) ? 3 : 0;

  uint32_t rep1 = 1;
  long long pos = start;
  // seed the tables with the WHOLE prefix (r3: seeding only the last
  // 32 KiB silently missed every match whose target lay deeper in the
  // overlap — streaming/concurrent ratios were up to 2x worse than
  // one-shot on periodic data)
  for (long long q = 0; q + 8 < start; q += 2) {
    uint64_t v = ld64(src + q);
    if (level <= 1) {
      table[zhash5(v, HBITS)] = (int32_t)q;
    } else if (level == 2) {
      tlong[zhash8(v, LBITS)] = (int32_t)q;
      tshort[zhash5(v, SBITS)] = (int32_t)q;
    } else if (level == 3) {
      uint32_t hh = zhash5(v, HBITS);
      prev[q] = head[hh];
      head[hh] = (int32_t)q;
      tshort[zhash(v, SBITS)] = (int32_t)q;
    } else {
      btins(src, head, prev, bt_mask, q, start, q - (8ll << 20));
      tshort[zhash(v, SBITS)] = (int32_t)q;
    }
  }
  while (pos < n) {
    long long bend = pos + bsz < n ? pos + bsz : n;
    long long regen = bend - pos;
    int last = mark_last && bend == n;

    // ---- match search over [pos, bend) ----------------------------------
    CT_TIC();
    Reps rsnap = E.R;
    int fsnap = E.force_plain;
    E.nseq = 0;
    E.lit_n = 0;
    E.next_emit = pos;
    long long nseq = 0, lit_n = 0;
    long long next_emit = pos;
    if (regen >= 32 && level >= 2) {
      if (level == 2)
        search_dfast(&E, src, pos, bend, window, tlong, tshort);
      else
        search_lazy(&E, src, pos, bend, window, head, prev, tshort,
                    level == 3 ? &ZCFG3 : &ZCFG4,
                    level == 3 ? nullptr : prev, bt_mask);
      nseq = E.nseq;
      lit_n = E.lit_n;
      next_emit = E.next_emit;
    } else if (regen >= 32) {
      long long s = pos == 0 ? 1 : pos;
      long long limit = bend - 16;
      while (s < limit) {
        // probe: two positions per 8-byte load (one ld64 carries the
        // 4-grams of both s and s+1 — the libzstd-fast/enc_fast.go
        // double-probe shape, halving loads and loop overhead)
        long long cand = -1;
        while (s + 1 < limit) {
          uint64_t v = ld64(src + s);
          uint32_t v0 = (uint32_t)v, v1 = (uint32_t)(v >> 8);
          uint32_t h0 = zhash5(v, HBITS);
          long long c0 = table[h0];
          table[h0] = (int32_t)s;
          if (rep1 && s >= (long long)rep1 &&
              ld32(src + s - rep1) == v0) {
            cand = s - rep1;
            break;
          }
          if (c0 >= 0 && s - c0 <= window && ld32(src + c0) == v0) {
            cand = c0;
            break;
          }
          uint32_t h1 = zhash5(v >> 8, HBITS);
          long long c1 = table[h1];
          table[h1] = (int32_t)(s + 1);
          if (c1 >= 0 && s + 1 - c1 <= window && ld32(src + c1) == v1) {
            s += 1;
            cand = c1;
            break;
          }
          s += 2 + ((s - next_emit) >> 6);
        }
        if (cand < 0) break;
        // backward extension — branchless first step: compare the 8 bytes
        // BEFORE (s, cand) with one XOR + clz (suffix-of-8 equality),
        // then a rare scalar loop for extensions past 8
        {
          long long room = s - next_emit < cand ? s - next_emit : cand;
          if (room > 0) {
            long long k;
            if (room >= 8) {
              uint64_t x = ld64(src + s - 8) ^ ld64(src + cand - 8);
              k = x ? (long long)(__builtin_clzll(x) >> 3) : 8;
            } else {
              k = 0;
              while (k < room && src[s - 1 - k] == src[cand - 1 - k]) k++;
            }
            if (k == 8) {
              while (k < room && src[s - 1 - k] == src[cand - 1 - k]) k++;
            }
            s -= k;
            cand -= k;
          }
        }
        // forward extension, 8 bytes at a time (matchLen XOR+ctz)
        long long m = 4;
        long long maxm = bend - s;
        while (m + 8 <= maxm) {
          uint64_t x = ld64(src + cand + m) ^ ld64(src + s + m);
          if (x) {
            m += __builtin_ctzll(x) >> 3;
            goto ext_done;
          }
          m += 8;
        }
        while (m < maxm && src[cand + m] == src[s + m]) m++;
      ext_done:;
#ifdef AB_NOEMIT
        if (m) { s += m; next_emit = s; continue; }
#endif
        // profitability gate: a minimal match at a far offset costs more
        // bits (ll+ml codes + ~log2(off) offset bits) than its literals —
        // structured data (kppkn/comp-data class) is full of them and
        // libzstd-1 skips them too. Rep-offset matches stay (cheap codes).
        if (m == 4 && (uint64_t)(s - cand) >= 4096 &&
            (uint32_t)(s - cand) != E.R.r[0]) {
          s++;
          continue;
        }
        long long ll = s - next_emit;
        {  // wild copy (s <= limit = bend-16; lits has 64 B slack)
          const uint8_t* lp = src + next_emit;
          uint8_t* od = lits + lit_n;
          memcpy(od, lp, 16);
          if (ll > 16)
            for (long long q = 16; q < ll; q += 16) memcpy(od + q, lp + q, 16);
        }
        lit_n += ll;
        seqs[nseq].ll = (uint32_t)ll;
        seqs[nseq].ml = (uint32_t)m;
        uint32_t off = (uint32_t)(s - cand);
        seqs[nseq].ofv = rep_ofv(&E.R, off, (uint32_t)ll,
                                 E.force_plain > 0);
        if (E.force_plain > 0) E.force_plain--;
        nseq++;
        rep1 = E.R.r[0];
        s += m;
        next_emit = s;
        if (s + 16 > bend) break;
        // insert a couple of positions inside the match
        uint64_t v1 = ld64(src + s - 2);
        table[zhash5(v1, HBITS)] = (int32_t)(s - 2);
        if (nseq >= MAXSEQ_PER_BLOCK - 2) break;
      }
    }
    long long tail = bend - next_emit;
    memcpy(lits + lit_n, src + next_emit, tail);
    lit_n += tail;
    CT_TOC(0);

    // ---- assemble block -------------------------------------------------
    long long body = 0;
    uint8_t* ob = scratch;
    bool ok = nseq > 0;
    if (ok) {
      // literals section
      uint32_t hist[256] = {0};
      for (long long i = 0; i < lit_n; i++) hist[lits[i]]++;
      Huf hf;
      long long lit_sec = -1;
      bool hb = lit_n >= 256 && huf_build(hist, lit_n, &hf);
      CT_TOC(1);
      if (hb) {
        if (lit_n < 1024) {
          // small sections: ONE stream (size_format 0, 3-byte header,
          // 10-bit sizes) skips the 6-byte jump table and 3 stream
          // paddings the 4X split pays (reference: blockenc.go picks
          // 1X below a size threshold too)
          long long l1 = huf_stream(&hf, lits, lit_n, stage);
          long long total1 = hf.table_len + l1;
          if (lit_n < 1024 && total1 < 1024 && total1 + 3 < lit_n) {
            uint32_t v = 2 | (0u << 2) | ((uint32_t)lit_n << 4)
                         | ((uint32_t)total1 << 14);
            ob[body] = (uint8_t)v;
            ob[body + 1] = (uint8_t)(v >> 8);
            ob[body + 2] = (uint8_t)(v >> 16);
            memcpy(ob + body + 3, hf.table, hf.table_len);
            memcpy(ob + body + 3 + hf.table_len, stage, l1);
            lit_sec = 3 + total1;
            body += lit_sec;
          }
        }
        if (lit_sec < 0) {
          long long seg = (lit_n + 3) / 4;
          long long ls[4];
          long long streams = 0;
          for (int q = 0; q < 4; q++) {
            long long a = q * seg;
            long long b = q < 3 ? a + seg : lit_n;
            ls[q] = huf_stream(&hf, lits + a, b - a, stage + streams);
            streams += ls[q];
          }
          long long total4 = hf.table_len + 6 + streams;
          if (ls[0] <= 0xFFFF && ls[1] <= 0xFFFF && ls[2] <= 0xFFFF &&
              total4 + 5 < lit_n) {
            // header (size_format 3: 5 bytes, covers all sizes)
            uint64_t v = 2 | (3u << 2) | ((uint64_t)lit_n << 4)
                         | ((uint64_t)total4 << 22);
            for (int i = 0; i < 5; i++)
              ob[body + i] = (uint8_t)(v >> (8 * i));
            long long hdr = 5;
            memcpy(ob + body + hdr, hf.table, hf.table_len);
            hdr += hf.table_len;
            for (int q = 0; q < 3; q++) {
              ob[body + hdr] = (uint8_t)ls[q];
              ob[body + hdr + 1] = (uint8_t)(ls[q] >> 8);
              hdr += 2;
            }
            memcpy(ob + body + hdr, stage, streams);
            lit_sec = 5 + total4;
            body += lit_sec;
          }
        }
      }
      CT_TOC(2);
      if (lit_sec < 0) {  // raw literals
        uint64_t v = 0 | (3u << 2) | ((uint64_t)lit_n << 4);
        ob[body] = (uint8_t)v;
        ob[body + 1] = (uint8_t)(v >> 8);
        ob[body + 2] = (uint8_t)(v >> 16);
        memcpy(ob + body + 3, lits, lit_n);
        body += 3 + lit_n;
      }
      // sequences section
      if (nseq < 128) {
        ob[body++] = (uint8_t)nseq;
      } else if (nseq < 0x7F00) {
        ob[body++] = (uint8_t)(128 + (nseq >> 8));
        ob[body++] = (uint8_t)nseq;
      } else {
        ob[body++] = 255;
        ob[body++] = (uint8_t)(nseq - 0x7F00);
        ob[body++] = (uint8_t)((nseq - 0x7F00) >> 8);
      }
      // per-seq codes + histograms
      CT_TIC();
      uint32_t h_ll[64] = {0}, h_ml[64] = {0}, h_of[64] = {0};
      int max_lc = 0, max_mc = 0, max_oc = 0;
      for (long long i = 0; i < nseq; i++) {
        int lc = ll_code(seqs[i].ll), mc = ml_code(seqs[i].ml),
            oc = highbit(seqs[i].ofv);
        lc_s[i] = (uint8_t)lc; mc_s[i] = (uint8_t)mc; oc_s[i] = (uint8_t)oc;
        h_ll[lc]++; h_ml[mc]++; h_of[oc]++;
        if (lc > max_lc) max_lc = lc;
        if (mc > max_mc) max_mc = mc;
        if (oc > max_oc) max_oc = oc;
      }
      CT_TOC(3);
      // table choice per stream (reference chooseComp, blockenc.go:633):
      // L1 keeps the round-1 heuristic (custom FSE at nseq>=300);
      // L2+ picks predefined / RLE / custom FSE by estimated bit cost.
      CTab c_ll, c_of, c_ml;
      const CTab *t_ll = &g_ll, *t_of = &g_of, *t_ml = &g_ml;
      int m_ll = 0, m_of = 0, m_ml = 0;
      uint8_t nc_buf[3][80];
      int nc_len[3] = {0, 0, 0};
      int16_t norm[64];
      if (level >= 1) {  // cost-based table choice at every level
        uint8_t rs;
        m_ll = choose_tab(h_ll, max_lc, nseq, PRE_LL, 36, &g_ll, 9, &c_ll,
                          nc_buf[0], &nc_len[0], &rs);
        if (m_ll == 1) { nc_buf[0][0] = rs; nc_len[0] = 1; }
        if (m_ll) t_ll = &c_ll;
        m_of = choose_tab(h_of, max_oc, nseq, PRE_OF, 29, &g_of, 8, &c_of,
                          nc_buf[1], &nc_len[1], &rs);
        if (m_of == 1) { nc_buf[1][0] = rs; nc_len[1] = 1; }
        if (m_of) t_of = &c_of;
        m_ml = choose_tab(h_ml, max_mc, nseq, PRE_ML, 53, &g_ml, 9, &c_ml,
                          nc_buf[2], &nc_len[2], &rs);
        if (m_ml == 1) { nc_buf[2][0] = rs; nc_len[2] = 1; }
        if (m_ml) t_ml = &c_ml;
      } else if (nseq >= 300) {
        if (normalize_c(h_ll, max_lc + 1, nseq, 9, norm)) {
          nc_len[0] = write_ncount_c(norm, max_lc, 9, nc_buf[0]);
          ctab_build(norm, max_lc + 1, 9, &c_ll);
          t_ll = &c_ll; m_ll = 2;
        }
        if (normalize_c(h_of, max_oc + 1, nseq, 8, norm)) {
          nc_len[1] = write_ncount_c(norm, max_oc, 8, nc_buf[1]);
          ctab_build(norm, max_oc + 1, 8, &c_of);
          t_of = &c_of; m_of = 2;
        }
        if (normalize_c(h_ml, max_mc + 1, nseq, 9, norm)) {
          nc_len[2] = write_ncount_c(norm, max_mc, 9, nc_buf[2]);
          ctab_build(norm, max_mc + 1, 9, &c_ml);
          t_ml = &c_ml; m_ml = 2;
        }
      }
      (void)norm;
      ob[body++] = (uint8_t)((m_ll << 6) | (m_of << 4) | (m_ml << 2));
      memcpy(ob + body, nc_buf[0], nc_len[0]); body += nc_len[0];
      memcpy(ob + body, nc_buf[1], nc_len[1]); body += nc_len[1];
      memcpy(ob + body, nc_buf[2], nc_len[2]); body += nc_len[2];

      CT_TOC(4);
      BitW w;
      bw_init(&w, ob + body);
      long long i = nseq - 1;
      int lc = lc_s[i], mc = mc_s[i], oc = oc_s[i];
      bw_add(&w, seqs[i].ll - LL_BASE[lc], LL_XBITS[lc]);
      bw_add(&w, seqs[i].ml - ML_BASE[mc], ML_XBITS[mc]);
      bw_add(&w, seqs[i].ofv - (1u << oc), oc);
      int st_ll = cinit(t_ll, lc), st_ml = cinit(t_ml, mc),
          st_of = cinit(t_of, oc);
      for (i = nseq - 2; i >= 0; i--) {
        lc = lc_s[i]; mc = mc_s[i]; oc = oc_s[i];
        // batched flushes: 3 state writes <= 27 bits, then extras
        // (16+16, then <=31) — each group stays under the 56-bit slack
        st_of = cenc2(t_of, &w, st_of, oc);
        st_ml = cenc2(t_ml, &w, st_ml, mc);
        st_ll = cenc2(t_ll, &w, st_ll, lc);
        bw_push(&w, seqs[i].ll - LL_BASE[lc], LL_XBITS[lc]);
        bw_flush56(&w);
        bw_push(&w, seqs[i].ml - ML_BASE[mc], ML_XBITS[mc]);
        bw_push(&w, seqs[i].ofv - (1u << oc), oc);
        bw_flush56(&w);
      }
      bw_add(&w, (uint32_t)(st_ml - (1 << t_ml->log)), t_ml->log);
      bw_add(&w, (uint32_t)(st_of - (1 << t_of->log)), t_of->log);
      bw_add(&w, (uint32_t)(st_ll - (1 << t_ll->log)), t_ll->log);
      body += bw_close(&w);
      CT_TOC(5);
      ok = body < regen;
    }

    if (d + 3 + (ok ? body : regen) + 8 > cap) {
      free(table); free(tlong); free(tshort); free(head); free(prev);
      free(seqs); free(lits); free(scratch); free(stage); free(lc_s);
      return -1;
    }
    if (ok) {
      uint32_t bh = (uint32_t)((last ? 1 : 0) | (2 << 1) | (body << 3));
      memcpy(dst + d, &bh, 3);
      d += 3;
      memcpy(dst + d, ob, body);
      d += body;
    } else {
      uint32_t bh = (uint32_t)((last ? 1 : 0) | (0 << 1) | (regen << 3));
      memcpy(dst + d, &bh, 3);
      d += 3;
      memcpy(dst + d, src + pos, regen);
      d += regen;
    }
    if (!ok) {
      // raw block emitted: the decoder saw no sequences, restore rep state
      E.R = rsnap;
      E.force_plain = fsnap;
      rep1 = E.R.r[0];  // L1's probe offset tracks r0
    }
    pos = bend;
  }
  free(table); free(tlong); free(tshort); free(head); free(prev);
  free(seqs); free(lits); free(scratch); free(stage); free(lc_s);
  return d;
}

// full single frame (header + blocks + optional checksum)
long long ct_zstd_compress_level(const uint8_t* src, long long n,
                                 uint8_t* dst, long long cap, int checksum,
                                 unsigned long long xxh, int level) {
  if (n <= 16) return -1;
  long long d = 0;
  memcpy(dst + d, "\x28\xb5\x2f\xfd", 4);
  d += 4;
  long long window = n < (8ll << 20) ? n : (8ll << 20);
  if (window < 1024) window = 1024;
  int wlog = 10;
  while ((1ll << (wlog + 1)) <= window) wlog++;
  long long wbase = 1ll << wlog;
  int mantissa = (int)((window - wbase) / (wbase >> 3));
  if (wbase + (long long)mantissa * (wbase >> 3) < window) mantissa++;
  if (mantissa > 7) { mantissa = 0; wlog++; }
  dst[d++] = (uint8_t)((2 << 6) | (checksum ? 4 : 0));
  dst[d++] = (uint8_t)(((wlog - 10) << 3) | mantissa);
  memcpy(dst + d, &n, 4);
  d += 4;
  long long b = encode_blocks_(src, n, 0, dst + d, cap - d - 8, 1, level);
  if (b < 0) return -1;
  d += b;
  if (checksum) {
    uint32_t c = (uint32_t)xxh;
    memcpy(dst + d, &c, 4);
    d += 4;
  }
  return d;
}

// one whole frame with explicit block size + window cap (the accel
// multi-block path: 64 KiB blocks keep the device history shift static,
// the window cap bounds the device history tensor)
long long ct_zstd_compress_frame_bs(const uint8_t* src, long long n,
                                    uint8_t* dst, long long cap,
                                    int checksum, unsigned long long xxh,
                                    int level, int block_log,
                                    long long max_window) {
  if (n <= 16) return -1;
  long long d = 0;
  memcpy(dst + d, "\x28\xb5\x2f\xfd", 4);
  d += 4;
  long long window = n < (8ll << 20) ? n : (8ll << 20);
  if (max_window > 0 && window > max_window) window = max_window;
  if (window < 1024) window = 1024;
  int wlog = 10;
  while ((1ll << (wlog + 1)) <= window) wlog++;
  long long wbase = 1ll << wlog;
  int mantissa = (int)((window - wbase) / (wbase >> 3));
  if (wbase + (long long)mantissa * (wbase >> 3) < window) mantissa++;
  if (mantissa > 7) { mantissa = 0; wlog++; }
  dst[d++] = (uint8_t)((2 << 6) | (checksum ? 4 : 0));
  dst[d++] = (uint8_t)(((wlog - 10) << 3) | mantissa);
  memcpy(dst + d, &n, 4);
  d += 4;
  long long b = encode_blocks_(src, n, 0, dst + d, cap - d - 8, 1, level,
                               block_log, max_window);
  if (b < 0) return -1;
  d += b;
  if (checksum) {
    uint32_t c = (uint32_t)xxh;
    memcpy(dst + d, &c, 4);
    d += 4;
  }
  return d;
}

long long ct_zstd_compress(const uint8_t* src, long long n, uint8_t* dst,
                           long long cap, int checksum,
                           unsigned long long xxh) {
  return ct_zstd_compress_level(src, n, dst, cap, checksum, xxh, 1);
}

// job entry for host-parallel frames (reference enc_jobs): encodes
// src[start, n) as non-final blocks, matching into the prefix [0, start)
long long ct_zstd_compress_blocks_level(const uint8_t* src, long long n,
                                        long long start, uint8_t* dst,
                                        long long cap, int level) {
  return encode_blocks_(src, n, start, dst, cap, 0, level);
}

long long ct_zstd_compress_blocks(const uint8_t* src, long long n,
                                  long long start, uint8_t* dst,
                                  long long cap) {
  return encode_blocks_(src, n, start, dst, cap, 0, 1);
}

// ---------------------------------------------------------------------------
// huff0 weight-table serialization (huff0.write_table fast path)
//
// Serializes a huffman table header: FSE-compressed weights when smaller,
// else raw nibbles (RFC 8878 §4.2.1.1; reference huff0/compress.go
// writeTable role). The FSE branch mirrors fse/core.py exactly — same
// normalization, NCount layout, 2-state interleave, and the same
// verify-by-exhaustion-decode gate (the format terminates weight streams by
// bit exhaustion, so an ambiguous stream must fall back to raw).
// ---------------------------------------------------------------------------

// exhaustion decode of an FSE weight stream; returns count or -1
static int huf_weights_fse_decode(const uint8_t* blob, int blen,
                                  const int16_t* norm, int nsym, int log,
                                  uint8_t* out /* >= 256 */) {
  int size = 1 << log;
  uint8_t spread[64];
  int high = size - 1;
  for (int s = 0; s < nsym; s++)
    if (norm[s] == -1) spread[high--] = (uint8_t)s;
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++)
    for (int i = 0; i < norm[s]; i++) {
      spread[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  int symbol_next[64];
  for (int s = 0; s < nsym; s++)
    symbol_next[s] = norm[s] == -1 ? 1 : (norm[s] > 0 ? norm[s] : 0);
  uint8_t nb[64];
  int16_t new_state[64];
  for (int u = 0; u < size; u++) {
    int s = spread[u];
    int nxt = symbol_next[s]++;
    int nbb = log - highbit((uint32_t)nxt);
    nb[u] = (uint8_t)nbb;
    new_state[u] = (int16_t)((nxt << nbb) - size);
  }
  if (blen <= 0 || blob[blen - 1] == 0) return -1;
  long long bitpos = (long long)(blen - 1) * 8 + highbit(blob[blen - 1]);
  auto rd = [&](int n) -> int {
    if (n == 0) return 0;
    bitpos -= n;
    long long bp = bitpos;
    uint32_t m = (1u << n) - 1;
    if (bp >= 0) {
      uint64_t ch = 0;
      int nbytes = blen - (int)(bp >> 3);
      if (nbytes > 8) nbytes = 8;
      memcpy(&ch, blob + (bp >> 3), nbytes);
      return (int)((ch >> (bp & 7)) & m);
    }
    uint64_t ch = 0;
    memcpy(&ch, blob, blen < 8 ? blen : 8);
    return (int)((ch << -bp) & m);
  };
  int s1 = rd(log), s2 = rd(log);
  int count = 0;
  for (int it = 0; it < 255 && count < 254; it++) {
    out[count++] = spread[s1];
    s1 = new_state[s1] + rd(nb[s1]);
    if (bitpos < 0) {
      out[count++] = spread[s2];
      return count;
    }
    out[count++] = spread[s2];
    s2 = new_state[s2] + rd(nb[s2]);
    if (bitpos < 0) {
      out[count++] = spread[s1];
      return count;
    }
  }
  return -1;  // did not terminate
}

// exact port of fse/core.py normalize_count WITH low-prob -1 entries
// (normalize_c above deliberately avoids them for seq tables; the huff0
// weight serializer must be byte-identical to the Python path, so this
// mirrors the numpy code operation-for-operation, including the stable
// largest-remainder ordering and the recurse-without-lowprob fallback).
static bool normalize_lowprob_c(const uint32_t* hist, int nsym,
                                long long total, int log, int16_t* norm,
                                bool low_allowed) {
  int size = 1 << log;
  int nz = 0;
  for (int s = 0; s < nsym; s++) {
    norm[s] = 0;
    if (hist[s]) nz++;
  }
  if (total <= 0 || nz == 0 || nz == 1) return false;
  long long low_threshold = total >> log;
  bool is_low[64];
  int n_low = 0;
  for (int s = 0; s < nsym; s++) {
    is_low[s] = low_allowed && hist[s] && (long long)hist[s] <= low_threshold;
    if (is_low[s]) {
      norm[s] = -1;
      n_low++;
    }
  }
  long long rest_slots = size - n_low;
  long long rest_total = 0;
  int m = 0;
  int mids[64];
  for (int s = 0; s < nsym; s++)
    if (hist[s] && !is_low[s]) {
      rest_total += hist[s];
      mids[m++] = s;
    }
  if (rest_total <= 0 || rest_slots <= 0)
    return low_allowed
               ? normalize_lowprob_c(hist, nsym, total, log, norm, false)
               : false;
  if (rest_slots < m) return false;
  double ratio = (double)rest_slots / (double)rest_total;
  double frac[64];
  long long base[64];
  long long acc = 0;
  for (int j = 0; j < m; j++) {
    double ideal = (double)hist[mids[j]] * ratio;
    double fl = __builtin_floor(ideal);
    long long b = (long long)fl;
    if (b < 1) b = 1;
    base[j] = b;
    frac[j] = ideal - fl;
    acc += b;
  }
  long long remainder = rest_slots - acc;
  if (remainder > 0) {
    // argsort(-frac, stable): descending frac, ties by index ascending
    int order[64];
    for (int j = 0; j < m; j++) order[j] = j;
    for (int a = 1; a < m; a++) {  // insertion sort = stable
      int t = order[a];
      int b2 = a - 1;
      while (b2 >= 0 && frac[order[b2]] < frac[t]) {
        order[b2 + 1] = order[b2];
        b2--;
      }
      order[b2 + 1] = t;
    }
    long long take = remainder < m ? remainder : m;
    for (long long j = 0; j < take; j++) base[order[j]]++;
    long long left = remainder - take;
    long long i = 0;
    while (left > 0) {
      base[order[i % m]]++;
      left--;
      i++;
    }
  } else if (remainder < 0) {
    // argsort(-base, stable) computed ONCE, then cycle stealing where >1
    int order[64];
    for (int j = 0; j < m; j++) order[j] = j;
    for (int a = 1; a < m; a++) {
      int t = order[a];
      int b2 = a - 1;
      while (b2 >= 0 && base[order[b2]] < base[t]) {
        order[b2 + 1] = order[b2];
        b2--;
      }
      order[b2 + 1] = t;
    }
    long long i = 0;
    while (remainder < 0) {
      int j = order[i % m];
      if (base[j] > 1) {
        base[j]--;
        remainder++;
      }
      i++;
    }
  }
  for (int j = 0; j < m; j++) norm[mids[j]] = (int16_t)base[j];
  return true;
}

long long ct_huf_write_table(const int32_t* nbits /* 256 */, int max_bits,
                             uint8_t* out, long long cap) {
  // weights + last present symbol
  uint8_t w[256];
  int last = -1;
  for (int s = 0; s < 256; s++) {
    w[s] = nbits[s] > 0 ? (uint8_t)(max_bits + 1 - nbits[s]) : 0;
    if (nbits[s] > 0) last = s;
  }
  if (last < 0) return -1;
  int n = last;  // explicit weights exclude the last present symbol

  // raw nibble encoding
  uint8_t raw[132];
  int raw_len = -1;
  if (n <= 128) {
    raw[0] = (uint8_t)(127 + n);
    int rn = 1;
    for (int i = 0; i < n; i += 2) {
      int hi = w[i];
      int lo = i + 1 < n ? w[i + 1] : 0;
      raw[rn++] = (uint8_t)((hi << 4) | lo);
    }
    raw_len = rn;
  }

  // FSE-compressed weights (accuracy <= 6)
  int fse_len = -1;
  uint8_t fse_out[132];
  if (n >= 2) {
    uint32_t hist[16] = {0};
    int max_sym = 0;
    for (int i = 0; i < n; i++) {
      hist[w[i]]++;
      if (w[i] > max_sym) max_sym = w[i];
    }
    // optimal_table_log(6, n, max_sym, max 6)
    int tl = 6;
    int mbs = highbit((uint32_t)(n - 1)) - 2;
    if (mbs < 1) mbs = 1;
    if (tl > mbs) tl = mbs;
    int mbsym = highbit((uint32_t)max_sym) + 2;
    if (tl < mbsym) tl = mbsym;
    if (tl < 5) tl = 5;
    if (tl > 6) tl = 6;
    int16_t norm[16];
    if (tl <= 6 &&
        normalize_lowprob_c(hist, max_sym + 1, n, tl, norm, true)) {
      uint8_t blob[384];
      int hlen = write_ncount_c(norm, max_sym, tl, blob);
      CTab ct;
      ctab_build(norm, max_sym + 1, tl, &ct);
      // 2-state interleaved encode, last-to-first (fse/core.py layout);
      // worst case 255 weights * 6 state bits + 2 flushes + marker < 256 B
      BitW bw;
      uint8_t stream[256];
      bw_init(&bw, stream);
      auto first_state = [&](int sym) -> int {
        int dnb = ct.delta_nb[sym];
        int nbb = (dnb + (1 << 15)) >> 16;
        int im = (nbb << 16) - dnb;
        return ct.state_table[(im >> nbb) + ct.delta_fs[sym]];
      };
      auto enc = [&](int state, int sym) -> int {
        int nbb = (state + ct.delta_nb[sym]) >> 16;
        bw_add(&bw, (uint32_t)state, nbb);
        return ct.state_table[(state >> nbb) + ct.delta_fs[sym]];
      };
      int ip = n, s1, s2;
      if (ip & 1) {
        s1 = first_state(w[ip - 1]);
        s2 = first_state(w[ip - 2]);
        s1 = enc(s1, w[ip - 3]);
        ip -= 3;
      } else {
        s2 = first_state(w[ip - 1]);
        s1 = first_state(w[ip - 2]);
        ip -= 2;
      }
      if (ip & 2) {
        s2 = enc(s2, w[ip - 1]);
        s1 = enc(s1, w[ip - 2]);
        ip -= 2;
      }
      while (ip >= 4) {
        s2 = enc(s2, w[ip - 1]);
        s1 = enc(s1, w[ip - 2]);
        s2 = enc(s2, w[ip - 3]);
        s1 = enc(s1, w[ip - 4]);
        ip -= 4;
      }
      bw_add(&bw, (uint32_t)(s2 - (1 << tl)), tl);
      bw_add(&bw, (uint32_t)(s1 - (1 << tl)), tl);
      long long slen = bw_close(&bw);
      int blen = hlen + (int)slen;
      if (blen < 128 && (raw_len < 0 || blen + 1 < raw_len)) {
        memcpy(blob + hlen, stream, slen);
        // verify unambiguous exhaustion-decode before committing
        uint8_t back[260];
        int cnt = huf_weights_fse_decode(stream, (int)slen, norm, max_sym + 1,
                                         tl, back);
        if (cnt == n && memcmp(back, w, n) == 0) {
          fse_out[0] = (uint8_t)blen;
          memcpy(fse_out + 1, blob, blen);
          fse_len = 1 + blen;
        }
      }
    }
  }
  const uint8_t* pick = fse_len > 0 ? fse_out : raw;
  long long plen = fse_len > 0 ? fse_len : raw_len;
  if (plen < 0 || plen > cap) return -1;
  memcpy(out, pick, plen);
  return plen;
}


// ---------------------------------------------------------------------------
// Device-encode job assembly (zstd/device.py _assemble_job, ported: the
// Python byte-plumbing ran at 0.04 GB/s and capped device e2e encode).
// Reference role: zstd/blockenc.go header paths + literal/seq splicing.
//
// Outputs: bodies packed into `out`; blk_len[b] = body length, or
// -1 (raw block: body bigger than the block) or -2 (RLE block: ONE byte
// appended to out). Returns total bytes written to out, or E_* (<0).
// ---------------------------------------------------------------------------

static long long lit_header_raw(uint8_t* o, long long regen, int rle) {
  if (regen < 32) {
    o[0] = (uint8_t)((rle ? 1 : 0) | (regen << 3));
    return 1;
  }
  if (regen < 4096) {
    uint32_t v = (uint32_t)((rle ? 1 : 0) | (1 << 2) | (regen << 4));
    o[0] = (uint8_t)v;
    o[1] = (uint8_t)(v >> 8);
    return 2;
  }
  uint32_t v = (uint32_t)((rle ? 1 : 0) | (3 << 2) | (regen << 4));
  o[0] = (uint8_t)v;
  o[1] = (uint8_t)(v >> 8);
  o[2] = (uint8_t)(v >> 16);
  return 3;
}

static long long lit_header_comp(uint8_t* o, long long regen,
                                 long long comp) {
  if (regen < (1 << 10) && comp < (1 << 10)) {
    uint32_t v = (uint32_t)(2 | (1 << 2) | (regen << 4) | (comp << 14));
    o[0] = (uint8_t)v; o[1] = (uint8_t)(v >> 8); o[2] = (uint8_t)(v >> 16);
    return 3;
  }
  if (regen < (1 << 14) && comp < (1 << 14)) {
    uint32_t v = (uint32_t)(2 | (2 << 2) | (regen << 4) | (comp << 18));
    o[0] = (uint8_t)v; o[1] = (uint8_t)(v >> 8); o[2] = (uint8_t)(v >> 16);
    o[3] = (uint8_t)(v >> 24);
    return 4;
  }
  uint64_t v = (uint64_t)2 | (3 << 2) | ((uint64_t)regen << 4) |
               ((uint64_t)comp << 22);
  for (int i = 0; i < 5; i++) o[i] = (uint8_t)(v >> (8 * i));
  return 5;
}

static long long seq_count_header(uint8_t* o, long long n) {
  if (n == 0) { o[0] = 0; return 1; }
  if (n < 128) { o[0] = (uint8_t)n; return 1; }
  if (n < 0x7F00) {
    o[0] = (uint8_t)(128 + (n >> 8));
    o[1] = (uint8_t)(n & 0xFF);
    return 2;
  }
  o[0] = 0xFF;
  o[1] = (uint8_t)((n - 0x7F00) & 0xFF);
  o[2] = (uint8_t)((n - 0x7F00) >> 8);
  return 3;
}

long long ct_zstd_assemble_job(
    const uint8_t* blk, long long n, int block, int nblk,
    const int32_t* n_seqs, const int32_t* lit_cnt, const int32_t* huff_ok,
    const int32_t* nbits, const int32_t* max_bits,
    const int32_t* stream_bits, const int32_t* lit_halves,
    long long lh_stride, const int32_t* seq_halves, long long sh_stride,
    const int32_t* seq_total_bits, const int32_t* ll, const int32_t* ml,
    long long ms_stride, const uint8_t* first_hdr, long long first_hdr_len,
    uint8_t* out, long long cap, long long* blk_len) {
  if (nblk <= 0 || block <= 0 || n > (long long)nblk * block) return -1;
  uint8_t* lits = (uint8_t*)malloc(block + 64);
  uint8_t* tbl = (uint8_t*)malloc(1 << 12);
  int32_t* memo_key = (int32_t*)malloc(256 * 4);
  uint8_t* memo_tbl = (uint8_t*)malloc(1 << 12);
  if (!lits || !tbl || !memo_key || !memo_tbl) {
    free(lits); free(tbl); free(memo_key); free(memo_tbl);
    return -2;
  }
  int memo_ok = 0;
  long long memo_len = 0;
  long long d = 0;
  int tables_written = 0;
  long long ret = 0;
  for (int b = 0; b < nblk; b++) {
    const uint8_t* bp = blk + (long long)b * block;
    long long blen = (long long)(b + 1) * block <= n
                         ? block : n - (long long)b * block;
    if (blen <= 0) { ret = -1; break; }
    // whole-block RLE?
    int all_same = 1;
    for (long long i = 1; i < blen; i++)
      if (bp[i] != bp[0]) { all_same = 0; break; }
    if (all_same) {
      if (d + 1 > cap) { ret = -3; break; }
      out[d++] = bp[0];
      blk_len[b] = -2;
      continue;
    }
    long long ns = n_seqs[b];
    long long lc = lit_cnt[b];
    if (ns < 0 || ns > ms_stride || lc < 0 || lc > blen) { ret = -1; break; }
    // ---- extract literals (run gather over the parse) ----------------
    const int32_t* lla = ll + (long long)b * ms_stride;
    const int32_t* mla = ml + (long long)b * ms_stride;
    long long lp = 0, pos = 0;
    int bad = 0;
    for (long long k = 0; k < ns; k++) {
      long long l = lla[k], m = mla[k];
      if (l < 0 || m < 0 || pos + l + m > blen || lp + l > blen) {
        bad = 1; break;
      }
      memcpy(lits + lp, bp + pos, l);
      lp += l;
      pos += l + m;
    }
    if (bad || pos > blen || lp + (blen - pos) != lc) { ret = -1; break; }
    memcpy(lits + lp, bp + pos, blen - pos);
    // ---- literal section: raw vs RLE vs compressed -------------------
    uint8_t lit_hdr[8];
    long long lit_hl = lit_header_raw(lit_hdr, lc, 0);
    long long lit_bl = lc;  // payload after the header
    int lit_rle = 0;
    if (lc > 0) {
      int same = 1;
      for (long long i = 1; i < lc; i++)
        if (lits[i] != lits[0]) { same = 0; break; }
      if (same) {
        uint8_t rle_hdr[8];
        long long rle_hl = lit_header_raw(rle_hdr, lc, 1);
        if (rle_hl + 1 < lit_hl + lit_bl) {  // strictly smaller, like the
          memcpy(lit_hdr, rle_hdr, rle_hl);  // Python path
          lit_hl = rle_hl;
          lit_bl = 1;
          lit_rle = 1;
        }
      }
    }
    // compressed candidate assembled straight into out (committed only
    // when smaller than raw/RLE)
    uint8_t comp_hdr[8];
    long long comp_hl = 0, comp_bl = 0;
    if (!lit_rle && huff_ok[b] && lc >= 256) {
      // tables recur across blocks (the device builds per-job tables):
      // one-slot memo keyed by the nbits vector covers the common case
      const int32_t* nb_ = nbits + (long long)b * 256;
      long long tl;
      if (memo_ok && memcmp(memo_key, nb_, 256 * 4) == 0) {
        tl = memo_len;
        memcpy(tbl, memo_tbl, tl > 0 ? (size_t)tl : 0);
      } else {
        tl = ct_huf_write_table(nb_, max_bits[b], tbl, 1 << 12);
        if (tl > 0 && tl <= (1 << 12)) {
          memcpy(memo_key, nb_, 256 * 4);
          memcpy(memo_tbl, tbl, tl);
          memo_len = tl;
          memo_ok = 1;
        }
      }
      if (tl > 0) {
        const int32_t* sb_ = stream_bits + (long long)b * 4;
        long long sbytes[4], shalves[4];
        int sb_ok = 1;
        for (int q = 0; q < 4; q++) {
          // negative/garbage device values (a degraded chip is a
          // documented real occurrence) would index o[] negatively
          if (sb_[q] < 0 || sb_[q] > (1 << 22)) sb_ok = 0;
          sbytes[q] = (sb_[q] + 1 + 7) / 8;
          shalves[q] = (sb_[q] + 16) >> 4;
        }
        if (!sb_ok) { ret = -1; break; }
        long long sbase[4] = {shalves[1] + shalves[2] + shalves[3],
                              shalves[2] + shalves[3], shalves[3], 0};
        long long body = tl + 6 + sbytes[0] + sbytes[1] + sbytes[2] +
                         sbytes[3];
        long long hwm = sbase[0] + shalves[0];
        if (sbytes[0] <= 0xFFFF && sbytes[1] <= 0xFFFF &&
            sbytes[2] <= 0xFFFF && hwm <= lh_stride) {
          comp_hl = lit_header_comp(comp_hdr, lc, body);
          if (comp_hl + body < lit_hl + lit_bl &&
              d + comp_hl + body <= cap) {
            uint8_t* o = out + d;
            memcpy(o, comp_hdr, comp_hl);
            o += comp_hl;
            memcpy(o, tbl, tl);
            o += tl;
            for (int q = 0; q < 3; q++) {
              o[2 * q] = (uint8_t)sbytes[q];
              o[2 * q + 1] = (uint8_t)(sbytes[q] >> 8);
            }
            o += 6;
            const int32_t* lh = lit_halves + (long long)b * lh_stride;
            for (int q = 0; q < 4; q++) {
              const int32_t* hp = lh + sbase[q];
              long long hb2 = sbytes[q] / 2;
              for (long long i = 0; i < hb2; i++) {
                uint16_t hv = (uint16_t)hp[i];
                o[2 * i] = (uint8_t)hv;
                o[2 * i + 1] = (uint8_t)(hv >> 8);
              }
              if (sbytes[q] & 1)
                o[sbytes[q] - 1] = (uint8_t)((uint16_t)hp[hb2]);
              long long eos = sb_[q];
              o[eos >> 3] |= (uint8_t)(1 << (eos & 7));
              o += sbytes[q];
            }
            comp_bl = body;
          } else {
            comp_hl = 0;
          }
        }
      }
    }
    // ---- sequence section --------------------------------------------
    uint8_t seq_hdr[8];
    long long seq_hl = seq_count_header(seq_hdr, ns);
    const uint8_t* seq_modes = nullptr;
    long long seq_ml_ = 0;
    uint8_t rep_mode = (uint8_t)((3 << 6) | (3 << 4) | (3 << 2));
    long long seq_bytes = 0;
    if (ns > 0) {
      if (seq_total_bits[b] < 0) { ret = -1; break; }
      seq_bytes = (seq_total_bits[b] + 1 + 7) / 8;
      if ((seq_bytes + 1) / 2 > sh_stride) { ret = -1; break; }
      if (!tables_written) {
        seq_modes = first_hdr;
        seq_ml_ = first_hdr_len;
      } else {
        seq_modes = &rep_mode;
        seq_ml_ = 1;
      }
    }
    long long lit_total = comp_bl > 0 ? comp_hl + comp_bl
                                      : lit_hl + lit_bl;
    long long total = lit_total + seq_hl + seq_ml_ + seq_bytes;
    if (total >= blen) {
      blk_len[b] = -1;  // raw block wins
      continue;
    }
    if (d + total > cap) { ret = -3; break; }
    uint8_t* o = out + d;
    if (comp_bl > 0) {
      o += comp_hl + comp_bl;  // already written in place at out+d
    } else {
      memcpy(o, lit_hdr, lit_hl);
      o += lit_hl;
      if (lit_rle) {
        o[0] = lits[0];
        o += 1;
      } else {
        memcpy(o, lits, lit_bl);
        o += lit_bl;
      }
    }
    memcpy(o, seq_hdr, seq_hl);
    o += seq_hl;
    if (ns > 0) {
      memcpy(o, seq_modes, seq_ml_);
      o += seq_ml_;
      const int32_t* shp = seq_halves + (long long)b * sh_stride;
      long long hb2 = seq_bytes / 2;
      for (long long i = 0; i < hb2; i++) {
        uint16_t hv = (uint16_t)shp[i];
        o[2 * i] = (uint8_t)hv;
        o[2 * i + 1] = (uint8_t)(hv >> 8);
      }
      if (seq_bytes & 1)
        o[seq_bytes - 1] = (uint8_t)((uint16_t)shp[hb2]);
      long long tb2 = seq_total_bits[b];
      o[tb2 >> 3] |= (uint8_t)(1 << (tb2 & 7));
      tables_written = 1;
    }
    blk_len[b] = total;
    d += total;
  }
  free(lits);
  free(tbl);
  free(memo_key);
  free(memo_tbl);
  return ret < 0 ? ret : d;
}

}  // extern "C"
