// DEFLATE (RFC 1951) — host-side native core.
//
// Encoder: real per-level ladder (reference flate/deflate.go level classes,
// flate/level1-6.go + deflateLazy at 7-9): levels 1-3 are greedy hash-chain
// matchers with increasing chain depth, levels 4-9 add lazy (one-position
// lookahead) evaluation with zlib-style good/lazy/nice/chain parameters.
// Code lengths are optimal length-limited (package-merge), blocks choose
// dynamic/stored by exact cost. Decoder: table-driven canonical decode for
// stored/fixed/dynamic blocks. The Python implementations (flate/deflate.py,
// flate/inflate.py) remain the full-featured paths (HUFFMAN_ONLY, custom
// windows, checkpoints) and the differential oracles.
//
// ct_inflate error codes: -1 corrupt input, -2 output capacity exceeded
// (caller may retry -2 with a larger buffer; -1 must not be retried).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline uint64_t fld64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline uint32_t fld32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
static inline int fhighbit(uint32_t v) { return 31 - __builtin_clz(v); }
static inline uint32_t fhash(uint32_t v, int bits) {
  return (v * 0x9E3779B1u) >> (32 - bits);
}
static inline uint32_t bitrev(uint32_t code, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; i++) {
    r = (r << 1) | (code & 1);
    code >>= 1;
  }
  return r;
}

// LSB-first bit writer (deflate bit order); huffman codes pre-reversed
struct FW {
  uint8_t* out;
  long long n;
  uint64_t acc;
  int bits;
};
static inline void fw_bits(FW* w, uint32_t v, int nb) {
  // 64-bit accumulator, one 8-byte store per 48 flushed bits (the
  // reference's huffman_bit_writer 64-bit discipline, not byte loops)
  w->acc |= ((uint64_t)v & ((1ull << nb) - 1)) << w->bits;
  w->bits += nb;
  // flush threshold 32 keeps bits + nb <= 31 + 32 < 64 (no acc overflow
  // even for fused code+extra pushes of up to 28 bits)
  if (w->bits >= 32) {
    memcpy(w->out + w->n, &w->acc, 8);
    w->n += 4;
    w->acc >>= 32;
    w->bits -= 32;
  }
}
static inline void fw_align(FW* w) {
  while (w->bits > 0) {
    w->out[w->n++] = (uint8_t)w->acc;
    w->acc >>= 8;
    w->bits -= 8;
  }
  w->acc = 0;
  w->bits = 0;
}

// sync-flush tail: empty stored block (byte-aligns the stream);
// final iff `final_flag`
static void fw_sync_block(FW* w, int final_flag) {
  fw_bits(w, final_flag ? 1 : 0, 1);
  fw_bits(w, 0, 2);
  fw_align(w);
  w->out[w->n++] = 0;
  w->out[w->n++] = 0;
  w->out[w->n++] = (uint8_t)0xFF;
  w->out[w->n++] = (uint8_t)0xFF;
}

// ---- length/distance code tables (RFC 1951 §3.2.5) ------------------------

static const uint16_t LEN_BASE[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 13,
                                      15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
                                      67, 83, 99, 115, 131, 163, 195, 227, 258};
static const uint8_t LEN_XB[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                                   2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t DST_BASE[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,   25,
    33,   49,   65,   97,   129,  193,   257,   385,   513,  769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
static const uint8_t DST_XB[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,
                                   5, 5, 6, 6, 7, 7, 8, 8,  9,  9,  10, 10,
                                   11, 11, 12, 12, 13, 13};

static inline int len_code(int l) {  // l in [3, 258]
  if (l == 258) return 28;
  int v = l - 3;
  if (v < 8) return v;
  int hb = fhighbit((uint32_t)v);
  return ((hb - 1) << 2) + ((v >> (hb - 2)) & 3);
}
static inline int dst_code(int d) {  // d in [1, 32768]
  if (d <= 4) return d - 1;
  int hb = fhighbit((uint32_t)(d - 1));
  return hb * 2 + (((d - 1) >> (hb - 1)) & 1);
}

// ---- optimal length-limited code lengths (package-merge) -------------------
//
// Deliberate divergence from the reference's heap Huffman + setMaxHeight
// (flate/huffman_code.go role): package-merge is optimal under the length
// limit and trivially fits nsym<=286 / limit 15.

struct PMN {
  uint64_t w;
  int16_t sym;   // >=0 for a leaf
  int16_t a, b;  // package children: indices into the previous level
};

static void pm_expand(const PMN* const* lvl, int level, int idx, uint8_t* lens) {
  const PMN& nd = lvl[level][idx];
  if (nd.sym >= 0) {
    lens[nd.sym]++;
  } else {
    pm_expand(lvl, level - 1, nd.a, lens);
    pm_expand(lvl, level - 1, nd.b, lens);
  }
}

static bool build_lengths(const uint32_t* hist, int nsym, int maxlen,
                          uint8_t* lens) {
  int leaf_sym[320];
  uint64_t leaf_w[320];
  int nl = 0;
  for (int s = 0; s < nsym; s++) {
    lens[s] = 0;
    if (hist[s]) {
      leaf_sym[nl] = s;
      leaf_w[nl] = hist[s];
      nl++;
    }
  }
  if (nl == 0) return false;
  if (nl == 1) {
    lens[leaf_sym[0]] = 1;
    return true;
  }
  if ((1ll << maxlen) < nl) return false;
  // sort leaves by weight ascending (stable insertion; nl <= 286)
  for (int i = 1; i < nl; i++) {
    uint64_t w = leaf_w[i];
    int sy = leaf_sym[i];
    int j = i - 1;
    while (j >= 0 && leaf_w[j] > w) {
      leaf_w[j + 1] = leaf_w[j];
      leaf_sym[j + 1] = leaf_sym[j];
      j--;
    }
    leaf_w[j + 1] = w;
    leaf_sym[j + 1] = sy;
  }
  int cap = 2 * nl + 2;
  PMN* store = (PMN*)malloc(sizeof(PMN) * (size_t)cap * (size_t)maxlen);
  if (!store) return false;
  PMN* lvl[16];
  int lsz[16];
  for (int L = 0; L < maxlen; L++) lvl[L] = store + (size_t)L * cap;
  // level 0 (deepest, cost 2^-maxlen): leaves only
  for (int i = 0; i < nl; i++) {
    lvl[0][i].w = leaf_w[i];
    lvl[0][i].sym = (int16_t)leaf_sym[i];
    lvl[0][i].a = lvl[0][i].b = -1;
  }
  lsz[0] = nl;
  for (int L = 1; L < maxlen; L++) {
    // merge leaves with packages of pairs from level L-1
    int np = lsz[L - 1] / 2;
    int i = 0, p = 0, o = 0;
    while (i < nl || p < np) {
      uint64_t pw = p < np ? lvl[L - 1][2 * p].w + lvl[L - 1][2 * p + 1].w
                           : ~0ull;
      if (i < nl && leaf_w[i] <= pw) {
        lvl[L][o].w = leaf_w[i];
        lvl[L][o].sym = (int16_t)leaf_sym[i];
        lvl[L][o].a = lvl[L][o].b = -1;
        i++;
      } else {
        lvl[L][o].w = pw;
        lvl[L][o].sym = -1;
        lvl[L][o].a = (int16_t)(2 * p);
        lvl[L][o].b = (int16_t)(2 * p + 1);
        p++;
      }
      o++;
    }
    lsz[L] = o;
  }
  int need = 2 * (nl - 1);
  if (lsz[maxlen - 1] < need) {
    free(store);
    return false;
  }
  const PMN* clvl[16];
  for (int L = 0; L < maxlen; L++) clvl[L] = lvl[L];
  for (int k = 0; k < need; k++) pm_expand(clvl, maxlen - 1, k, lens);
  free(store);
  return true;
}

static void canon_codes(const uint8_t* lens, int nsym, uint16_t* codes) {
  int bl_count[16] = {0};
  for (int s = 0; s < nsym; s++) bl_count[lens[s]]++;
  bl_count[0] = 0;
  uint32_t next[16];
  uint32_t code = 0;
  for (int b = 1; b <= 15; b++) {
    code = (code + bl_count[b - 1]) << 1;
    next[b] = code;
  }
  for (int s = 0; s < nsym; s++)
    codes[s] = lens[s] ? (uint16_t)bitrev(next[lens[s]]++, lens[s]) : 0;
}

// ---------------------------------------------------------------------------
// deflate
// ---------------------------------------------------------------------------

struct Tok {  // literal: dist=0, val=byte; match: val=len, dist=distance
  uint16_t val, dist;
};

#define FHB 15
#define FBLOCK (1 << 16)
#define FSPAN (1 << 17)  // max input bytes per block (checkpoint granularity)
#define FWIN 32768

// Emit one block of tokens covering src[pos, bend). Chooses dynamic vs
// stored by exact bit cost. Returns false only on internal failure.
static void emit_tok_block(FW* w, const Tok* toks, long long ntok,
                           const uint8_t* src, long long pos, long long bend,
                           int last) {
  uint32_t h_lit[288] = {0}, h_dst[32] = {0};
  long long extra_bits = 0;
  for (long long i = 0; i < ntok; i++) {
    if (toks[i].dist == 0) {
      h_lit[toks[i].val]++;
    } else {
      int lc = len_code(toks[i].val);
      int dc = dst_code(toks[i].dist);
      h_lit[257 + lc]++;
      h_dst[dc]++;
      extra_bits += LEN_XB[lc] + DST_XB[dc];
    }
  }
  h_lit[256]++;  // EOB
  uint8_t l_lit[288] = {0}, l_dst[32] = {0};
  uint16_t c_lit[288], c_dst[32];
  bool okl = build_lengths(h_lit, 286, 15, l_lit);
  if (!build_lengths(h_dst, 30, 15, l_dst)) {
    l_dst[0] = 1;
    l_dst[1] = 1;  // two dummy dist codes (legal: unused)
  }
  long long stored_bits = 8 * (bend - pos) + 5 * 8;  // hdr+len+nlen, aligned
  bool wrote = false;
  if (okl) {
    canon_codes(l_lit, 286, c_lit);
    canon_codes(l_dst, 30, c_dst);
    int hlit = 286;
    while (hlit > 257 && l_lit[hlit - 1] == 0) hlit--;
    int hdist = 30;
    while (hdist > 1 && l_dst[hdist - 1] == 0) hdist--;
    uint8_t seq[320];
    int ns = 0;
    for (int i = 0; i < hlit; i++) seq[ns++] = l_lit[i];
    for (int i = 0; i < hdist; i++) seq[ns++] = l_dst[i];
    // RLE the code-length sequence into CL symbols
    uint8_t cls[320], clx[320];
    int ncl = 0;
    uint32_t h_cl[19] = {0};
    for (int i = 0; i < ns;) {
      int v = seq[i];
      int run = 1;
      while (i + run < ns && seq[i + run] == v) run++;
      if (v == 0) {
        int r = run;
        while (r >= 11) {
          int take = r > 138 ? 138 : r;
          cls[ncl] = 18;
          clx[ncl++] = (uint8_t)(take - 11);
          h_cl[18]++;
          r -= take;
        }
        if (r >= 3) {
          cls[ncl] = 17;
          clx[ncl++] = (uint8_t)(r - 3);
          h_cl[17]++;
          r = 0;
        }
        while (r-- > 0) {
          cls[ncl] = 0;
          clx[ncl++] = 0;
          h_cl[0]++;
        }
      } else {
        cls[ncl] = (uint8_t)v;
        clx[ncl++] = 0;
        h_cl[v]++;
        int r = run - 1;
        while (r >= 3) {
          int take = r > 6 ? 6 : r;
          cls[ncl] = 16;
          clx[ncl++] = (uint8_t)(take - 3);
          h_cl[16]++;
          r -= take;
        }
        while (r-- > 0) {
          cls[ncl] = (uint8_t)v;
          clx[ncl++] = 0;
          h_cl[v]++;
        }
      }
      i += run;
    }
    uint8_t l_cl[19];
    uint16_t c_cl[19];
    if (build_lengths(h_cl, 19, 7, l_cl)) {
      canon_codes(l_cl, 19, c_cl);
      static const uint8_t ORD[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                      11, 4, 12, 3, 13, 2, 14, 1, 15};
      int hclen = 19;
      while (hclen > 4 && l_cl[ORD[hclen - 1]] == 0) hclen--;
      // exact dynamic cost for the stored-vs-dynamic choice
      long long dyn_bits = 3 + 14 + 3 * hclen;
      for (int i = 0; i < ncl; i++) {
        dyn_bits += l_cl[cls[i]];
        if (cls[i] == 16) dyn_bits += 2;
        else if (cls[i] == 17) dyn_bits += 3;
        else if (cls[i] == 18) dyn_bits += 7;
      }
      for (int s = 0; s < 286; s++) dyn_bits += (long long)h_lit[s] * l_lit[s];
      for (int s = 0; s < 30; s++) dyn_bits += (long long)h_dst[s] * l_dst[s];
      dyn_bits += extra_bits;
      if (dyn_bits < stored_bits || bend - pos > 65535) {
        fw_bits(w, last ? 1 : 0, 1);
        fw_bits(w, 2, 2);  // dynamic
        fw_bits(w, hlit - 257, 5);
        fw_bits(w, hdist - 1, 5);
        fw_bits(w, hclen - 4, 4);
        for (int i = 0; i < hclen; i++) fw_bits(w, l_cl[ORD[i]], 3);
        for (int i = 0; i < ncl; i++) {
          fw_bits(w, c_cl[cls[i]], l_cl[cls[i]]);
          if (cls[i] == 16) fw_bits(w, clx[i], 2);
          else if (cls[i] == 17) fw_bits(w, clx[i], 3);
          else if (cls[i] == 18) fw_bits(w, clx[i], 7);
        }
        for (long long i = 0; i < ntok; i++) {
          if (toks[i].dist == 0) {
            fw_bits(w, c_lit[toks[i].val], l_lit[toks[i].val]);
          } else {
            // fused code+extra: one buffer push per field pair
            int lc = len_code(toks[i].val);
            int ll = l_lit[257 + lc];
            fw_bits(w, c_lit[257 + lc]
                        | ((uint32_t)(toks[i].val - LEN_BASE[lc]) << ll),
                    ll + LEN_XB[lc]);
            int dc = dst_code(toks[i].dist);
            int dl = l_dst[dc];
            fw_bits(w, c_dst[dc]
                        | ((uint32_t)(toks[i].dist - DST_BASE[dc]) << dl),
                    dl + DST_XB[dc]);
          }
        }
        fw_bits(w, c_lit[256], l_lit[256]);  // EOB
        wrote = true;
      }
    }
  }
  if (!wrote) {
    // stored block(s)
    long long p = pos;
    do {
      long long len = bend - p;
      if (len > 65535) len = 65535;
      int lb = (p + len == bend) ? last : 0;
      fw_bits(w, lb, 1);
      fw_bits(w, 0, 2);
      fw_align(w);
      w->out[w->n++] = (uint8_t)len;
      w->out[w->n++] = (uint8_t)(len >> 8);
      w->out[w->n++] = (uint8_t)~len;
      w->out[w->n++] = (uint8_t)(~len >> 8);
      memcpy(w->out + w->n, src + p, len);
      w->n += len;
      p += len;
    } while (p < bend);
  }
}

// per-level matcher parameters (reference flate/deflate.go levels[] role)
struct FCfg {
  int good, lazy, nice, chain;
};
static const FCfg FCFG[10] = {
    {0, 0, 0, 0},        // 0: store (handled in Python)
    {4, 0, 8, 4},        // 1: greedy, shallow
    {4, 0, 16, 8},       // 2: greedy
    {4, 0, 32, 32},      // 3: greedy, deeper
    {4, 4, 16, 16},      // 4: lazy begins
    {8, 16, 32, 32},     // 5
    {8, 16, 128, 128},   // 6: default
    {8, 32, 128, 256},   // 7
    {32, 128, 258, 1024}, // 8
    {32, 258, 258, 4096}, // 9: best
};

static inline long long fmatch_len(const uint8_t* src, long long c,
                                   long long s, long long maxm) {
  long long m = 0;
  while (m + 8 <= maxm) {
    uint64_t x = fld64(src + c + m) ^ fld64(src + s + m);
    if (x) return m + (__builtin_ctzll(x) >> 3);
    m += 8;
  }
  while (m < maxm && src[c + m] == src[s + m]) m++;
  return m;
}

// chain-walk longest match at s, starting from candidate c (callers pass
// prev[s]: the head value from before s itself was inserted). Returns
// length (0 if none), sets *dist.
static inline int find_match(const uint8_t* src, const int32_t* prev,
                             long long s, long long n, long long c,
                             int chain, int nice, int* dist) {
  long long maxm = n - s;
  if (maxm > 258) maxm = 258;
  if (maxm < 4) return 0;
  int best = 3;  // require >= 4
  long long bc = -1;
  uint32_t v = fld32(src + s);
  long long lo = s - FWIN;
  while (c >= 0 && c > lo && chain-- > 0) {
    if (src[c + best] == src[s + best] && fld32(src + c) == v) {
      long long m = fmatch_len(src, c + 4, s + 4, maxm - 4) + 4;
      if (m > best) {
        best = (int)m;
        bc = c;
        if (best >= nice || best >= (int)maxm) break;
      }
    }
    c = prev[c];
  }
  if (bc < 0) return 0;
  *dist = (int)(s - bc);
  return best;
}

// fast path for levels 1-3: single hash TABLE (no chains, no prev array),
// snappy-style skip acceleration — the reference's fastEnc L1-L3 class
// (flate/level1.go:18 role). Literal runs ride ONE token (no per-literal
// token traffic) and histograms accumulate inline in the matcher, so the
// writer makes a single pass. Ratio lands between zlib-1 and the chain
// path; speed is the point.
static void emit_run_block(FW* w, const Tok* toks, long long ntok,
                           const uint8_t* src, long long pos, long long bend,
                           int last, const uint32_t* h_lit,
                           const uint32_t* h_dst, long long extra_bits);

// endmode: 2 = mark the final content block final (one-shot);
// 1 = end with a FINAL empty stored block; 0 = end with a NON-final
// empty stored block (sync flush — output stays byte-aligned so
// successive chunk calls concatenate into one valid deflate stream)
static long long deflate_fast(const uint8_t* src, long long n, uint8_t* dst,
                              long long cap, int level,
                              long long start, int endmode) {
  static const struct { int bits, skip, insert; } FF[4] = {
      {0, 0, 0}, {15, 5, 0}, {16, 5, 1}, {17, 6, 2}};
  int bits = FF[level].bits;
  int skip = FF[level].skip;
  int insert = FF[level].insert;
  int32_t* head = (int32_t*)malloc(sizeof(int32_t) << bits);
  Tok* toks = (Tok*)malloc(sizeof(Tok) * (FBLOCK + 512));
  if (!head || !toks) {
    free(head);
    free(toks);
    return -1;
  }
  memset(head, -1, sizeof(int32_t) << bits);
  FW w;
  w.out = dst;
  w.n = 0;
  w.acc = 0;
  w.bits = 0;
  long long ntok = 0;
  long long blk_start = start;
  uint32_t h_lit[288] = {0}, h_dst[32] = {0};
  long long extra_bits = 0;
  auto flush = [&](long long upto, int last) {
    h_lit[256]++;  // EOB
    emit_run_block(&w, toks, ntok, src, blk_start, upto, last, h_lit,
                   h_dst, extra_bits);
    ntok = 0;
    blk_start = upto;
    memset(h_lit, 0, sizeof(h_lit));
    memset(h_dst, 0, sizeof(h_dst));
    extra_bits = 0;
  };
  // seed the table with the carried window (streaming continuation)
  for (long long q = start > FWIN ? start - FWIN : 0; q + 4 <= start; q++)
    head[fhash(fld32(src + q), bits)] = (int32_t)q;
  long long s = start, next_emit = start;
  long long limit = n - 12;
  // literal run token: dist = 0xFFFF, val = run length (split at 32000)
  auto emit_run = [&](long long upto) {
    long long p = next_emit;
    while (p < upto) {
      long long take = upto - p;
      if (take > 32000) take = 32000;
      for (long long i = 0; i < take; i++) h_lit[src[p + i]]++;
      toks[ntok].val = (uint16_t)take;
      toks[ntok].dist = 0xFFFF;
      ntok++;
      p += take;
      // long match-free stretches must flush here too, or the token
      // buffer overflows (r3 review #2: flush only ran after matches)
      if (ntok >= FBLOCK || p - blk_start >= FSPAN) {
        next_emit = p;
        flush(p, 0);
      }
    }
    next_emit = upto;
  };
  while (s < limit) {
    uint32_t v = fld32(src + s);
    uint32_t h = fhash(v, bits);
    long long c = head[h];
    head[h] = (int32_t)s;
    if (c >= 0 && s - c <= FWIN && fld32(src + c) == v) {
      long long maxm = n - s;
      if (maxm > 258) maxm = 258;
      long long m = fmatch_len(src, c + 4, s + 4, maxm - 4) + 4;
      if (m == 4 && s - c > 16384) {  // zlib TOO_FAR analogue (chain
        s++;                          // path already has it)
        continue;
      }
      emit_run(s);
      toks[ntok].val = (uint16_t)m;
      toks[ntok].dist = (uint16_t)(s - c);
      ntok++;
      int lc = len_code((int)m);
      int dc = dst_code((int)(s - c));
      h_lit[257 + lc]++;
      h_dst[dc]++;
      extra_bits += LEN_XB[lc] + DST_XB[dc];
      long long e = s + m;
      if (insert && e - 1 < limit) {
        long long step = insert == 1 ? 3 : 2;
        for (long long p = s + 1; p + 4 <= e && p < limit; p += step)
          head[fhash(fld32(src + p), bits)] = (int32_t)p;
      } else if (e - 2 > s && e - 2 < limit) {
        head[fhash(fld32(src + e - 2), bits)] = (int32_t)(e - 2);
      }
      s = e;
      next_emit = s;
      if (ntok >= FBLOCK || s - blk_start >= FSPAN) flush(s, 0);
    } else {
      s += 1 + ((s - next_emit) >> skip);
    }
  }
  emit_run(n);
  if (endmode == 2) {
    flush(n, 1);
  } else {
    if (ntok > 0 || blk_start < n) flush(n, 0);
    fw_sync_block(&w, endmode == 1);
  }
  fw_align(&w);
  free(head);
  free(toks);
  if (w.n > cap) return -1;
  return w.n;
}

// writer for run-encoded token blocks (histograms precomputed inline by
// the matcher): builds the dynamic header exactly like emit_tok_block,
// then writes literal runs straight from src
static void emit_run_block(FW* w, const Tok* toks, long long ntok,
                           const uint8_t* src, long long pos, long long bend,
                           int last, const uint32_t* h_lit,
                           const uint32_t* h_dst, long long extra_bits) {
  uint8_t l_lit[288] = {0}, l_dst[32] = {0};
  uint16_t c_lit[288], c_dst[32];
  bool okl = build_lengths(h_lit, 286, 15, l_lit);
  if (!build_lengths(h_dst, 30, 15, l_dst)) {
    l_dst[0] = 1;
    l_dst[1] = 1;
  }
  long long stored_bits = 8 * (bend - pos) + 5 * 8;
  bool wrote = false;
  if (okl) {
    canon_codes(l_lit, 286, c_lit);
    canon_codes(l_dst, 30, c_dst);
    int hlit = 286;
    while (hlit > 257 && l_lit[hlit - 1] == 0) hlit--;
    int hdist = 30;
    while (hdist > 1 && l_dst[hdist - 1] == 0) hdist--;
    uint8_t seq[320];
    int ns = 0;
    for (int i = 0; i < hlit; i++) seq[ns++] = l_lit[i];
    for (int i = 0; i < hdist; i++) seq[ns++] = l_dst[i];
    uint8_t cls[320], clx[320];
    int ncl = 0;
    uint32_t h_cl[19] = {0};
    for (int i = 0; i < ns;) {
      int v = seq[i];
      int run = 1;
      while (i + run < ns && seq[i + run] == v) run++;
      if (v == 0) {
        int r = run;
        while (r >= 11) {
          int take = r > 138 ? 138 : r;
          cls[ncl] = 18;
          clx[ncl++] = (uint8_t)(take - 11);
          h_cl[18]++;
          r -= take;
        }
        if (r >= 3) {
          cls[ncl] = 17;
          clx[ncl++] = (uint8_t)(r - 3);
          h_cl[17]++;
          r = 0;
        }
        while (r-- > 0) {
          cls[ncl] = 0;
          clx[ncl++] = 0;
          h_cl[0]++;
        }
      } else {
        cls[ncl] = (uint8_t)v;
        clx[ncl++] = 0;
        h_cl[v]++;
        int r = run - 1;
        while (r >= 3) {
          int take = r > 6 ? 6 : r;
          cls[ncl] = 16;
          clx[ncl++] = (uint8_t)(take - 3);
          h_cl[16]++;
          r -= take;
        }
        while (r-- > 0) {
          cls[ncl] = (uint8_t)v;
          clx[ncl++] = 0;
          h_cl[v]++;
        }
      }
      i += run;
    }
    uint8_t l_cl[19];
    uint16_t c_cl[19];
    if (build_lengths(h_cl, 19, 7, l_cl)) {
      canon_codes(l_cl, 19, c_cl);
      static const uint8_t ORD[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                      11, 4, 12, 3, 13, 2, 14, 1, 15};
      int hclen = 19;
      while (hclen > 4 && l_cl[ORD[hclen - 1]] == 0) hclen--;
      long long dyn_bits = 3 + 14 + 3 * hclen;
      for (int i = 0; i < ncl; i++) {
        dyn_bits += l_cl[cls[i]];
        if (cls[i] == 16) dyn_bits += 2;
        else if (cls[i] == 17) dyn_bits += 3;
        else if (cls[i] == 18) dyn_bits += 7;
      }
      for (int s = 0; s < 286; s++) dyn_bits += (long long)h_lit[s] * l_lit[s];
      for (int s = 0; s < 30; s++) dyn_bits += (long long)h_dst[s] * l_dst[s];
      dyn_bits += extra_bits;
      if (dyn_bits < stored_bits || bend - pos > 65535) {
        fw_bits(w, last ? 1 : 0, 1);
        fw_bits(w, 2, 2);
        fw_bits(w, hlit - 257, 5);
        fw_bits(w, hdist - 1, 5);
        fw_bits(w, hclen - 4, 4);
        for (int i = 0; i < hclen; i++) fw_bits(w, l_cl[ORD[i]], 3);
        for (int i = 0; i < ncl; i++) {
          fw_bits(w, c_cl[cls[i]], l_cl[cls[i]]);
          if (cls[i] == 16) fw_bits(w, clx[i], 2);
          else if (cls[i] == 17) fw_bits(w, clx[i], 3);
          else if (cls[i] == 18) fw_bits(w, clx[i], 7);
        }
        long long p = pos;
        for (long long i = 0; i < ntok; i++) {
          if (toks[i].dist == 0xFFFF) {
            long long run = toks[i].val;
            for (long long j = 0; j < run; j++) {
              uint8_t b = src[p + j];
              fw_bits(w, c_lit[b], l_lit[b]);
            }
            p += run;
          } else {
            int lc = len_code(toks[i].val);
            int ll = l_lit[257 + lc];
            fw_bits(w, c_lit[257 + lc]
                        | ((uint32_t)(toks[i].val - LEN_BASE[lc]) << ll),
                    ll + LEN_XB[lc]);
            int dc = dst_code(toks[i].dist);
            int dl = l_dst[dc];
            fw_bits(w, c_dst[dc]
                        | ((uint32_t)(toks[i].dist - DST_BASE[dc]) << dl),
                    dl + DST_XB[dc]);
            p += toks[i].val;
          }
        }
        fw_bits(w, c_lit[256], l_lit[256]);
        wrote = true;
      }
    }
  }
  if (!wrote) {
    long long p = pos;
    do {
      long long len = bend - p;
      if (len > 65535) len = 65535;
      int lb = (p + len == bend) ? last : 0;
      fw_bits(w, lb, 1);
      fw_bits(w, 0, 2);
      fw_align(w);
      w->out[w->n++] = (uint8_t)len;
      w->out[w->n++] = (uint8_t)(len >> 8);
      w->out[w->n++] = (uint8_t)~len;
      w->out[w->n++] = (uint8_t)(~len >> 8);
      memcpy(w->out + w->n, src + p, len);
      w->n += len;
      p += len;
    } while (p < bend);
  }
}

static long long deflate_chain(const uint8_t* src, long long n, uint8_t* dst,
                               long long cap, int level,
                               long long start, int endmode) {
  const FCfg cfg = FCFG[level];
  int32_t* head = (int32_t*)malloc(sizeof(int32_t) << FHB);
  int32_t* prev = (int32_t*)malloc(sizeof(int32_t) * (size_t)(n > 0 ? n : 1));
  Tok* toks = (Tok*)malloc(sizeof(Tok) * (FBLOCK + 512));
  if (!head || !prev || !toks) {
    free(head);
    free(prev);
    free(toks);
    return -1;
  }
  memset(head, -1, sizeof(int32_t) << FHB);
  FW w;
  w.out = dst;
  w.n = 0;
  w.acc = 0;
  w.bits = 0;

  long long ntok = 0;
  long long blk_start = start;

  // flush a token block once enough input is covered
  auto flush = [&](long long upto, int last) {
    emit_tok_block(&w, toks, ntok, src, blk_start, upto, last);
    ntok = 0;
    blk_start = upto;
  };

#define FINSERT(pos)                                     \
  do {                                                   \
    uint32_t hh = fhash(fld32(src + (pos)), FHB);        \
    prev[pos] = head[hh];                                \
    head[hh] = (int32_t)(pos);                           \
  } while (0)

  // seed the chains with the carried window (streaming continuation)
  for (long long q = start > FWIN ? start - FWIN : 0; q + 4 <= start; q++) {
    uint32_t hh = fhash(fld32(src + q), FHB);
    prev[q] = head[hh];
    head[hh] = (int32_t)q;
  }
  long long s = start;
  long long limit = n - 12;  // safe 8-byte loads in matcher
  const bool lazy = cfg.lazy > 0;

  int prev_len = 0, prev_dist = 0;
  long long prev_pos = -1;

  while (s < limit) {
    FINSERT(s);
    int dist = 0;
    int chain = cfg.chain;
    if (lazy && prev_len >= cfg.good) chain >>= 2;
    int mlen = find_match(src, prev, s, n, prev[s], chain, cfg.nice, &dist);
    // drop far-away minimum matches (zlib TOO_FAR analogue)
    if (mlen == 4 && dist > 16384) mlen = 0;

    if (!lazy) {
      if (mlen >= 4) {
        toks[ntok].val = (uint16_t)mlen;
        toks[ntok].dist = (uint16_t)dist;
        ntok++;
        long long e = s + mlen;
        if (e > limit) e = limit;
        for (long long p2 = s + 1; p2 < e; p2++) FINSERT(p2);
        s += mlen;
      } else {
        toks[ntok].val = src[s];
        toks[ntok].dist = 0;
        ntok++;
        s++;
      }
      if (ntok >= FBLOCK || s - blk_start >= FSPAN) flush(s, 0);
      continue;
    }

    // lazy: compare with the match found at the previous position
    if (prev_len >= 4 && mlen <= prev_len) {
      toks[ntok].val = (uint16_t)prev_len;
      toks[ntok].dist = (uint16_t)prev_dist;
      ntok++;
      long long e = prev_pos + prev_len;
      if (e > limit) e = limit;
      for (long long p2 = s + 1; p2 < e; p2++) FINSERT(p2);
      s = prev_pos + prev_len;
      prev_len = 0;
      prev_pos = -1;
      if (ntok >= FBLOCK || s - blk_start >= FSPAN) flush(s, 0);
      continue;
    }
    if (prev_pos >= 0) {
      toks[ntok].val = src[prev_pos];
      toks[ntok].dist = 0;
      ntok++;
      if (ntok >= FBLOCK || s - blk_start >= FSPAN) flush(s, 0);
    }
    if (mlen >= cfg.lazy) {
      // good enough: emit immediately, skip the lazy comparison
      toks[ntok].val = (uint16_t)mlen;
      toks[ntok].dist = (uint16_t)dist;
      ntok++;
      long long e = s + mlen;
      if (e > limit) e = limit;
      for (long long p2 = s + 1; p2 < e; p2++) FINSERT(p2);
      s += mlen;
      prev_len = 0;
      prev_pos = -1;
      if (ntok >= FBLOCK || s - blk_start >= FSPAN) flush(s, 0);
      continue;
    }
    prev_len = mlen;
    prev_dist = dist;
    prev_pos = s;
    s++;
  }
  // pending lazy literal
  if (prev_pos >= 0) {
    toks[ntok].val = src[prev_pos];
    toks[ntok].dist = 0;
    ntok++;
  }
  // trailing literals
  while (s < n) {
    toks[ntok].val = src[s];
    toks[ntok].dist = 0;
    ntok++;
    s++;
    if (ntok >= FBLOCK + 400 || s - blk_start >= FSPAN) flush(s, 0);
  }
  if (endmode == 2) {
    if (ntok > 0 || blk_start == start) {
      flush(n, 1);
    } else {
      // all tokens already flushed: emit an empty final fixed block
      fw_bits(&w, 1, 1);
      fw_bits(&w, 1, 2);
      fw_bits(&w, 0, 7);  // fixed EOB (code 0, 7 bits)
    }
  } else {
    if (ntok > 0 || blk_start < n) flush(n, 0);
    fw_sync_block(&w, endmode == 1);
  }
  fw_align(&w);
#undef FINSERT
  free(head);
  free(prev);
  free(toks);
  if (w.n > cap) return -1;  // should not happen given caller's cap
  return w.n;
}

long long ct_deflate_level(const uint8_t* src, long long n, uint8_t* dst,
                           long long cap, int level) {
  if (n < 0 || cap < n + n / 8 + 1024) return -1;
  if (level < 1) level = 1;
  if (level > 9) level = 9;
  if (n < 16) {
    // tiny input: one stored block
    FW w;
    w.out = dst;
    w.n = 0;
    w.acc = 0;
    w.bits = 0;
    fw_bits(&w, 1, 1);
    fw_bits(&w, 0, 2);
    fw_align(&w);
    dst[w.n++] = (uint8_t)n;
    dst[w.n++] = (uint8_t)(n >> 8);
    dst[w.n++] = (uint8_t)~n;
    dst[w.n++] = (uint8_t)(~n >> 8);
    memcpy(dst + w.n, src, n);
    w.n += n;
    return w.n;
  }
  // L1 rides the table-only fast matcher (reference fastEnc posture:
  // ~2x zlib-1 speed at zlib-1-class size); L2/L3 keep shallow CHAINS so
  // their sizes stay below zlib-2/zlib-3 (the r2 size guarantee), now on
  // the 64-bit fused bit writer
  if (level == 1) return deflate_fast(src, n, dst, cap, 1, 0, 2);
  if (level == 2) return deflate_chain(src, n, dst, cap, 1, 0, 2);
  if (level == 3) return deflate_chain(src, n, dst, cap, 2, 0, 2);
  return deflate_chain(src, n, dst, cap, level, 0, 2);
}

// streaming continuation entry: encode src[start, n) as deflate blocks
// with the carried 32 KiB window below `start` (the reference
// flate.Writer role). Ends with a sync-flush empty stored block (final
// iff last) so successive calls concatenate byte-aligned.
long long ct_deflate_blocks(const uint8_t* src, long long n,
                            long long start, uint8_t* dst, long long cap,
                            int level, int last) {
  if (n < 0 || start < 0 || start > n ||
      cap < (n - start) + (n - start) / 8 + 1024)
    return -1;
  if (level < 1) level = 1;
  if (level > 9) level = 9;
  int endmode = last ? 1 : 0;
  if (n - start < 16) {
    // tiny chunk: stored block (if any) + sync tail
    FW w;
    w.out = dst;
    w.n = 0;
    w.acc = 0;
    w.bits = 0;
    if (n > start) {
      fw_bits(&w, 0, 1);
      fw_bits(&w, 0, 2);
      fw_align(&w);
      long long len = n - start;
      dst[w.n++] = (uint8_t)len;
      dst[w.n++] = (uint8_t)(len >> 8);
      dst[w.n++] = (uint8_t)~len;
      dst[w.n++] = (uint8_t)(~len >> 8);
      memcpy(dst + w.n, src + start, len);
      w.n += len;
    }
    fw_sync_block(&w, last);
    return w.n;
  }
  if (level == 1) return deflate_fast(src, n, dst, cap, 1, start, endmode);
  if (level == 2) return deflate_chain(src, n, dst, cap, 1, start, endmode);
  if (level == 3) return deflate_chain(src, n, dst, cap, 2, start, endmode);
  return deflate_chain(src, n, dst, cap, level, start, endmode);
}

// legacy entry (level-6 quality class)
long long ct_deflate(const uint8_t* src, long long n, uint8_t* dst,
                     long long cap) {
  return ct_deflate_level(src, n, dst, cap, 6);
}

// ---------------------------------------------------------------------------
// inflate
// ---------------------------------------------------------------------------

struct FBr {
  const uint8_t* p;
  long long n;
  long long bit;
};
static inline uint32_t fbr_peek(FBr* b, int nb) {
  long long byte = b->bit >> 3;
  uint64_t v = 0;
  if (byte + 8 <= b->n) {  // fast path: whole-word load
    memcpy(&v, b->p + byte, 8);
  } else {  // tail: byte-exact assembly (missing bytes read as 0 — the
    // decoder's own n*8-bit budget checks reject streams that actually
    // need them; no input slack required of the caller)
    for (long long i = byte; i < b->n; i++)
      v |= (uint64_t)b->p[i] << ((i - byte) << 3);
  }
  return (uint32_t)((v >> (b->bit & 7)) & ((1u << nb) - 1));
}
static inline uint32_t fbr_get(FBr* b, int nb) {
  uint32_t v = fbr_peek(b, nb);
  b->bit += nb;
  return v;
}

struct HufD {
  int16_t sym[1 << 15];
  uint8_t len[1 << 15];
  int maxlen;
};

static bool hufd_build(HufD* t, const uint8_t* lens, int nsym) {
  int bl[16] = {0};
  int maxlen = 0;
  for (int s = 0; s < nsym; s++) {
    bl[lens[s]]++;
    if (lens[s] > maxlen) maxlen = lens[s];
  }
  if (maxlen == 0) return false;
  t->maxlen = maxlen;
  bl[0] = 0;
  uint32_t code = 0;
  uint32_t next[16];
  long long avail = 1;
  for (int b = 1; b <= maxlen; b++) {
    avail = (avail << 1) - bl[b];
    if (avail < 0) return false;
    code = (code + bl[b - 1]) << 1;
    next[b] = code;
  }
  int size = 1 << maxlen;
  memset(t->len, 0, size);
  for (int s = 0; s < nsym; s++) {
    int L = lens[s];
    if (!L) continue;
    uint32_t c = next[L]++;
    uint32_t rc = bitrev(c, L);
    for (uint32_t f = rc; f < (uint32_t)size; f += (1u << L)) {
      t->sym[f] = (int16_t)s;
      t->len[f] = (uint8_t)L;
    }
  }
  return true;
}

static inline int hufd_read(const HufD* t, FBr* b) {
  uint32_t idx = fbr_peek(b, t->maxlen);
  if (!t->len[idx]) return -1;
  b->bit += t->len[idx];
  return t->sym[idx];
}

// Streaming inflate at deflate-block granularity (reference role:
// flate/inflate.go's resumable step machine, gzip/gunzip.go:75 Reader).
// Decodes as many COMPLETE blocks as the input allows, starting at
// *bitpos; dst[0..wn) must hold the 32 KiB window prefix (history), the
// output appends from wn. On return, *bitpos points past the last
// complete block and *status is:
//   0 = need more input (a block ran off the end; its partial output was
//       rolled back),  1 = final block decoded (stream complete),
//   2 = dst capacity reached at a block boundary (caller drains/grows),
//  -1 = corrupt input.
// Returns bytes produced (excluding the window), valid for status >= 0.
// The input buffer must have 8 guard bytes past n (as ct_inflate).
long long ct_inflate_stream(const uint8_t* src, long long n,
                            long long* bitpos, uint8_t* dst, long long wn,
                            long long cap, int* status) {
  FBr br;
  br.p = src;
  br.n = n;
  br.bit = *bitpos;
  HufD* lit_t = (HufD*)malloc(sizeof(HufD));
  HufD* dst_t = (HufD*)malloc(sizeof(HufD));
  if (!lit_t || !dst_t) {
    free(lit_t);
    free(dst_t);
    *status = -1;
    return -1;
  }
  long long d = wn;
  int st = 0;  // default: need more input
  while (true) {
    long long blk_bit = br.bit;
    long long blk_d = d;
    // "truncated, need more" vs "corrupt": any failure whose consumed
    // bits ran past the real input is a truncation; failures strictly
    // inside the input are corruption.
#define FAIL_TRUNC_OR(code)                                   \
    do {                                                      \
      if (br.bit + 15 > 8 * n) { st = 0; }                    \
      else { st = (code); }                                   \
      br.bit = blk_bit;                                       \
      d = blk_d;                                              \
      goto sdone;                                             \
    } while (0)
    if (br.bit + 3 > 8 * n) { st = 0; goto sdone; }
    int final = fbr_get(&br, 1);
    int btype = fbr_get(&br, 2);
    if (btype == 0) {
      br.bit = (br.bit + 7) & ~7ll;
      long long byte = br.bit >> 3;
      if (byte + 4 > n) {
        st = 0;  // header not fully buffered yet
        br.bit = blk_bit;
        d = blk_d;
        goto sdone;
      }
      int len = src[byte] | (src[byte + 1] << 8);
      int nlen = src[byte + 2] | (src[byte + 3] << 8);
      if ((len ^ 0xFFFF) != nlen) { st = -1; goto sdone; }
      if (byte + 4 + len > n) {
        st = 0;  // stored payload not fully buffered yet
        br.bit = blk_bit;
        d = blk_d;
        goto sdone;
      }
      if (d + len > cap) { st = 2; br.bit = blk_bit; d = blk_d; goto sdone; }
      memcpy(dst + d, src + byte + 4, len);
      d += len;
      br.bit = (byte + 4 + len) * 8;
    } else if (btype == 1 || btype == 2) {
      uint8_t ll[288], dl[32];
      if (btype == 1) {
        for (int i = 0; i < 144; i++) ll[i] = 8;
        for (int i = 144; i < 256; i++) ll[i] = 9;
        for (int i = 256; i < 280; i++) ll[i] = 7;
        for (int i = 280; i < 288; i++) ll[i] = 8;
        for (int i = 0; i < 30; i++) dl[i] = 5;
        if (!hufd_build(lit_t, ll, 288) || !hufd_build(dst_t, dl, 30))
          FAIL_TRUNC_OR(-1);
      } else {
        int hlit = fbr_get(&br, 5) + 257;
        int hdist = fbr_get(&br, 5) + 1;
        int hclen = fbr_get(&br, 4) + 4;
        static const uint8_t ORD[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                        11, 4, 12, 3, 13, 2, 14, 1, 15};
        uint8_t cl[19] = {0};
        for (int i = 0; i < hclen; i++) cl[ORD[i]] = (uint8_t)fbr_get(&br, 3);
        HufD cl_t_s;
        if (!hufd_build(&cl_t_s, cl, 19)) FAIL_TRUNC_OR(-1);
        uint8_t seq[320];
        int ns = 0;
        int want = hlit + hdist;
        while (ns < want) {
          if (br.bit + 15 > 8 * n + 15) break;  // hard stop near guard end
          int s = hufd_read(&cl_t_s, &br);
          if (s < 0) { ns = -1; break; }
          if (s < 16) {
            seq[ns++] = (uint8_t)s;
          } else if (s == 16) {
            if (ns == 0) { ns = -1; break; }
            int r = fbr_get(&br, 2) + 3;
            uint8_t v = seq[ns - 1];
            while (r-- && ns < want) seq[ns++] = v;
          } else if (s == 17) {
            int r = fbr_get(&br, 3) + 3;
            while (r-- && ns < want) seq[ns++] = 0;
          } else {
            int r = fbr_get(&br, 7) + 11;
            while (r-- && ns < want) seq[ns++] = 0;
          }
        }
        if (ns != want) FAIL_TRUNC_OR(-1);
        if (br.bit > 8 * n) FAIL_TRUNC_OR(-1);
        memcpy(ll, seq, hlit);
        memset(ll + hlit, 0, sizeof(ll) - hlit);
        memcpy(dl, seq + hlit, hdist);
        memset(dl + hdist, 0, sizeof(dl) - hdist);
        if (!hufd_build(lit_t, ll, 288)) FAIL_TRUNC_OR(-1);
        if (!hufd_build(dst_t, dl, 30)) {
          dst_t->maxlen = 1;
          memset(dst_t->len, 0, 2);
        }
      }
      while (true) {
        if (br.bit > 8 * n) FAIL_TRUNC_OR(-1);
        int s = hufd_read(lit_t, &br);
        if (s < 0) FAIL_TRUNC_OR(-1);
        if (s < 256) {
          if (d >= cap) { st = 2; br.bit = blk_bit; d = blk_d; goto sdone; }
          dst[d++] = (uint8_t)s;
        } else if (s == 256) {
          break;
        } else {
          int lc = s - 257;
          if (lc > 28) FAIL_TRUNC_OR(-1);
          int len = LEN_BASE[lc] + (int)fbr_get(&br, LEN_XB[lc]);
          int ds = hufd_read(dst_t, &br);
          if (ds < 0 || ds > 29) FAIL_TRUNC_OR(-1);
          int dist = DST_BASE[ds] + (int)fbr_get(&br, DST_XB[ds]);
          if (dist > d) FAIL_TRUNC_OR(-1);
          if (d + len > cap) { st = 2; br.bit = blk_bit; d = blk_d; goto sdone; }
          if (dist >= len) {
            memcpy(dst + d, dst + d - dist, len);
            d += len;
          } else {
            for (int k = 0; k < len; k++) { dst[d] = dst[d - dist]; d++; }
          }
        }
      }
      if (br.bit > 8 * n) FAIL_TRUNC_OR(-1);
    } else {
      FAIL_TRUNC_OR(-1);
    }
    if (final) { st = 1; break; }
#undef FAIL_TRUNC_OR
  }
sdone:
  free(lit_t);
  free(dst_t);
  *bitpos = br.bit;
  *status = st;
  return st < 0 ? -1 : d - wn;
}

long long ct_inflate(const uint8_t* src, long long n, uint8_t* dst,
                     long long cap) {
  FBr br;
  br.p = src;
  br.n = n;
  br.bit = 0;
  HufD* lit_t = (HufD*)malloc(sizeof(HufD));
  HufD* dst_t = (HufD*)malloc(sizeof(HufD));
  if (!lit_t || !dst_t) {
    free(lit_t);
    free(dst_t);
    return -1;
  }
  long long d = 0;
  while (true) {
    if ((br.bit >> 3) >= n) { d = -1; break; }
    int final = fbr_get(&br, 1);
    int btype = fbr_get(&br, 2);
    if (btype == 0) {
      br.bit = (br.bit + 7) & ~7ll;
      long long byte = br.bit >> 3;
      if (byte + 4 > n) { d = -1; break; }
      int len = src[byte] | (src[byte + 1] << 8);
      int nlen = src[byte + 2] | (src[byte + 3] << 8);
      if ((len ^ 0xFFFF) != nlen || byte + 4 + len > n) {
        d = -1;
        break;
      }
      if (d + len > cap) { d = -2; break; }
      memcpy(dst + d, src + byte + 4, len);
      d += len;
      br.bit = (byte + 4 + len) * 8;
    } else if (btype == 1 || btype == 2) {
      uint8_t ll[288], dl[32];
      if (btype == 1) {
        for (int i = 0; i < 144; i++) ll[i] = 8;
        for (int i = 144; i < 256; i++) ll[i] = 9;
        for (int i = 256; i < 280; i++) ll[i] = 7;
        for (int i = 280; i < 288; i++) ll[i] = 8;
        for (int i = 0; i < 30; i++) dl[i] = 5;
        if (!hufd_build(lit_t, ll, 288) || !hufd_build(dst_t, dl, 30)) {
          d = -1;
          break;
        }
      } else {
        int hlit = fbr_get(&br, 5) + 257;
        int hdist = fbr_get(&br, 5) + 1;
        int hclen = fbr_get(&br, 4) + 4;
        static const uint8_t ORD[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                        11, 4, 12, 3, 13, 2, 14, 1, 15};
        uint8_t cl[19] = {0};
        for (int i = 0; i < hclen; i++) cl[ORD[i]] = (uint8_t)fbr_get(&br, 3);
        HufD* cl_t = (HufD*)malloc(sizeof(HufD));
        if (!cl_t || !hufd_build(cl_t, cl, 19)) {
          free(cl_t);
          d = -1;
          break;
        }
        uint8_t seq[320];
        int ns = 0;
        int want = hlit + hdist;
        while (ns < want) {
          int s = hufd_read(cl_t, &br);
          if (s < 0) { ns = -1; break; }
          if (s < 16) {
            seq[ns++] = (uint8_t)s;
          } else if (s == 16) {
            if (ns == 0) { ns = -1; break; }
            int r = fbr_get(&br, 2) + 3;
            uint8_t v = seq[ns - 1];
            while (r-- && ns < want) seq[ns++] = v;
          } else if (s == 17) {
            int r = fbr_get(&br, 3) + 3;
            while (r-- && ns < want) seq[ns++] = 0;
          } else {
            int r = fbr_get(&br, 7) + 11;
            while (r-- && ns < want) seq[ns++] = 0;
          }
        }
        free(cl_t);
        if (ns != want) { d = -1; break; }
        memcpy(ll, seq, hlit);
        memset(ll + hlit, 0, sizeof(ll) - hlit);
        memcpy(dl, seq + hlit, hdist);
        memset(dl + hdist, 0, sizeof(dl) - hdist);
        if (!hufd_build(lit_t, ll, 288)) { d = -1; break; }
        if (!hufd_build(dst_t, dl, 30)) {
          // all-zero dist lengths are legal when no matches occur
          dst_t->maxlen = 1;
          memset(dst_t->len, 0, 2);
        }
      }
      while (true) {
        if (br.bit > 8 * n) { d = -1; goto out; }
        int s = hufd_read(lit_t, &br);
        if (s < 0) { d = -1; goto out; }
        if (s < 256) {
          if (d >= cap) { d = -2; goto out; }
          dst[d++] = (uint8_t)s;
        } else if (s == 256) {
          break;
        } else {
          int lc = s - 257;
          if (lc > 28) { d = -1; goto out; }
          int len = LEN_BASE[lc] + (int)fbr_get(&br, LEN_XB[lc]);
          int ds = hufd_read(dst_t, &br);
          if (ds < 0 || ds > 29) { d = -1; goto out; }
          int dist = DST_BASE[ds] + (int)fbr_get(&br, DST_XB[ds]);
          if (dist > d) { d = -1; goto out; }
          if (d + len > cap) { d = -2; goto out; }
          if (dist >= len) {
            memcpy(dst + d, dst + d - dist, len);
            d += len;
          } else {
            for (int k = 0; k < len; k++) { dst[d] = dst[d - dist]; d++; }
          }
        }
      }
    } else {
      d = -1;
      break;
    }
    if (final) {
      if (br.bit > 8 * n) d = -1;  // consumed past the real input
      break;
    }
  }
out:
  free(lit_t);
  free(dst_t);
  return d;
}

}  // extern "C"
