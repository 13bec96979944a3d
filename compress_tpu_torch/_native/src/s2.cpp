// S2 / Snappy block codec — host-side native core.
//
// Format parity (studied from reference behavior, not copied):
//   tag encodings + repeat-offset extension per s2/README.md "Format
//   Extensions" and s2/decode_other.go semantics; snappy base format per
//   google/snappy format_description.txt.
//
// The encoder is our own design ("repeat-aware greedy with adaptive skip"):
// single 6-byte multiply-shift hash table, repeat-offset probe at every
// position, backward extension, adaptive literal-run skip. It is specified
// deterministically so the pure-Python fallback produces byte-identical
// output (differential-tested, like the reference's asm-vs-Go CI).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

static inline uint64_t s2_load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline uint32_t s2_load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// 4-byte multiply-shift hash: low 32 bits of the LE load, spread by the
// golden-ratio constant. Deterministic across implementations (the pure
// Python fallback mirrors this exactly). 4-byte hashing finds the short
// matches that dominate text; collisions are cheap to reject via the
// 32-bit verify.
static inline uint32_t hash4(uint64_t v, int bits) {
  return (uint32_t)(((v << 32) * 0x9E3779B185EBCA87ULL) >> (64 - bits));
}

// ---------------------------------------------------------------------------
// Emitters
// ---------------------------------------------------------------------------

static inline int emit_literal(uint8_t* dst, const uint8_t* lit, uint32_t n) {
  if (n == 0) return 0;
  uint32_t x = n - 1;
  int i = 0;
  if (x < 60) {
    dst[i++] = (uint8_t)(x << 2);
  } else if (x < (1u << 8)) {
    dst[i++] = 60 << 2;
    dst[i++] = (uint8_t)x;
  } else if (x < (1u << 16)) {
    dst[i++] = 61 << 2;
    dst[i++] = (uint8_t)x;
    dst[i++] = (uint8_t)(x >> 8);
  } else if (x < (1u << 24)) {
    dst[i++] = 62 << 2;
    dst[i++] = (uint8_t)x;
    dst[i++] = (uint8_t)(x >> 8);
    dst[i++] = (uint8_t)(x >> 16);
  } else {
    dst[i++] = 63 << 2;
    dst[i++] = (uint8_t)x;
    dst[i++] = (uint8_t)(x >> 8);
    dst[i++] = (uint8_t)(x >> 16);
    dst[i++] = (uint8_t)(x >> 24);
  }
  memcpy(dst + i, lit, n);
  return i + (int)n;
}

// Repeat op (S2 extension): copy1 tag with offset byte 0.
// length >= 4. Chains for very long lengths.
static int emit_repeat(uint8_t* dst, uint32_t length) {
  int i = 0;
  for (;;) {
    if (length <= 8) {
      dst[i++] = (uint8_t)(((length - 4) << 2) | 1);
      dst[i++] = 0;
      return i;
    }
    if (length <= 263) {
      dst[i++] = (5 << 2) | 1;
      dst[i++] = 0;
      dst[i++] = (uint8_t)(length - 8);
      return i;
    }
    if (length <= 65795) {
      dst[i++] = (6 << 2) | 1;
      dst[i++] = 0;
      uint32_t v = length - 260;
      dst[i++] = (uint8_t)v;
      dst[i++] = (uint8_t)(v >> 8);
      return i;
    }
    uint32_t maxl = 65539u + (1u << 24) - 1;  // L=7 ceiling
    uint32_t take = length <= maxl ? length : maxl;
    if (length - take != 0 && length - take < 4) take = length - 4;  // keep >=4 rest
    if (take >= 65540) {
      dst[i++] = (7 << 2) | 1;
      dst[i++] = 0;
      uint32_t v = take - 65540;
      dst[i++] = (uint8_t)v;
      dst[i++] = (uint8_t)(v >> 8);
      dst[i++] = (uint8_t)(v >> 16);
    } else {
      // take in (65795, 65540) impossible; fall back to 65795 chunk
      take = 65795;
      dst[i++] = (6 << 2) | 1;
      dst[i++] = 0;
      uint32_t v = take - 260;
      dst[i++] = (uint8_t)v;
      dst[i++] = (uint8_t)(v >> 8);
    }
    length -= take;
    if (length == 0) return i;
  }
}

// S2 copy: copy1/copy2/copy4 + repeat chaining for long matches.
static int emit_copy_s2(uint8_t* dst, uint32_t offset, uint32_t length) {
  int i = 0;
  if (offset >= 65536) {
    // copy4; length 1..64 per op, chain with repeats
    if (length > 64) {
      uint32_t first = (length - 64 >= 4) ? 64 : 60;
      dst[i++] = (uint8_t)(((first - 1) << 2) | 3);
      memcpy(dst + i, &offset, 4);
      i += 4;
      return i + emit_repeat(dst + i, length - first);
    }
    dst[i++] = (uint8_t)(((length - 1) << 2) | 3);
    memcpy(dst + i, &offset, 4);
    return i + 4;
  }
  if (length > 64) {
    uint32_t first = (length - 64 >= 4) ? 64 : 60;
    dst[i++] = (uint8_t)(((first - 1) << 2) | 2);
    dst[i++] = (uint8_t)offset;
    dst[i++] = (uint8_t)(offset >> 8);
    return i + emit_repeat(dst + i, length - first);
  }
  if (offset < 2048 && length <= 11) {
    dst[i++] = (uint8_t)(((offset >> 8) << 5) | ((length - 4) << 2) | 1);
    dst[i++] = (uint8_t)offset;
    return i;
  }
  dst[i++] = (uint8_t)(((length - 1) << 2) | 2);
  dst[i++] = (uint8_t)offset;
  dst[i++] = (uint8_t)(offset >> 8);
  return i;
}

// Snappy copy: no repeat ops allowed; chain plain copies.
static int emit_copy_snappy(uint8_t* dst, uint32_t offset, uint32_t length) {
  int i = 0;
  int tag = offset >= 65536 ? 3 : 2;
  int obytes = offset >= 65536 ? 4 : 2;
  while (length > 68) {
    dst[i++] = (uint8_t)((63 << 2) | tag);
    memcpy(dst + i, &offset, obytes);
    i += obytes;
    length -= 64;
  }
  if (length > 64) {
    dst[i++] = (uint8_t)((59 << 2) | tag);  // len 60
    memcpy(dst + i, &offset, obytes);
    i += obytes;
    length -= 60;
  }
  if (offset < 2048 && length >= 4 && length <= 11) {
    dst[i++] = (uint8_t)(((offset >> 8) << 5) | ((length - 4) << 2) | 1);
    dst[i++] = (uint8_t)offset;
    return i;
  }
  dst[i++] = (uint8_t)(((length - 1) << 2) | tag);
  memcpy(dst + i, &offset, obytes);
  return i + obytes;
}

// ---------------------------------------------------------------------------
// Block encoder
// ---------------------------------------------------------------------------

static inline int table_bits(uint64_t n) {
  int b = 8;
  while ((1ull << b) < n && b < 16) b++;
  return b;
}

static inline uint32_t match_len(const uint8_t* a, const uint8_t* b, uint32_t max) {
  uint32_t i = 0;
  while (i + 8 <= max) {
    uint64_t x = s2_load64(a + i) ^ s2_load64(b + i);
    if (x) return i + (uint32_t)(__builtin_ctzll(x) >> 3);
    i += 8;
  }
  while (i < max && a[i] == b[i]) i++;
  return i;
}

// mode: 0 = s2 (repeat offsets), 1 = snappy-compatible.
// Emits the raw block body (no uvarint preamble — the Python layer owns the
// framing). Returns bytes written; dst must have max_encoded_len room.
int64_t ct_s2_encode_block(uint8_t* dst, const uint8_t* src, uint64_t n,
                           int mode) {
  int64_t di = 0;
  if (n == 0) return 0;
  if (n < 16) return emit_literal(dst, src, (uint32_t)n);

  const int bits = table_bits(n);
  static thread_local int32_t table[1 << 16];
  const uint32_t tsize = 1u << bits;
  for (uint32_t i = 0; i < tsize; i++) table[i] = -1;

  uint64_t s = 1, next_emit = 0;
  uint32_t repeat = 0;
  const int snappy = mode == 1;

  for (;;) {
    // probe loop
    uint64_t cand;
    int is_rep = 0;
    for (;;) {
      if (s + 16 > n) goto remainder;
      uint64_t v = s2_load64(src + s);
      uint32_t h = hash4(v, bits);
      int32_t c = table[h];
      table[h] = (int32_t)s;
      if (!snappy && repeat > 0 && s2_load32(src + s) == s2_load32(src + s - repeat)) {
        cand = s - repeat;
        is_rep = 1;
        break;
      }
      if (c >= 0 && s2_load32(src + c) == (uint32_t)v) {
        cand = (uint64_t)c;
        is_rep = 0;
        break;
      }
      s += 1 + ((s - next_emit) >> 6);
    }
    // extend backwards
    while (s > next_emit && cand > 0 && src[s - 1] == src[cand - 1]) {
      s--;
      cand--;
    }
    di += emit_literal(dst + di, src + next_emit, (uint32_t)(s - next_emit));
    {
      uint32_t offset = (uint32_t)(s - cand);
      uint32_t length = 4 + match_len(src + cand + 4, src + s + 4, (uint32_t)(n - s - 4));
      if (!snappy && is_rep && offset == repeat) {
        di += emit_repeat(dst + di, length);
      } else if (snappy) {
        di += emit_copy_snappy(dst + di, offset, length);
      } else {
        di += emit_copy_s2(dst + di, offset, length);
      }
      repeat = offset;
      s += length;
      next_emit = s;
    }
    if (s + 16 > n) goto remainder;
    // re-seed the table inside the covered span so the next probe at s can
    // still find close matches (dense-ish insertion buys ~3% ratio)
    for (int d = 1; d <= 4; d++)
      table[hash4(s2_load64(src + s - d), bits)] = (int32_t)(s - d);
  }

remainder:
  if (next_emit < n)
    di += emit_literal(dst + di, src + next_emit, (uint32_t)(n - next_emit));
  return di;
}

// ---------------------------------------------------------------------------
// Better / Best block encoders (reference roles: s2/encode_better.go,
// s2/encode_best.go — re-designed: two-table greedy for better, hash-chain
// lazy with a byte-cost score for best; shared emitters above)
// ---------------------------------------------------------------------------

static inline uint32_t hash8b(uint64_t v, int bits) {
  return (uint32_t)((v * 0xCF1BBCDCB7A56463ULL) >> (64 - bits));
}
static inline uint32_t hash5b(uint64_t v, int bits) {
  return (uint32_t)(((v << 24) * 0x9E3779B185EBCA87ULL) >> (64 - bits));
}

// approximate emit cost in bytes of one copy op
static inline int s2_copy_cost(uint32_t off, uint32_t len, uint32_t rep,
                               int snappy) {
  int c;
  if (!snappy && off == rep)
    c = len <= 8 ? 2 : (len <= 263 ? 3 : 4);
  else if (off < 2048 && len <= 11)
    c = 2;
  else if (off < 65536)
    c = 3;
  else
    c = 5;
  if (len > 64) c += 3;  // continuation op
  return c;
}

static inline int64_t emit_match(uint8_t* dst, const uint8_t* src,
                                 uint64_t next_emit, uint64_t s, uint32_t off,
                                 uint32_t len, uint32_t* repeat, int snappy) {
  int64_t di = emit_literal(dst, src + next_emit, (uint32_t)(s - next_emit));
  if (!snappy && off == *repeat)
    di += emit_repeat(dst + di, len);
  else if (snappy)
    di += emit_copy_snappy(dst + di, off, len);
  else
    di += emit_copy_s2(dst + di, off, len);
  *repeat = off;
  return di;
}

// level 2: two-table greedy — 8-byte hash into a large table for long
// matches, 4-byte hash into a small table for short ones; repeat-first
// probe; short hits can be upgraded by a long-table hit one byte later.
static int64_t s2_encode_better(uint8_t* dst, const uint8_t* src, uint64_t n,
                                int snappy) {
  const int lbits = table_bits(n) + 1 > 17 ? 17 : table_bits(n) + 1;
  const int sbits = table_bits(n) > 14 ? 14 : table_bits(n);
  static thread_local int32_t tlong[1 << 17];
  static thread_local int32_t tshort[1 << 14];
  for (uint32_t i = 0; i < (1u << lbits); i++) tlong[i] = -1;
  for (uint32_t i = 0; i < (1u << sbits); i++) tshort[i] = -1;

  int64_t di = 0;
  uint64_t s = 1, next_emit = 0;
  uint32_t repeat = 0;
  for (;;) {
    uint64_t cand;
    for (;;) {
      if (s + 16 > n) goto remainder;
      uint64_t v = s2_load64(src + s);
      uint32_t hl = hash8b(v, lbits), hs = hash4(v, sbits);
      int32_t cl = tlong[hl], cs = tshort[hs];
      tlong[hl] = (int32_t)s;
      tshort[hs] = (int32_t)s;
      if (!snappy && repeat > 0 && s >= repeat &&
          s2_load32(src + s) == s2_load32(src + s - repeat)) {
        cand = s - repeat;
        break;
      }
      if (cl >= 0 && s2_load64(src + cl) == v) {
        cand = (uint64_t)cl;
        break;
      }
      if (cs >= 0 && s2_load32(src + cs) == (uint32_t)v) {
        cand = (uint64_t)cs;
        // upgrade: a long-table hit at s+1 that matches 8 bytes beats a
        // 4-byte-verified short hit when it extends further
        uint64_t v1 = s2_load64(src + s + 1);
        int32_t cl1 = tlong[hash8b(v1, lbits)];
        if (cl1 >= 0 && s2_load64(src + cl1) == v1) {
          uint32_t m0 = 4 + match_len(src + cand + 4, src + s + 4,
                                      (uint32_t)(n - s - 4));
          uint32_t m1 = 8 + match_len(src + cl1 + 8, src + s + 1 + 8,
                                      (uint32_t)(n - s - 1 - 8));
          if (m1 > m0 + 1) {
            s += 1;
            cand = (uint64_t)cl1;
            tshort[hash4(v1, sbits)] = (int32_t)s;
          }
        }
        break;
      }
      s += 1 + ((s - next_emit) >> 7);
    }
    while (s > next_emit && cand > 0 && src[s - 1] == src[cand - 1]) {
      s--;
      cand--;
    }
    {
      uint32_t offset = (uint32_t)(s - cand);
      uint32_t length =
          4 + match_len(src + cand + 4, src + s + 4, (uint32_t)(n - s - 4));
      di += emit_match(dst + di, src, next_emit, s, offset, length, &repeat,
                       snappy);
      s += length;
      next_emit = s;
    }
    if (s + 16 > n) goto remainder;
    for (int d = 1; d <= 6; d++) {
      uint64_t v = s2_load64(src + s - d);
      tlong[hash8b(v, lbits)] = (int32_t)(s - d);
      tshort[hash4(v, sbits)] = (int32_t)(s - d);
    }
  }
remainder:
  if (next_emit < n)
    di += emit_literal(dst + di, src + next_emit, (uint32_t)(n - next_emit));
  return di;
}

// level 3: hash-chain search with one-position lazy lookahead; candidates
// scored by bytes-saved (match length minus op cost), repeat offsets
// probed at every position.
struct S2Best {
  uint32_t len, off;
  int score;
};

static inline S2Best s2_find_best(const uint8_t* src, uint64_t n,
                                  const int32_t* prev, uint64_t s, int64_t c0,
                                  uint32_t repeat, int snappy, int chain) {
  S2Best b = {0, 0, 0};
  uint64_t maxm = n - s;
  if (!snappy && repeat > 0 && s >= repeat &&
      s2_load32(src + s) == s2_load32(src + s - repeat)) {
    uint32_t m =
        4 + match_len(src + s - repeat + 4, src + s + 4, (uint32_t)(maxm - 4));
    b.len = m;
    b.off = repeat;
    b.score = (int)m - s2_copy_cost(repeat, m, repeat, snappy);
  }
  uint32_t v = s2_load32(src + s);
  int64_t c = c0;
  uint32_t qlen = b.len > 3 ? b.len : 3;
  while (c >= 0 && chain-- > 0) {
    if (s + qlen < n && src[c + qlen] == src[s + qlen] &&
        s2_load32(src + c) == v) {
      uint32_t m =
          4 + match_len(src + c + 4, src + s + 4, (uint32_t)(maxm - 4));
      uint32_t off = (uint32_t)(s - c);
      int sc = (int)m - s2_copy_cost(off, m, repeat, snappy);
      if (sc > b.score) {
        b.score = sc;
        b.len = m;
        b.off = off;
        qlen = m;
        if (m >= 512) break;  // long enough: stop searching
      }
    }
    c = prev[c];
  }
  return b;
}

static int64_t s2_encode_best(uint8_t* dst, const uint8_t* src, uint64_t n,
                              int snappy) {
  const int hbits = table_bits(n) + 2 > 18 ? 18 : table_bits(n) + 2;
  int32_t* head = (int32_t*)malloc(sizeof(int32_t) << hbits);
  int32_t* prev = (int32_t*)malloc(sizeof(int32_t) * n);
  if (!head || !prev) {
    free(head);
    free(prev);
    return -1;
  }
  memset(head, -1, sizeof(int32_t) << hbits);
  // r3 retune: chain 16 runs 4x faster than 192 for +1% size — matches
  // the reference EncodeBest speed class (46.8 MB/s, s2/README.md:468)
  const int CHAIN = 16;

  int64_t di = 0;
  uint64_t s = 1, next_emit = 0;
  uint32_t repeat = 0;
// 4-byte hash: the chain must see minimum-length (4-byte) matches — a
// wider hash would hide the cheap close-range copy1 matches entirely
#define S2INS(p)                                      \
  do {                                                \
    uint32_t hh = hash4(s2_load64(src + (p)), hbits); \
    prev[p] = head[hh];                               \
    head[hh] = (int32_t)(p);                          \
  } while (0)
  S2Best pb = {0, 0, 0};
  uint64_t pb_pos = 0;
  while (s + 16 <= n) {
    S2INS(s);
    S2Best cur =
        s2_find_best(src, n, prev, s, prev[s], repeat, snappy,
                     pb.len >= 64 ? CHAIN / 4 : CHAIN);
    if (pb.len >= 4 && cur.score <= pb.score + 1) {
      // previous position wins: extend backwards, emit
      uint64_t mp = pb_pos;
      while (mp > next_emit && mp > pb.off &&
             src[mp - 1] == src[mp - pb.off - 1]) {
        mp--;
        pb.len++;
      }
      di += emit_match(dst + di, src, next_emit, mp, pb.off, pb.len, &repeat,
                       snappy);
      uint64_t e = mp + pb.len;  // invariant under backward extension
      next_emit = e;
      if (e + 16 > n) {
        s = e;
        pb.len = 0;
        break;
      }
      for (uint64_t p2 = s + 1; p2 < e; p2++) S2INS(p2);
      s = e;
      pb.len = 0;
      continue;
    }
    // require score > 1: taking a match splits the literal run, costing
    // one extra literal-header byte, so +1-byte matches are net losses
    if (cur.len >= 4 && cur.score > 1) {
      pb = cur;
      pb_pos = s;
    } else {
      pb.len = 0;
    }
    s++;
  }
  if (pb.len >= 4) {
    uint64_t mp = pb_pos;
    while (mp > next_emit && mp > pb.off &&
           src[mp - 1] == src[mp - pb.off - 1]) {
      mp--;
      pb.len++;
    }
    di += emit_match(dst + di, src, next_emit, mp, pb.off, pb.len, &repeat,
                     snappy);
    next_emit = pb_pos + pb.len;
  }
#undef S2INS
  free(head);
  free(prev);
  if (next_emit < n)
    di += emit_literal(dst + di, src + next_emit, (uint32_t)(n - next_emit));
  return di;
}

// level: 1 fast, 2 better, 3 best. mode: 0 s2, 1 snappy.
int64_t ct_s2_encode_block_level(uint8_t* dst, const uint8_t* src, uint64_t n,
                                 int mode, int level) {
  if (n < 16 || level <= 1) return ct_s2_encode_block(dst, src, n, mode);
  if (level == 2) return s2_encode_better(dst, src, n, mode == 1);
  return s2_encode_best(dst, src, n, mode == 1);
}

// ---------------------------------------------------------------------------
// Block decoder
// ---------------------------------------------------------------------------

// mode bit0: allow S2 repeat ops (0 = strict snappy: offset 0 is corrupt).
// Returns 0 on success, -1 on corrupt input.
int ct_s2_decode_block(uint8_t* dst, uint64_t dlen, const uint8_t* src,
                       uint64_t slen, int mode) {
  uint64_t d = 0, s = 0;
  uint64_t offset = 0;
  const int allow_repeat = mode & 1;
  while (s < slen) {
    uint8_t tag = src[s];
    uint64_t length;
    switch (tag & 3) {
      case 0: {  // literal
        uint32_t x = tag >> 2;
        if (x < 60) {
          s += 1;
        } else {
          uint32_t nb = x - 59;  // 1..4 extra bytes
          if (s + 1 + nb > slen) return -1;
          x = 0;
          for (uint32_t k = 0; k < nb; k++) x |= (uint32_t)src[s + 1 + k] << (8 * k);
          s += 1 + nb;
        }
        length = (uint64_t)x + 1;
        if (length > dlen - d || length > slen - s) return -1;
        memcpy(dst + d, src + s, length);
        d += length;
        s += length;
        continue;
      }
      case 1: {  // copy1 / repeat
        if (s + 2 > slen) return -1;
        uint64_t toff = ((uint64_t)(tag & 0xE0) << 3) | src[s + 1];
        length = (tag >> 2) & 7;
        s += 2;
        if (toff == 0) {
          if (!allow_repeat) return -1;
          switch (length) {
            case 5:
              if (s + 1 > slen) return -1;
              length = (uint64_t)src[s] + 4;
              s += 1;
              break;
            case 6:
              if (s + 2 > slen) return -1;
              length = ((uint64_t)src[s] | ((uint64_t)src[s + 1] << 8)) + 256;
              s += 2;
              break;
            case 7:
              if (s + 3 > slen) return -1;
              length = ((uint64_t)src[s] | ((uint64_t)src[s + 1] << 8) |
                        ((uint64_t)src[s + 2] << 16)) +
                       65536;
              s += 3;
              break;
            default:;  // 0..4
          }
        } else {
          offset = toff;
        }
        length += 4;
        break;
      }
      case 2: {  // copy2
        if (s + 3 > slen) return -1;
        offset = (uint64_t)src[s + 1] | ((uint64_t)src[s + 2] << 8);
        length = 1 + (tag >> 2);
        s += 3;
        break;
      }
      default: {  // copy4
        if (s + 5 > slen) return -1;
        offset = s2_load32(src + s + 1);
        length = 1 + (tag >> 2);
        s += 5;
        break;
      }
    }
    if (offset == 0 || d < offset || length > dlen - d) return -1;
    if (offset >= length) {
      memcpy(dst + d, dst + d - offset, length);
    } else {
      // overlapping forward copy
      uint8_t* o = dst + d;
      const uint8_t* in = dst + d - offset;
      for (uint64_t i = 0; i < length; i++) o[i] = in[i];
    }
    d += length;
  }
  return d == dlen ? 0 : -1;
}

// Assemble the device emit kernel's row-local panels into contiguous S2
// block bodies (ops/lzemit.py assemble_bodies role; the numpy boolean
// mask cost ~130 ms per 16 MB — this is ~131k short memcpys instead).
// b0/b1: (nb, 512, 128) u8 row-output panels (slots 0-127 / 128-255);
// rl: (nb, 4, 128) i32, row r's byte count at [r>>7, r&127].
// out needs 256 trailing slack bytes (rows are copied 128-wide).
// block_lens[b] receives each body's length; returns total bytes.
long long ct_s2_assemble_rows(const uint8_t* b0, const uint8_t* b1,
                              const int32_t* rl, long long nb,
                              uint8_t* out, long long* block_lens) {
  long long o = 0;
  for (long long b = 0; b < nb; b++) {
    const uint8_t* p0 = b0 + b * 512 * 128;
    const uint8_t* p1 = b1 + b * 512 * 128;
    const int32_t* r = rl + b * 512;
    long long start = o;
    for (int row = 0; row < 512; row++) {
      int len = r[((row >> 7) << 7) + (row & 127)];
      if (len < 0) len = 0;
      if (len > 256) len = 256;
      memcpy(out + o, p0 + row * 128, 128);  // wide: out has slack
      if (len > 128) memcpy(out + o + 128, p1 + row * 128, 128);
      o += len;
    }
    block_lens[b] = o - start;
  }
  return o;
}

}  // extern "C"
