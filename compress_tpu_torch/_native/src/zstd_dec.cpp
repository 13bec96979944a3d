// zstd block decoder — host-side native core (RFC 8878).
//
// Decodes the compressed-block payloads (literals section: raw/RLE/
// huff0 1X/4X/treeless; sequences: predefined/RLE/FSE/repeat tables;
// 3-state interleaved decode; sequence execution with repeat offsets).
// Frame/ block headers, skippable frames, and checksums stay in Python
// (compress_tpu/zstd/__init__.py) — they are cheap and branchy.
//
// Format parity studied from RFC 8878 and the reference's behavior
// (zstd/blockdec.go, zstd/seqdec.go); the pure-Python decoder in
// compress_tpu/zstd/block.py is the differential oracle (the suite runs
// both modes, like the reference's noasm CI).
//
// Every length is validated before use; corrupt input returns a negative
// error code and the Python wrapper falls back / raises (the reference's
// hostile-input contract, zstd/blockdec.go:141-189).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// backwards bit reader (stream read back-to-front, top bit of last byte
// marks the start)
// ---------------------------------------------------------------------------

struct BitRev {
  const uint8_t* p;
  long long bitpos;   // bits remaining below the cursor
  long long nsafe;    // last byte index with a full in-bounds 8-byte load
  long long tail_base;
  bool ok;
  uint8_t tail[16];   // staged copy of the final bytes (+ zero slack) so
                      // loads near the stream end never read past p+n —
                      // the raw C ABI takes exact-sized buffers (ASAN/fuzz
                      // hardening; the reference pads instead,
                      // zstd/blockdec.go:42 compressedBlockOverAlloc)
};

static bool br_init(BitRev* b, const uint8_t* p, long long n) {
  b->p = p;
  b->ok = true;
  if (n <= 0 || n > (1 << 30)) return false;
  uint8_t last = p[n - 1];
  if (last == 0) return false;  // no start marker
  int hb = 31 - __builtin_clz((uint32_t)last);
  b->bitpos = (n - 1) * 8 + hb;
  b->nsafe = n - 8;
  b->tail_base = n >= 8 ? n - 8 : 0;
  memset(b->tail, 0, 16);
  memcpy(b->tail, p + b->tail_base, (size_t)(n - b->tail_base));
  return true;
}

static inline uint64_t br_load(const BitRev* b, long long byte) {
  uint64_t v;
  if (byte <= b->nsafe) {
    memcpy(&v, b->p + byte, 8);
  } else {
    memcpy(&v, b->tail + (byte - b->tail_base), 8);
  }
  return v;
}

static inline uint32_t br_read(BitRev* b, int nb) {
  if (nb == 0) return 0;
  if (nb < 0 || nb > 31 || b->bitpos < nb) {
    b->ok = false;
    return 0;
  }
  b->bitpos -= nb;
  long long byte = b->bitpos >> 3;
  int shift = (int)(b->bitpos & 7);
  uint64_t v = br_load(b, byte);
  return (uint32_t)((v >> shift) & ((1u << nb) - 1));
}

// take up to 57 bits [bitpos-total, bitpos) as one load; fields are then
// extracted top-down with br_take. Returns false if not enough bits.
static inline bool br_grab(BitRev* b, int total, uint64_t* win) {
  if (b->bitpos < total) return false;
  b->bitpos -= total;
  *win = br_load(b, b->bitpos >> 3) >> (b->bitpos & 7);
  return true;
}

static inline uint32_t win_take(uint64_t win, int* rem, int nb) {
  *rem -= nb;
  return (uint32_t)((win >> *rem) & ((1ull << nb) - 1));
}

// ---------------------------------------------------------------------------
// FSE decode table
// ---------------------------------------------------------------------------

struct FseDT {
  uint8_t sym[1 << 9];
  uint8_t nb[1 << 9];
  uint16_t base[1 << 9];
  int log = -1;        // -1 = unset; 0 = RLE
  uint8_t rle_sym = 0;
};

// read NCount header (mirrors fse/core.py read_ncount exactly).
// returns bytes consumed or -1.
static int fse_read_ncount(const uint8_t* p, long long n, int16_t* norm,
                           int* max_sym, int* log, int max_log) {
  if (n < 1) return -1;
  uint64_t bit_stream = 0;
  int bit_count = 0;
  long long pp = 0;
  auto fill = [&]() {
    while (bit_count <= 16 && pp < n) {
      bit_stream |= (uint64_t)p[pp] << bit_count;
      bit_count += 8;
      pp++;
    }
  };
  auto take = [&](int nb) -> int {
    fill();
    int v = (int)(bit_stream & ((1u << nb) - 1));
    bit_stream >>= nb;
    bit_count -= nb;
    return v;
  };
  int tlog = take(4) + 5;
  // 9 is the zstd-internal ceiling (FseDT sizing); the standalone fse
  // package allows up to 12 (callers pass the cap they can hold)
  if (tlog > max_log || tlog > 12) return -1;
  int table_size = 1 << tlog;
  int remaining = table_size + 1;
  int threshold = table_size;
  int nb_bits = tlog + 1;
  for (int s = 0; s < 256; s++) norm[s] = 0;
  int s = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (s > 255) return -1;
    if (previous0) {
      int run = take(2);
      int total = run;
      while (run == 3) {
        run = take(2);
        total += run;
        if (total > 512) return -1;
      }
      s += total;
      if (s > 256) return -1;
      previous0 = false;
      continue;
    }
    int mx = (2 * threshold - 1) - remaining;
    fill();
    int count;
    int low = (int)(bit_stream & ((1u << (nb_bits - 1)) - 1));
    if (low < mx) {
      count = low;
      bit_stream >>= (nb_bits - 1);
      bit_count -= (nb_bits - 1);
    } else {
      count = (int)(bit_stream & ((1u << nb_bits) - 1));
      bit_stream >>= nb_bits;
      bit_count -= nb_bits;
      if (count >= threshold) count -= mx;
    }
    count -= 1;
    remaining -= count >= 0 ? count : -count;
    norm[s] = (int16_t)count;
    s++;
    previous0 = count == 0;
    while (remaining < threshold && remaining > 1) {
      nb_bits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || bit_count < 0) return -1;
  *max_sym = s - 1;
  *log = tlog;
  return (int)(pp - (bit_count >> 3));
}

static bool fse_build_dt(FseDT* dt, const int16_t* norm, int max_sym,
                         int log) {
  if (log < 0 || log > 9) return false;
  int size = 1 << log;
  dt->log = log;
  // spread: -1 symbols fill the tail; rest walk the co-prime step
  int high = size - 1;
  int16_t counts[256];
  for (int s = 0; s <= max_sym; s++) counts[s] = norm[s];
  for (int s = 0; s <= max_sym; s++) {
    if (norm[s] == -1) {
      dt->sym[high] = (uint8_t)s;
      high--;
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_sym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      dt->sym[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return false;
  // per-state nb/base: rank within symbol
  uint16_t next[256];
  for (int s = 0; s <= max_sym; s++)
    next[s] = (uint16_t)(norm[s] == -1 ? 1 : (norm[s] < 0 ? 0 : norm[s]));
  for (int u = 0; u < size; u++) {
    uint8_t s = dt->sym[u];
    uint16_t nx = next[s]++;
    int nb = log - (nx ? (31 - __builtin_clz((uint32_t)nx)) : 0);
    // canonical: nb = log - highbit(next); base = (next << nb) - size
    if (nb > log) nb = log;
    dt->nb[u] = (uint8_t)nb;
    dt->base[u] = (uint16_t)((nx << nb) - size);
  }
  return true;
}

static inline void fse_dt_rle(FseDT* dt, uint8_t sym) {
  dt->log = 0;
  dt->rle_sym = sym;
  dt->sym[0] = sym;
  dt->nb[0] = 0;
  dt->base[0] = 0;
}

// ---------------------------------------------------------------------------
// huff0 decode table
// ---------------------------------------------------------------------------

struct HufDT {
  uint8_t sym[1 << 11];
  uint8_t nb[1 << 11];
  uint16_t ent[1 << 11];  // nb << 8 | sym: ONE load on the decode chain
  int max_bits = -1;
};

// parse weights (raw nibbles or FSE-compressed) -> build table.
// returns header bytes consumed or -1.
static int huf_read_table(HufDT* ht, const uint8_t* p, long long n) {
  if (n < 1) return -1;
  uint8_t w[256];
  int nw = 0;
  int used;
  if (p[0] >= 128) {
    nw = p[0] - 127;
    used = 1 + (nw + 1) / 2;
    if (used > n || nw > 255) return -1;
    for (int i = 0; i < nw; i++) {
      uint8_t b = p[1 + i / 2];
      w[i] = (i & 1) ? (b & 0xF) : (b >> 4);
    }
  } else {
    int blen = p[0];
    if (1 + blen > n) return -1;
    // FSE-decode weights: 2 interleaved states, accuracy <= 6, terminated
    // by stream exhaustion (mirrors huff0/decode_weights_fse: emit, then
    // reload; reload overflow => the OTHER state emits and we stop)
    int16_t norm[256];
    int max_sym, log;
    int hdr = fse_read_ncount(p + 1, blen, norm, &max_sym, &log, 6);
    if (hdr < 0 || hdr > blen) return -1;
    FseDT dt;
    if (!fse_build_dt(&dt, norm, max_sym, log)) return -1;
    BitRev br;
    if (!br_init(&br, p + 1 + hdr, blen - hdr)) return -1;
    uint32_t s1 = br_read(&br, log), s2 = br_read(&br, log);
    if (!br.ok) return -1;
    bool done = false;
    for (int it = 0; it < 255 && !done; it++) {
      if (nw > 253) return -1;
      w[nw++] = dt.sym[s1];
      if (br.bitpos < dt.nb[s1]) {
        w[nw++] = dt.sym[s2];
        done = true;
        break;
      }
      s1 = dt.base[s1] + br_read(&br, dt.nb[s1]);
      w[nw++] = dt.sym[s2];
      if (br.bitpos < dt.nb[s2]) {
        if (nw > 254) return -1;
        w[nw++] = dt.sym[s1];
        done = true;
        break;
      }
      s2 = dt.base[s2] + br_read(&br, dt.nb[s2]);
    }
    if (!done) return -1;
    used = 1 + blen;
  }
  // implied last weight: total must reach a power of two
  uint64_t ksum = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 11) return -1;
    if (w[i]) ksum += 1ull << (w[i] - 1);
  }
  if (ksum < 1) return -1;
  int max_bits = 64 - __builtin_clzll(ksum);
  uint64_t rest = (1ull << max_bits) - ksum;
  if (rest == 0 || (rest & (rest - 1))) return -1;
  int last_w = 64 - __builtin_clzll(rest);
  if (nw > 255) return -1;
  w[nw++] = (uint8_t)last_w;
  if (max_bits > 11) return -1;
  ht->max_bits = max_bits;
  // fill table weight-ascending
  int posn = 0;
  for (int wv = 1; wv <= max_bits; wv++) {
    int nb = max_bits + 1 - wv;
    int span = 1 << (wv - 1);
    for (int s = 0; s < nw; s++) {
      if (w[s] != wv) continue;
      if (posn + span > (1 << max_bits)) return -1;
      memset(ht->sym + posn, s, span);
      memset(ht->nb + posn, nb, span);
      posn += span;
    }
  }
  if (posn != (1 << max_bits)) return -1;
  for (int i = 0; i < (1 << max_bits); i++)
    ht->ent[i] = (uint16_t)((ht->nb[i] << 8) | ht->sym[i]);
  return used;
}

static bool huf_decode_stream(const HufDT* ht, const uint8_t* p, long long n,
                              uint8_t* out, long long out_len) {
  BitRev br;
  if (!br_init(&br, p, n)) return false;
  int mb = ht->max_bits;
  // quad fast path (same shape as the 4X loop): one 8-byte load yields
  // four symbols; safe quad count re-derived from actual remaining bits
  const uint16_t* ent = ht->ent;
  const uint32_t mask = (1u << mb) - 1;
  const int mb4 = 4 * mb, sh0 = 3 * mb;
  long long i = 0;
  for (;;) {
    long long quads = (out_len - i) / 4;
    long long q = br.bitpos / mb4 - 1;
    if (q < quads) quads = q;
    if (quads <= 0) break;
    for (long long t = 0; t < quads; t++, i += 4) {
      long long bp = br.bitpos;
      long long lo = bp - mb4;
      uint64_t w = br_load(&br, lo >> 3);
      int sh = (int)(lo & 7) + sh0;
      uint32_t e1 = ent[(w >> sh) & mask];
      sh -= (int)(e1 >> 8);
      uint32_t e2 = ent[(w >> sh) & mask];
      sh -= (int)(e2 >> 8);
      uint32_t e3 = ent[(w >> sh) & mask];
      sh -= (int)(e3 >> 8);
      uint32_t e4 = ent[(w >> sh) & mask];
      out[i] = (uint8_t)e1;
      out[i + 1] = (uint8_t)e2;
      out[i + 2] = (uint8_t)e3;
      out[i + 3] = (uint8_t)e4;
      br.bitpos =
          bp - (long long)((e1 >> 8) + (e2 >> 8) + (e3 >> 8) + (e4 >> 8));
    }
  }
  for (; i < out_len; i++) {
    // peek mb bits (tolerate partial at the very end: pad with zeros)
    uint32_t idx;
    if (br.bitpos >= mb) {
      long long bp = br.bitpos - mb;
      uint64_t v = br_load(&br, bp >> 3);
      idx = (uint32_t)((v >> (bp & 7)) & ((1u << mb) - 1));
    } else {
      if (br.bitpos <= 0) return false;
      uint64_t v = br_load(&br, 0);
      idx = (uint32_t)((v << (mb - br.bitpos)) & ((1u << mb) - 1));
    }
    out[i] = ht->sym[idx];
    int nb = ht->nb[idx];
    if (nb > br.bitpos) nb = (int)br.bitpos;  // final symbol may drain
    br.bitpos -= nb;
  }
  return br.bitpos == 0;
}

// 4 interleaved streams: four independent bit chains give the CPU real
// ILP (the role of the reference's decompress_amd64.s 4X loop). The
// common phase decodes one symbol per stream per iteration with a
// branch-light fast peek; each stream's tail (last few symbols, where
// bitpos < max_bits) finishes on the scalar path above.
static bool huf_decode_4streams(const HufDT* ht, const uint8_t* ps[4],
                                const long long ns[4], uint8_t* outs[4],
                                const long long lens[4]) {
  int mb = ht->max_bits;
  BitRev br[4];
  for (int k = 0; k < 4; k++)
    if (!br_init(&br[k], ps[k], ns[k])) return false;
  const uint8_t* sym = ht->sym;
  const uint8_t* nbt = ht->nb;
  const uint16_t* ent = ht->ent;
  uint32_t mask = (1u << mb) - 1;
  // Quad loop: ONE 8-byte load yields FOUR symbols per stream (4*mb <= 44
  // bits always fit the 57-bit budget); the four streams interleave for
  // ILP (reference decompress_amd64.s 4X role). The safe quad count is
  // re-derived from the ACTUAL remaining bits each round — the worst-case
  // bound (mb bits/symbol) alone would push ~half the symbols onto the
  // slow guarded tail when the average code is ~mb/2 bits.
  long long i = 0;  // symbols emitted per stream (lockstep)
  long long minlen = lens[0];
  for (int k = 1; k < 4; k++)
    if (lens[k] < minlen) minlen = lens[k];
  const int mb4 = 4 * mb;
  const int sh0 = 3 * mb;
  for (;;) {
    long long quads = (minlen - i) / 4;
    for (int k = 0; k < 4; k++) {
      // after t quads bitpos >= bp0 - 4*mb*t; each quad needs bitpos>=4*mb
      long long q = br[k].bitpos / mb4 - 1;
      if (q < quads) quads = q;
    }
    if (quads <= 0) break;
    for (long long t = 0; t < quads; t++, i += 4) {
      for (int k = 0; k < 4; k++) {
        long long bp = br[k].bitpos;
        long long lo = bp - mb4;
        uint64_t w = br_load(&br[k], lo >> 3);
        int sh = (int)(lo & 7) + sh0;
        // fused nb|sym entries: ONE load per link of the serial
        // shift->index->load chain (the chain is the quad's critical
        // path; the 4 streams overlap it via the k-unroll)
        uint32_t e1 = ent[(w >> sh) & mask];
        sh -= (int)(e1 >> 8);
        uint32_t e2 = ent[(w >> sh) & mask];
        sh -= (int)(e2 >> 8);
        uint32_t e3 = ent[(w >> sh) & mask];
        sh -= (int)(e3 >> 8);
        uint32_t e4 = ent[(w >> sh) & mask];
        uint8_t* op = outs[k] + i;
        op[0] = (uint8_t)e1;
        op[1] = (uint8_t)e2;
        op[2] = (uint8_t)e3;
        op[3] = (uint8_t)e4;
        br[k].bitpos =
            bp - (long long)((e1 >> 8) + (e2 >> 8) + (e3 >> 8) + (e4 >> 8));
      }
    }
  }
  // tails: per stream, finish with the guarded scalar loop
  for (int k = 0; k < 4; k++) {
    for (long long j = i; j < lens[k]; j++) {
      uint32_t idx;
      if (br[k].bitpos >= mb) {
        long long bp = br[k].bitpos - mb;
        uint64_t v = br_load(&br[k], bp >> 3);
        idx = (uint32_t)((v >> (bp & 7)) & mask);
      } else {
        if (br[k].bitpos <= 0) return false;
        uint64_t v = br_load(&br[k], 0);
        idx = (uint32_t)((v << (mb - br[k].bitpos)) & mask);
      }
      outs[k][j] = sym[idx];
      int nb = nbt[idx];
      if (nb > br[k].bitpos) nb = (int)br[k].bitpos;
      br[k].bitpos -= nb;
    }
    if (br[k].bitpos != 0) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// sequence code tables
// ---------------------------------------------------------------------------

static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096,
    8192, 16384, 32768, 65536};
static const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                                    4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
static const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,
                                    3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14,
                                    15, 16};

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

// ---------------------------------------------------------------------------
// persistent per-frame decoder state
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// transformed sequence-decode tables: each FSE state maps directly to
// {value base, extra bits, next-state bits, next-state base} in ONE 8-byte
// entry (the reference's fseDecoder.transform baseline trick,
// zstd/fse_decoder.go:51 transform) — the hot loop does 3 loads/sequence
// instead of 9 scattered ones plus range checks.
// ---------------------------------------------------------------------------

struct SeqEnt {
  uint32_t vbase;   // decoded value base (LL_BASE/ML_BASE/1<<ofc)
  uint8_t ebits;    // extra bits to read for the value (0xFF = invalid sym)
  uint8_t nb;       // FSE state-update bits
  uint16_t base;    // FSE state-update base
};

struct SeqDT {
  SeqEnt e[1 << 9];
  int log = -1;
};

// kind: 0=ll, 1=of, 2=ml
static void transform_dt(SeqDT* o, const FseDT* t, int kind) {
  int size = t->log > 0 ? (1 << t->log) : 1;
  o->log = t->log;
  for (int i = 0; i < size; i++) {
    uint8_t sym = t->sym[i];
    SeqEnt* e = &o->e[i];
    e->nb = t->nb[i];
    e->base = t->base[i];
    if (kind == 0) {
      if (sym > 35) { e->ebits = 0xFF; continue; }
      e->vbase = LL_BASE[sym];
      e->ebits = LL_BITS[sym];
    } else if (kind == 2) {
      if (sym > 52) { e->ebits = 0xFF; continue; }
      e->vbase = ML_BASE[sym];
      e->ebits = ML_BITS[sym];
    } else {
      if (sym > 31) { e->ebits = 0xFF; continue; }
      e->vbase = sym ? (1u << sym) : 1;
      e->ebits = sym;
    }
  }
}

// The decode arena holds history AND in-flight block output contiguously
// (the reference's history-as-output trick, framedec.go:334): every match
// copy has a single source, no history/current split, and wide 16-byte
// overcopies are always in-bounds thanks to the +64 slack.
struct ZState {
  uint8_t* arena;        // [history | current block output...]
  long long arena_cap;   // 2*window + 128K + slack
  long long apos;        // valid bytes in arena (history end)
  long long window;      // nominal window size
  uint32_t rep[3];
  HufDT huf;             // previous huff table (treeless)
  FseDT t_ll, t_of, t_ml;
  SeqDT d_ll, d_of, d_ml;  // transformed twins of t_* (kept in sync)
  uint8_t lits[(1 << 17) + 32];  // literals scratch (+overcopy slack)
  uint8_t tmp[(1 << 17) + 64];
};

void* ct_zstd_state_new(long long window) {
  if (window < 0 || window > (64ll << 20)) return nullptr;
  ZState* s = (ZState*)calloc(1, sizeof(ZState));
  if (!s) return nullptr;
  s->window = window < 1024 ? 1024 : window;
  s->arena_cap = 2 * s->window + (1 << 17) + 64;
  s->arena = (uint8_t*)malloc(s->arena_cap);
  if (!s->arena) {
    free(s);
    return nullptr;
  }
  s->apos = 0;
  s->rep[0] = 1;
  s->rep[1] = 4;
  s->rep[2] = 8;
  s->huf.max_bits = -1;
  s->t_ll.log = -1;
  s->t_of.log = -1;
  s->t_ml.log = -1;
  return s;
}

void ct_zstd_state_free(void* sp) {
  ZState* s = (ZState*)sp;
  if (!s) return;
  free(s->arena);
  free(s);
}

// make room for one more 128K block at the arena tail (slide history down)
static inline void arena_room(ZState* s) {
  if (s->apos + (1 << 17) + 64 > s->arena_cap) {
    long long keep = s->apos < s->window ? s->apos : s->window;
    memmove(s->arena, s->arena + s->apos - keep, keep);
    s->apos = keep;
  }
}

static void win_append(ZState* s, const uint8_t* p, long long n) {
  if (n >= s->window) {
    memcpy(s->arena, p + n - s->window, s->window);
    s->apos = s->window;
    return;
  }
  while (n > 0) {
    arena_room(s);
    long long take = n < (1 << 17) ? n : (1 << 17);
    memcpy(s->arena + s->apos, p, take);
    s->apos += take;
    p += take;
    n -= take;
  }
}

void ct_zstd_state_append(void* sp, const uint8_t* p, long long n) {
  win_append((ZState*)sp, p, n);
}

#ifdef CT_PROF
#include <x86intrin.h>
extern "C" unsigned long long ct_phase_cycles[16];
static unsigned long long ct_dec_t0;
#define CT_TIC() (ct_dec_t0 = __rdtsc())
#define CT_TOC(i) (ct_phase_cycles[i] += __rdtsc() - ct_dec_t0, \
                   ct_dec_t0 = __rdtsc())
#else
#define CT_TIC()
#define CT_TOC(i)
#endif

// error codes
enum {
  E_CORRUPT = -1,
  E_UNSUPPORTED = -2,  // caller falls back to Python
};

// decode one compressed block body into base (hist bytes of contiguous
// history live immediately below base); returns decoded size or error.
// base must have (1<<17)+64 writable bytes (overcopy slack included).
static long long decode_block_core(ZState* s, const uint8_t* src, long long n,
                                   uint8_t* const base, const long long hist) {
  if (!s || n < 2) return E_CORRUPT;
  long long pos = 0;
  CT_TIC();

  // ---- literals section ---------------------------------------------------
  uint8_t b0 = src[0];
  int lit_type = b0 & 3;
  long long regen = 0, comp = 0;
  int streams = 1;
  if (lit_type == 0 || lit_type == 1) {
    int sf = (b0 >> 2) & 3;
    if (sf == 0 || sf == 2) {
      regen = b0 >> 3;
      pos = 1;
    } else if (sf == 1) {
      if (n < 2) return E_CORRUPT;
      regen = (b0 >> 4) | ((long long)src[1] << 4);
      pos = 2;
    } else {
      if (n < 3) return E_CORRUPT;
      regen = (b0 >> 4) | ((long long)src[1] << 4) | ((long long)src[2] << 12);
      pos = 3;
    }
  } else {
    int sf = (b0 >> 2) & 3;
    if (sf == 0 || sf == 1) {
      if (n < 3) return E_CORRUPT;
      uint32_t v = b0 | ((uint32_t)src[1] << 8) | ((uint32_t)src[2] << 16);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
      streams = sf == 0 ? 1 : 4;
      pos = 3;
    } else if (sf == 2) {
      if (n < 4) return E_CORRUPT;
      uint64_t v = b0 | ((uint64_t)src[1] << 8) | ((uint64_t)src[2] << 16) |
                   ((uint64_t)src[3] << 24);
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
      streams = 4;
      pos = 4;
    } else {
      if (n < 5) return E_CORRUPT;
      uint64_t v = b0 | ((uint64_t)src[1] << 8) | ((uint64_t)src[2] << 16) |
                   ((uint64_t)src[3] << 24) | ((uint64_t)src[4] << 32);
      regen = (v >> 4) & 0x3FFFF;
      comp = (v >> 22) & 0x3FFFF;
      streams = 4;
      pos = 5;
    }
  }
  if (regen > (1 << 17)) return E_CORRUPT;

  if (lit_type == 0) {  // raw
    if (pos + regen > n) return E_CORRUPT;
    memcpy(s->lits, src + pos, regen);
    pos += regen;
  } else if (lit_type == 1) {  // RLE
    if (pos + 1 > n) return E_CORRUPT;
    memset(s->lits, src[pos], regen);
    pos += 1;
  } else {  // compressed / treeless
    if (pos + comp > n) return E_CORRUPT;
    const uint8_t* lp = src + pos;
    long long ln = comp;
    if (lit_type == 2) {
      int used = huf_read_table(&s->huf, lp, ln);
      if (used < 0) return E_CORRUPT;
      lp += used;
      ln -= used;
    } else if (s->huf.max_bits < 0) {
      return E_CORRUPT;  // treeless without a table
    }
    if (streams == 1) {
      if (!huf_decode_stream(&s->huf, lp, ln, s->lits, regen)) return E_CORRUPT;
    } else {
      if (ln < 6) return E_CORRUPT;
      long long l1 = lp[0] | (lp[1] << 8);
      long long l2 = lp[2] | (lp[3] << 8);
      long long l3 = lp[4] | (lp[5] << 8);
      long long l4 = ln - 6 - l1 - l2 - l3;
      if (l4 < 0) return E_CORRUPT;
      long long seg = (regen + 3) / 4;
      long long last = regen - 3 * seg;
      if (last < 0) return E_CORRUPT;
      const uint8_t* q = lp + 6;
      const uint8_t* sp[4] = {q, q + l1, q + l1 + l2, q + l1 + l2 + l3};
      const long long sn[4] = {l1, l2, l3, l4};
      uint8_t* so[4] = {s->lits, s->lits + seg, s->lits + 2 * seg,
                        s->lits + 3 * seg};
      const long long sl[4] = {seg, seg, seg, last};
      if (!huf_decode_4streams(&s->huf, sp, sn, so, sl)) return E_CORRUPT;
    }
    pos += comp;
  }

  CT_TOC(0);
  // ---- sequences section --------------------------------------------------
  if (pos >= n) return E_CORRUPT;
  long long nseq = src[pos];
  pos++;
  if (nseq >= 128) {
    if (nseq == 255) {
      if (pos + 2 > n) return E_CORRUPT;
      nseq = (src[pos] | (src[pos + 1] << 8)) + 0x7F00;
      pos += 2;
    } else {
      if (pos + 1 > n) return E_CORRUPT;
      nseq = ((nseq - 128) << 8) | src[pos];
      pos += 1;
    }
  }
  if (nseq == 0) {
    memcpy(base, s->lits, regen);
    return regen;
  }
  if (pos >= n) return E_CORRUPT;
  uint8_t modes = src[pos];
  pos++;

  // predefined decode tables are constants: build once per process
  // (3% of decode time was rebuilding them per block)
  struct PreDTs {
    FseDT ll, of, ml;
    bool ok;
    PreDTs() {
      int16_t norm[256];
      auto cp = [&](const int16_t* pre, int n) {
        for (int i = 0; i < n; i++) norm[i] = pre[i];
      };
      cp(PRE_LL, 36);
      ok = fse_build_dt(&ll, norm, 35, 6);
      cp(PRE_OF, 29);
      ok = ok && fse_build_dt(&of, norm, 28, 5);
      cp(PRE_ML, 53);
      ok = ok && fse_build_dt(&ml, norm, 52, 6);
    }
  };
  static const PreDTs g_pre;

  auto setup = [&](FseDT* dt, int mode, const int16_t* pre, int pre_n,
                   int pre_log, int max_log) -> bool {
    if (mode == 0) {
      const FseDT* src_dt = pre == PRE_LL ? &g_pre.ll
                            : pre == PRE_OF ? &g_pre.of : &g_pre.ml;
      if (!g_pre.ok) return false;
      memcpy(dt, src_dt, sizeof(FseDT));
      return true;
    }
    if (mode == 1) {
      if (pos >= n) return false;
      fse_dt_rle(dt, src[pos]);
      pos++;
      return true;
    }
    if (mode == 2) {
      int16_t norm[256];
      int ms, lg;
      int used = fse_read_ncount(src + pos, n - pos, norm, &ms, &lg, max_log);
      if (used < 0) return false;
      pos += used;
      return fse_build_dt(dt, norm, ms, lg);
    }
    return dt->log >= 0;  // repeat
  };
  int m_ll = (modes >> 6) & 3, m_of = (modes >> 4) & 3, m_ml = (modes >> 2) & 3;
  if (!setup(&s->t_ll, m_ll, PRE_LL, 36, 6, 9)) return E_CORRUPT;
  if (!setup(&s->t_of, m_of, PRE_OF, 29, 5, 8)) return E_CORRUPT;
  if (!setup(&s->t_ml, m_ml, PRE_ML, 53, 6, 9)) return E_CORRUPT;
  if (m_ll != 3) transform_dt(&s->d_ll, &s->t_ll, 0);
  if (m_of != 3) transform_dt(&s->d_of, &s->t_of, 1);
  if (m_ml != 3) transform_dt(&s->d_ml, &s->t_ml, 2);

  CT_TOC(1);
  BitRev br;
  if (!br_init(&br, src + pos, n - pos)) return E_CORRUPT;
  uint32_t st_ll = br_read(&br, s->t_ll.log);
  uint32_t st_of = br_read(&br, s->t_of.log);
  uint32_t st_ml = br_read(&br, s->t_ml.log);
  if (!br.ok) return E_CORRUPT;

  // decode straight into the arena tail: history and output share one
  // address space, so every match copy is single-source; +64 slack allows
  // 16/32-byte overcopies (reference: compressedBlockOverAlloc=16 and the
  // seqdec asm wide-copy convention, zstd/blockdec.go:42)
  uint8_t* o = base;
  uint8_t* const o_lim = base + (1 << 17);   // max block size bound
  const uint8_t* lit = s->lits;
  const uint8_t* const lit_end = s->lits + regen;
  uint32_t rep[3] = {s->rep[0], s->rep[1], s->rep[2]};

  const SeqEnt* D_ll = s->d_ll.e;
  const SeqEnt* D_of = s->d_of.e;
  const SeqEnt* D_ml = s->d_ml.e;

  // The loop peels the LAST sequence (no FSE state update there), so the
  // body is a single always-updating path: one wide bit-grab feeds the
  // three extra-bit fields AND the three FSE state updates (the reference
  // asm's one-refill-per-sequence discipline, seqdec_amd64.s role).
  // Rep-offset resolution is branchless (the 4-way history branch is
  // data-dependent and mispredicts ~every other sequence on text).
  //
  // Software pipeline (reference decompressSequencesLong role,
  // zstd/seqdec.go:221 + prefetch variant): decode runs DEPTH sequences
  // ahead of execution and prefetches each match source as soon as its
  // offset is known, so the (cache-missing) match reads overlap the
  // FSE/bit work instead of serializing with it. All validation happens
  // at decode time; execution runs unchecked.
// Pipeline depth. Measured r4 (paired, multiple contents/windows):
// immediate execution (depth 1) beats the 8-deep prefetch ring
// everywhere on this host — the ring's store/load round-trip costs more
// than the prefetch distance saves while match sources sit in L2. The
// reference's Long/prefetch variant (zstd/seqdec.go:221) maps to
// CT_SDEPTH=8 and stays available for cache-starved targets.
#ifndef CT_SDEPTH
#define CT_SDEPTH 1
#endif
  enum { SDEPTH = CT_SDEPTH };
  struct SeqRec {
    uint32_t ll, ml, off;
  };
  SeqRec ring[SDEPTH];
  long long cum_out = 0;  // output bytes after the pending sequence
  long long cum_lit = 0;  // literal bytes consumed through the pending seq
  long long exec_i = 0;

  auto exec_one = [&](const SeqRec& r) {
    uint32_t ll = r.ll, ml = r.ml, off = r.off;
#ifdef AB_NOEXEC
    o += ll + ml; lit += ll; (void)off; if (1) return;
#endif
    // fast path: short literals + short non-overlapping match (the
    // dominant text shape) — two 16-byte copies total
    if ((ll | ml) < 17 && off >= 16) {
      memcpy(o, lit, 16);
      o += ll;
      lit += ll;
      memcpy(o, o - off, 16);
      o += ml;
      return;
    }
    // literals copy (wide: lits has +32 slack, arena o_lim +64)
    memcpy(o, lit, 16);
    memcpy(o + 16, lit + 16, 16);
    if (ll > 32) memcpy(o + 32, lit + 32, ll - 32);
    o += ll;
    lit += ll;

    // match copy: single source (arena holds history + current output)
    const uint8_t* m_src = o - off;
    if (off >= 16) {
      // non-overlapping at 16-byte granularity: unconditional wide copies
      memcpy(o, m_src, 16);
      memcpy(o + 16, m_src + 16, 16);
      if (ml > 32) {
        if ((long long)off >= (long long)ml) {
          // fully disjoint: one bulk memcpy (repeated-content frames
          // carry 100 KB matches — 2x over a 16-byte stepping loop)
          memcpy(o + 32, m_src + 32, ml - 32);
        } else {
          uint8_t* dd = o + 32;
          const uint8_t* ss = m_src + 32;
          long long rem = (long long)ml - 32;
          do {
            memcpy(dd, ss, 16);
            dd += 16;
            ss += 16;
            rem -= 16;
          } while (rem > 0);
        }
      }
      o += ml;
    } else if (off >= 8) {
      // 8-byte steps never overlap their own write
      uint8_t* dd = o;
      const uint8_t* ss = m_src;
      long long rem = ml;
      do {
        memcpy(dd, ss, 8);
        dd += 8;
        ss += 8;
        rem -= 8;
      } while (rem > 0);
      o += ml;
    } else if (off == 1) {
      // byte run: by far the most common tight offset
      memset(o, o[-1], ml);
      o += ml;
    } else {
      // tight overlap (off 2..7, rare): one period byte-wise, then
      // self-doubling copies
      long long m = ml;
      long long have = 0;
      for (; have < m && have < (long long)off; have++)
        o[have] = o[have - off];
      while (have < m) {
        long long take = have < m - have ? have : m - have;
        memcpy(o + have, o, take);
        have += take;
      }
      o += ml;
    }
  };

  auto finish_seq = [&](const SeqEnt& el, const SeqEnt& eo,
                        const SeqEnt& em, uint32_t of_x, uint32_t ml_x,
                        uint32_t ll_x, long long i) -> bool {
    uint32_t of_val = eo.vbase + of_x;
    uint32_t ml = em.vbase + ml_x;
    uint32_t ll = el.vbase + ll_x;
    uint32_t cand3 = rep[0] - 1;
    uint32_t is_long = of_val > 3;
    uint32_t code = is_long ? 3u : of_val - 1 + (ll == 0 ? 1u : 0u);
    uint32_t off = code == 0 ? rep[0] : code == 1 ? rep[1]
                   : code == 2 ? rep[2] : is_long ? of_val - 3 : cand3;
    if (off == 0) return false;
    rep[2] = code >= 2 ? rep[1] : rep[2];
    rep[1] = code >= 1 ? rep[0] : rep[1];
    rep[0] = off;
    cum_lit += ll;
    if (cum_lit > regen) return false;
    if ((long long)off > cum_out + ll + hist) return false;
    cum_out += ll + ml;
    if (cum_out > (1 << 17)) return false;
    const uint8_t* pm = base + (cum_out - ml) - off;
    __builtin_prefetch(pm, 0, 1);
    __builtin_prefetch(pm + 64, 0, 1);
    ring[i & (SDEPTH - 1)] = {ll, ml, off};
    if (i >= SDEPTH - 1) {
      exec_one(ring[exec_i & (SDEPTH - 1)]);
      exec_i++;
    }
    return true;
  };

  for (long long i = 0; i < nseq; i++) {
    SeqEnt el = D_ll[st_ll];
    SeqEnt eo = D_of[st_of];
    SeqEnt em = D_ml[st_ml];
    int tot = eo.ebits + em.ebits + el.ebits;
    int stbits = el.nb + em.nb + eo.nb;
    uint32_t of_x, ml_x, ll_x;
    long long last = (i == nseq - 1);
    int need = tot + stbits;
    if (!last && need <= 57 && br.bitpos >= 57) {
      // opportunistic double-sequence window: ONE peek may serve two
      long long pk = br.bitpos - 57;
      uint64_t v;
      memcpy(&v, br.p + (pk >> 3), 8);
      uint64_t w = v >> (pk & 7);
      int rem = 57;
      of_x = win_take(w, &rem, eo.ebits);
      ml_x = win_take(w, &rem, em.ebits);
      ll_x = win_take(w, &rem, el.ebits);
      st_ll = (el.base + win_take(w, &rem, el.nb)) & 511;
      st_ml = (em.base + win_take(w, &rem, em.nb)) & 511;
      st_of = (eo.base + win_take(w, &rem, eo.nb)) & 511;
      if (!finish_seq(el, eo, em, of_x, ml_x, ll_x, i)) return E_CORRUPT;
      long long used = need;
      i++;
      SeqEnt el2 = D_ll[st_ll];
      SeqEnt eo2 = D_of[st_of];
      SeqEnt em2 = D_ml[st_ml];
      long long last2 = (i == nseq - 1);
      int tot2 = eo2.ebits + em2.ebits + el2.ebits;
      int st2 = last2 ? 0 : el2.nb + em2.nb + eo2.nb;
      int need2 = tot2 + st2;
      if (need2 <= rem) {
        of_x = win_take(w, &rem, eo2.ebits);
        ml_x = win_take(w, &rem, em2.ebits);
        ll_x = win_take(w, &rem, el2.ebits);
        if (!last2) {
          st_ll = (el2.base + win_take(w, &rem, el2.nb)) & 511;
          st_ml = (em2.base + win_take(w, &rem, em2.nb)) & 511;
          st_of = (eo2.base + win_take(w, &rem, eo2.nb)) & 511;
        }
        if (!finish_seq(el2, eo2, em2, of_x, ml_x, ll_x, i))
          return E_CORRUPT;
        used += need2;
      } else {
        i--;  // second seq did not fit: re-enter loop for it
      }
      br.bitpos -= used;
      continue;
    }
    need = tot + (last ? 0 : stbits);
    uint64_t w;
    if (need <= 57 && br_grab(&br, need, &w)) {
      int rem = need;
      of_x = win_take(w, &rem, eo.ebits);
      ml_x = win_take(w, &rem, em.ebits);
      ll_x = win_take(w, &rem, el.ebits);
      if (!last) {
        st_ll = (el.base + win_take(w, &rem, el.nb)) & 511;
        st_ml = (em.base + win_take(w, &rem, em.nb)) & 511;
        st_of = (eo.base + win_take(w, &rem, eo.nb)) & 511;
      }
    } else {
      of_x = br_read(&br, eo.ebits);
      ml_x = br_read(&br, em.ebits);
      ll_x = br_read(&br, el.ebits);
      if (!br.ok) return E_CORRUPT;
      if (!last) {
        st_ll = (el.base + br_read(&br, el.nb)) & 511;
        st_ml = (em.base + br_read(&br, em.nb)) & 511;
        st_of = (eo.base + br_read(&br, eo.nb)) & 511;
        if (!br.ok) return E_CORRUPT;
      }
    }
    if (!finish_seq(el, eo, em, of_x, ml_x, ll_x, i)) return E_CORRUPT;
  }
  while (exec_i < nseq) {
    exec_one(ring[exec_i & (SDEPTH - 1)]);
    exec_i++;
  }
  if (br.bitpos != 0) return E_CORRUPT;
  // trailing literals
  long long tail = lit_end - lit;
  if (o + tail > o_lim) return E_CORRUPT;
  memcpy(o, lit, tail);
  o += tail;

  s->rep[0] = rep[0];
  s->rep[1] = rep[1];
  s->rep[2] = rep[2];
  CT_TOC(2);
  return o - base;
}

// streaming API: decode one block into the rolling arena, copy out to dst
// (used by the incremental stream Reader).
long long ct_zstd_decode_block(void* sp, const uint8_t* src, long long n,
                               uint8_t* dst, long long cap) {
  ZState* s = (ZState*)sp;
  if (!s || cap < (1 << 17)) return E_CORRUPT;
  arena_room(s);
  long long r = decode_block_core(s, src, n, s->arena + s->apos, s->apos);
  if (r < 0) return r;
  if (r > cap) return E_CORRUPT;
  // RFC 8878 Block_Maximum_Size = min(Window_Size, 128 KB)
  if (s->window > 0 && r > s->window && r > 1024) return E_CORRUPT;
  memcpy(dst, s->arena + s->apos, r);
  s->apos += r;
  return r;
}

enum { E_SPACE = -3 };  // output buffer too small; caller grows and retries

// ---------------------------------------------------------------------------
// sidecar builder — encode-time accelerator for the device decoder.
//
// Walks one single-block frame once and serializes the accel tensors the
// batched TPU decoder needs (VERDICT r2 missing #1): huff0 per-stream bit
// checkpoints every HUFF_K symbols, sequence checkpoints (bit offset +
// 3 FSE states + resolved rep offsets) every ZSEQ_K sequences, and the
// round-annotated execute plan (the ops/execute.py plan_block_ops
// algorithm, ported). The payload ships in a skippable frame before the
// content frame; decode then needs ZERO per-symbol host work.
// Precedent: huff0's 4X jump table pays format bytes for decode
// parallelism (reference huff0/compress.go:269).
// ---------------------------------------------------------------------------

static const int ACC_HUFF_K = 32;   // ops/entropy.py HUFF_CKPT_K
static const int ACC_ZSEQ_K = 8;    // ops/entropy_dec.py ZSEQ_K

struct ByteSink {
  uint8_t* p;
  long long pos, cap;
  bool ok;
  void u8(uint8_t v) {
    if (pos + 1 > cap) { ok = false; return; }
    p[pos++] = v;
  }
  void u16(uint32_t v) {
    if (pos + 2 > cap) { ok = false; return; }
    p[pos++] = v & 0xFF;
    p[pos++] = (v >> 8) & 0xFF;
  }
  void u32(uint64_t v) {
    if (pos + 4 > cap) { ok = false; return; }
    for (int i = 0; i < 4; i++) p[pos++] = (v >> (8 * i)) & 0xFF;
  }
};

// decode one huff0 stream recording the remaining-bit offset every k
// symbols (mirrors device_dec._hwalk exactly, incl. final-symbol drain)
static bool huf_walk_cks(const HufDT* ht, const uint8_t* p, long long n,
                         long long out_len, ByteSink* sink) {
  BitRev br;
  if (!br_init(&br, p, n)) return false;
  int mb = ht->max_bits;
  long long nch = out_len > 0 ? (out_len + ACC_HUFF_K - 1) / ACC_HUFF_K : 1;
  if (nch > 0xFFFF) return false;
  sink->u16((uint32_t)nch);
  sink->u32((uint64_t)br.bitpos);
  for (long long i = 0; i < out_len; i++) {
    uint32_t idx;
    if (br.bitpos >= mb) {
      long long bp = br.bitpos - mb;
      uint64_t v = br_load(&br, bp >> 3);
      idx = (uint32_t)((v >> (bp & 7)) & ((1u << mb) - 1));
    } else {
      if (br.bitpos <= 0) return false;
      uint64_t v = br_load(&br, 0);
      idx = (uint32_t)((v << (mb - br.bitpos)) & ((1u << mb) - 1));
    }
    int nb = ht->nb[idx];
    if (nb > br.bitpos) nb = (int)br.bitpos;
    br.bitpos -= nb;
    if ((i + 1) % ACC_HUFF_K == 0 && i + 1 < out_len)
      sink->u32((uint64_t)br.bitpos);
  }
  return sink->ok;
}

// plan_block_ops port: decode-order ops -> round-annotated dst-row-aligned
// pieces with transitive source substitution (ops/execute.py:51).
struct PlanOut {
  int32_t* src;
  uint8_t* len;
  uint8_t* rnd;
  long long n, cap;
  int n_rounds;
  bool ok;
  void push(long long s, long long ln, int r) {
    if (n >= cap) { ok = false; return; }
    src[n] = (int32_t)s;
    len[n] = (uint8_t)ln;   // pieces are row-bounded: ln <= 128
    rnd[n] = (uint8_t)r;
    n++;
    if (r + 1 > n_rounds) n_rounds = r + 1;
  }
};

static const long long ACC_OUT_BASE = 512 * 128;

// emit pieces for dst range [d0, d0+L) with per-byte sources sarr/rounds
// rarr, cutting at non-contiguous sources, round changes, and 128-lane
// dst row boundaries
// history rows (previous blocks' output, last byte adjacent to the
// current block) live ABOVE the 1024-row arena: history byte -j (j >= 1,
// relative to the current block's start) sits at arena address
// ACC_HIST_BASE + hist_cap - j. 64 KiB blocks make the decode-side
// history update a STATIC 512-row shift.
static const long long ACC_HIST_BASE = 1024 * 128;

static void plan_emit(PlanOut* po, long long d0, const int32_t* sarr,
                      const int16_t* rarr, long long L) {
  long long a = 0;
  while (a < L && po->ok) {
    long long b = a + 1;
    while (b < L && sarr[b] == sarr[b - 1] + 1 && rarr[b] == rarr[a]) b++;
    long long d = d0 + a;
    long long s = sarr[a];
    long long ln = b - a;
    while (ln > 0 && po->ok) {
      long long room = 128 - ((ACC_OUT_BASE + d) & 127);
      long long take = ln < room ? ln : room;
      po->push(s, take, rarr[a]);
      d += take;
      s += take;
      ln -= take;
    }
    a = b;
  }
}

// hist_avail: history bytes reachable before this block (0 for
// single-block); hist_cap: the decode-side history tensor size in bytes
// (fixed per frame). A source byte at block-relative position sp < 0 is
// history, fully resolved at block start (round 0), at arena address
// ACC_HIST_BASE + hist_cap + sp.
static bool plan_ops(const int32_t* lls, const int32_t* mls,
                     const int32_t* offs, long long nseq, long long tail_lit,
                     int max_rounds, PlanOut* po, int32_t* esrc,
                     int16_t* ernd, int32_t* stmp, int16_t* rtmp,
                     long long hist_avail, long long hist_cap,
                     long long out_base = ACC_OUT_BASE,
                     long long out_cap = (1 << 16)) {
  long long pos = 0, lit_pos = 0;
  for (long long k = 0; k <= nseq; k++) {
    long long ll = k < nseq ? lls[k] : tail_lit;
    if (ll > 0) {
      for (long long i = 0; i < ll; i++) {
        stmp[i] = (int32_t)(lit_pos + i);
        rtmp[i] = 0;
      }
      plan_emit(po, pos, stmp, rtmp, ll);
      for (long long i = 0; i < ll; i++) {
        esrc[pos + i] = (int32_t)(lit_pos + i);
        ernd[pos + i] = 0;
      }
      lit_pos += ll;
      pos += ll;
    }
    if (k == nseq) break;
    long long L = mls[k];
    long long off = offs[k];
    if (off <= 0 || off > pos + hist_avail || pos + L > out_cap)
      return false;
    int rmax = 0;
    bool contig = true;
    for (long long i = 0; i < L; i++) {
      long long sp = pos - off + (off < L ? (i % off) : i);
      if (sp < 0) {
        stmp[i] = (int32_t)(ACC_HIST_BASE + hist_cap + sp);
        rtmp[i] = 0;
      } else {
        stmp[i] = esrc[sp];
        rtmp[i] = ernd[sp];
      }
      if (rtmp[i] > rmax) rmax = rtmp[i];
      if (i && (stmp[i] != stmp[i - 1] + 1 || rtmp[i] != rtmp[i - 1]))
        contig = false;
    }
    int rnd_direct = rmax + 1;
    if (rnd_direct <= max_rounds) {
      if (off >= L && contig) {
        // transitive read keeps the round low without fragmenting
        plan_emit(po, pos, stmp, rtmp, L);
        for (long long i = 0; i < L; i++) {
          esrc[pos + i] = stmp[i];
          ernd[pos + i] = rtmp[i];
        }
      } else {
        // read the output bytes directly, one round later (history bytes
        // keep their round-0 absolute address — they are not re-written)
        for (long long i = 0; i < L; i++) {
          long long sp = pos - off + (off < L ? (i % off) : i);
          if (sp < 0) {
            stmp[i] = (int32_t)(ACC_HIST_BASE + hist_cap + sp);
            rtmp[i] = 0;
          } else {
            stmp[i] = (int32_t)(out_base + sp);
            rtmp[i] = (int16_t)rnd_direct;
          }
        }
        plan_emit(po, pos, stmp, rtmp, L);
        for (long long i = 0; i < L; i++) {
          esrc[pos + i] = stmp[i];
          ernd[pos + i] = rtmp[i];  // history bytes stay round 0
        }
      }
    } else {
      // too deep: flatten through transitive sources
      plan_emit(po, pos, stmp, rtmp, L);
      for (long long i = 0; i < L; i++) {
        esrc[pos + i] = stmp[i];
        ernd[pos + i] = rtmp[i];
      }
    }
    pos += L;
    if (!po->ok) return false;
  }
  return po->ok;
}

// s2/snappy device-decode plan: parse one s2 block's tag stream (mirrors
// s2.cpp ct_s2_decode_block, incl. the repeat extension) into decode-order
// ops, then plan them for the arena execute kernel. Output payload:
//   u32 total_out; u32 n_lit; u8 lit[n_lit];
//   u32 n_pieces; u8 n_rounds; i32 src[n]; u8 len[n]; u8 round[n]
// Returns payload size or E_CORRUPT/E_SPACE; 0 when not plannable
// (output > 64K). mode bit0 = allow repeat tags (s2), 0 = strict snappy.
long long ct_s2_build_plan(const uint8_t* src, long long slen,
                           long long dlen, int mode, int max_rounds,
                           uint8_t* out, long long cap) {
  // blocks up to 256 KiB decode on device; the arena scales by the
  // power-of-two class M = ceil(dlen / 64Ki): literal region M*512
  // rows, output base M*64Ki (mirrored in s2/device_dec.py)
  if (dlen > (1 << 18) || dlen < 0) return 0;
  long long ocap = 4 * dlen + 1024;  // ops bound: >= 1 op per 2 bytes
  int32_t* k_ll = (int32_t*)malloc(ocap * 4);   // literal lens per op
  int32_t* mls = (int32_t*)malloc(ocap * 4);
  int32_t* ofs = (int32_t*)malloc(ocap * 4);
  uint8_t* lit = (uint8_t*)malloc(dlen + (1 << 16) + 16);
  if (!k_ll || !mls || !ofs || !lit) {
    free(k_ll); free(mls); free(ofs); free(lit);
    return E_CORRUPT;
  }
  long long nop = 0, nlit = 0, total = 0;
  long long s = 0;
  uint64_t offset = 0;
  const int allow_repeat = mode & 1;
  long long pend_lit = 0;  // literal run preceding the next copy
  bool ok = true;
  while (s < slen && ok) {
    uint8_t tag = src[s];
    uint64_t length;
    switch (tag & 3) {
      case 0: {
        uint32_t x = tag >> 2;
        if (x < 60) {
          s += 1;
        } else {
          uint32_t nb = x - 59;
          if (s + 1 + nb > (uint64_t)slen) { ok = false; break; }
          x = 0;
          for (uint32_t k = 0; k < nb; k++)
            x |= (uint32_t)src[s + 1 + k] << (8 * k);
          s += 1 + nb;
        }
        length = (uint64_t)x + 1;
        if ((long long)length > slen - s || total + (long long)length > dlen) {
          ok = false;
          break;
        }
        memcpy(lit + nlit, src + s, length);
        nlit += length;
        pend_lit += length;
        total += length;
        s += length;
        continue;
      }
      case 1: {
        if (s + 2 > slen) { ok = false; break; }
        uint64_t toff = ((uint64_t)(tag & 0xE0) << 3) | src[s + 1];
        length = (tag >> 2) & 7;
        s += 2;
        if (toff == 0) {
          if (!allow_repeat) { ok = false; break; }
          switch (length) {
            case 5:
              if (s + 1 > slen) { ok = false; break; }
              length = (uint64_t)src[s] + 4;
              s += 1;
              break;
            case 6:
              if (s + 2 > slen) { ok = false; break; }
              length = ((uint64_t)src[s] | ((uint64_t)src[s + 1] << 8)) + 256;
              s += 2;
              break;
            case 7:
              if (s + 3 > slen) { ok = false; break; }
              length = ((uint64_t)src[s] | ((uint64_t)src[s + 1] << 8) |
                        ((uint64_t)src[s + 2] << 16)) + 65536;
              s += 3;
              break;
            default:;
          }
        } else {
          offset = toff;
        }
        length += 4;
        break;
      }
      case 2: {
        if (s + 3 > slen) { ok = false; break; }
        offset = (uint64_t)src[s + 1] | ((uint64_t)src[s + 2] << 8);
        length = 1 + (tag >> 2);
        s += 3;
        break;
      }
      default: {
        if (s + 5 > slen) { ok = false; break; }
        offset = (uint64_t)src[s + 1] | ((uint64_t)src[s + 2] << 8) |
                 ((uint64_t)src[s + 3] << 16) | ((uint64_t)src[s + 4] << 24);
        length = 1 + (tag >> 2);
        s += 5;
        break;
      }
    }
    if (!ok) break;
    if (offset == 0 || (long long)offset > total ||
        total + (long long)length > dlen || nop >= ocap) {
      ok = false;
      break;
    }
    k_ll[nop] = (int32_t)pend_lit;
    mls[nop] = (int32_t)length;
    ofs[nop] = (int32_t)offset;
    nop++;
    pend_lit = 0;
    total += length;
  }
  long long ret = E_CORRUPT;
  if (ok && total == dlen) {
    long long pcap = 2 * nop + total + 1024;
    int32_t* psrc = (int32_t*)malloc(pcap * 4);
    uint8_t* plen = (uint8_t*)malloc(pcap);
    uint8_t* prnd = (uint8_t*)malloc(pcap);
    long long scap = dlen + 1024;
    int32_t* esrc = (int32_t*)malloc(scap * 4);
    int16_t* ernd2 = (int16_t*)malloc(scap * 2);
    int32_t* stmp = (int32_t*)malloc(scap * 4);
    int16_t* rtmp = (int16_t*)malloc(scap * 2);
    if (psrc && plen && prnd && esrc && ernd2 && stmp && rtmp) {
      long long M = 1;
      while (M * (1 << 16) < dlen) M <<= 1;
      PlanOut po{psrc, plen, prnd, 0, pcap, 1, true};
      bool planned = plan_ops(k_ll, mls, ofs, nop, pend_lit, max_rounds,
                              &po, esrc, ernd2, stmp, rtmp, 0, 0,
                              M * ACC_OUT_BASE, M * (1 << 16));
      if (planned) {
        ByteSink sink{out, 0, cap, true};
        sink.u32((uint64_t)total);
        sink.u32((uint64_t)nlit);
        if (sink.ok && sink.pos + nlit <= cap) {
          memcpy(out + sink.pos, lit, nlit);
          sink.pos += nlit;
        } else {
          sink.ok = false;
        }
        sink.u32((uint64_t)po.n);
        sink.u8((uint8_t)po.n_rounds);
        if (sink.ok && sink.pos + 6 * po.n <= cap) {
          for (long long i = 0; i < po.n; i++) sink.u32((uint64_t)psrc[i]);
          memcpy(out + sink.pos, plen, po.n);
          sink.pos += po.n;
          memcpy(out + sink.pos, prnd, po.n);
          sink.pos += po.n;
          ret = sink.pos;
        } else {
          ret = E_SPACE;
        }
      }
    }
    free(psrc); free(plen); free(prnd); free(esrc); free(ernd2);
    free(stmp); free(rtmp);
  }
  free(k_ll); free(mls); free(ofs); free(lit);
  return ret;
}

// build the sidecar payload for ONE single-block frame. src points at the
// first block header (frame header stripped by the caller) with 16 bytes
// of readable slack; returns payload size, 0 if the frame shape is not
// device-eligible (caller emits no sidecar), or E_CORRUPT/E_SPACE.
// opts bit0: also serialize the per-8-sequence checkpoint records
// (bit offset + FSE states + reps) — the compact/validation channel.
// The default plan-only sidecar omits them (r3 review #4: nothing in the
// plan-driven decode path reads them, and they cost ~2.75 B/sequence).
// pieces worst case per block (full flatten, max_rounds=1): every output
// byte may open a new piece at a row boundary or source discontinuity
static const long long SIDE_PCAP = 2ll * (1 << 16) + (1 << 16) + 1024;

// carried per-frame state for the multi-block walk (RFC 8878: rep
// offsets, FSE tables in repeat mode, and the huff table for treeless
// literals all persist across blocks within one frame)
struct SideSt {
  uint32_t rep[3];
  FseDT ts[3];
  HufDT huf;
};

// shared scratch (allocated once per frame by the outer walk)
struct SideScr {
  int32_t *lls, *mls, *ofs;
  int32_t* psrc;
  uint8_t *plen, *prnd;
  int32_t *esrc, *stmp;
  int16_t *ernd, *rtmp;
};

// walk ONE block and append its sidecar record. Returns the block's
// decoded size, or -1 (shape not device-eligible) or E_SPACE.
static long long side_block(const uint8_t* bp, long long bsize, int btype,
                            SideSt* st, ByteSink* sink, int max_rounds,
                            int opts, long long hist_avail,
                            long long hist_cap, SideScr* sc) {
  long long flags_at = sink->pos;
  sink->u8(0);
  if (!sink->ok) return E_SPACE;
  const bool emit_cks = (opts & 1) != 0;

  if (btype == 0 || btype == 1) {
    // raw / RLE BLOCK: record as a literal-only plan (the literal stage
    // ships the bytes; the plan is identity round-0 pieces)
    long long regen = bsize;
    if (regen > (1 << 16)) return -1;
    sink->u8(btype == 0 ? 1 : 2);  // lit_kind raw / RLE
    sink->u32((uint64_t)regen);
    sink->u32(0);                  // n_seqs
    sink->u32((uint64_t)regen);    // total_out
    if (emit_cks) sink->u16(0);
    // identity plan: one piece per 128-lane row
    long long n_pieces = (regen + 127) / 128;
    sink->u32((uint64_t)n_pieces);
    sink->u8(1);  // n_rounds
    for (long long i = 0; i < regen; i += 128) sink->u32((uint64_t)i);
    for (long long i = 0; i < regen; i += 128)
      sink->u8((uint8_t)(regen - i < 128 ? regen - i : 128));
    for (long long i = 0; i < n_pieces; i++) sink->u8(0);
    if (!sink->ok) return E_SPACE;
    sink->p[flags_at] = (uint8_t)(1 | (emit_cks ? 2 : 0));
    return regen;
  }

  // ---- literals section: 4X/1X compressed, raw, or RLE ----
  // lit_kind: 0 = 4X compressed, 1 = raw, 2 = RLE, 3 = 1X compressed
  if (bsize < 1) return -1;
  // the header parse below reads up to 5 bytes; copy what exists so a
  // truncated block cannot read past the buffer (caught by the
  // pos + comp > bsize check after)
  uint8_t hdr[5] = {0, 0, 0, 0, 0};
  memcpy(hdr, bp, bsize < 5 ? (size_t)bsize : (size_t)5);
  const uint8_t* bph = bp;
  bp = hdr;
  uint8_t b0 = bp[0];
  int lit_type = b0 & 3;
  int sf = (b0 >> 2) & 3;
  long long regen = 0, comp = 0, pos = 0;
  int lit_kind;
  int n_streams = 0;
  if (lit_type == 0 || lit_type == 1) {
    lit_kind = lit_type == 0 ? 1 : 2;
    if (sf == 0 || sf == 2) {
      regen = b0 >> 3;
      pos = 1;
    } else if (sf == 1) {
      regen = (b0 >> 4) | ((long long)bp[1] << 4);
      pos = 2;
    } else {
      regen = (b0 >> 4) | ((long long)bp[1] << 4) | ((long long)bp[2] << 12);
      pos = 3;
    }
    comp = lit_type == 0 ? regen : 1;
  } else if (lit_type == 2) {
    if (sf == 0 || sf == 1) {
      uint32_t v = b0 | ((uint32_t)bp[1] << 8) | ((uint32_t)bp[2] << 16);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
      pos = 3;
      n_streams = sf == 0 ? 1 : 4;
    } else if (sf == 2) {
      uint64_t v = b0 | ((uint64_t)bp[1] << 8) | ((uint64_t)bp[2] << 16) |
                   ((uint64_t)bp[3] << 24);
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
      pos = 4;
      n_streams = 4;
    } else {
      uint64_t v = b0 | ((uint64_t)bp[1] << 8) | ((uint64_t)bp[2] << 16) |
                   ((uint64_t)bp[3] << 24) | ((uint64_t)bp[4] << 32);
      regen = (v >> 4) & 0x3FFFF;
      comp = (v >> 22) & 0x3FFFF;
      pos = 5;
      n_streams = 4;
    }
    lit_kind = n_streams == 4 ? 0 : 3;
  } else {
    // treeless: reuse the carried table from an earlier block
    if (st->huf.max_bits < 0) return -1;
    if (sf == 0) {
      uint32_t v = b0 | ((uint32_t)bp[1] << 8) | ((uint32_t)bp[2] << 16);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
      pos = 3;
      n_streams = 1;
    } else if (sf == 1) {
      uint32_t v = b0 | ((uint32_t)bp[1] << 8) | ((uint32_t)bp[2] << 16);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
      pos = 3;
      n_streams = 4;
    } else if (sf == 2) {
      uint64_t v = b0 | ((uint64_t)bp[1] << 8) | ((uint64_t)bp[2] << 16) |
                   ((uint64_t)bp[3] << 24);
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
      pos = 4;
      n_streams = 4;
    } else {
      uint64_t v = b0 | ((uint64_t)bp[1] << 8) | ((uint64_t)bp[2] << 16) |
                   ((uint64_t)bp[3] << 24) | ((uint64_t)bp[4] << 32);
      regen = (v >> 4) & 0x3FFFF;
      comp = (v >> 22) & 0x3FFFF;
      pos = 5;
      n_streams = 4;
    }
    lit_kind = n_streams == 4 ? 0 : 3;
  }
  bp = bph;  // header parsed; all further reads are bounds-checked
  if (regen > (1 << 16) || pos + comp > bsize) return -1;
  HufDT* ht = &st->huf;
  const uint8_t* sp[4] = {nullptr, nullptr, nullptr, nullptr};
  long long sn[4] = {0, 0, 0, 0};
  long long slen[4] = {0, 0, 0, 0};
  if (lit_kind == 0 || lit_kind == 3) {
    const uint8_t* lp = bp + pos;
    long long ln = comp;
    if (lit_type == 2) {
      int used = huf_read_table(ht, lp, ln);
      if (used < 0) {
        ht->max_bits = -1;  // table clobbered mid-read: invalidate carry
        return -1;
      }
      lp += used;
      ln -= used;
    }
    if (lit_kind == 0) {
      if (ln < 6) return -1;
      long long l1 = lp[0] | (lp[1] << 8);
      long long l2 = lp[2] | (lp[3] << 8);
      long long l3 = lp[4] | (lp[5] << 8);
      long long l4 = ln - 6 - l1 - l2 - l3;
      if (l4 < 0) return -1;
      long long seg = (regen + 3) / 4;
      const uint8_t* q = lp + 6;
      sp[0] = q;
      sp[1] = q + l1;
      sp[2] = q + l1 + l2;
      sp[3] = q + l1 + l2 + l3;
      sn[0] = l1;
      sn[1] = l2;
      sn[2] = l3;
      sn[3] = l4;
      slen[0] = slen[1] = slen[2] = seg;
      slen[3] = regen - 3 * seg;
    } else {
      sp[0] = lp;
      sn[0] = ln;
      slen[0] = regen;
    }
  }

  // ---- sequences section header ----
  long long spos = pos + comp;
  if (spos >= bsize) return -1;
  long long nseq = bp[spos++];
  if (nseq >= 128) {
    if (nseq == 255) {
      if (spos + 2 > bsize) return -1;
      nseq = (bp[spos] | (bp[spos + 1] << 8)) + 0x7F00;
      spos += 2;
    } else {
      if (spos + 1 > bsize) return -1;
      nseq = ((nseq - 128) << 8) | bp[spos];
      spos += 1;
    }
  }
  FseDT* ts = st->ts;
  if (nseq > 0) {
    if (spos >= bsize) return -1;
    uint8_t modes = bp[spos++];
    static const int16_t* pre[3] = {PRE_LL, PRE_OF, PRE_ML};
    static const int pre_n[3] = {36, 29, 53};
    static const int pre_log[3] = {6, 5, 6};
    static const int max_log[3] = {9, 8, 9};
    int mode_order[3] = {(modes >> 6) & 3, (modes >> 4) & 3,
                         (modes >> 2) & 3};
    for (int t = 0; t < 3; t++) {
      int mode = mode_order[t];
      if (mode == 0) {
        int16_t norm[256];
        for (int i = 0; i < pre_n[t]; i++) norm[i] = pre[t][i];
        if (!fse_build_dt(&ts[t], norm, pre_n[t] - 1, pre_log[t])) return -1;
      } else if (mode == 1) {
        if (spos >= bsize) return -1;
        fse_dt_rle(&ts[t], bp[spos++]);
      } else if (mode == 2) {
        int16_t norm[256];
        int ms, lg;
        int u = fse_read_ncount(bp + spos, bsize - spos, norm, &ms, &lg,
                                max_log[t]);
        if (u < 0) return -1;
        spos += u;
        if (!fse_build_dt(&ts[t], norm, ms, lg)) {
          ts[t].log = -1;  // clobbered mid-build: invalidate carry
          return -1;
        }
      } else {
        // repeat: reuse the carried table from an earlier block
        if (ts[t].log < 0) return -1;
      }
    }
  }
  // device exactness gate (offset codes <= 23) is CONTENT-gated during
  // the walk below — a table that merely allows large codes no longer
  // disqualifies a stream that never uses them (VERDICT r2 weak #10)

  // ---- walk sequences: checkpoints + (ll, ml, resolved off) ----
  int32_t* lls = sc->lls;
  int32_t* mls = sc->mls;
  int32_t* ofs = sc->ofs;
  BitRev br;
  if (nseq > (1 << 16)) return -1;  // scratch bound (64K block max anyway)
  uint32_t s_ll = 0, s_of = 0, s_ml = 0;
  if (nseq > 0) {
    if (!br_init(&br, bp + spos, bsize - spos)) return -1;
    s_ll = br_read(&br, ts[0].log);
    s_of = br_read(&br, ts[1].log);
    s_ml = br_read(&br, ts[2].log);
    if (!br.ok) return -1;
  } else {
    br.p = bp;
    br.bitpos = 0;
    br.ok = true;
  }
  uint32_t* rep = st->rep;
  long long seq_nch = nseq > 0 ? (nseq + ACC_ZSEQ_K - 1) / ACC_ZSEQ_K : 0;
  if (seq_nch > 0xFFFF) return -1;
  // write literal checkpoints now (before the variable-size seq section)
  sink->u8((uint8_t)lit_kind);
  sink->u32((uint64_t)regen);
  sink->u32((uint64_t)nseq);
  long long total_at = sink->pos;
  sink->u32(0);  // total_out patched below
  int n_ck_streams = lit_kind == 0 ? 4 : (lit_kind == 3 ? 1 : 0);
  for (int k = 0; k < n_ck_streams; k++)
    if (!huf_walk_cks(ht, sp[k], sn[k], slen[k], sink)) return -1;
  if (emit_cks) sink->u16((uint32_t)seq_nch);
  auto seq_ck = [&]() {
    if (!emit_cks || nseq == 0) return;
    sink->u32((uint64_t)br.bitpos);
    sink->u16(s_ll);
    sink->u16(s_of);
    sink->u16(s_ml);
    sink->u32(rep[0]);
    sink->u32(rep[1]);
    sink->u32(rep[2]);
  };
  seq_ck();
  long long total_out = 0;
  long long lit_used = 0;
  for (long long i = 0; i < nseq; i++) {
    uint8_t of_c = ts[1].sym[s_of];
    uint8_t ml_c = ts[2].sym[s_ml];
    uint8_t ll_c = ts[0].sym[s_ll];
    if (ml_c > 52 || ll_c > 35 || of_c > 23) return -1;
    uint32_t of_x = br_read(&br, of_c);
    uint32_t ml_x = br_read(&br, ML_BITS[ml_c]);
    uint32_t ll_x = br_read(&br, LL_BITS[ll_c]);
    if (!br.ok) return -1;
    uint32_t of_val = of_c ? ((1u << of_c) + of_x) : 1;
    uint32_t ml = ML_BASE[ml_c] + ml_x;
    uint32_t ll = LL_BASE[ll_c] + ll_x;
    uint32_t off;
    if (of_val > 3) {
      off = of_val - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = off;
    } else {
      uint32_t code = of_val - 1 + (ll == 0 ? 1 : 0);
      if (code == 0) {
        off = rep[0];
      } else if (code == 1) {
        off = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else if (code == 2) {
        off = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        off = rep[0] - 1;
        if (off == 0) return -1;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      }
    }
    lls[i] = (int32_t)ll;
    mls[i] = (int32_t)ml;
    ofs[i] = (int32_t)off;
    lit_used += ll;
    total_out += ll + ml;
    if (i < nseq - 1) {
      s_ll = ts[0].base[s_ll] + br_read(&br, ts[0].nb[s_ll]);
      s_ml = ts[2].base[s_ml] + br_read(&br, ts[2].nb[s_ml]);
      s_of = ts[1].base[s_of] + br_read(&br, ts[1].nb[s_of]);
      if (!br.ok) return -1;
    }
    if ((i + 1) % ACC_ZSEQ_K == 0 && i + 1 < nseq) seq_ck();
  }
  if (br.bitpos != 0 || lit_used > regen) return -1;
  if (nseq == 0 && spos != bsize) return -1;
  long long tail_lit = regen - lit_used;
  total_out += tail_lit;
  if (total_out > (1 << 16) || !sink->ok) return -1;
  sink->p[total_at] = total_out & 0xFF;
  sink->p[total_at + 1] = (total_out >> 8) & 0xFF;
  sink->p[total_at + 2] = (total_out >> 16) & 0xFF;
  sink->p[total_at + 3] = 0;

  // ---- execute plan ----
  PlanOut po{sc->psrc, sc->plen, sc->prnd, 0, SIDE_PCAP, 1, true};
  if (!plan_ops(lls, mls, ofs, nseq, tail_lit, max_rounds, &po, sc->esrc,
                sc->ernd, sc->stmp, sc->rtmp, hist_avail, hist_cap))
    return -1;
  if (po.n > 0xFFFFFFFFll) return -1;
  sink->u32((uint64_t)po.n);
  sink->u8((uint8_t)po.n_rounds);
  if (!sink->ok || sink->pos + 6 * po.n > sink->cap) return E_SPACE;
  for (long long i = 0; i < po.n; i++) sink->u32((uint64_t)sc->psrc[i]);
  memcpy(sink->p + sink->pos, sc->plen, po.n);
  sink->pos += po.n;
  memcpy(sink->p + sink->pos, sc->prnd, po.n);
  sink->pos += po.n;
  sink->p[flags_at] = (uint8_t)(1 | (emit_cks ? 2 : 0));  // eligible
  return total_out;
}

long long ct_zstd_build_sidecar(const uint8_t* src, long long n,
                                int max_rounds, int opts, int hist_blocks,
                                uint8_t* out, long long cap) {
  if (hist_blocks < 0 || hist_blocks > 128) return 0;  // cap 8 MiB history
  ByteSink sink{out, 0, cap, true};
  sink.u8('C'); sink.u8('T'); sink.u8('A'); sink.u8('3');
  long long nblk_at = sink.pos;
  sink.u16(0);  // n_blocks patched below
  sink.u16((uint32_t)hist_blocks);
  if (!sink.ok) return E_SPACE;

  SideSt st;
  st.rep[0] = 1;
  st.rep[1] = 4;
  st.rep[2] = 8;
  st.ts[0].log = st.ts[1].log = st.ts[2].log = -1;
  st.huf.max_bits = -1;
  SideScr sc;
  sc.lls = (int32_t*)malloc(((1 << 16) + 8) * 4);
  sc.mls = (int32_t*)malloc(((1 << 16) + 8) * 4);
  sc.ofs = (int32_t*)malloc(((1 << 16) + 8) * 4);
  sc.psrc = (int32_t*)malloc(SIDE_PCAP * 4);
  sc.plen = (uint8_t*)malloc(SIDE_PCAP);
  sc.prnd = (uint8_t*)malloc(SIDE_PCAP);
  sc.esrc = (int32_t*)malloc((1 << 16) * 4);
  sc.ernd = (int16_t*)malloc((1 << 16) * 2);
  sc.stmp = (int32_t*)malloc((1 << 16) * 4);
  sc.rtmp = (int16_t*)malloc((1 << 16) * 2);
  bool alloc_ok = sc.lls && sc.mls && sc.ofs && sc.psrc && sc.plen &&
                  sc.prnd && sc.esrc && sc.ernd && sc.stmp && sc.rtmp;
  long long ret = 0;
  long long pos = 0, decoded = 0, n_blocks = 0;
  long long hist_cap = (long long)hist_blocks << 16;
  bool any_compressed = false;
  if (!alloc_ok) {
    ret = E_CORRUPT;
    goto done;
  }
  for (;;) {
    if (pos + 3 > n || n_blocks >= 0xFFFF) goto done;  // ret stays 0
    {
      uint32_t bh = (uint32_t)src[pos] | ((uint32_t)src[pos + 1] << 8) |
                    ((uint32_t)src[pos + 2] << 16);
      pos += 3;
      int last = bh & 1;
      int btype = (bh >> 1) & 3;
      long long bsize = bh >> 3;
      long long raw = btype == 1 ? 1 : bsize;
      if (btype == 3 || bsize > (1 << 17) || pos + raw > n) goto done;
      long long hist_avail = decoded < hist_cap ? decoded : hist_cap;
      long long t = side_block(src + pos, bsize, btype, &st, &sink,
                               max_rounds, opts, hist_avail, hist_cap, &sc);
      if (t == E_SPACE) {
        ret = E_SPACE;
        goto done;
      }
      if (t < 0) goto done;  // ineligible shape: whole frame falls back
      if (btype == 2) any_compressed = true;
      decoded += t;
      n_blocks++;
      pos += raw;
      if (last) break;
      // non-final blocks must decode to EXACTLY 64 KiB: the device-side
      // history update is a static 512-row shift
      if (t != (1 << 16)) goto done;
    }
  }
  if (!sink.ok) {
    ret = E_SPACE;
    goto done;
  }
  // a frame of only raw/RLE blocks gains nothing from device decode:
  // skip the sidecar (raw/RLE records exist for blocks INSIDE mixed
  // multi-block frames, where the history shift still needs them)
  if (!any_compressed) goto done;
  out[nblk_at] = (uint8_t)(n_blocks & 0xFF);
  out[nblk_at + 1] = (uint8_t)(n_blocks >> 8);
  ret = sink.pos;
done:
  free(sc.lls); free(sc.mls); free(sc.ofs); free(sc.psrc); free(sc.plen);
  free(sc.prnd); free(sc.esrc); free(sc.ernd); free(sc.stmp); free(sc.rtmp);
  return ret;
}

// whole-frame decode with the output buffer AS the history arena (the
// reference's history-as-output trick, zstd/framedec.go:334): no per-block
// Python dispatch, no arena->dst copies, no window maintenance. src points
// at the first block header and must have 16 readable slack bytes past n;
// dst must have cap writable bytes. Returns decoded size (consumed bytes
// via *consumed) or E_CORRUPT / E_SPACE.
// block_max: RFC 8878 Block_Maximum_Size = min(Window_Size, 128 KB);
// oversized blocks are corruption (libzstd agrees; found by the
// reference's decode fuzz corpus). <= 0 means "no window cap" (the
// caller keeps old behaviour).
long long ct_zstd_decode_frame(const uint8_t* src, long long n,
                               uint8_t* dst, long long cap,
                               long long* consumed, long long block_max) {
  if (block_max <= 0 || block_max > (1 << 17)) block_max = 1 << 17;
  // reused per-thread state: a fresh ~300 KB calloc per frame costs
  // ~10 us of mmap+zeroing — dominant on small frames. Thread-local
  // because ctypes releases the GIL (decode_concurrent runs this
  // concurrently); a direct TLS object (not a heap pointer) so thread
  // exit reclaims it — pools create fresh threads per call. Only the
  // cheap fields need resetting; the big lits/tmp scratch carries no
  // cross-frame semantics.
  static thread_local ZState ts;
  ZState* s = &ts;
  s->rep[0] = 1;
  s->rep[1] = 4;
  s->rep[2] = 8;
  s->huf.max_bits = -1;
  s->t_ll.log = -1;
  s->t_of.log = -1;
  s->t_ml.log = -1;
  long long pos = 0, apos = 0;
  long long ret = E_CORRUPT;
  for (;;) {
    if (pos + 3 > n) goto done;
    uint32_t bh = (uint32_t)src[pos] | ((uint32_t)src[pos + 1] << 8) |
                  ((uint32_t)src[pos + 2] << 16);
    pos += 3;
    int last = bh & 1;
    int btype = (bh >> 1) & 3;
    long long bsize = bh >> 3;
    if (btype == 0) {
      if (pos + bsize > n || bsize > block_max) goto done;
      if (apos + bsize > cap) { ret = E_SPACE; goto done; }
      memcpy(dst + apos, src + pos, bsize);
      apos += bsize;
      pos += bsize;
    } else if (btype == 1) {
      if (pos >= n || bsize > block_max) goto done;
      if (apos + bsize > cap) { ret = E_SPACE; goto done; }
      memset(dst + apos, src[pos], bsize);
      apos += bsize;
      pos += 1;
    } else if (btype == 2) {
      if (bsize > (1 << 17) || pos + bsize > n) goto done;
      if (apos + (1 << 17) + 64 > cap) { ret = E_SPACE; goto done; }
      long long r = decode_block_core(s, src + pos, bsize, dst + apos, apos);
      if (r < 0 || r > block_max) goto done;
      apos += r;
      pos += bsize;
    } else {
      goto done;
    }
    if (last) {
      *consumed = pos;
      ret = apos;
      goto done;
    }
  }
done:
  return ret;  // s is the reused thread-local state
}

// ---------------------------------------------------------------------------
// standalone-entropy exports: the fse/huff0 PACKAGES (compress_tpu/fse,
// compress_tpu/huff0) reuse the battle-tested table parsers and stream
// loops above for their own containers (reference: fse/decompress.go
// readNCount, huff0/decompress.go ReadTable + 1X/4X main loops).
// ---------------------------------------------------------------------------

long long ct_fse_read_ncount(const uint8_t* p, long long n, int max_log,
                             int16_t* norm256, int* max_sym, int* log) {
  return fse_read_ncount(p, n, norm256, max_sym, log, max_log);
}

// whole huff0 container body after the uvarint length: table + stream(s).
// fourx: 0 = 1X, 1 = 4X (6-byte jump table + 4 streams). p needs 16
// readable slack bytes past n. Returns 0 or -1.
long long ct_huf0_decompress_body(const uint8_t* p, long long n, int fourx,
                                  uint8_t* out, long long out_len) {
  static thread_local HufDT ht;
  int used = huf_read_table(&ht, p, n);
  if (used < 0 || used > n) return -1;
  const uint8_t* q = p + used;
  long long ln = n - used;
  if (!fourx)
    return huf_decode_stream(&ht, q, ln, out, out_len) ? 0 : -1;
  if (ln < 6) return -1;
  long long l1 = q[0] | (q[1] << 8);
  long long l2 = q[2] | (q[3] << 8);
  long long l3 = q[4] | (q[5] << 8);
  long long l4 = ln - 6 - l1 - l2 - l3;
  if (l4 <= 0) return -1;
  long long seg = (out_len + 3) / 4;
  long long last = out_len - 3 * seg;
  if (last < 0) return -1;
  q += 6;
  const uint8_t* sp[4] = {q, q + l1, q + l1 + l2, q + l1 + l2 + l3};
  const long long sn[4] = {l1, l2, l3, l4};
  uint8_t* so[4] = {out, out + seg, out + 2 * seg, out + 3 * seg};
  const long long sl[4] = {seg, seg, seg, last};
  return huf_decode_4streams(&ht, sp, sn, so, sl) ? 0 : -1;
}

// ---------------------------------------------------------------------------
// whole-STREAM decode: frame headers, skippable frames, frame bodies and
// xxhash checksums all in one native call (the reference's DecodeAll role,
// zstd/decoder.go:319, kept entirely out of Python). Happy-path only:
// dictionary frames, over-limit windows, corrupt or trailing-garbage
// inputs return E_UNSUPPORTED/E_CORRUPT and the caller re-runs the
// Python decoder for the precise error. src needs 16 readable slack
// bytes past n. Returns total decoded size or E_CORRUPT/E_SPACE/
// E_UNSUPPORTED.
// ---------------------------------------------------------------------------

uint64_t ct_xxh64(const uint8_t* p, uint64_t len, uint64_t seed);

long long ct_zstd_decode_all(const uint8_t* src, long long n,
                             uint8_t* dst, long long cap,
                             long long max_window, int ignore_checksum) {
  long long pos = 0, out = 0;
  while (pos < n) {
    if (pos + 4 > n) return E_CORRUPT;
    uint32_t magic;
    memcpy(&magic, src + pos, 4);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (pos + 8 > n) return E_CORRUPT;
      uint32_t sz;
      memcpy(&sz, src + pos + 4, 4);
      if (pos + 8 + (long long)sz > n) return E_CORRUPT;
      pos += 8 + sz;
      continue;
    }
    if (magic != 0xFD2FB528u) return E_CORRUPT;
    pos += 4;
    if (pos >= n) return E_CORRUPT;
    uint8_t fhd = src[pos++];
    int fcs_flag = fhd >> 6;
    int single_seg = (fhd >> 5) & 1;
    int has_checksum = (fhd >> 2) & 1;
    int dict_flag = fhd & 3;
    if (fhd & 0x18) return E_CORRUPT;  // reserved/unused bits must be 0
    long long window = 0;
    if (!single_seg) {
      if (pos >= n) return E_CORRUPT;
      uint8_t wd = src[pos++];
      int wexp = wd >> 3;
      long long base = 1ll << (10 + wexp);
      window = base + (long long)(wd & 7) * (base >> 3);
    }
    if (dict_flag) return E_UNSUPPORTED;  // Python path handles dicts
    long long fcs = -1;
    if (fcs_flag == 0) {
      if (single_seg) {
        if (pos >= n) return E_CORRUPT;
        fcs = src[pos++];
      }
    } else if (fcs_flag == 1) {
      if (pos + 2 > n) return E_CORRUPT;
      fcs = (long long)(src[pos] | (src[pos + 1] << 8)) + 256;
      pos += 2;
    } else if (fcs_flag == 2) {
      if (pos + 4 > n) return E_CORRUPT;
      uint32_t v;
      memcpy(&v, src + pos, 4);
      fcs = v;
      pos += 4;
    } else {
      if (pos + 8 > n) return E_CORRUPT;
      uint64_t v;
      memcpy(&v, src + pos, 8);
      if (v > (1ull << 62)) return E_CORRUPT;
      fcs = (long long)v;
      pos += 8;
    }
    if (single_seg) window = fcs < 0 ? 0 : fcs;
    if (window > max_window) return E_UNSUPPORTED;
    long long block_max = window > 0 && window < (1 << 17) ? window : 1 << 17;
    if (block_max < 1024) block_max = 1024;  // RFC 8878: floor 1 KB
    long long consumed = 0;
    long long r = ct_zstd_decode_frame(src + pos, n - pos, dst + out,
                                       cap - out, &consumed, block_max);
    if (r < 0) return r;
    if (fcs >= 0 && r != fcs) return E_CORRUPT;
    pos += consumed;
    out += r;
    if (has_checksum) {
      if (pos + 4 > n) return E_CORRUPT;
      if (!ignore_checksum) {
        uint32_t want;
        memcpy(&want, src + pos, 4);
        if ((uint32_t)ct_xxh64(dst + out - r, (uint64_t)r, 0) != want)
          return E_CORRUPT;
      }
      pos += 4;
    }
  }
  return out;
}

// headers-only pre-scan: total declared output size of a whole stream
// (sum of frame content sizes), walking skippables and block headers
// without decoding. Returns -1 when any frame omits FCS or the framing
// is malformed — the caller then uses the guess-and-grow path. Lets the
// Python wrapper allocate the EXACT output object up front (decoding
// straight into a bytes object saves an output-sized memcpy).
long long ct_zstd_scan_size(const uint8_t* src, long long n) {
  long long pos = 0, total = 0;
  while (pos < n) {
    if (pos + 4 > n) return -1;
    uint32_t magic;
    memcpy(&magic, src + pos, 4);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (pos + 8 > n) return -1;
      uint32_t sz;
      memcpy(&sz, src + pos + 4, 4);
      if (pos + 8 + (long long)sz > n) return -1;
      pos += 8 + sz;
      continue;
    }
    if (magic != 0xFD2FB528u) return -1;
    pos += 4;
    if (pos >= n) return -1;
    uint8_t fhd = src[pos++];
    int fcs_flag = fhd >> 6;
    int single_seg = (fhd >> 5) & 1;
    int has_checksum = (fhd >> 2) & 1;
    int dict_flag = fhd & 3;
    if (fhd & 0x18) return -1;
    if (!single_seg) pos++;  // window descriptor
    if (dict_flag) return -1;
    long long fcs = -1;
    if (fcs_flag == 0) {
      if (!single_seg) return -1;  // no FCS declared
      if (pos >= n) return -1;
      fcs = src[pos++];
    } else if (fcs_flag == 1) {
      if (pos + 2 > n) return -1;
      fcs = (long long)(src[pos] | (src[pos + 1] << 8)) + 256;
      pos += 2;
    } else if (fcs_flag == 2) {
      if (pos + 4 > n) return -1;
      uint32_t v;
      memcpy(&v, src + pos, 4);
      fcs = v;
      pos += 4;
    } else {
      if (pos + 8 > n) return -1;
      uint64_t v;
      memcpy(&v, src + pos, 8);
      if (v > (1ull << 62)) return -1;
      fcs = (long long)v;
      pos += 8;
    }
    total += fcs;
    for (;;) {
      if (pos + 3 > n) return -1;
      uint32_t bh = (uint32_t)src[pos] | ((uint32_t)src[pos + 1] << 8) |
                    ((uint32_t)src[pos + 2] << 16);
      pos += 3;
      int btype = (bh >> 1) & 3;
      long long bsize = bh >> 3;
      if (btype == 3) return -1;
      pos += btype == 1 ? 1 : bsize;
      if (pos > n) return -1;
      if (bh & 1) break;
    }
    if (has_checksum) {
      pos += 4;
      if (pos > n) return -1;
    }
  }
  return total;
}

}  // extern "C"
