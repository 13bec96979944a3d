// Standalone fse/huff0 stream loops — native twins of the per-symbol
// Python loops in compress_tpu/fse/core.py (encode_interleaved2 /
// decode_interleaved2) and compress_tpu/huff0/__init__.py
// (_encode_stream / _decode_stream).
//
// The reference ships these as dedicated packages with ~200 MB/s encode
// and ~300 MB/s decode per core (fse/README.md:59-66, huff0 asm loops
// huff0/decompress_amd64.s); our containers/tables/normalization stay in
// Python/numpy (they are vectorized and byte-exact) and only the
// per-symbol bitstream loops cross into C. Outputs are byte-identical
// to the Python loops (differential-tested); COMPRESS_TPU_NONATIVE=1
// keeps the pure-Python path.
//
// Bitstream contract: LSB-first writer closed with a 1-bit end marker;
// reader consumes from the top. Stream buffers passed to the decoders
// need 16 readable slack bytes past their length (callers pad).

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// LSB-first bit writer (fse/core.py BitWriter)
// ---------------------------------------------------------------------------

struct BW {
  uint8_t* out;
  long long pos, cap;
  uint64_t acc;
  int n;
  bool ok;
};

static inline void bw_add(BW* b, uint32_t v, int nb) {
  // nb <= 13 everywhere; acc holds < 32+13 bits before the 4-byte flush
  b->acc |= ((uint64_t)v & ((1ull << nb) - 1)) << b->n;
  b->n += nb;
  if (b->n >= 32) {
    if (b->pos + 4 > b->cap) {
      b->ok = false;
      b->n = 0;
      return;
    }
    uint32_t w = (uint32_t)b->acc;
    memcpy(b->out + b->pos, &w, 4);
    b->pos += 4;
    b->acc >>= 32;
    b->n -= 32;
  }
}

static inline long long bw_close(BW* b) {
  bw_add(b, 1, 1);  // end-of-stream marker
  if (!b->ok) return -1;
  while (b->n > 0) {
    if (b->pos >= b->cap) return -1;
    b->out[b->pos++] = (uint8_t)b->acc;
    b->acc >>= 8;
    b->n -= 8;
  }
  return b->pos;
}

// ---------------------------------------------------------------------------
// FSE tables (standalone tableLog <= 12 — wider than the zstd-internal
// 9-bit tables in zstd_dec.cpp)
// ---------------------------------------------------------------------------

static const int FSE_MAX_LOG = 12;
static const int FSE_MAX_SIZE = 1 << FSE_MAX_LOG;

// symbol spread shared by ctable/dtable (fse/core.py spread_symbols /
// RFC 8878 table fill): -1 ("less than one") symbols fill the high tail,
// the rest walk the co-prime step skipping claimed tail slots.
static bool fse_spread(const int16_t* norm, int max_sym, int log,
                       uint8_t* spread) {
  int size = 1 << log;
  // pre-validate the distribution: an over-full table would spin the
  // co-prime walk forever once the -1 tail exhausts the high slots
  // (these entries arrive from Python callers, not just parsed headers)
  long long total = 0;
  for (int s = 0; s <= max_sym; s++)
    total += norm[s] == -1 ? 1 : (norm[s] > 0 ? norm[s] : 0);
  if (total != size) return false;
  int high = size - 1;
  for (int s = 0; s <= max_sym; s++) {
    if (norm[s] == -1) {
      if (high < 0) return false;
      spread[high] = (uint8_t)s;
      high--;
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= max_sym; s++) {
    for (int i = 0; i < norm[s]; i++) {
      spread[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  return pos == 0;
}

// fse/core.py encode_interleaved2 with the ctable built in place
// (build_ctable port). Returns stream length or -1.
long long ct_fse_encode_i2(const uint8_t* sym, long long n,
                           const int16_t* norm, int max_sym, int tl,
                           uint8_t* dst, long long cap) {
  if (n < 2 || tl < 5 || tl > FSE_MAX_LOG || max_sym > 255) return -1;
  int size = 1 << tl;
  uint8_t spread[FSE_MAX_SIZE];
  if (!fse_spread(norm, max_sym, tl, spread)) return -1;
  // cumulative first-slot per symbol
  int32_t cumul[257];
  cumul[0] = 0;
  for (int s = 0; s <= max_sym; s++) {
    int c = norm[s];
    cumul[s + 1] = cumul[s] + (c == -1 ? 1 : (c > 0 ? c : 0));
  }
  static thread_local int32_t state_table[FSE_MAX_SIZE];
  int32_t cpos[256];
  memcpy(cpos, cumul, sizeof(int32_t) * (max_sym + 1));
  for (int u = 0; u < size; u++) {
    int s = spread[u];
    state_table[cpos[s]++] = size + u;
  }
  int64_t delta_nb[256];
  int64_t delta_fs[256];
  int total = 0;
  for (int s = 0; s <= max_sym; s++) {
    int c = norm[s];
    if (c == 0) {
      delta_nb[s] = ((int64_t)(tl + 1) << 16) - size;  // poison
      delta_fs[s] = 0;
      continue;
    }
    if (c == -1 || c == 1) {
      delta_nb[s] = ((int64_t)tl << 16) - size;
      delta_fs[s] = total - 1;
      total += 1;
    } else {
      int hb = 31 - __builtin_clz((uint32_t)(c - 1));
      int max_bits_out = tl - hb;
      int64_t min_state_plus = (int64_t)c << max_bits_out;
      delta_nb[s] = ((int64_t)max_bits_out << 16) - min_state_plus;
      delta_fs[s] = total - c;
      total += c;
    }
  }
  BW bw{dst, 0, cap, 0, 0, true};
  auto first_state = [&](int s) -> int32_t {
    int nb = (int)((delta_nb[s] + (1 << 15)) >> 16);
    int64_t im = ((int64_t)nb << 16) - delta_nb[s];
    int64_t lu = (im >> nb) + delta_fs[s];
    return state_table[lu];
  };
  auto enc = [&](int32_t state, int s) -> int32_t {
    int nb = (int)((state + delta_nb[s]) >> 16);
    bw_add(&bw, (uint32_t)state, nb);
    return state_table[(state >> nb) + delta_fs[s]];
  };
  long long ip = n;
  int32_t s1, s2;
  if (ip & 1) {
    s1 = first_state(sym[ip - 1]);
    s2 = first_state(sym[ip - 2]);
    s1 = enc(s1, sym[ip - 3]);
    ip -= 3;
  } else {
    s2 = first_state(sym[ip - 1]);
    s1 = first_state(sym[ip - 2]);
    ip -= 2;
  }
  if (ip & 2) {
    s2 = enc(s2, sym[ip - 1]);
    s1 = enc(s1, sym[ip - 2]);
    ip -= 2;
  }
  while (ip >= 4) {
    s2 = enc(s2, sym[ip - 1]);
    s1 = enc(s1, sym[ip - 2]);
    s2 = enc(s2, sym[ip - 3]);
    s1 = enc(s1, sym[ip - 4]);
    ip -= 4;
  }
  bw_add(&bw, (uint32_t)(s2 - size), tl);
  bw_add(&bw, (uint32_t)(s1 - size), tl);
  return bw_close(&bw);
}

// fse/core.py decode_interleaved2 (dtable built in place; build_dtable
// port: new_state = (next_rank << nb) - size, nb = tl - highbit(rank)).
// stream needs 16 readable slack bytes past slen. Returns 0 or -1.
long long ct_fse_decode_i2(const uint8_t* stream, long long slen,
                           const int16_t* norm, int max_sym, int tl,
                           uint8_t* out, long long out_len) {
  if (tl < 5 || tl > FSE_MAX_LOG || max_sym > 255 || slen <= 0) return -1;
  if (stream[slen - 1] == 0) return -1;  // missing end marker
  int size = 1 << tl;
  static thread_local uint8_t spread[FSE_MAX_SIZE];
  if (!fse_spread(norm, max_sym, tl, spread)) return -1;
  static thread_local uint8_t nbt[FSE_MAX_SIZE];
  static thread_local uint16_t nst[FSE_MAX_SIZE];
  uint16_t next[256];
  for (int s = 0; s <= max_sym; s++)
    next[s] = (uint16_t)(norm[s] == -1 ? 1 : (norm[s] < 0 ? 0 : norm[s]));
  for (int u = 0; u < size; u++) {
    uint8_t s = spread[u];
    uint16_t nx = next[s]++;
    int nb = tl - (nx ? (31 - __builtin_clz((uint32_t)nx)) : 0);
    if (nb > tl) nb = tl;
    nbt[u] = (uint8_t)nb;
    nst[u] = (uint16_t)((nx << nb) - size);
  }
  long long bitpos = (slen - 1) * 8 +
                     (31 - __builtin_clz((uint32_t)stream[slen - 1]));
  // a valid stream never reads below bit 0 — underflow means corruption
  // (bail immediately: shifting by >= 64 would be UB and the Python
  // fallback re-derives the precise error)
  bool corrupt = false;
  auto rd = [&](int nb) -> uint32_t {
    if (nb == 0) return 0;
    bitpos -= nb;
    if (bitpos < 0) {
      corrupt = true;
      return 0;
    }
    uint64_t v;
    memcpy(&v, stream + (bitpos >> 3), 8);
    return (uint32_t)((v >> (bitpos & 7)) & ((1u << nb) - 1));
  };
  uint32_t s1 = rd(tl), s2 = rd(tl);
  long long i = 0;
  // fast path: one 57-bit peek serves ~4 state reloads (nb <= 12);
  // commit the reader once per window
  while (i + 4 < out_len - 2 && bitpos >= 57 && !corrupt) {
    long long pk = bitpos - 57;
    uint64_t v;
    memcpy(&v, stream + (pk >> 3), 8);
    uint64_t w = v >> (pk & 7);
    int rem = 57;
    for (int k = 0; k < 4; k++) {
      uint32_t* st = (i & 1) ? &s2 : &s1;
      out[i] = spread[*st];
      int nb = nbt[*st];
      if (nb > rem) break;
      rem -= nb;
      *st = nst[*st] + (uint32_t)((w >> rem) & ((1u << nb) - 1));
      i++;
      if (*st >= (uint32_t)size) return -1;
    }
    bitpos -= 57 - rem;
  }
  for (; i < out_len && !corrupt; i++) {
    if (i & 1) {
      out[i] = spread[s2];
      if (i < out_len - 2) s2 = nst[s2] + rd(nbt[s2]);
    } else {
      out[i] = spread[s1];
      if (i < out_len - 2) s1 = nst[s1] + rd(nbt[s1]);
    }
    if (s1 >= (uint32_t)size || s2 >= (uint32_t)size) return -1;
  }
  return (!corrupt && bitpos == 0) ? 0 : -1;
}

// ---------------------------------------------------------------------------
// huff0 standalone stream loops
// ---------------------------------------------------------------------------

// huff0/_encode_stream: symbols encoded in reverse. Returns length or -1.
long long ct_huf0_encode_stream(const uint8_t* data, long long n,
                                const uint16_t* codes, const uint8_t* nbits,
                                uint8_t* dst, long long cap) {
  BW bw{dst, 0, cap, 0, 0, true};
  for (long long i = n - 1; i >= 0; i--) {
    uint8_t b = data[i];
    bw_add(&bw, codes[b], nbits[b]);
  }
  return bw_close(&bw);
}

// huff0/_decode_stream: peek max_bits, consume nb_t[window]. stream needs
// 16 readable slack bytes past slen. Returns 0, or -1 on over/under-read.
long long ct_huf0_decode_stream(const uint8_t* stream, long long slen,
                                const uint8_t* sym_t, const uint8_t* nb_t,
                                int max_bits, uint8_t* out,
                                long long out_len) {
  if (slen <= 0 || stream[slen - 1] == 0 || max_bits < 1 || max_bits > 11)
    return -1;
  long long bitpos = (slen - 1) * 8 +
                     (31 - __builtin_clz((uint32_t)stream[slen - 1]));
  const uint32_t mask = (1u << max_bits) - 1;
  for (long long i = 0; i < out_len; i++) {
    long long bp = bitpos - max_bits;
    uint64_t v;
    uint32_t window;
    if (bp >= 0) {
      memcpy(&v, stream + (bp >> 3), 8);
      window = (uint32_t)((v >> (bp & 7)) & mask);
    } else {
      memcpy(&v, stream, 8);
      window = (uint32_t)((v << -bp) & mask);
    }
    out[i] = sym_t[window];
    bitpos -= nb_t[window];
    if (bitpos < 0) return -1;
  }
  return bitpos == 0 ? 0 : -1;
}

// ---------------------------------------------------------------------------
// whole-container helpers
// ---------------------------------------------------------------------------

long long ct_fse_read_ncount(const uint8_t* p, long long n, int max_log,
                             int16_t* norm256, int* max_sym, int* log);

// fse container body after the uvarint length: NCount header + interleaved
// 2-state stream. p needs 16 readable slack bytes past n. Returns 0 / -1.
long long ct_fse_decompress_body(const uint8_t* p, long long n,
                                 uint8_t* out, long long out_len) {
  int16_t norm[256];
  int max_sym, tl;
  long long used = ct_fse_read_ncount(p, n, FSE_MAX_LOG, norm, &max_sym, &tl);
  if (used < 0 || used > n) return -1;
  return ct_fse_decode_i2(p + used, n - used, norm, max_sym, tl, out,
                          out_len);
}

// fse/core.py write_ncount port (byte-identical serialization).
long long ct_fse_write_ncount(const int16_t* norm, int max_sym, int tl,
                              uint8_t* dst, long long cap) {
  if (tl < 5 || tl > FSE_MAX_LOG) return -1;
  long long pos = 0;
  uint64_t bit_stream = 0;
  int bit_count = 0;
  bool ok = true;
  auto put = [&](uint32_t v, int nb) {
    bit_stream |= ((uint64_t)v & ((1u << nb) - 1)) << bit_count;
    bit_count += nb;
    while (bit_count >= 16) {
      if (pos + 2 > cap) { ok = false; return; }
      dst[pos++] = (uint8_t)bit_stream;
      dst[pos++] = (uint8_t)(bit_stream >> 8);
      bit_stream >>= 16;
      bit_count -= 16;
    }
  };
  int table_size = 1 << tl;
  put((uint32_t)(tl - 5), 4);
  int remaining = table_size + 1;
  int threshold = table_size;
  int nb_bits = tl + 1;
  int s = 0;
  bool previous0 = false;
  while (remaining > 1 && s <= max_sym && ok) {
    if (previous0) {
      int start = s;
      while (s <= max_sym && norm[s] == 0) s++;
      int run = s - start;
      while (run >= 24) {
        put(0xFFFF, 16);
        run -= 24;
      }
      while (run >= 3) {
        put(3, 2);
        run -= 3;
      }
      put((uint32_t)run, 2);
      if (s > max_sym) break;
    }
    int count = norm[s];
    s++;
    int mx = (2 * threshold - 1) - remaining;
    remaining -= count < 0 ? -count : count;
    count += 1;
    if (count >= threshold) count += mx;
    put((uint32_t)count, nb_bits - (count < mx ? 1 : 0));
    previous0 = count == 1;
    while (remaining < threshold) {
      nb_bits--;
      threshold >>= 1;
    }
  }
  if (!ok) return -1;
  while (bit_count > 0) {
    if (pos >= cap) return -1;
    dst[pos++] = (uint8_t)bit_stream;
    bit_stream >>= 8;
    bit_count -= 8;
  }
  return pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// huff0 package-merge (optimal length-limited code lengths) — exact port
// of huff0/__init__.py package_merge_lengths including its tie order
// (python tuple compare: weight, then the symbol tuple lexicographically;
// all items are distinct so the order is total).
// ---------------------------------------------------------------------------

#include <vector>
#include <algorithm>

extern "C" long long ct_huf0_package_merge(const int64_t* freqs, int limit,
                                           int32_t* lengths256) {
  struct Item {
    int64_t w;
    std::vector<int16_t> syms;
  };
  std::vector<int> sym;
  for (int s = 0; s < 256; s++)
    if (freqs[s] > 0) sym.push_back(s);
  size_t n = sym.size();
  for (int s = 0; s < 256; s++) lengths256[s] = 0;
  if (n == 0) return -1;
  if (n == 1) {
    lengths256[sym[0]] = 1;
    return 0;
  }
  if (limit < 1 || limit > 20 || (1ll << limit) < (long long)n) return -1;
  auto less = [](const Item& a, const Item& b) {
    if (a.w != b.w) return a.w < b.w;
    return std::lexicographical_compare(a.syms.begin(), a.syms.end(),
                                        b.syms.begin(), b.syms.end());
  };
  std::vector<Item> items(n);
  for (size_t i = 0; i < n; i++) {
    items[i].w = freqs[sym[i]];
    items[i].syms = {(int16_t)sym[i]};
  }
  std::sort(items.begin(), items.end(), less);
  std::vector<Item> packages = items;
  std::vector<Item> merged = items;
  for (int lvl = 0; lvl < limit - 1; lvl++) {
    std::vector<Item> paired;
    for (size_t i = 0; i + 1 < packages.size(); i += 2) {
      Item it;
      it.w = packages[i].w + packages[i + 1].w;
      it.syms = packages[i].syms;
      it.syms.insert(it.syms.end(), packages[i + 1].syms.begin(),
                     packages[i + 1].syms.end());
      paired.push_back(std::move(it));
    }
    merged = items;
    merged.insert(merged.end(), paired.begin(), paired.end());
    std::sort(merged.begin(), merged.end(), less);
    packages = merged;
  }
  size_t take = 2 * n - 2;
  for (size_t i = 0; i < take && i < merged.size(); i++)
    for (int16_t s : merged[i].syms) lengths256[s] += 1;
  return 0;
}
