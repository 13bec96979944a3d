// Host-side checksum kernels: CRC-32C (Castagnoli) and xxHash64.
//
// Reference parity: s2/s2.go crc(), zstd/internal/xxhash (asm-backed in the
// reference; here hardware CRC32 instruction where available, else
// slicing-by-16).

#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CRC-32C
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[16][256];
static bool crc32c_init_done = false;

static void crc32c_init() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    crc32c_table[0][i] = c;
  }
  for (int k = 1; k < 16; k++)
    for (uint32_t i = 0; i < 256; i++)
      crc32c_table[k][i] =
          crc32c_table[0][crc32c_table[k - 1][i] & 0xFF] ^ (crc32c_table[k - 1][i] >> 8);
  crc32c_init_done = true;
}

uint32_t ct_crc32c(const uint8_t* buf, uint64_t len, uint32_t crc) {
  crc = ~crc;
#if defined(__SSE4_2__)
  uint64_t c = crc;
  while (len >= 8) {
    uint64_t v;
    memcpy(&v, buf, 8);
    c = _mm_crc32_u64(c, v);
    buf += 8;
    len -= 8;
  }
  crc = (uint32_t)c;
  while (len--) crc = _mm_crc32_u8(crc, *buf++);
  return ~crc;
#else
  if (!crc32c_init_done) crc32c_init();
  while (len >= 16) {
    uint32_t b0;
    memcpy(&b0, buf, 4);
    b0 ^= crc;
    crc = crc32c_table[15][b0 & 0xFF] ^ crc32c_table[14][(b0 >> 8) & 0xFF] ^
          crc32c_table[13][(b0 >> 16) & 0xFF] ^ crc32c_table[12][b0 >> 24] ^
          crc32c_table[11][buf[4]] ^ crc32c_table[10][buf[5]] ^
          crc32c_table[9][buf[6]] ^ crc32c_table[8][buf[7]] ^
          crc32c_table[7][buf[8]] ^ crc32c_table[6][buf[9]] ^
          crc32c_table[5][buf[10]] ^ crc32c_table[4][buf[11]] ^
          crc32c_table[3][buf[12]] ^ crc32c_table[2][buf[13]] ^
          crc32c_table[1][buf[14]] ^ crc32c_table[0][buf[15]];
    buf += 16;
    len -= 16;
  }
  if (!crc32c_init_done) crc32c_init();
  while (len--) crc = crc32c_table[0][(crc ^ *buf++) & 0xFF] ^ (crc >> 8);
  return ~crc;
#endif
}

// ---------------------------------------------------------------------------
// xxHash64
// ---------------------------------------------------------------------------

static const uint64_t XP1 = 0x9E3779B185EBCA87ULL;
static const uint64_t XP2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t XP3 = 0x165667B19E3779F9ULL;
static const uint64_t XP4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t XP5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t xxh_round(uint64_t acc, uint64_t inp) {
  acc += inp * XP2;
  return rotl64(acc, 31) * XP1;
}
static inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * XP1 + XP4;
}
static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

uint64_t ct_xxh64(const uint8_t* p, uint64_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    const uint8_t* limit = end - 32;
    uint64_t v1 = seed + XP1 + XP2, v2 = seed + XP2, v3 = seed, v4 = seed - XP1;
    do {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + XP5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, load64(p));
    h = rotl64(h, 27) * XP1 + XP4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)load32(p) * XP1;
    h = rotl64(h, 23) * XP2 + XP3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p++) * XP5;
    h = rotl64(h, 11) * XP1;
  }
  h ^= h >> 33;
  h *= XP2;
  h ^= h >> 29;
  h *= XP3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Streaming xxHash64 (reference: zstd/internal/xxhash Digest.Write/Sum64) —
// lets the streaming zstd Writer checksum unbounded input in O(1) memory.
// ---------------------------------------------------------------------------

struct XxhState {
  uint64_t v1, v2, v3, v4;
  uint64_t total;
  uint8_t buf[32];
  uint32_t bufn;
  uint64_t seed;
};

void* ct_xxh64_new(uint64_t seed) {
  XxhState* s = new XxhState();
  s->v1 = seed + XP1 + XP2;
  s->v2 = seed + XP2;
  s->v3 = seed;
  s->v4 = seed - XP1;
  s->total = 0;
  s->bufn = 0;
  s->seed = seed;
  return s;
}

void ct_xxh64_update(void* st, const uint8_t* p, uint64_t len) {
  XxhState* s = (XxhState*)st;
  s->total += len;
  if (s->bufn) {
    uint64_t take = 32 - s->bufn;
    if (take > len) take = len;
    memcpy(s->buf + s->bufn, p, take);
    s->bufn += (uint32_t)take;
    p += take;
    len -= take;
    if (s->bufn == 32) {
      s->v1 = xxh_round(s->v1, load64(s->buf));
      s->v2 = xxh_round(s->v2, load64(s->buf + 8));
      s->v3 = xxh_round(s->v3, load64(s->buf + 16));
      s->v4 = xxh_round(s->v4, load64(s->buf + 24));
      s->bufn = 0;
    }
  }
  while (len >= 32) {
    s->v1 = xxh_round(s->v1, load64(p));
    s->v2 = xxh_round(s->v2, load64(p + 8));
    s->v3 = xxh_round(s->v3, load64(p + 16));
    s->v4 = xxh_round(s->v4, load64(p + 24));
    p += 32;
    len -= 32;
  }
  if (len) {
    memcpy(s->buf, p, len);
    s->bufn = (uint32_t)len;
  }
}

uint64_t ct_xxh64_digest(void* st) {
  XxhState* s = (XxhState*)st;
  uint64_t h;
  if (s->total >= 32) {
    h = rotl64(s->v1, 1) + rotl64(s->v2, 7) + rotl64(s->v3, 12) +
        rotl64(s->v4, 18);
    h = xxh_merge(h, s->v1);
    h = xxh_merge(h, s->v2);
    h = xxh_merge(h, s->v3);
    h = xxh_merge(h, s->v4);
  } else {
    h = s->seed + XP5;
  }
  h += s->total;
  const uint8_t* p = s->buf;
  const uint8_t* end = s->buf + s->bufn;
  while (p + 8 <= end) {
    h ^= xxh_round(0, load64(p));
    h = rotl64(h, 27) * XP1 + XP4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)load32(p) * XP1;
    h = rotl64(h, 23) * XP2 + XP3;
    p += 4;
  }
  while (p < end) {
    h ^= (uint64_t)(*p++) * XP5;
    h = rotl64(h, 11) * XP1;
  }
  h ^= h >> 33;
  h *= XP2;
  h ^= h >> 29;
  h *= XP3;
  h ^= h >> 32;
  return h;
}

void ct_xxh64_free(void* st) { delete (XxhState*)st; }

}  // extern "C"
