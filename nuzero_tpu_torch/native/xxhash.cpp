// xxHash64 (public-domain algorithm by Yann Collet), implemented from the
// published specification, for the keyless inference cache.
//
// The port's own copy of nuzero_tpu/native/xxhash.cpp.  The reference hashes
// state tensors with the metrohash C extension to index its KeylessCache
// (ref Utils/Caches/KeylessCache.py:41-50); this is the host-side
// equivalent, loaded with ctypes.
//
// Built at first use by nuzero_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 xxhash.cpp -o _build/libnuzero_native-<digest>.so

#include <cstdint>
#include <cstring>

static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2;
  acc = rotl(acc, 31);
  acc *= P1;
  return acc;
}

static inline uint64_t merge_round(uint64_t acc, uint64_t val) {
  val = round1(0, val);
  acc ^= val;
  acc = acc * P1 + P4;
  return acc;
}

extern "C" uint64_t xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;

  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2;
    uint64_t v2 = seed + P2;
    uint64_t v3 = seed + 0;
    uint64_t v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, read64(p)); p += 8;
      v2 = round1(v2, read64(p)); p += 8;
      v3 = round1(v3, read64(p)); p += 8;
      v4 = round1(v4, read64(p)); p += 8;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }

  h += len;

  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)read32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    p++;
  }

  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

