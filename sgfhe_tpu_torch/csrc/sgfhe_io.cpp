// Host IO codec of the wire formats (sgfhe_tpu_torch/serialize.py): bit
// packing of the space-optimal ciphertexts (reference src/fhe.jl:293-301 and
// :375-383 encodings), dense packing of w-bit residues, and the frames'
// CRC32. The same functions and results as native/sgfhe_io.cpp of the JAX
// package; the width packers stream through a 64-bit register and the CRC
// reads eight bytes a step (slicing-by-8), since a Params(1024) key frame
// carries 151 M residues.
//
// Build (sgfhe_tpu_torch/native.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -o libsgfhe_io.so sgfhe_io.cpp

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

inline uint64_t width_mask(unsigned width) {
  return width >= 32 ? 0xFFFFFFFFull : ((1ull << width) - 1);
}

}  // namespace

extern "C" {

// Pack n_bits bits (one byte a bit, values 0/1) little-endian into
// ceil(n_bits/8) bytes, as numpy packbits(bitorder="little").
void sgfhe_packbits(const uint8_t* bits, size_t n_bits, uint8_t* out) {
  size_t full = n_bits / 8;
  for (size_t i = 0; i < full; ++i) {
    const uint8_t* b = bits + 8 * i;
    out[i] = (uint8_t)((b[0] & 1) | ((b[1] & 1) << 1) | ((b[2] & 1) << 2) |
                       ((b[3] & 1) << 3) | ((b[4] & 1) << 4) | ((b[5] & 1) << 5) |
                       ((b[6] & 1) << 6) | ((b[7] & 1) << 7));
  }
  if (n_bits % 8) {
    out[full] = 0;
    for (size_t j = 8 * full; j < n_bits; ++j)
      out[full] |= (uint8_t)((bits[j] & 1) << (j - 8 * full));
  }
}

// Inverse of sgfhe_packbits.
void sgfhe_unpackbits(const uint8_t* bytes, size_t n_bits, uint8_t* out) {
  for (size_t j = 0; j < n_bits; ++j) out[j] = (bytes[j / 8] >> (j % 8)) & 1;
}

// Dense little-endian packing of `count` values of `width` bits (1..32):
// value i occupies bits [i*width, (i+1)*width) of ceil(count*width/8) bytes.
void sgfhe_pack_uint(const uint32_t* vals, size_t count, unsigned width, uint8_t* out) {
  const uint64_t mask = width_mask(width);
  uint64_t acc = 0;  // fewer than 8 pending bits before each value
  unsigned pending = 0;
  for (size_t i = 0; i < count; ++i) {
    acc |= (vals[i] & mask) << pending;
    pending += width;
    while (pending >= 8) {
      *out++ = (uint8_t)acc;
      acc >>= 8;
      pending -= 8;
    }
  }
  if (pending) *out = (uint8_t)acc;
}

// Inverse of sgfhe_pack_uint; reads exactly ceil(count*width/8) bytes.
void sgfhe_unpack_uint(const uint8_t* bytes, size_t count, unsigned width, uint32_t* out) {
  const uint64_t mask = width_mask(width);
  uint64_t acc = 0;
  unsigned have = 0;
  for (size_t i = 0; i < count; ++i) {
    while (have < width) {
      acc |= (uint64_t)(*bytes++) << have;
      have += 8;
    }
    out[i] = (uint32_t)(acc & mask);
    acc >>= width;
    have -= width;
  }
}

// CRC32 (IEEE 802.3, reflected 0xEDB88320) continuing from `seed` (the CRC
// of the bytes before), so a frame's CRC chains over its parts; equal to
// zlib.crc32(data, seed).
uint32_t sgfhe_crc32(const uint8_t* data, size_t len, uint32_t seed) {
  static const CrcTables tables;
  const auto& t = tables.t;
  uint32_t crc = ~seed;
  for (; len >= 8; len -= 8, data += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);  // little-endian host
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
          t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
          t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; len; --len, ++data) crc = (crc >> 8) ^ t[0][(crc ^ *data) & 0xFF];
  return ~crc;
}

}  // extern "C"
