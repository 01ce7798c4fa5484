// Keccak-256 (original pad 0x01) — native host implementation.
//
// The Fiat-Shamir transcript (models/transcript.py) and artifact digests call
// keccak256 hundreds of times per proof; this C++ core replaces the pure-
// Python fallback in host/keccak.py.  Exposed via ctypes (no pybind11 in the
// image).  Build: host/keccak.py compiles this on demand with
// g++ -O2 -shared -fPIC into the package's build/ directory.

#include <cstdint>
#include <cstring>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int ROT[5][5] = {{0, 36, 3, 41, 18},
                              {1, 44, 10, 45, 2},
                              {62, 6, 43, 15, 61},
                              {28, 55, 25, 21, 56},
                              {27, 20, 39, 8, 14}};

static inline uint64_t rotl(uint64_t x, int n) {
  n &= 63;
  return n ? (x << n) | (x >> (64 - n)) : x;
}

static void keccak_f(uint64_t st[5][5]) {
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], d[5];
    for (int x = 0; x < 5; ++x)
      c[x] = st[x][0] ^ st[x][1] ^ st[x][2] ^ st[x][3] ^ st[x][4];
    for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) st[x][y] ^= d[x];
    uint64_t b[5][5];
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y][(2 * x + 3 * y) % 5] = rotl(st[x][y], ROT[x][y]);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        st[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y]);
    st[0][0] ^= RC[round];
  }
}

extern "C" void keccak256(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  const uint64_t rate = 136;
  uint64_t st[5][5];
  std::memset(st, 0, sizeof(st));
  uint8_t block[136];

  uint64_t off = 0;
  while (len - off >= rate) {
    for (int i = 0; i < (int)(rate / 8); ++i) {
      uint64_t lane;
      std::memcpy(&lane, data + off + i * 8, 8);
      st[i % 5][i / 5] ^= lane;
    }
    keccak_f(st);
    off += rate;
  }
  uint64_t rem = len - off;
  std::memset(block, 0, rate);
  std::memcpy(block, data + off, rem);
  block[rem] = 0x01;
  block[rate - 1] |= 0x80;
  for (int i = 0; i < (int)(rate / 8); ++i) {
    uint64_t lane;
    std::memcpy(&lane, block + i * 8, 8);
    st[i % 5][i / 5] ^= lane;
  }
  keccak_f(st);
  for (int i = 0; i < 4; ++i)
    std::memcpy(out + i * 8, &st[i % 5][i / 5], 8);
}
