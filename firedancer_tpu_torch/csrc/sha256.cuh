// SHA-256 for one lane per thread: the compression, the compression of
// a constant block, and the fixed-length form the merkle trees hash (a
// one-byte prefix before 64 bytes).  poh_spans.cu builds the PoH chain's
// 32- and 64-byte forms from these on a pair of warps.
//
// State and message are big-endian uint32 words, so a 32-byte digest is
// itself the 8 message words of the next PoH hash: a chain never turns
// words into bytes between hashes.  The constant block keeps the
// schedule of firedancer_tpu_torch/ops/sha256.py: the second block of a
// 64-byte message is fully constant, so its 64 schedule words plus the
// round constants are one table (S256_PAD64_WK).
//
// The functions also compile as host C++ (FD_FN), so the arithmetic can
// be checked on a machine without a GPU.

#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define FD_FN __device__ __forceinline__
#define S256_CONST __constant__
#else
#define FD_FN static inline
#define S256_CONST static const
#endif

S256_CONST uint32_t S256_K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u, 0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

S256_CONST uint32_t S256_H0[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
};

// schedule + K of the constant pad block of a 64-byte message (0x80,
// zeros, bit length 512): ops/sha256.py PAD64_WK
S256_CONST uint32_t S256_PAD64_WK[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u,
    0x649b69c1u, 0xf0fe4786u, 0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u, 0xfdb1232bu, 0xc7353eb0u,
    0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu, 0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u,
    0x007f3e86u, 0x37088980u, 0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u, 0x6ed41a95u, 0x6d437890u,
    0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu, 0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

FD_FN uint32_t s256_rotr(uint32_t x, int n) {
#if defined(__CUDACC__)
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32 - n));
#endif
}

// One round; the eight working words rotate by renaming, as the torch
// version's tuple does.
#define S256_ROUND(a, b, c, d, e, f, g, h, wk)                              \
  do {                                                                     \
    const uint32_t t1 = h + (s256_rotr(e, 6) ^ s256_rotr(e, 11) ^          \
                             s256_rotr(e, 25)) + ((e & f) ^ (~e & g)) + wk; \
    const uint32_t t2 = (s256_rotr(a, 2) ^ s256_rotr(a, 13) ^              \
                         s256_rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c)); \
    d += t1;                                                               \
    h = t1 + t2;                                                           \
  } while (0)

// h += compress(h, w): w is the block's 16 message words, overwritten by
// the schedule's ring.
FD_FN void s256_compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; t += 8) {
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int i = t + k;
      if (i >= 16) {
        const uint32_t w15 = w[(i + 1) & 15], w2 = w[(i + 14) & 15];
        const uint32_t s0 = s256_rotr(w15, 7) ^ s256_rotr(w15, 18) ^ (w15 >> 3);
        const uint32_t s1 = s256_rotr(w2, 17) ^ s256_rotr(w2, 19) ^ (w2 >> 10);
        w[i & 15] += s0 + w[(i + 9) & 15] + s1;
      }
    }
    S256_ROUND(a, b, c, d, e, f, g, hh, S256_K[t + 0] + w[(t + 0) & 15]);
    S256_ROUND(hh, a, b, c, d, e, f, g, S256_K[t + 1] + w[(t + 1) & 15]);
    S256_ROUND(g, hh, a, b, c, d, e, f, S256_K[t + 2] + w[(t + 2) & 15]);
    S256_ROUND(f, g, hh, a, b, c, d, e, S256_K[t + 3] + w[(t + 3) & 15]);
    S256_ROUND(e, f, g, hh, a, b, c, d, S256_K[t + 4] + w[(t + 4) & 15]);
    S256_ROUND(d, e, f, g, hh, a, b, c, S256_K[t + 5] + w[(t + 5) & 15]);
    S256_ROUND(c, d, e, f, g, hh, a, b, S256_K[t + 6] + w[(t + 6) & 15]);
    S256_ROUND(b, c, d, e, f, g, hh, a, S256_K[t + 7] + w[(t + 7) & 15]);
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// h += compress(h, block) for a block whose content is constant: wk is
// its schedule with the round constants added.
FD_FN void s256_compress_wk(uint32_t h[8], const uint32_t *wk) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 64; t += 8) {
    S256_ROUND(a, b, c, d, e, f, g, hh, wk[t + 0]);
    S256_ROUND(hh, a, b, c, d, e, f, g, wk[t + 1]);
    S256_ROUND(g, hh, a, b, c, d, e, f, wk[t + 2]);
    S256_ROUND(f, g, hh, a, b, c, d, e, wk[t + 3]);
    S256_ROUND(e, f, g, hh, a, b, c, d, wk[t + 4]);
    S256_ROUND(d, e, f, g, hh, a, b, c, wk[t + 5]);
    S256_ROUND(c, d, e, f, g, hh, a, b, wk[t + 6]);
    S256_ROUND(b, c, d, e, f, g, hh, a, wk[t + 7]);
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

FD_FN void s256_init(uint32_t h[8]) {
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = S256_H0[i];
}

// out = SHA-256(p || x): a one-byte prefix before 64 bytes given as 16
// big-endian words (a merkle leaf over a signature, p = 0, or an
// interior node over two children, p = 1).  65 bytes make two blocks:
// the message shifted right by one byte, then x's last byte, 0x80 and
// the bit length 520.
FD_FN void s256_prefixed64(uint32_t out[8], uint32_t p, const uint32_t x[16]) {
  uint32_t w[16];
  w[0] = (p << 24) | (x[0] >> 8);
#pragma unroll
  for (int i = 1; i < 16; i++) w[i] = (x[i - 1] << 24) | (x[i] >> 8);
  s256_init(out);
  s256_compress(out, w);
  w[0] = (x[15] << 24) | 0x800000u;
#pragma unroll
  for (int i = 1; i < 15; i++) w[i] = 0;
  w[15] = 520;
  s256_compress(out, w);
}

// big-endian words <-> bytes
FD_FN uint32_t s256_load_be(const uint8_t *b) {
  return ((uint32_t)b[0] << 24) | ((uint32_t)b[1] << 16) |
         ((uint32_t)b[2] << 8) | (uint32_t)b[3];
}

FD_FN void s256_store_be(uint8_t *b, uint32_t v) {
  b[0] = (uint8_t)(v >> 24);
  b[1] = (uint8_t)(v >> 16);
  b[2] = (uint8_t)(v >> 8);
  b[3] = (uint8_t)v;
}
