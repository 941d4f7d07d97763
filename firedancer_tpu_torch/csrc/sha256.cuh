// SHA-256 for one lane per thread: the compression and the compression
// of a constant block; and a hash's parts on a pair of warps, the
// schedule warp's and the rounds warp's, from which poh_spans.cu builds
// the PoH chain's 32- and 64-byte forms and mixin_tree.cu the merkle
// tree's 65-byte nodes.
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

// ---- a hash on a pair of warps: the rounds warp and the schedule warp --------
// poh_spans.cu and mixin_tree.cu run each hash on a pair of warps: the
// schedule warp computes K_t + W_t of rounds 16-63 and hands them over in
// chunks of 16, the rounds warp runs the rounds (PERF.md has the
// measurements).  The integer work of both runs partly on the FMA pipe.
//
// The 1 is read from constant memory, which the host may rewrite, so the
// compiler cannot fold the multiply and turn it back into an IADD3.
S256_CONST uint32_t S256_ONE = 1u;

// x + y, as mad.lo(x, 1, y) on the FMA pipe where imad; a plain add where
// an operand may be a constant that the compiler should fold: rounds 0-3
// see H0's, and rounds 0-15 add K_t + W_t, an append's tail in 8-15.
FD_FN uint32_t s256_add(uint32_t x, uint32_t y, bool imad) {
  if (!imad) return x + y;
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(S256_ONE), "r"(y));
  return r;
#else
  return x * S256_ONE + y;
#endif
}

// Round t of a compression, kw = K_t + W_t; the working words rotate by
// renaming.  t picks the adds' forms: rounds t < 4 from H0 add plainly,
// so that H0 folds, and t < 16 adds kw plainly, so that a constant word
// folds; a compression from a variable state passes t >= 8 for its
// rounds 0-15.  The rotations stay funnel shifts (SHF): as two IMAD.HI
// forms each they were slower on this card (PERF.md).
#define S256_PROUND(a, b, c, d, e, f, g, h, kw, t)                           \
  do {                                                                       \
    const bool live_ = (t) >= 4;                                             \
    const uint32_t s1_ = s256_rotr(e, 6) ^ s256_rotr(e, 11) ^                \
                         s256_rotr(e, 25);                                   \
    const uint32_t s0_ = s256_rotr(a, 2) ^ s256_rotr(a, 13) ^                \
                         s256_rotr(a, 22);                                   \
    const uint32_t t1_ = s256_add(                                           \
        s256_add(s256_add(h, kw, (t) >= 16), (e & f) ^ (~e & g), live_),     \
        s1_, live_);                                                         \
    d = s256_add(d, t1_, live_);                                             \
    h = s256_add(s256_add(t1_, (a & b) ^ (a & c) ^ (b & c), live_), s0_,     \
                live_);                                                      \
  } while (0)

// Rounds t0 .. t0 + 7, kw[i] = K + W of round t0 + i.
FD_FN void s256_rounds8(uint32_t v[8], const uint32_t *kw, int t0) {
  uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
  uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
  S256_PROUND(a, b, c, d, e, f, g, h, kw[0], t0 + 0);
  S256_PROUND(h, a, b, c, d, e, f, g, kw[1], t0 + 1);
  S256_PROUND(g, h, a, b, c, d, e, f, kw[2], t0 + 2);
  S256_PROUND(f, g, h, a, b, c, d, e, kw[3], t0 + 3);
  S256_PROUND(e, f, g, h, a, b, c, d, kw[4], t0 + 4);
  S256_PROUND(d, e, f, g, h, a, b, c, kw[5], t0 + 5);
  S256_PROUND(c, d, e, f, g, h, a, b, kw[6], t0 + 6);
  S256_PROUND(b, c, d, e, f, g, h, a, kw[7], t0 + 7);
  v[0] = a; v[1] = b; v[2] = c; v[3] = d;
  v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

// H0 as literals, so that the compiler folds it (S256_H0 is constant
// memory).
FD_FN void s256_h0(uint32_t h[8]) {
  h[0] = 0x6a09e667u; h[1] = 0xbb67ae85u; h[2] = 0x3c6ef372u;
  h[3] = 0xa54ff53au; h[4] = 0x510e527fu; h[5] = 0x9b05688cu;
  h[6] = 0x1f83d9abu; h[7] = 0x5be0cd19u;
}

// A 0 that ptxas cannot see: a barrier id plus the working words ANDed
// with it waits for the rounds before it (poh_spans.cu).
S256_CONST uint32_t S256_ZERO = 0u;

// The first 16 round constants as literals, for the forms that fold them.
#define S256_K16                                          \
  0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,     \
      0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, \
      0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, \
      0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u

// The schedule warp's part of a hash: K_t + W_t of rounds 16-63 from the
// block's words w (overwritten by the schedule's ring), 16 at a time (a
// chunk); put(c, kw) hands chunk c over and returns 0, which the next word
// takes in (on the card a 0 that ptxas cannot see).  Its adds run
// on the FMA pipe, its rotations and shifts as SHF.  A loop of one chunk a
// trip, so that the ring's indices stay constant and the warp's code is
// small: unrolled, the schedule warp's instruction fetch slowed the rounds
// warp beside it.
template <class Put>
FD_FN void s256_schedule(uint32_t w[16], Put put) {
#pragma unroll 1
  for (int i = 0; i < 3; i++) {
    uint32_t kw[16];
#pragma unroll
    for (int k = 0; k < 16; k++) {
      const uint32_t x15 = w[(k + 1) & 15], x2 = w[(k + 14) & 15];
      const uint32_t s0 = s256_rotr(x15, 7) ^ s256_rotr(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = s256_rotr(x2, 17) ^ s256_rotr(x2, 19) ^ (x2 >> 10);
      w[k] = s256_add(
          s256_add(s256_add(w[k], s0, true), w[(k + 9) & 15], true), s1, true);
      kw[k] = w[k] + S256_K[16 + 16 * i + k];
    }
    w[0] ^= put(i, kw);
  }
}

// The rounds warp's part of a hash's first compression: v = the working
// words after 64 rounds from H0, rounds 0-15 on w, rounds 16-63 on the
// chunks that get(c, kw, v) hands over (v: the working words before
// them).
template <class Get>
FD_FN void s256_rounds_h0(uint32_t v[8], const uint32_t w[16], Get get) {
  // the first 16 round constants as literals, so that an append's
  // K_t + W_t of rounds 8-15 folds
  const uint32_t k16[16] = {S256_K16};
  s256_h0(v);
#pragma unroll
  for (int c = 0; c < 2; c++) {
    uint32_t kw[8];
#pragma unroll
    for (int i = 0; i < 8; i++) kw[i] = k16[8 * c + i] + w[8 * c + i];
    s256_rounds8(v, kw, 8 * c);
  }
#pragma unroll
  for (int c = 0; c < 3; c++) {
    uint32_t kw[16];
    get(c, kw, v);
    s256_rounds8(v, kw, 16);  // rounds 16-63 take one set of forms
    s256_rounds8(v, kw + 8, 16);
  }
}

// Bytes sel's nibbles pick from hi:lo (__byte_perm).
FD_FN uint32_t s256_perm(uint32_t lo, uint32_t hi, uint32_t sel) {
#if defined(__CUDACC__)
  return __byte_perm(lo, hi, sel);
#else
  const uint64_t x = ((uint64_t)hi << 32) | lo;
  uint32_t r = 0;
  for (int n = 0; n < 4; n++)
    r |= (uint32_t)((x >> (8 * ((sel >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
#endif
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
