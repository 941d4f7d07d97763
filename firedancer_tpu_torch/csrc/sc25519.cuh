// Scalars mod L for one lane per thread: the S < L test, the SHA-512
// digest mod L, and the signed 4-bit recode.  A transcription of
// firedancer_tpu_torch/ops/scalar25519.py (radix 2^12 limbs, folds of
// 2^252 = -C mod L), in int64 so no product comes near overflow.

#pragma once
#include "fe25519.cuh"

#define SC_MASK 0xfffll

// L = 2^252 + C in 12-bit limbs.
FD_FN int64_t sc_l_limb(int i) {
  const int64_t l[22] = {0x3ed, 0xf5d, 0xa5c, 0x631, 0x812, 0xd65, 0x79c, 0xa2f, 0x9de, 0xdef, 0x014, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x001};
  return l[i];
}

FD_FN int64_t sc_l2_limb(int i) {
  const int64_t l2[22] = {0x7da, 0xeba, 0x4b9, 0xc63, 0x024, 0xacb, 0xf39, 0x45e, 0x3bd, 0xbdf, 0x029, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x000, 0x002};
  return l2[i];
}

// Little-endian bytes -> 12-bit limbs (limb i = bits 12i .. 12i + 11).
template <int NBYTES, int NLIMB>
FD_FN void sc_bytes_to_limbs(int64_t *x, const uint8_t *b) {
#pragma unroll
  for (int t = 0; t < NLIMB / 2; t++) {
    const int64_t b0 = 3 * t < NBYTES ? b[3 * t] : 0;
    const int64_t b1 = 3 * t + 1 < NBYTES ? b[3 * t + 1] : 0;
    const int64_t b2 = 3 * t + 2 < NBYTES ? b[3 * t + 2] : 0;
    x[2 * t] = b0 | ((b1 & 0xf) << 8);
    x[2 * t + 1] = (b1 >> 4) | (b2 << 4);
  }
}

// One parallel signed carry pass; the top limb's own carry is dropped
// (the callers keep headroom limbs there).
template <int N>
FD_FN void sc_carry(int64_t *x) {
#pragma unroll
  for (int i = N - 1; i > 0; i--) x[i] = (x[i] & SC_MASK) + (x[i - 1] >> 12);
  x[0] &= SC_MASK;
}

// x (N limbs) -> lo(21 limbs) - C * hi into out (max(21, N - 10) + 2 limbs).
template <int N>
FD_FN void sc_fold(int64_t *out, const int64_t *x) {
  const int64_t c[11] = {0x3ed, 0xf5d, 0xa5c, 0x631, 0x812, 0xd65, 0x79c, 0xa2f, 0x9de, 0xdef, 0x014};
  constexpr int M = N - 21;
  constexpr int OUT = (21 > M + 11 ? 21 : M + 11) + 2;
#pragma unroll
  for (int i = 0; i < OUT; i++) out[i] = i < 21 ? x[i] : 0;
#pragma unroll
  for (int i = 0; i < 11; i++) {
#pragma unroll
    for (int j = 0; j < M; j++) out[i + j] -= c[i] * x[21 + j];
  }
}

// Serial exact carry of N signed limbs, then four conditional
// subtractions of L: a value in [0, 2^264) -> canonical 22 limbs.
template <int N>
FD_FN void sc_cond_sub_l(int64_t *out, int64_t *x) {
#pragma unroll
  for (int i = 0; i < N - 1; i++) {
    x[i + 1] += x[i] >> 12;
    x[i] &= SC_MASK;
  }
#pragma unroll
  for (int i = 0; i < 22; i++) out[i] = x[i];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    int64_t d[22], borrow = 0;
#pragma unroll
    for (int i = 0; i < 22; i++) {
      const int64_t t = out[i] + (1 << 12) - sc_l_limb(i) - borrow;
      d[i] = t & SC_MASK;
      borrow = 1 - (t >> 12);
    }
    if (borrow == 0) {
#pragma unroll
      for (int i = 0; i < 22; i++) out[i] = d[i];
    }
  }
}

// SHA-512 digest (little-endian) mod L -> 22 canonical limbs.
FD_FN void sc_reduce512(int64_t *k, const uint8_t *digest) {
  int64_t x44[44], x36[36], x28[28], x23[23];
  sc_bytes_to_limbs<64, 44>(x44, digest);
  sc_fold<44>(x36, x44);
  sc_carry<36>(x36);
  sc_carry<36>(x36);
  sc_fold<36>(x28, x36);
  sc_carry<28>(x28);
  sc_carry<28>(x28);
  sc_fold<28>(x23, x28);
  sc_carry<23>(x23);
  sc_carry<23>(x23);
#pragma unroll
  for (int i = 0; i < 22; i++) x23[i] += sc_l2_limb(i);
  sc_carry<23>(x23);
  sc_carry<23>(x23);
  sc_carry<23>(x23);
  sc_cond_sub_l<23>(k, x23);
}

// S < L (fd_curve25519_scalar_validate).
FD_FN bool sc_is_canonical(const uint8_t *s) {
  int64_t x[22], borrow = 0;
  sc_bytes_to_limbs<32, 22>(x, s);
#pragma unroll
  for (int i = 0; i < 22; i++) {
    const int64_t t = x[i] + (1 << 12) - sc_l_limb(i) - borrow;
    borrow = 1 - (t >> 12);
  }
  return borrow == 1;
}

// 4-bit windows (low first) -> signed digits in [-8, 8]: a carry ripples
// low to high; a carry out of the top window is dropped (it cannot occur
// for a scalar below 2^253).
FD_FN void sc_signed_digits(int8_t *dig, const uint8_t *nib) {
  int carry = 0;
  for (int w = 0; w < 64; w++) {
    const int d = nib[w] + carry;
    carry = d > 8;
    dig[w] = (int8_t)(carry ? d - 16 : d);
  }
}
