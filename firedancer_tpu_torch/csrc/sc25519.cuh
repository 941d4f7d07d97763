// Scalars mod L for one lane per thread: the S < L test, the SHA-512
// digest mod L, products mod L, and the signed 4-bit recode.  A
// transcription of firedancer_tpu_torch/ops/scalar25519.py (radix 2^12
// limbs, folds of 2^252 = -C mod L), in int64 so no product comes near
// overflow.

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

// Little-endian bytes -> 12-bit limbs (limb i = bits 12i .. 12i + 11;
// bits past the last byte read 0).
template <int NBYTES, int NLIMB>
FD_FN void sc_bytes_to_limbs(int64_t *x, const uint8_t *b) {
#pragma unroll
  for (int t = 0; t < (NLIMB + 1) / 2; t++) {
    const int64_t b0 = 3 * t < NBYTES ? b[3 * t] : 0;
    const int64_t b1 = 3 * t + 1 < NBYTES ? b[3 * t + 1] : 0;
    const int64_t b2 = 3 * t + 2 < NBYTES ? b[3 * t + 2] : 0;
    x[2 * t] = b0 | ((b1 & 0xf) << 8);
    if (2 * t + 1 < NLIMB) x[2 * t + 1] = (b1 >> 4) | (b2 << 4);
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

// The value of N carried limbs (any value in [0, 2^264)) + 2L, carried
// three times, then reduced below L: the last steps of reduce_512 and
// mul_mod_l.  N = 23 (the fold ladder stops there); x is clobbered.
FD_FN void sc_finish23(int64_t *out, int64_t *x) {
#pragma unroll
  for (int i = 0; i < 22; i++) x[i] += sc_l2_limb(i);
  sc_carry<23>(x);
  sc_carry<23>(x);
  sc_carry<23>(x);
  sc_cond_sub_l<23>(out, x);
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
  sc_finish23(k, x23);
}

// a * b mod L for a of 22 limbs (any value below 2^264: a non-canonical
// S too) and b of 11 (z, 128 bits) -> 22 canonical limbs
// (scalar25519.mul_mod_l at nb = 11).  The sizes follow its loop: the
// 33-limb convolution (columns of at most 11 products below 2^24) and
// three carries; folds while more than 23 limbs remain, 33 -> 25 -> 23,
// each with two carries; one more fold, 23 -> 23; then sc_finish23.
FD_FN void sc_mul_mod_l(int64_t *out, const int64_t *a, const int64_t *b) {
  int64_t x33[33], x25[25], x23[23], y23[23];
#pragma unroll
  for (int i = 0; i < 33; i++) x33[i] = 0;
#pragma unroll
  for (int i = 0; i < 11; i++) {
#pragma unroll
    for (int j = 0; j < 22; j++) x33[i + j] += b[i] * a[j];
  }
  sc_carry<33>(x33);
  sc_carry<33>(x33);
  sc_carry<33>(x33);
  sc_fold<33>(x25, x33);
  sc_carry<25>(x25);
  sc_carry<25>(x25);
  sc_fold<25>(x23, x25);
  sc_carry<23>(x23);
  sc_carry<23>(x23);
  sc_fold<23>(y23, x23);
  sc_carry<23>(y23);
  sc_carry<23>(y23);
  sc_finish23(out, y23);
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

// 4-bit window w (low first) of 12-bit limbs: limb w / 3, shift 4 (w % 3).
FD_FN uint8_t sc_window(const int64_t *limbs, int w) {
  return (uint8_t)((limbs[w / 3] >> (4 * (w % 3))) & 0xf);
}

// 64 unsigned 4-bit windows (low first) -> magnitudes 0..8 and signs 0/1
// (scalar25519.signed_windows): a carry ripples low to high; a window
// whose digit d (carry included) exceeds 8 becomes 16 - d with sign 1,
// so d = 16 gives magnitude 0 with sign 1.  The carry out of the top
// window is dropped: it cannot occur below 2^253, and an S that large is
// rejected by the S < L test anyway.
FD_FN void sc_signed_windows(uint8_t *mag, uint8_t *sgn, const uint8_t *nib) {
  int carry = 0;
  for (int w = 0; w < 64; w++) {
    const int d = nib[w] + carry;
    carry = d > 8;
    mag[w] = (uint8_t)(carry ? 16 - d : d);
    sgn[w] = (uint8_t)carry;
  }
}

// The scalar half of the strict tail, one lane: S < L, k = digest mod L,
// and the signed windows of S (its bytes as they are) and of k.
FD_FN bool sc_reduce_recode(const uint8_t *s, const uint8_t *digest,
                            uint8_t *smag, uint8_t *ssgn, uint8_t *kmag,
                            uint8_t *ksgn) {
  int64_t kl[22];
  sc_reduce512(kl, digest);
  uint8_t nib[64];
  for (int w = 0; w < 64; w++) nib[w] = sc_window(kl, w);
  sc_signed_windows(kmag, ksgn, nib);
  for (int i = 0; i < 32; i++) {
    nib[2 * i] = s[i] & 0xf;
    nib[2 * i + 1] = s[i] >> 4;
  }
  sc_signed_windows(smag, ssgn, nib);
  return sc_is_canonical(s);
}
