// GF(2^255-19) arithmetic for one lane per thread.
//
// Radix: 10 limbs of 26/25/26/25/... bits in uint32 (the reference's
// portable fd_f25519 / ref10 radix), products accumulated in uint64.
// This is the layout of firedancer_tpu_torch/ops/f25519.py, so a kernel
// writes its field outputs as the torch code's limb planes.
//
// Magnitudes: every function returns TIGHT limbs (even limbs < 2^26,
// odd limbs < 2^25 + 2^15) and accepts tight inputs.  mul multiplies a
// doubled limb (< 2^27.01) by a 19-folded limb (< 2^30.25), both in
// uint32, and a column sums at most ten such products: < 2^60.7.
// sub adds 2p before subtracting; a tight subtrahend never exceeds it.
//
// The functions also compile as host C++ (FD_FN), so the arithmetic can
// be checked on a machine without a GPU.

#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define FD_FN __device__ __forceinline__
#else
#define FD_FN static inline
#endif

struct fe {
  uint32_t v[10];
};

FD_FN int fe_width(int i) { return (i & 1) ? 25 : 26; }

// Serial carry of a wide accumulator: limb 9 wraps into limb 0 times 19
// (2^255 = 19 mod p), then limb 0 sheds once more.
FD_FN void fe_carry_wide(fe &r, uint64_t h[10]) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    h[i + 1] += h[i] >> fe_width(i);
    h[i] &= (1ull << fe_width(i)) - 1;
  }
  h[0] += 19 * (h[9] >> 25);
  h[9] &= (1ull << 25) - 1;
  h[1] += h[0] >> 26;
  h[0] &= (1ull << 26) - 1;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (uint32_t)h[i];
}

// The same chain for sums below 2^29 (add and sub results).
FD_FN void fe_carry(fe &r, uint32_t h[10]) {
#pragma unroll
  for (int i = 0; i < 9; i++) {
    h[i + 1] += h[i] >> fe_width(i);
    h[i] &= (1u << fe_width(i)) - 1;
  }
  h[0] += 19 * (h[9] >> 25);
  h[9] &= (1u << 25) - 1;
  h[1] += h[0] >> 26;
  h[0] &= (1u << 26) - 1;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = h[i];
}

FD_FN void fe_set(fe &r, uint32_t v0) {
  r.v[0] = v0;
#pragma unroll
  for (int i = 1; i < 10; i++) r.v[i] = 0;
}

FD_FN void fe_add(fe &r, const fe &a, const fe &b) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i] + b.v[i];
  fe_carry(r, h);
}

FD_FN void fe_sub(fe &r, const fe &a, const fe &b) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    // limbs of 2p: 2 * (2^26 - 19), then 2 * (2^w - 1)
    uint32_t two_p = i == 0 ? 0x7ffffdau : ((i & 1) ? 0x3fffffeu : 0x7fffffeu);
    h[i] = a.v[i] + two_p - b.v[i];
  }
  fe_carry(r, h);
}

FD_FN void fe_neg(fe &r, const fe &a) {
  fe z;
  fe_set(z, 0);
  fe_sub(r, z, a);
}

// Column k sums f_i * g_j over i + j = k (mod 10); odd * odd products are
// doubled (their half-bit offsets add up to one bit), and columns past
// limb 9 are folded in times 19.
FD_FN void fe_mul(fe &r, const fe &f, const fe &g) {
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 10; j++) {
      const int k = i + j;
      const uint32_t fi = ((i & 1) && (j & 1)) ? 2 * f.v[i] : f.v[i];
      const uint32_t gj = k >= 10 ? 19 * g.v[j] : g.v[j];
      h[k >= 10 ? k - 10 : k] += (uint64_t)fi * gj;
    }
  }
  fe_carry_wide(r, h);
}

// Squaring: each cross product once, doubled (factor <= 4 on a tight
// limb stays below 2^28.01 in uint32).
FD_FN void fe_sqr(fe &r, const fe &f) {
  uint64_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = i; j < 10; j++) {
      const int k = i + j;
      const uint32_t m = (i == j ? 1u : 2u) * (((i & 1) && (j & 1)) ? 2u : 1u);
      const uint32_t gj = k >= 10 ? 19 * f.v[j] : f.v[j];
      h[k >= 10 ? k - 10 : k] += (uint64_t)(m * f.v[i]) * gj;
    }
  }
  fe_carry_wide(r, h);
}

FD_FN void fe_sqr_n(fe &r, const fe &a, int n) {
  fe_sqr(r, a);
  for (int i = 1; i < n; i++) fe_sqr(r, r);
}

// z^(2^252 - 3), the ref10 addition chain (ref fd_f25519_pow22523).
FD_FN void fe_pow22523(fe &r, const fe &z) {
  fe z2, z9, z11, t, z5, z10, z20, z50, z100;
  fe_sqr(z2, z);
  fe_sqr_n(t, z2, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sqr(t, z11);
  fe_mul(z5, t, z9);          // 2^5 - 1
  fe_sqr_n(t, z5, 5);
  fe_mul(z10, t, z5);         // 2^10 - 1
  fe_sqr_n(t, z10, 10);
  fe_mul(z20, t, z10);        // 2^20 - 1
  fe_sqr_n(t, z20, 20);
  fe_mul(t, t, z20);          // 2^40 - 1
  fe_sqr_n(t, t, 10);
  fe_mul(z50, t, z10);        // 2^50 - 1
  fe_sqr_n(t, z50, 50);
  fe_mul(z100, t, z50);       // 2^100 - 1
  fe_sqr_n(t, z100, 100);
  fe_mul(t, t, z100);         // 2^200 - 1
  fe_sqr_n(t, t, 50);
  fe_mul(t, t, z50);          // 2^250 - 1
  fe_sqr_n(t, t, 2);
  fe_mul(r, t, z);            // 2^252 - 3
}

// The representative in [0, p) with every limb exactly in range.
FD_FN void fe_canonical(fe &r, const fe &a) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) h[i] = a.v[i];
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
#pragma unroll
    for (int i = 0; i < 9; i++) {
      h[i + 1] += h[i] >> fe_width(i);
      h[i] &= (1u << fe_width(i)) - 1;
    }
    h[0] += 19 * (h[9] >> 25);
    h[9] &= (1u << 25) - 1;
  }
#pragma unroll
  for (int i = 0; i < 9; i++) {
    h[i + 1] += h[i] >> fe_width(i);
    h[i] &= (1u << fe_width(i)) - 1;
  }
  // v < 2^255 + 2^26; v >= p iff v + 19 carries out of bit 255, and then
  // v - p is v + 19 without that carry
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = h[i];
  t[0] += 19;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    t[i + 1] += t[i] >> fe_width(i);
    t[i] &= (1u << fe_width(i)) - 1;
  }
  const bool ge = (t[9] >> 25) != 0;
  t[9] &= (1u << 25) - 1;
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = ge ? t[i] : h[i];
}

// a == c for a canonical constant c.
FD_FN bool fe_eq_canon(const fe &a_canon, const fe &c) {
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) d |= a_canon.v[i] ^ c.v[i];
  return d == 0;
}

FD_FN bool fe_iszero(const fe &a) {
  fe c;
  fe_canonical(c, a);
  uint32_t d = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) d |= c.v[i];
  return d == 0;
}

FD_FN bool fe_eq(const fe &a, const fe &b) {
  fe d;
  fe_sub(d, a, b);
  return fe_iszero(d);
}

FD_FN uint32_t fe_sgn(const fe &a) {
  fe c;
  fe_canonical(c, a);
  return c.v[0] & 1;
}

// Little-endian 32 bytes at any alignment -> limbs; bit 255 is dropped and
// values >= p are kept as they are (fd_f25519_frombytes semantics).
FD_FN void fe_frombytes(fe &r, const uint8_t *b) {
  uint64_t w[4];
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint64_t x = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) x |= (uint64_t)b[8 * k + j] << (8 * j);
    w[k] = x;
  }
  const int offs[10] = {0, 26, 51, 77, 102, 128, 153, 179, 204, 230};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int o = offs[i], wd = fe_width(i), q = o >> 6, s = o & 63;
    uint64_t x = w[q] >> s;
    if (s + wd > 64) x |= w[q + 1] << (64 - s);
    r.v[i] = (uint32_t)(x & ((1ull << wd) - 1));
  }
}

// x = sqrt(u / v) when u / v is a square (RFC 8032 5.1.3): returns
// whether it is; x is then unspecified otherwise.
FD_FN bool fe_sqrt_ratio(fe &x, const fe &u, const fe &v, const fe &sqrt_m1) {
  fe v2, v3, v7, t, vxx, nu;
  fe_sqr(v2, v);
  fe_mul(v3, v2, v);
  fe_sqr(t, v2);
  fe_mul(v7, t, v3);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sqr(t, x);
  fe_mul(vxx, t, v);
  const bool good = fe_eq(vxx, u);
  fe_neg(nu, u);
  const bool flipped = fe_eq(vxx, nu);
  if (flipped) fe_mul(x, x, sqrt_m1);
  return good || flipped;
}
