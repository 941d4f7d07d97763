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

// sub ? a - b : a + b.  sub adds 2p before subtracting (limbs of 2p:
// 2 * (2^26 - 19), then 2 * (2^w - 1)); a tight b never exceeds it.
// Threads that need different sums run one instruction stream.
FD_FN void fe_addsub(fe &r, const fe &a, const fe &b, bool sub) {
  uint32_t h[10];
#pragma unroll
  for (int i = 0; i < 10; i++) {
    uint32_t two_p = i == 0 ? 0x7ffffdau : ((i & 1) ? 0x3fffffeu : 0x7fffffeu);
    h[i] = a.v[i] + (sub ? two_p - b.v[i] : b.v[i]);
  }
  fe_carry(r, h);
}

FD_FN void fe_add(fe &r, const fe &a, const fe &b) {
  fe_addsub(r, a, b, false);
}

FD_FN void fe_sub(fe &r, const fe &a, const fe &b) {
  fe_addsub(r, a, b, true);
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

// ---- Division by a variable-time Bernstein-Yang inverse ("safegcd";
// bitcoin-core/secp256k1's modinv32_var, doc/safegcd_implementation.md).
//
// Values as 9 signed limbs of 30 bits (fe_s30), p as {-19, 0, ..., 0,
// 2^15}.  A batch runs 30 divsteps on the low words of f and g alone
// (fe_divsteps30: it skips a run of zero bits of g in one step and
// cancels up to 6 bits of g with one multiple of f), then applies the
// batch's transition matrix to f and g exactly and to d and e mod p, each
// over 2^30 (fe_update).  From f = p, g = den, d = 0,
// e = num, the lane stops after the first batch that leaves g = 0; then
// f = +-1 and d = +-num / den mod p.  Inputs below 2^255 need at most 738
// divsteps (Bernstein and Yang's bound), so 25 batches.  The time depends
// on den: the verifier's inputs are all public.  Each batch's dependent
// chain is its divsteps, a few single-word operations each, against the
// 265 ten-limb products in series of a Fermat inverse.

struct fe_s30 {
  int32_t v[9];
};

// a batch's transition matrix: t [f, g] = 2^30 [f', g']
struct fe_t2 {
  int32_t u, v, q, r;
};

#define FE_M30 0x3fffffff
#define FE_P_INV30 0x179435e5u         // p^-1 mod 2^30
#define FE_DIV_BATCHES 25
#define FE_P_S30_LO (-19)               // p's limbs 0 and 8; 1-7 are 0
#define FE_P_S30_HI 32768

FD_FN int fe_ctz32(uint32_t x) {
#if defined(__CUDACC__)
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// Bit offset of limb i of an fe: 0, 26, 51, 77, ..., 230.
FD_FN int fe_limb_off(int i) { return (51 * i + 1) >> 1; }

// canonical fe -> 30-bit limbs, all in [0, 2^30)
FD_FN void fe_to_s30(fe_s30 &r, const fe &a) {
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int o = fe_limb_off(i), q = o >> 6, s = o & 63;
    w[q] |= (uint64_t)a.v[i] << s;
    if (s + fe_width(i) > 64) w[q + 1] |= (uint64_t)a.v[i] >> (64 - s);
  }
#pragma unroll
  for (int j = 0; j < 9; j++) {
    const int o = 30 * j, q = o >> 6, s = o & 63;
    uint64_t x = w[q] >> s;
    if (s + 30 > 64 && q < 3) x |= w[q + 1] << (64 - s);
    r.v[j] = (int32_t)(x & FE_M30);
  }
}

// 30-bit limbs of a value in [0, p) (limbs 0-7 in [0, 2^30)) -> canonical
// fe
FD_FN void fe_from_s30(fe &r, const fe_s30 &a) {
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 9; j++) {
    const int o = 30 * j, q = o >> 6, s = o & 63;
    const uint64_t x = (uint32_t)a.v[j];
    w[q] |= x << s;
    if (s + 30 > 64 && q < 3) w[q + 1] |= x >> (64 - s);
  }
#pragma unroll
  for (int i = 0; i < 10; i++) {
    const int o = fe_limb_off(i), wd = fe_width(i), q = o >> 6, s = o & 63;
    uint64_t x = w[q] >> s;
    if (s + wd > 64) x |= w[q + 1] << (64 - s);
    r.v[i] = (uint32_t)(x & ((1ull << wd) - 1));
  }
}

// 30 divsteps from eta = -delta on the low words of f (odd) and g;
// returns eta after them.
FD_FN int32_t fe_divsteps30(int32_t eta, uint32_t f, uint32_t g, fe_t2 &t) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (;;) {
    // g's zero bits, up to the i steps left (a sentinel bit at i), each
    // a halving of g
    const int zeros = fe_ctz32(g | (0xffffffffu << i));
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    // g odd: where delta > 0, (f, g) becomes (g, -f)
    if (eta < 0) {
      uint32_t tmp;
      eta = -eta;
      tmp = f; f = g; g = 0u - tmp;
      tmp = u; u = q; q = 0u - tmp;
      tmp = v; v = r; r = 0u - tmp;
    }
    // then g += w f cancels g's low bits, as many as the steps before
    // delta turns positive, the steps left and 6 allow: w = -g / f mod
    // 2^6, with f (f f - 2) = -1 / f mod 2^6
    int limit = eta + 1 > i ? i : eta + 1;
    limit = limit > 6 ? 6 : limit;
    const uint32_t w = (f * g * (f * f - 2u)) & ((1u << limit) - 1u);
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t.u = (int32_t)u;
  t.v = (int32_t)v;
  t.q = (int32_t)q;
  t.r = (int32_t)r;
  return eta;
}

// [x, y] = t [x, y] / 2^30: mod p for d and e (mod_p: md and me
// multiples of p make the low 30 bits 0; d and e stay in (-2p, p), limbs
// in (-2^30, 2^30)), exact for f and g (their low 30 bits are 0 already,
// and so md = me = 0).
FD_FN void fe_update(fe_s30 &x, fe_s30 &y, const fe_t2 &t, bool mod_p) {
  const int32_t u = t.u, v = t.v, q = t.q, r = t.r;
  const int32_t sx = mod_p ? x.v[8] >> 31 : 0, sy = mod_p ? y.v[8] >> 31 : 0;
  int32_t mx = (u & sx) + (v & sy);
  int32_t my = (q & sx) + (r & sy);
  int64_t cx = (int64_t)u * x.v[0] + (int64_t)v * y.v[0];
  int64_t cy = (int64_t)q * x.v[0] + (int64_t)r * y.v[0];
  mx -= (int32_t)((FE_P_INV30 * (uint32_t)cx + (uint32_t)mx) & FE_M30);
  my -= (int32_t)((FE_P_INV30 * (uint32_t)cy + (uint32_t)my) & FE_M30);
  cx += (int64_t)FE_P_S30_LO * mx;
  cy += (int64_t)FE_P_S30_LO * my;
  cx >>= 30;
  cy >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cx += (int64_t)u * x.v[i] + (int64_t)v * y.v[i];
    cy += (int64_t)q * x.v[i] + (int64_t)r * y.v[i];
    if (i == 8) {
      cx += (int64_t)FE_P_S30_HI * mx;
      cy += (int64_t)FE_P_S30_HI * my;
    }
    x.v[i - 1] = (int32_t)cx & FE_M30;
    cx >>= 30;
    y.v[i - 1] = (int32_t)cy & FE_M30;
    cy >>= 30;
  }
  x.v[8] = (int32_t)cx;
  y.v[8] = (int32_t)cy;
}

// d in (-2p, p) -> d (negated where sign < 0) in [0, p), limbs 0-7 in
// [0, 2^30).
FD_FN void fe_s30_normalize(fe_s30 &d, int32_t sign) {
  int32_t add = d.v[8] >> 31;
  d.v[0] += FE_P_S30_LO & add;
  d.v[8] += FE_P_S30_HI & add;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] = (d.v[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= FE_M30;
  }
  add = d.v[8] >> 31;
  d.v[0] += FE_P_S30_LO & add;
  d.v[8] += FE_P_S30_HI & add;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= FE_M30;
  }
}

// A division's start, as the pair of a lane holds it: [x, y] = [f, g] =
// [p, den] (the divsteps' pair) or [d, e] = [0, num] (mod_p's), from
// canonical src (den or num).
FD_FN void fe_div_start(fe_s30 &x, fe_s30 &y, const fe &src, bool mod_p) {
#pragma unroll
  for (int i = 0; i < 9; i++) x.v[i] = 0;
  if (!mod_p) {
    x.v[0] = FE_P_S30_LO;
    x.v[8] = FE_P_S30_HI;
  }
  fe_to_s30(y, src);
}

// One batch for one of the pair: 30 divsteps from eta on f and g's low
// words f0 and g0, then the batch's matrix applied to [x, y] (fe_update's
// mod_p).  Returns eta after it.
FD_FN int32_t fe_div_batch(fe_s30 &x, fe_s30 &y, int32_t eta, uint32_t f0,
                           uint32_t g0, bool mod_p) {
  fe_t2 t;
  eta = fe_divsteps30(eta, f0, g0, t);
  fe_update(x, y, t, mod_p);
  return eta;
}

// r = num / den mod p, canonical, for canonical num and den (0 where den
// is 0), both of the pair on one thread.  Returns the batches run.
FD_FN int fe_div_canon(fe &r, const fe &num, const fe &den) {
  fe_s30 d, e, f, g;
  fe_div_start(f, g, den, false);
  fe_div_start(d, e, num, true);
  int32_t eta = -1;             // delta = 1
  int b = 0;
  while (b < FE_DIV_BATCHES) {
    const uint32_t f0 = (uint32_t)f.v[0], g0 = (uint32_t)g.v[0];
    fe_div_batch(d, e, eta, f0, g0, true);
    eta = fe_div_batch(f, g, eta, f0, g0, false);
    b++;
    int32_t nz = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) nz |= g.v[i];
    if (nz == 0) break;
  }
  fe_s30_normalize(d, f.v[8]);
  fe_from_s30(r, d);
  return b;
}
