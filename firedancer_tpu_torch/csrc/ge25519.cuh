// ed25519 point arithmetic (twisted Edwards, a = -1) for one lane per
// thread, over fe25519.cuh: msm.cu's points and the decompression that
// the chain kernels share (the chain itself runs on four threads a lane,
// dsm_chain.cuh).  The formulas and their order are those of
// firedancer_tpu_torch/ops/curve25519.py, so the kernel and the torch
// code produce equal coordinates, not merely equal projective points.

#pragma once
#include "fe25519.cuh"

// Point functions stay out of line on the device (field functions are
// inlined into them): with all of them inlined into the tail kernel, nvcc
// 12.9's front end (cicc) crashes.  Out of line they cost a call per point
// operation and pass coordinates through the stack.
#if defined(__CUDACC__)
#define GE_FN __device__ __noinline__
#else
#define GE_FN static inline
#endif

struct ge {
  fe X, Y, Z, T;
};

// (Y - X, Y + X, Z, 2dT)
struct ge_niels {
  fe Ym, Yp, Z, T2d;
};

GE_FN void ge_identity(ge &r) {
  fe_set(r.X, 0);
  fe_set(r.Y, 1);
  fe_set(r.Z, 1);
  fe_set(r.T, 0);
}

// E = B - A, F = D - C, G = D + C, H = B + A; (EF, GH, FG, EH).
GE_FN void ge_finish(ge &r, const fe &a, const fe &b, const fe &c,
                     const fe &d, bool want_t) {
  fe e, f, g, h;
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  if (want_t) fe_mul(r.T, e, h);
}

// Unified addition (add-2008-hwcd-3), complete on the curve.
GE_FN void ge_add(ge &r, const ge &p, const ge &q, const fe &d2) {
  fe a, b, c, t, u, zz;
  fe_sub(t, p.Y, p.X);
  fe_sub(u, q.Y, q.X);
  fe_mul(a, t, u);
  fe_add(t, p.Y, p.X);
  fe_add(u, q.Y, q.X);
  fe_mul(b, t, u);
  fe_mul(t, p.T, q.T);
  fe_mul(c, t, d2);
  fe_mul(zz, p.Z, q.Z);
  fe_add(zz, zz, zz);
  ge_finish(r, a, b, c, zz, true);
}

// dbl-2008-hwcd with every coordinate negated (the same projective
// point).  T is never read; want_t = false leaves r.T as it was.
GE_FN void ge_double(ge &r, const ge &p, bool want_t) {
  fe xx, yy, zz2, xpy2, yp, ym, ec, tc, t;
  fe_sqr(xx, p.X);
  fe_sqr(yy, p.Y);
  fe_sqr(t, p.Z);
  fe_add(zz2, t, t);
  fe_add(t, p.X, p.Y);
  fe_sqr(xpy2, t);
  fe_add(yp, yy, xx);
  fe_sub(ym, yy, xx);
  fe_sub(ec, xpy2, yp);
  fe_sub(tc, zz2, ym);
  fe_mul(r.X, ec, tc);
  fe_mul(r.Y, yp, ym);
  fe_mul(r.Z, ym, tc);
  if (want_t) fe_mul(r.T, ec, yp);
}

GE_FN void ge_to_niels(ge_niels &r, const ge &p, const fe &d2) {
  fe_sub(r.Ym, p.Y, p.X);
  fe_add(r.Yp, p.Y, p.X);
  r.Z = p.Z;
  fe_mul(r.T2d, p.T, d2);
}

GE_FN void ge_add_niels(ge &r, const ge &p, const fe &ym, const fe &yp,
                        const fe &z, const fe &t2d) {
  fe a, b, c, zz, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, ym);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, yp);
  fe_mul(c, p.T, t2d);
  fe_mul(zz, p.Z, z);
  fe_add(zz, zz, zz);
  ge_finish(r, a, b, c, zz, true);
}

// [0..n-1]P in Niels form: entry 0 the identity, entry 1 P itself, then
// repeated unified adds of P (the TPU kernels' tables, and
// curve25519.niels_table).  P may have any Z; its T must be valid.
GE_FN void ge_niels_table(ge_niels *tab, const ge &p, int n, const fe &d2) {
  ge cur;
  ge_identity(cur);
  ge_to_niels(tab[0], cur, d2);
  ge_to_niels(tab[1], p, d2);
  cur = p;
  for (int i = 2; i < n; i++) {
    ge nxt;
    ge_add(nxt, cur, p, d2);
    ge_to_niels(tab[i], nxt, d2);
    cur = nxt;
  }
}

// Field elements in the torch layout: (10, n) int64 limb planes, limb i
// of element j at plane[i * n + j].  The planes hold tight limbs, as
// every ops/f25519 function returns them.
FD_FN void fe_load(fe &r, const int64_t *plane, long long n, long long j) {
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = (uint32_t)plane[i * n + j];
}

FD_FN void fe_store(int64_t *plane, long long n, long long j, const fe &a) {
#pragma unroll
  for (int i = 0; i < 10; i++) plane[i * n + j] = a.v[i];
}

FD_FN void ge_load(ge &p, const int64_t *x, const int64_t *y,
                   const int64_t *z, const int64_t *t, long long n,
                   long long j) {
  fe_load(p.X, x, n, j);
  fe_load(p.Y, y, n, j);
  fe_load(p.Z, z, n, j);
  fe_load(p.T, t, n, j);
}

// Point decompression (fd_ed25519_point_frombytes) with the small-order
// test (fd_ed25519_affine_is_small_order), shared by the verify tail and
// the decompress kernel.  y is the encoded y (bit 255 dropped, a value >=
// p kept as it is); x = sqrt(u / v) for u = y^2 - 1, v = d y^2 + 1, then
// negated when its parity differs from the sign bit.  Returns whether the
// square root exists; x is unspecified where it does not.  small: x = 0,
// or canonical y in {0, y8_0, y8_1} (the affine points of order <= 8).
// The decompress kernel inlines the body (ge_frombytes_inl); the verify
// tail calls it out of line (ge_frombytes).
FD_FN bool ge_frombytes_inl(fe &x, fe &y, bool &small, const uint8_t *b,
                            const fe &d, const fe &sqrt_m1, const fe &y8_0,
                            const fe &y8_1) {
  fe yy, u, v, one, yc, zero;
  fe_set(one, 1);
  fe_frombytes(y, b);
  fe_sqr(yy, y);
  fe_sub(u, yy, one);
  fe_mul(v, yy, d);
  fe_add(v, v, one);
  const bool ok = fe_sqrt_ratio(x, u, v, sqrt_m1);
  if (fe_sgn(x) != (uint32_t)(b[31] >> 7)) fe_neg(x, x);
  fe_canonical(yc, y);
  fe_set(zero, 0);
  small = fe_iszero(x) || fe_eq_canon(yc, zero) || fe_eq_canon(yc, y8_0) ||
          fe_eq_canon(yc, y8_1);
  return ok;
}

// A canonical y is one of the five small-order y values {0, 1, -1,
// y8_0, y8_1}: the byte test of R in the strict finish (r_check.cu) and
// the antipa tail, which rejects R by its encoding, as the JAX graph does.
FD_FN bool ge_small_y(const fe &yc, const fe &y8_0, const fe &y8_1) {
  fe one, m1, zero;
  fe_set(one, 1);
  fe_set(zero, 0);
  fe_neg(m1, one);
  fe_canonical(m1, m1);
  return fe_eq_canon(yc, zero) || fe_eq_canon(yc, one) ||
         fe_eq_canon(yc, m1) || fe_eq_canon(yc, y8_0) ||
         fe_eq_canon(yc, y8_1);
}

GE_FN bool ge_frombytes(fe &x, fe &y, bool &small, const uint8_t *b,
                        const fe &d, const fe &sqrt_m1, const fe &y8_0,
                        const fe &y8_1) {
  return ge_frombytes_inl(x, y, small, b, d, sqrt_m1, y8_0, y8_1);
}
