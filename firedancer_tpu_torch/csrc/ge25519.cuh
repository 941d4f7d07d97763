// ed25519 point arithmetic (twisted Edwards, a = -1) for one lane per
// thread, over fe25519.cuh.  The formulas and their order are those of
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

// p + q with q affine (Z = 1) in Niels form.  want_t = false skips T.
GE_FN void ge_add_affine_niels(ge &r, const ge &p, const fe &ym,
                               const fe &yp, const fe &t2d, bool want_t) {
  fe a, b, c, zz, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, ym);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, yp);
  fe_mul(c, p.T, t2d);
  fe_add(zz, p.Z, p.Z);
  ge_finish(r, a, b, c, zz, want_t);
}
