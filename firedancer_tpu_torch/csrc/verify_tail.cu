// Fused strict-verify tail: one thread per signature.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::verify_tail_fused
// (_fused_tail_kernel).  Per lane: decompress A and test it for small
// order, test S < L, reduce the SHA-512 digest k mod L, recode S and k to
// signed 4-bit digits, run the shared chain Q = [S]B + [k](-A) over 64
// windows, and compare Q.Y with y_R * Q.Z.  Writes the folded ok bit and
// Q's X and Z as (10, n) int64 limb planes (ops/f25519.py layout); the
// x-parity half of the R check runs in torch (ed25519._compressed_r_check).
//
// Field arithmetic: 10 x 25.5-bit uint32 limbs with uint64 products
// (fe25519.cuh).
//
// What bounds it: operations.  A lane does about 3,100 field products
// (the 64-window chain, the A table and the square-root chain) of 100
// 32x32->64 multiply-adds each, and reads 160 bytes.  What the design does
// about it: every intermediate stays in the thread (registers, and the
// per-lane [0..8](-A) Niels table in local memory, 1.4 KB); [0..8]B and
// the curve constants are staged into shared memory once per block, so a
// lane's data-dependent pick of a base entry is a shared-memory read, not
// a serialised constant-cache read.  Doublings skip T where the next step
// never reads it, as the TPU kernel does.  Small blocks (VT_THREADS) keep
// a batch of a few thousand lanes spread over all SMs.

#include "fe25519.cuh"
#include "ge25519.cuh"
#include "sc25519.cuh"

// Constants table, int32 (VT_NCONST, 10) limb rows:
//   rows 4i .. 4i+3: [i]B as (y - x, y + x, 2dxy, -2dxy), i = 0..8
//   rows 36..40:     d, 2d, sqrt(-1), and the two order-8 y values
#define VT_NCONST 41

struct vt_consts {
  fe base[9][4];
  fe d, d2, sqrt_m1, y8_0, y8_1;
};

// The whole tail for one lane.  Returns the ok bit; writes Q's X and Z.
FD_FN bool vt_lane(const vt_consts &c, const uint8_t *pub, const uint8_t *s,
                   const uint8_t *digest, const uint8_t *r, fe &qx, fe &qz) {
  // ---- A: decompress and small-order test
  fe y, yy, u, v, x, one;
  fe_set(one, 1);
  fe_frombytes(y, pub);
  fe_sqr(yy, y);
  fe_sub(u, yy, one);
  fe_mul(v, yy, c.d);
  fe_add(v, v, one);
  const bool ok_a = fe_sqrt_ratio(x, u, v, c.sqrt_m1);
  if (fe_sgn(x) != (uint32_t)(pub[31] >> 7)) fe_neg(x, x);
  fe yc;
  fe_canonical(yc, y);
  fe zero;
  fe_set(zero, 0);
  const bool small = fe_iszero(x) || fe_eq_canon(yc, zero) ||
                     fe_eq_canon(yc, c.y8_0) || fe_eq_canon(yc, c.y8_1);

  // ---- the [0..8](-A) table in Niels form
  ge na, pt;
  fe_neg(na.X, x);
  na.Y = y;
  na.Z = one;
  fe_mul(na.T, na.X, y);
  ge_niels tab[9];
  ge_identity(pt);
  ge_to_niels(tab[0], pt, c.d2);
  ge_to_niels(tab[1], na, c.d2);
  pt = na;
  for (int i = 2; i < 9; i++) {
    ge nxt;
    ge_add(nxt, pt, na, c.d2);
    ge_to_niels(tab[i], nxt, c.d2);
    pt = nxt;
  }

  // ---- scalars: S < L, k = digest mod L, signed digits of both
  const bool ok_s = sc_is_canonical(s);
  int64_t kl[22];
  sc_reduce512(kl, digest);
  uint8_t nib[64];
  int8_t kd[64], sd[64];
  for (int w = 0; w < 64; w++)
    nib[w] = (uint8_t)((kl[w / 3] >> (4 * (w % 3))) & 0xf);
  sc_signed_digits(kd, nib);
  for (int i = 0; i < 32; i++) {
    nib[2 * i] = s[i] & 0xf;
    nib[2 * i + 1] = s[i] >> 4;
  }
  sc_signed_digits(sd, nib);

  // ---- shared chain, high window first
  ge acc;
  ge_identity(acc);
  for (int w = 63; w >= 0; w--) {
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, true);
    const int kdw = kd[w], km = kdw < 0 ? -kdw : kdw;
    const ge_niels &e = tab[km];
    if (kdw < 0) {
      fe nt;
      fe_neg(nt, e.T2d);
      ge_add_niels(acc, acc, e.Yp, e.Ym, e.Z, nt);
    } else {
      ge_add_niels(acc, acc, e.Ym, e.Yp, e.Z, e.T2d);
    }
    const int sdw = sd[w], sm = sdw < 0 ? -sdw : sdw;
    const fe *b = c.base[sm];
    if (sdw < 0)
      ge_add_affine_niels(acc, acc, b[1], b[0], b[3], false);
    else
      ge_add_affine_niels(acc, acc, b[0], b[1], b[2], false);
  }

  // ---- projective y-compare against R's encoded y (mod p)
  fe yr, t;
  fe_frombytes(yr, r);
  fe_mul(t, yr, acc.Z);
  const bool ok_y = fe_eq(acc.Y, t);
  qx = acc.X;
  qz = acc.Z;
  return ok_a && !small && ok_s && ok_y;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define VT_THREADS 32

__global__ void __launch_bounds__(VT_THREADS)
    verify_tail_kernel(const uint8_t *pub, long long pub_stride,
                       const uint8_t *s, long long s_stride,
                       const uint8_t *digest, long long digest_stride,
                       const uint8_t *r, long long r_stride,
                       const int32_t *consts, int n, uint8_t *ok,
                       int64_t *x_out, int64_t *z_out) {
  __shared__ vt_consts c;
  uint32_t *cw = &c.base[0][0].v[0];
  for (int i = threadIdx.x; i < VT_NCONST * 10; i += blockDim.x)
    cw[i] = (uint32_t)consts[i];
  __syncthreads();
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  fe qx, qz;
  ok[lane] = vt_lane(c, pub + lane * pub_stride, s + lane * s_stride,
                     digest + lane * digest_stride, r + lane * r_stride, qx,
                     qz);
  for (int i = 0; i < 10; i++) {
    x_out[i * (long long)n + lane] = qx.v[i];
    z_out[i * (long long)n + lane] = qz.v[i];
  }
}

extern "C" int fd_verify_tail(const uint8_t *pub, long long pub_stride,
                              const uint8_t *s, long long s_stride,
                              const uint8_t *digest, long long digest_stride,
                              const uint8_t *r, long long r_stride,
                              const int32_t *consts, int n, uint8_t *ok,
                              int64_t *x_out, int64_t *z_out, void *stream) {
  const int blocks = (n + VT_THREADS - 1) / VT_THREADS;
  verify_tail_kernel<<<blocks, VT_THREADS, 0, (cudaStream_t)stream>>>(
      pub, pub_stride, s, s_stride, digest, digest_stride, r, r_stride,
      consts, n, ok, x_out, z_out);
  return (int)cudaGetLastError();
}
#endif
