// The strict verify's finish: one thread per signature.
//
// Replaces the XLA step that follows the Pallas kernels in the JAX
// package, firedancer_tpu/ops/ed25519.py::_compressed_r_check with its
// tree-shaped batch inversion (firedancer_tpu/ops/f25519.py::batch_inv).
// All three strict layouts end with it (ops/ed25519.py).  Per lane: R's
// encoded y taken mod p, its sign bit and the small-order test (y in {0,
// 1, -1, y8_0, y8_1}); z_ok = Q.Z != 0 mod p; zi = Q.Z^(p - 2) (one where
// Q.Z is 0); the canonical affine x = Q.X zi and its parity; in the
// unfused layout also the y-compare Q.Y zi == y_R mod p (the fused and
// split layouts' kernels made it and pass ok_y).  Writes
// z_ok & !small & ok_y & (parity == sign) as one byte.
//
// Inputs: Q.X, Q.Z (and Q.Y) as (10, n) int64 limb planes (ops/f25519.py
// layout), as verify_tail, dsm_tail_q and double_scalar_mul_base write
// them; every limb is taken mod p on load, so any limb below 2^31 is
// read right.  R as a row view of any stride, 32 bytes a row.
//
// What bounds it: the latency of one dependent chain.  The inverse is
// 254 squarings and 11 products in series (fe_inv), against 160 to 240
// bytes read and 1 written a lane, so the card's rate allows a few
// microseconds at 4,096 lanes; but those lanes are 128 warps, about one
// an SM, and each warp runs its chain at the latency of a field
// squaring.  What the design does about it: nothing yet beyond keeping
// every intermediate in registers; the inverse is per lane (Fermat), so
// there is no cross-lane tree and one launch does the whole finish.  The
// inverse is unique, so the affine x, and the bit, do not depend on how
// it was computed: the plain version's Montgomery batch inversion gives
// the same bits.  Blocks are one warp, so a batch spreads over all SMs.

#include "fe25519.cuh"
#include "ge25519.cuh"

// Constants table, int32 (RC_NCONST, 10) limb rows: the two order-8 y
// values.
#define RC_NCONST 2

struct rc_consts {
  fe y8_0, y8_1;
};

// One lane.  qy is null where the caller's kernel made the y-compare
// (ok_y); otherwise ok_y is ignored and the compare runs here.
FD_FN bool rc_lane(const rc_consts &c, const fe &qx_in, const fe &qz_in,
                   const fe *qy_in, bool ok_y, const uint8_t *r) {
  fe yr, one, m1, zero, qx, qz, zi, x, t;
  fe_set(one, 1);
  fe_set(zero, 0);
  fe_neg(m1, one);
  fe_canonical(m1, m1);
  fe_frombytes(yr, r);
  fe_canonical(yr, yr);       // R's encoded y, mod p
  const uint32_t sign = r[31] >> 7;
  const bool small = fe_eq_canon(yr, zero) || fe_eq_canon(yr, one) ||
                     fe_eq_canon(yr, m1) || fe_eq_canon(yr, c.y8_0) ||
                     fe_eq_canon(yr, c.y8_1);
  fe_canonical(qx, qx_in);
  fe_canonical(qz, qz_in);
  const bool z_ok = !fe_eq_canon(qz, zero);
#pragma unroll
  for (int i = 0; i < 10; i++) t.v[i] = z_ok ? qz.v[i] : one.v[i];
  fe_inv(zi, t);
  fe_mul(x, qx, zi);
  if (qy_in != nullptr) {
    fe qy;
    fe_canonical(qy, *qy_in);
    fe_mul(t, qy, zi);
    ok_y = fe_eq(t, yr);
  }
  return z_ok && !small && ok_y && fe_sgn(x) == sign;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define RC_THREADS 32             // one warp a block

__global__ void __launch_bounds__(RC_THREADS)
    r_check_kernel(const int64_t *qx, const int64_t *qz, const int64_t *qy,
                   const uint8_t *ok_y, const uint8_t *r, long long r_stride,
                   const int32_t *consts, int n, uint8_t *out) {
  const long long j = (long long)blockIdx.x * RC_THREADS + threadIdx.x;
  if (j >= n) return;
  rc_consts c;
  uint32_t *cw = &c.y8_0.v[0];
#pragma unroll
  for (int i = 0; i < RC_NCONST * 10; i++) cw[i] = (uint32_t)consts[i];
  fe x, z, y;
  fe_load(x, qx, n, j);
  fe_load(z, qz, n, j);
  bool oky = true;
  if (qy != nullptr)
    fe_load(y, qy, n, j);
  else
    oky = ok_y[j] != 0;
  out[j] = rc_lane(c, x, z, qy != nullptr ? &y : nullptr, oky,
                   r + j * r_stride);
}

// ok_y or qy, the other null.
extern "C" int fd_r_check(const int64_t *qx, const int64_t *qz,
                          const int64_t *qy, const uint8_t *ok_y,
                          const uint8_t *r, long long r_stride,
                          const int32_t *consts, int n, uint8_t *out,
                          void *stream) {
  const int blocks = (n + RC_THREADS - 1) / RC_THREADS;
  r_check_kernel<<<blocks, RC_THREADS, 0, (cudaStream_t)stream>>>(
      qx, qz, qy, ok_y, r, r_stride, consts, n, out);
  return (int)cudaGetLastError();
}
#endif
