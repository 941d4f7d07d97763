// The strict verify's finish: a pair of threads per signature.
//
// Replaces the XLA step that follows the Pallas kernels in the JAX
// package, firedancer_tpu/ops/ed25519.py::_compressed_r_check with its
// tree-shaped batch inversion (firedancer_tpu/ops/f25519.py::batch_inv).
// All three strict layouts end with it (ops/ed25519.py).  Per lane: R's
// encoded y taken mod p, its sign bit and the small-order test (y in {0,
// 1, -1, y8_0, y8_1}); z_ok = Q.Z != 0 mod p; the canonical affine x =
// Q.X / Q.Z (Q.X where Q.Z is 0) and its parity; in the unfused layout
// also the y-compare Q.Y / Q.Z == y_R mod p, made as Q.Y == y_R Q.Z (the
// fused and split layouts' kernels made it and pass ok_y).  Writes
// z_ok & !small & ok_y & (parity == sign) as one byte.
//
// Inputs: Q.X, Q.Z (and Q.Y) as (10, n) int64 limb planes (ops/f25519.py
// layout), as verify_tail, dsm_tail_q and double_scalar_mul_base write
// them; every limb is taken mod p on load, so any limb below 2^31 is
// read right.  R as a row view of any stride, 32 bytes a row.
//
// What bounds it: the latency of one dependent chain, against 160 to 240
// bytes read and 1 written a lane.  What the design does about it:
//  - the division is a variable-time Bernstein-Yang ("safegcd") one
//    (csrc/fe25519.cuh fe_div_canon): ~530 divsteps on single words in
//    ~140 steps and 18-19 batches of matrix products, against a Fermat
//    inverse's 254 squarings and 11 products in series, each ending in
//    an 11-step 64-bit carry chain.  Q.Z comes from public
//    keys, signatures and messages, so its time is public too.  Dividing
//    X by Z at once saves the product by the inverse;
//  - a lane is a pair of threads of one warp (rc_div_pair): both run the
//    divsteps, one applies the matrices to f and g, the other to d and e,
//    so each batch's chain carries one of the two updates.  On an H100
//    at 4,096 lanes the pair took 0.0192 ms and one thread a lane 0.0223;
//    at 32,768, where issue and not the chain sets the time, 0.0342
//    against 0.0287 (PERF.md).  The main path's dispatches are the
//    former;
//  - a warp runs its batches and steps to its slowest lane's count;
//    blocks are one warp, so a batch spreads over all SMs.
// The quotient is unique, so the affine x, and the bit, do not depend on
// how it was computed: the plain version's Montgomery batch inversion
// gives the same bits.

#include "fe25519.cuh"
#include "ge25519.cuh"

// Constants table, int32 (RC_NCONST, 10) limb rows: the two order-8 y
// values.
#define RC_NCONST 2

struct rc_consts {
  fe y8_0, y8_1;
};

// A lane's inputs as the division and the finish take them: X and Z
// canonical, den = Z (1 where Z is 0), R's y mod p and its sign bit.
struct rc_in {
  fe qx, qz, den, yr;
  bool z_ok, small;
  uint32_t sign;
};

// den = Z (canonical), or 1 where Z is 0; returns Z != 0.
FD_FN bool rc_den(fe &den, const fe &qz) {
  fe one, zero;
  fe_set(one, 1);
  fe_set(zero, 0);
  const bool z_ok = !fe_eq_canon(qz, zero);
#pragma unroll
  for (int i = 0; i < 10; i++) den.v[i] = z_ok ? qz.v[i] : one.v[i];
  return z_ok;
}

FD_FN void rc_setup(rc_in &s, const rc_consts &c, const fe &qx_in,
                    const fe &qz_in, const uint8_t *r) {
  fe_frombytes(s.yr, r);
  fe_canonical(s.yr, s.yr);   // R's encoded y, mod p
  s.sign = r[31] >> 7;
  s.small = ge_small_y(s.yr, c.y8_0, c.y8_1);
  fe_canonical(s.qx, qx_in);
  fe_canonical(s.qz, qz_in);
  s.z_ok = rc_den(s.den, s.qz);
}

// The bit, from x = X / Z canonical.  Where use_qy, the y-compare runs
// here, as Y == y_R Z; otherwise ok_y is the caller's kernel's.
FD_FN bool rc_finish(const rc_in &s, const fe &x, const fe &qy_in,
                     bool use_qy, bool ok_y) {
  if (use_qy) {
    fe qy, t;
    fe_canonical(qy, qy_in);
    fe_mul(t, s.yr, s.qz);    // Y / Z == y_R, for Z != 0
    ok_y = fe_eq(t, qy);
  }
  return s.z_ok && !s.small && ok_y && (x.v[0] & 1) == s.sign;
}

// One lane on one thread (the host harness's form of the kernel's
// thread pair).  qy is null where the caller's kernel made the y-compare (ok_y).
FD_FN bool rc_lane(const rc_consts &c, const fe &qx_in, const fe &qz_in,
                   const fe *qy_in, bool ok_y, const uint8_t *r) {
  rc_in s;
  fe x;
  rc_setup(s, c, qx_in, qz_in, r);
  fe_div_canon(x, s.qx, s.den);
  return rc_finish(s, x, qy_in ? *qy_in : s.qz, qy_in != nullptr, ok_y);
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define RC_THREADS 32             // one warp a block: 16 lanes, a pair each

// x = num / den (canonical; role 1's) on the pair of threads (2k, 2k + 1)
// of the warp: role 0 holds f and g, role 1 d and e.  Both run each
// batch's divsteps on f and g's low limbs, which role 1 takes from role
// 0 by shuffle, then each applies the batch's matrix to its own pair.
// The warp runs every lane to its slowest lane's batches: after g = 0 a
// batch keeps f, and d mod p.
__device__ __forceinline__ void rc_div_pair(fe &x, const fe &num,
                                            const fe &den, int role) {
  const unsigned all = 0xffffffffu;
  const int lead = threadIdx.x & ~1;
  fe src;
#pragma unroll
  for (int i = 0; i < 10; i++) src.v[i] = role ? num.v[i] : den.v[i];
  fe_s30 a, b;
  fe_div_start(a, b, src, role == 1);
  int32_t eta = -1;
  for (int k = 0; k < FE_DIV_BATCHES; k++) {
    eta = fe_div_batch(a, b, eta, __shfl_sync(all, (uint32_t)a.v[0], lead),
                       __shfl_sync(all, (uint32_t)b.v[0], lead), role == 1);
    int32_t nz = 0;
#pragma unroll
    for (int i = 0; i < 9; i++) nz |= b.v[i];
    if (__all_sync(all, __shfl_sync(all, nz, lead) == 0)) break;
  }
  fe_s30_normalize(a, __shfl_sync(all, a.v[8], lead));
  fe_from_s30(x, a);
}

__global__ void __launch_bounds__(RC_THREADS)
    r_check_kernel(const int64_t *qx, const int64_t *qz, const int64_t *qy,
                   const uint8_t *ok_y, const uint8_t *r, long long r_stride,
                   const int32_t *consts, int n, uint8_t *out) {
  const long long j = ((long long)blockIdx.x * RC_THREADS + threadIdx.x) >> 1;
  const int role = threadIdx.x & 1;
  const long long at = j < n ? j : 0;  // pairs past n rerun lane 0
  rc_consts c;
  uint32_t *cw = &c.y8_0.v[0];
#pragma unroll
  for (int i = 0; i < RC_NCONST * 10; i++) cw[i] = (uint32_t)consts[i];
  fe x, z, y;
  fe_load(x, qx, n, at);
  fe_load(z, qz, n, at);
  bool oky = true;
  if (qy != nullptr)
    fe_load(y, qy, n, at);
  else
    oky = ok_y[at] != 0;
  rc_in s;
  rc_setup(s, c, x, z, r + at * r_stride);
  rc_div_pair(x, s.qx, s.den, role);
  if (j < n && role == 1) out[j] = rc_finish(s, x, y, qy != nullptr, oky);
}

// ok_y or qy, the other null.
extern "C" int fd_r_check(const int64_t *qx, const int64_t *qz,
                          const int64_t *qy, const uint8_t *ok_y,
                          const uint8_t *r, long long r_stride,
                          const int32_t *consts, int n, uint8_t *out,
                          void *stream) {
  const int blocks = (int)((2LL * n + RC_THREADS - 1) / RC_THREADS);
  r_check_kernel<<<blocks, RC_THREADS, 0, (cudaStream_t)stream>>>(
      qx, qz, qy, ok_y, r, r_stride, consts, n, out);
  return (int)cudaGetLastError();
}
#endif
