// Fused strict-verify tail: one thread per signature.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::verify_tail_fused
// (_fused_tail_kernel).  Per lane: decompress A and test it for small
// order, test S < L, reduce the SHA-512 digest k mod L, recode S and k to
// signed 4-bit digits (sc_reduce_recode in sc25519.cuh), run the shared
// chain Q = [S]B + [k](-A) over 64 windows (ge_dsm_chain in
// dsm_chain.cuh), and compare Q.Y with y_R * Q.Z.  The split layout runs
// the same helpers as separate kernels (reduce_recode.cu, dsm.cu).
// Writes the folded ok bit and Q's X and Z as (10, n) int64 limb planes
// (ops/f25519.py layout); the x-parity half of the R check runs in torch
// (ed25519._compressed_r_check).
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

#include "dsm_chain.cuh"
#include "fe25519.cuh"
#include "ge25519.cuh"
#include "sc25519.cuh"

// The whole tail for one lane.  Returns the ok bit; writes Q's X and Z.
FD_FN bool vt_lane(const vt_consts &c, const uint8_t *pub, const uint8_t *s,
                   const uint8_t *digest, const uint8_t *r, fe &qx, fe &qz) {
  // ---- A: decompress and small-order test; -A = (-x, y, 1, -x y)
  ge na;
  bool small;
  const bool ok_a =
      ge_frombytes(na.X, na.Y, small, pub, c.d, c.sqrt_m1, c.y8_0, c.y8_1);
  fe_neg(na.X, na.X);
  fe_set(na.Z, 1);
  fe_mul(na.T, na.X, na.Y);

  // ---- scalars: S < L, k = digest mod L, signed windows of both
  uint8_t smag[64], ssgn[64], kmag[64], ksgn[64];
  const bool ok_s = sc_reduce_recode(s, digest, smag, ssgn, kmag, ksgn);

  // ---- Q = [S]B + [k](-A), then the projective y-compare against R's
  // encoded y (mod p)
  ge acc;
  ge_dsm_chain(acc, na, smag, ssgn, kmag, ksgn, c);
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
  fe_store(x_out, n, lane, qx);
  fe_store(z_out, n, lane, qz);
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
