// Fused strict-verify tail: four threads per signature.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::verify_tail_fused
// (_fused_tail_kernel).  Per lane: decompress A and test it for small
// order, test S < L, reduce the SHA-512 digest k mod L, recode S and k to
// signed 4-bit digits (sc_reduce_recode in sc25519.cuh), run the shared
// chain Q = [S]B + [k](-A) over 64 windows (g4_dsm_chain in
// dsm_chain.cuh), and compare Q.Y with y_R * Q.Z.  The split layout runs
// the same helpers as separate kernels (reduce_recode.cu, dsm.cu).
// Writes the folded ok bit and Q's X and Z as (10, n) int64 limb planes
// (ops/f25519.py layout); the x-parity half of the R check runs in the
// r_check kernel (r_check.cu).
//
// Field arithmetic: 10 x 25.5-bit uint32 limbs with uint64 products
// (fe25519.cuh).
//
// What bounds it: operations.  A lane does about 3,100 field products
// (the 64-window chain, the A table and the square-root chain) of 100
// 32x32->64 multiply-adds each, and reads 160 bytes.  One thread per
// lane would run them as a strictly serial chain (16 squarings and 27
// products a window), so a batch of a few thousand lanes, one warp per
// SM, would be bound by that chain's latency, not by the card's rate.
// What the design does about it: a lane is a group of four threads
// (g4_dsm_chain), rank q holding coordinate q of the lane's points (X,
// Y, Z, T) and making the products whose results it owns, 12 rounds a
// window instead of 43 products in series, with four times the warps to
// hide latency.  Operands move between ranks by warp shuffles with a
// rank-dependent source, and each addition is made only by the ranks
// that read it, so the four ranks between them issue about the
// one-thread chain's products and additions (48 products a window
// against 43), plus the shuffles and the rank selects.  The
// decompression and the scalar steps run on all four ranks alike, which
// needs no hand-over; rank 0 writes X, rank 2 (which makes the
// y-compare) ok and Z.  Each rank keeps its column of the [0..8](-A)
// Niels table in shared memory (11.5 KB a block); [0..8]B and the curve
// constants are staged there once per block, so a lane's data-dependent
// pick of an entry is a shared-memory read.  Doublings skip T where the next step
// never reads it, as the TPU kernel does.  Blocks are one warp (8
// lanes), so a batch of 4,096 lanes gives 512 warps, about 4 an SM.

#include "dsm_chain.cuh"
#include "fe25519.cuh"
#include "ge25519.cuh"
#include "sc25519.cuh"

// A and the scalars of one lane: -A = (-x, y, 1, -x y) and the signed
// windows of S and k (w: smag, ssgn, kmag, ksgn).  Returns the folded
// ok bit of A's decompression, its small-order test and S < L.
FD_FN bool vt_prepare(const vt_consts &c, const uint8_t *pub,
                      const uint8_t *s, const uint8_t *digest, ge &na,
                      uint8_t w[4][64]) {
  bool small;
  const bool ok_a =
      ge_frombytes(na.X, na.Y, small, pub, c.d, c.sqrt_m1, c.y8_0, c.y8_1);
  fe_neg(na.X, na.X);
  fe_set(na.Z, 1);
  fe_mul(na.T, na.X, na.Y);
  const bool ok_s = sc_reduce_recode(s, digest, w[0], w[1], w[2], w[3]);
  return ok_a && !small && ok_s;
}

// The whole tail for rank r0 of the lane (on the host: all four ranks,
// r0 = 0); tab as g4_dsm_chain takes it.  q gets Q in the layout (X on
// rank 0, Z on rank 2), ok the folded ok bit (rank 2's counts).
FD_FN void vt_lane4(const vt_consts &c, const uint8_t *pub, const uint8_t *s,
                    const uint8_t *digest, const uint8_t *r, fe *q,
                    bool *ok, uint32_t *tab, int r0) {
  ge na;
  fe p[G4_RANKS];
  uint8_t w[4][64];
  const bool ok_a = vt_prepare(c, pub, s, digest, na, w);
  g4_from_ge(p, na, r0);
  g4_dsm_chain(q, p, w[0], w[1], w[2], w[3], c, tab, r0);
  fe yr;
  fe_frombytes(yr, r);      // R's encoded y, mod p
  g4_y_compare(ok, q, yr, r0);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) ok[i] = ok[i] && ok_a;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define VT_THREADS 32             // one warp: 8 lanes of 4 ranks
#define VT_LANES (VT_THREADS / 4)
static_assert(VT_THREADS == G4_TAB_STRIDE, "tab is [entry][limb][thread]");

__global__ void __launch_bounds__(VT_THREADS)
    verify_tail_kernel(const uint8_t *pub, long long pub_stride,
                       const uint8_t *s, long long s_stride,
                       const uint8_t *digest, long long digest_stride,
                       const uint8_t *r, long long r_stride,
                       const int32_t *consts, int n, uint8_t *ok,
                       int64_t *x_out, int64_t *z_out) {
  __shared__ vt_consts c;
  __shared__ uint32_t tab[G4_TAB_WORDS * VT_THREADS];
  uint32_t *cw = &c.base[0][0].v[0];
  for (int i = threadIdx.x; i < VT_NCONST * 10; i += blockDim.x)
    cw[i] = (uint32_t)consts[i];
  __syncthreads();
  // a partial last block runs its spare groups on the last lane and
  // drops their results: every thread of the warp takes part in every
  // shuffle
  const long long g = (long long)blockIdx.x * VT_LANES + threadIdx.x / 4;
  const long long lane = g < n ? g : n - 1;
  const int rank = threadIdx.x & 3;
  fe q;
  bool ok_l;
  vt_lane4(c, pub + lane * pub_stride, s + lane * s_stride,
           digest + lane * digest_stride, r + lane * r_stride, &q, &ok_l,
           tab + threadIdx.x, rank);
  if (g >= n) return;
  if (rank == 0) {
    fe_store(x_out, n, lane, q);
  } else if (rank == 2) {
    ok[lane] = ok_l;
    fe_store(z_out, n, lane, q);
  }
}

extern "C" int fd_verify_tail(const uint8_t *pub, long long pub_stride,
                              const uint8_t *s, long long s_stride,
                              const uint8_t *digest, long long digest_stride,
                              const uint8_t *r, long long r_stride,
                              const int32_t *consts, int n, uint8_t *ok,
                              int64_t *x_out, int64_t *z_out, void *stream) {
  const int blocks = (n + VT_LANES - 1) / VT_LANES;
  verify_tail_kernel<<<blocks, VT_THREADS, 0, (cudaStream_t)stream>>>(
      pub, pub_stride, s, s_stride, digest, digest_stride, r, r_stride,
      consts, n, ok, x_out, z_out);
  return (int)cudaGetLastError();
}
#endif
