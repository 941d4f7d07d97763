// The double-scalar multiply of the split and unfused strict layouts:
// two entry points over the chain that the fused tail runs too
// (dsm_chain.cuh).
//
// Replaces, in firedancer_tpu/ops/curve_pallas.py:
//   fd_dsm_tail_q   dsm_tail_q (_dsm_tail_q_kernel): signed windows
//                   (smag, ssgn, kmag, ksgn) and a point A ->
//                   Q = [s]B + [k](-A), A negated here, and the
//                   projective y-compare Q.Y == y_R Q.Z; writes ok_y and
//                   Q's X and Z.  Four threads per signature
//                   (ge_dsm_chain4), as in the fused tail;
//   fd_dsm_base     double_scalar_mul_base (_dsm_kernel): unsigned
//                   windows s, k and a point A -> [s]B + [k]A, recoded
//                   here (sc_signed_windows: the carry out of the top
//                   window is dropped, as torch drops it), then one add of
//                   the identity so that T is valid again: X, Y, Z, T.
//                   One thread per signature (ge_dsm_chain).
// A is any point in extended coordinates (Z need not be 1), read from
// (10, n) int64 planes (ge_load); windows are uint8 (64, n) planes,
// window w of lane j at w * n + j; outputs are (10, n) int64 planes.
//
// What bounds it: operations.  A lane does the chain of the fused tail
// without its decompression: about 1,800 field products and 1,024
// squarings (the [0..8]A table 72, 64 windows of four doublings, a Niels
// add and an affine add) against 656 bytes read (dsm_tail_q).  What the
// design does about it: fd_dsm_tail_q runs the fused tail's design
// (verify_tail.cu): a lane is a group of four threads that makes each
// round of the formulas' four products side by side, shorter in latency
// and larger in work than one thread per lane; every rank loads the
// lane's windows and A itself, rank 0 writes ok_y and X and rank 1 Z,
// each rank's column of the [0..8](-A) table lies in shared memory, and
// blocks are one warp of 8 lanes.  fd_dsm_base keeps one thread per
// lane: its accumulator in registers, its table in local memory (1.4
// KB).  Both stage [0..8]B and the constants into shared memory once per
// block.

#include "dsm_chain.cuh"
#include "sc25519.cuh"

// dsm_tail_q, one lane on one thread (the one-thread chain, which the
// host tests hold the four-rank one against): returns ok_y; writes Q's X
// and Z.
FD_FN bool dsm_tail_q_lane(const vt_consts &c, const uint8_t *smag,
                           const uint8_t *ssgn, const uint8_t *kmag,
                           const uint8_t *ksgn, const ge &a, const fe &y_r,
                           fe &qx, fe &qz) {
  ge na = a, q;
  fe_neg(na.X, a.X);
  fe_neg(na.T, a.T);
  ge_dsm_chain(q, na, smag, ssgn, kmag, ksgn, c);
  return dsm_y_compare(q, y_r, qx, qz);
}

// dsm_tail_q for rank r0 of the lane (on the host: all four ranks, r0 =
// 0); tab as ge_dsm_chain4 takes it.  Every rank returns the same.
FD_FN bool dsm_tail_q_lane4(const vt_consts &c, const uint8_t *smag,
                            const uint8_t *ssgn, const uint8_t *kmag,
                            const uint8_t *ksgn, const ge &a, const fe &y_r,
                            fe &qx, fe &qz, uint32_t *tab, int r0) {
  ge na = a, q;
  fe_neg(na.X, a.X);
  fe_neg(na.T, a.T);
  ge_dsm_chain4(q, na, smag, ssgn, kmag, ksgn, c, tab, r0);
  return dsm_y_compare(q, y_r, qx, qz);
}

// double_scalar_mul_base, one lane: q = [s]B + [k]A with a valid T.
FD_FN void dsm_base_lane(const vt_consts &c, const uint8_t *s_win,
                         const uint8_t *k_win, const ge &a, ge &q) {
  uint8_t smag[64], ssgn[64], kmag[64], ksgn[64];
  sc_signed_windows(smag, ssgn, s_win);
  sc_signed_windows(kmag, ksgn, k_win);
  ge_dsm_chain(q, a, smag, ssgn, kmag, ksgn, c);
  // the chain leaves T stale; adding the identity (1, 1, 1, 0) in Niels
  // form gives (4XZ, 4YZ, 4Z^2, 4XY): the same point, T valid
  fe one, zero;
  fe_set(one, 1);
  fe_set(zero, 0);
  ge_add_niels(q, q, one, one, one, zero);
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define DSM_THREADS 32                // one warp
#define DSM_LANES4 (DSM_THREADS / 4)  // fd_dsm_tail_q: 8 lanes of 4 ranks
static_assert(DSM_THREADS == G4_TAB_STRIDE, "tab is [entry][limb][thread]");

__device__ void dsm_stage_consts(vt_consts &c, const int32_t *consts) {
  uint32_t *cw = &c.base[0][0].v[0];
  for (int i = threadIdx.x; i < VT_NCONST * 10; i += blockDim.x)
    cw[i] = (uint32_t)consts[i];
  __syncthreads();
}

// Window plane p of lane j: window w at wins[(p * 64 + w) * n + j].
__device__ void dsm_load_wins(uint8_t *out, const uint8_t *wins, int p,
                              long long n, long long j) {
  for (int w = 0; w < 64; w++) out[w] = wins[((long long)p * 64 + w) * n + j];
}

// Four threads a lane, 8 lanes a block; a partial last block runs its
// spare groups on the last lane and drops their results.
__global__ void __launch_bounds__(DSM_THREADS)
    dsm_tail_q_kernel(const uint8_t *wins, const int64_t *ax,
                      const int64_t *ay, const int64_t *az,
                      const int64_t *at, const int64_t *yr,
                      const int32_t *consts, int n, uint8_t *ok,
                      int64_t *x_out, int64_t *z_out) {
  __shared__ vt_consts c;
  __shared__ uint32_t tab[G4_TAB_WORDS * DSM_THREADS];
  dsm_stage_consts(c, consts);
  const long long g = (long long)blockIdx.x * DSM_LANES4 + threadIdx.x / 4;
  const long long lane = g < n ? g : n - 1;
  const int rank = threadIdx.x & 3;
  uint8_t w[4][64];
  for (int p = 0; p < 4; p++) dsm_load_wins(w[p], wins, p, n, lane);
  ge a;
  ge_load(a, ax, ay, az, at, n, lane);
  fe y_r, qx, qz;
  fe_load(y_r, yr, n, lane);
  const bool ok_l = dsm_tail_q_lane4(c, w[0], w[1], w[2], w[3], a, y_r, qx,
                                     qz, tab + threadIdx.x, rank);
  if (g >= n) return;
  if (rank == 0) {
    ok[lane] = ok_l;
    fe_store(x_out, n, lane, qx);
  } else if (rank == 1) {
    fe_store(z_out, n, lane, qz);
  }
}

__global__ void __launch_bounds__(DSM_THREADS)
    dsm_base_kernel(const uint8_t *wins, const int64_t *ax,
                    const int64_t *ay, const int64_t *az, const int64_t *at,
                    const int32_t *consts, int n, int64_t *x_out,
                    int64_t *y_out, int64_t *z_out, int64_t *t_out) {
  __shared__ vt_consts c;
  dsm_stage_consts(c, consts);
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint8_t w[2][64];
  for (int p = 0; p < 2; p++) dsm_load_wins(w[p], wins, p, n, lane);
  ge a, q;
  ge_load(a, ax, ay, az, at, n, lane);
  dsm_base_lane(c, w[0], w[1], a, q);
  fe_store(x_out, n, lane, q.X);
  fe_store(y_out, n, lane, q.Y);
  fe_store(z_out, n, lane, q.Z);
  fe_store(t_out, n, lane, q.T);
}

// wins: uint8 (4, 64, n) = smag, ssgn, kmag, ksgn.
extern "C" int fd_dsm_tail_q(const uint8_t *wins, const int64_t *ax,
                             const int64_t *ay, const int64_t *az,
                             const int64_t *at, const int64_t *yr,
                             const int32_t *consts, int n, uint8_t *ok,
                             int64_t *x_out, int64_t *z_out, void *stream) {
  const int blocks = (n + DSM_LANES4 - 1) / DSM_LANES4;
  dsm_tail_q_kernel<<<blocks, DSM_THREADS, 0, (cudaStream_t)stream>>>(
      wins, ax, ay, az, at, yr, consts, n, ok, x_out, z_out);
  return (int)cudaGetLastError();
}

// wins: uint8 (2, 64, n) = s windows, k windows (unsigned 4-bit).
extern "C" int fd_dsm_base(const uint8_t *wins, const int64_t *ax,
                           const int64_t *ay, const int64_t *az,
                           const int64_t *at, const int32_t *consts, int n,
                           int64_t *x_out, int64_t *y_out, int64_t *z_out,
                           int64_t *t_out, void *stream) {
  const int blocks = (n + DSM_THREADS - 1) / DSM_THREADS;
  dsm_base_kernel<<<blocks, DSM_THREADS, 0, (cudaStream_t)stream>>>(
      wins, ax, ay, az, at, consts, n, x_out, y_out, z_out, t_out);
  return (int)cudaGetLastError();
}
#endif
