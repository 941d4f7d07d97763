// The double-scalar multiply of the split and unfused strict layouts:
// two entry points over the chain that the fused tail runs too
// (dsm_chain.cuh).
//
// Replaces, in firedancer_tpu/ops/curve_pallas.py:
//   fd_dsm_tail_q   dsm_tail_q (_dsm_tail_q_kernel): signed windows
//                   (smag, ssgn, kmag, ksgn) and a point A ->
//                   Q = [s]B + [k](-A), A negated here, and the
//                   projective y-compare Q.Y == y_R Q.Z; writes ok_y and
//                   Q's X and Z;
//   fd_dsm_base     double_scalar_mul_base (_dsm_kernel): unsigned
//                   windows s, k and a point A -> [s]B + [k]A, recoded
//                   here (sc_signed_windows: the carry out of the top
//                   window is dropped, as torch drops it), then one add of
//                   the identity so that T is valid again: X, Y, Z, T.
// A is any point in extended coordinates (Z need not be 1), read from
// (10, n) int64 planes; windows are uint8 (64, n) planes, window w of
// lane j at w * n + j; outputs are (10, n) int64 planes.
//
// What bounds it: operations.  A lane does the chain of the fused tail
// without its decompression: about 1,800 field products and 1,024
// squarings (the [0..8]A table 72, 64 windows of four doublings, a Niels
// add and an affine add) against 656 bytes read (dsm_tail_q).  What the
// design does about it: both entries run the fused tail's design
// (verify_tail.cu): a lane is a group of four threads, rank q holding
// coordinate q of the lane's points and making the products whose
// results it owns (g4_dsm_chain); every rank loads the lane's windows
// and its own coordinate of A, each rank's column of the [0..8]A table
// lies in shared memory, and blocks are one warp of 8 lanes.  Each rank
// writes the coordinate it holds: rank 0 X, rank 1 Y, rank 2 Z (and
// dsm_tail_q's ok_y, which rank 2 computes), rank 3 T.  Both stage
// [0..8]B and the constants into shared memory once per block.

#include "dsm_chain.cuh"
#include "sc25519.cuh"

// dsm_tail_q for rank r0 of the lane (on the host: all four ranks, r0 =
// 0); a holds rank r0 + i's coordinate of A at i, tab as g4_dsm_chain
// takes it.  q gets Q in the layout, ok the y-compare (rank 2's counts).
FD_FN void dsm_tail_q_lane4(const vt_consts &c, const uint8_t *smag,
                            const uint8_t *ssgn, const uint8_t *kmag,
                            const uint8_t *ksgn, const fe *a, const fe &y_r,
                            fe *q, bool *ok, uint32_t *tab, int r0) {
  fe na[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int r = r0 + i;
    fe n;
    fe_neg(n, a[i]);
    g4_pick(na[i], r == 0 || r == 3, n, a[i]);   // -A = (-X, Y, Z, -T)
  }
  g4_dsm_chain(q, na, smag, ssgn, kmag, ksgn, c, tab, r0);
  g4_y_compare(ok, q, y_r, r0);
}

// double_scalar_mul_base for rank r0 of the lane, as dsm_tail_q_lane4:
// q gets [s]B + [k]A with a valid T, in the layout.
FD_FN void dsm_base_lane4(const vt_consts &c, const uint8_t *s_win,
                          const uint8_t *k_win, const fe *a, fe *q,
                          uint32_t *tab, int r0) {
  uint8_t smag[64], ssgn[64], kmag[64], ksgn[64];
  sc_signed_windows(smag, ssgn, s_win);
  sc_signed_windows(kmag, ksgn, k_win);
  g4_dsm_chain(q, a, smag, ssgn, kmag, ksgn, c, tab, r0);
  // the chain leaves T stale; adding the identity (1, 1, 1, 0) in Niels
  // form gives (4XZ, 4YZ, 4Z^2, 4XY): the same point, T valid
  fe col[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) fe_set(col[i], r0 + i != 3);
  g4_add_niels_cols(q, r0, col, false);
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define DSM_THREADS 32                // one warp: 8 lanes of 4 ranks
#define DSM_LANES4 (DSM_THREADS / 4)
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

// The plane of coordinate rank among four.
template <typename P>
__device__ P *dsm_plane(int rank, P *x, P *y, P *z, P *t) {
  return rank == 0 ? x : rank == 1 ? y : rank == 2 ? z : t;
}

// Four threads a lane, 8 lanes a block; a partial last block runs its
// spare groups on the last lane and drops their results, so that every
// thread of the warp takes part in every shuffle.
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
  fe a, y_r, q;
  fe_load(a, dsm_plane(rank, ax, ay, az, at), n, lane);
  fe_load(y_r, yr, n, lane);
  bool ok_l;
  dsm_tail_q_lane4(c, w[0], w[1], w[2], w[3], &a, y_r, &q, &ok_l,
                   tab + threadIdx.x, rank);
  if (g >= n) return;
  if (rank == 0) {
    fe_store(x_out, n, lane, q);
  } else if (rank == 2) {
    ok[lane] = ok_l;
    fe_store(z_out, n, lane, q);
  }
}

// As dsm_tail_q_kernel; rank q writes coordinate q.
__global__ void __launch_bounds__(DSM_THREADS)
    dsm_base_kernel(const uint8_t *wins, const int64_t *ax,
                    const int64_t *ay, const int64_t *az, const int64_t *at,
                    const int32_t *consts, int n, int64_t *x_out,
                    int64_t *y_out, int64_t *z_out, int64_t *t_out) {
  __shared__ vt_consts c;
  __shared__ uint32_t tab[G4_TAB_WORDS * DSM_THREADS];
  dsm_stage_consts(c, consts);
  const long long g = (long long)blockIdx.x * DSM_LANES4 + threadIdx.x / 4;
  const long long lane = g < n ? g : n - 1;
  const int rank = threadIdx.x & 3;
  uint8_t w[2][64];
  for (int p = 0; p < 2; p++) dsm_load_wins(w[p], wins, p, n, lane);
  fe a, q;
  fe_load(a, dsm_plane(rank, ax, ay, az, at), n, lane);
  dsm_base_lane4(c, w[0], w[1], &a, &q, tab + threadIdx.x, rank);
  if (g >= n) return;
  fe_store(dsm_plane(rank, x_out, y_out, z_out, t_out), n, lane, q);
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
  const int blocks = (n + DSM_LANES4 - 1) / DSM_LANES4;
  dsm_base_kernel<<<blocks, DSM_THREADS, 0, (cudaStream_t)stream>>>(
      wins, ax, ay, az, at, consts, n, x_out, y_out, z_out, t_out);
  return (int)cudaGetLastError();
}
#endif
