// The antipa verify tail: four threads per signature.
//
// Replaces no Pallas kernel: in the JAX package the antipa mode's steps
// after the digest are XLA device code
// (firedancer_tpu/ops/ed25519.py::verify_batch_antipa: decompress A and
// R, k mod L, scalar25519.halve_scalar, v S mod L, the 32-window chain
// curve25519.double_scalar_mul_halved and the comb scalar_mul_base).
// In plain torch the divsteps and Lagrange rounds alone would be tens of
// thousands of elementwise launches, so the port runs the whole tail as
// one kernel after the SHA-512 kernel (sha512.cu).  Per lane: decompress
// A and test it for small order; decompress R and reject it where its
// encoded y mod p is one of the five small-order y values (the JAX
// graph's byte test); test S < L; k = digest mod L; (u, v) = the divstep
// halving of k (sc_halve in sc25519.cuh, the model's pair exactly);
// c = v S mod L; then Q = [c]B + [u](-A) + [|v|]R~, R~ = -R where v >= 0
// and R where v < 0, and accept iff Q is the identity (X = 0, Y = Z mod
// p).  Writes that bit, folded with the prechecks, as one byte.
//
// The bit depends on the point Q only, so the kernel groups the sum its
// own way: u and |v| are taken mod 2^128 (the JAX graph keeps their low
// 32 windows, so the bits stay equal even past the measured bound), c
// is split at 2^128 into c_lo + 2^128 c_hi, and all four scalars are
// recoded to 33 signed 4-bit digits (magnitude 0..8; the 33rd is the
// carry out of the top window).  One chain of 33 windows then makes,
// per window, four doublings, two Niels adds from the [0..8](-A) and
// [0..8]R~ tables and two affine adds from the [0..8]B and [0..8](2^128
// B) tables: 128 doublings against the strict chain's 256, at the cost
// of R's decompression, a second variable table and the scalar half.
//
// Field arithmetic: 10 x 25.5-bit uint32 limbs (fe25519.cuh); the chain
// runs on four threads a lane (dsm_chain.cuh: rank q holds coordinate q
// of the lane's points), as the strict tail's does.
//
// What bounds it: operations.  A lane does 1,026 field squarings and
// 1,553 products (tools/kernel_time.py AP_SQR, AP_MUL: two
// decompressions, two tables, 33 windows) of 55 and 100 32 x 32 -> 64
// multiply-adds, and the scalar half's 250 divsteps and 24 Lagrange
// rounds on 256-bit words, against 160 bytes read and 1 written.  What the design does about it:
// the chain's products spread over the lane's four ranks (12 rounds a
// window instead of 43 products in series), the two variable tables sit
// in shared memory by rank column (23 KB a block of 8 lanes), so a
// digit's pick is a shared-memory read, and every select is by mask, so
// a warp's lanes run one instruction stream.  The decompressions and
// the scalar half run on all four ranks alike, which needs no
// hand-over: a first version, simple and right.

#include "dsm_chain.cuh"
#include "fe25519.cuh"
#include "ge25519.cuh"
#include "sc25519.cuh"

#define AP_NWIN 33   // 32 windows of a 128-bit scalar and the carry out

// Constants table, int32 (AP_NCONST, 10) limb rows: the strict chain's
// (dsm_chain.cuh vt_consts: [0..8]B, d, 2d, sqrt(-1), the order-8 y
// values), then [0..8](2^128 B) in the same rows as [0..8]B.
#define AP_NCONST (VT_NCONST + 36)

struct ap_consts {
  vt_consts v;
  fe base_hi[9][4];
};

// The lane's prologue stays out of line on the device, as ge25519.cuh's
// point functions do: a shorter lane body for cicc, and the scalar
// half's words stay out of the chain's registers.
#if defined(__CUDACC__)
#define AP_FN __device__ __noinline__
#else
#define AP_FN static inline
#endif

// The scalar half of a lane: S < L (returned), k = digest mod L, (u, v)
// = sc_halve(k), c = v S mod L, and the 33 signed digits (magnitude 0..8
// and sign 0/1, low first) of u mod 2^128 (row 0), |v| mod 2^128 (row
// 1), c mod 2^128 (row 2) and c >> 128 (row 3).  v_pos: v >= 0.
AP_FN bool ap_scalars(const uint8_t *s, const uint8_t *digest,
                      uint8_t mag[4][AP_NWIN], uint8_t sgn[4][AP_NWIN],
                      bool &v_pos) {
  uint32_t sw[8], dw[16], kl[10], k[8], u[8], av[8], c[8], l[8], nc[8];
  sc_load_words<8>(sw, s);
  const bool ok_s = sc_is_canonical(sw);
  sc_load_words<16>(dw, digest);
  sc_reduce512(kl, dw);
  sc_limbs_to_words(k, kl);
  v_pos = sc_halve(u, av, k);
  sc_w_mul_mod_l(c, sw, av);     // |v| S mod L
  // v < 0: L - c, and 0 stays 0 (scalar25519.neg_mod_l)
  uint32_t nz = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    l[i] = sc_l_word(i);
    nz |= c[i];
  }
  sc_w_addsub(nc, l, c, ~0u);
  sc_w_sel(c, (!v_pos && nz) ? ~0u : 0u, nc, c);
  const uint32_t *src[4] = {u, av, c, c + 4};
#pragma unroll
  for (int j = 0; j < 4; j++) {
    uint8_t *m = mag[j], *g = sgn[j];
    m[AP_NWIN - 1] = (uint8_t)sc_signed_recode_n<4>(
        src[j], [&](int q, uint32_t me, uint32_t mo, uint32_t se,
                    uint32_t so) {
          sc_put_windows(m, q, me, mo);
          sc_put_windows(g, q, se, so);
        });
    g[AP_NWIN - 1] = 0;
  }
  return ok_s;
}

// The lane's points: -A = (-x, y, 1, -xy) and R~ = -R where v >= 0, R
// where v < 0.  Returns that A decompresses and is not of small order
// and that R decompresses and passes the byte test.
AP_FN bool ap_points(const vt_consts &c, const uint8_t *pub,
                     const uint8_t *r, bool v_pos, ge &na, ge &rt) {
  bool small_a, small_r;
  const bool ok_a =
      ge_frombytes(na.X, na.Y, small_a, pub, c.d, c.sqrt_m1, c.y8_0, c.y8_1);
  fe_neg(na.X, na.X);
  fe_set(na.Z, 1);
  fe_mul(na.T, na.X, na.Y);
  const bool ok_r =
      ge_frombytes(rt.X, rt.Y, small_r, r, c.d, c.sqrt_m1, c.y8_0, c.y8_1);
  fe nx;
  fe_neg(nx, rt.X);
  g4_pick(rt.X, v_pos, nx, rt.X);
  fe_set(rt.Z, 1);
  fe_mul(rt.T, rt.X, rt.Y);
  fe yc;                     // R's encoded y mod p, for the byte test
  fe_frombytes(yc, r);
  fe_canonical(yc, yc);
  return ok_a && !small_a && ok_r && !ge_small_y(yc, c.y8_0, c.y8_1);
}

// Q is the identity (X = 0 and Y = Z mod p), in the layout: rank 0
// tests X, rank 2 takes Y from rank 1 and compares it with its Z; ok[i]
// is rank r0 + i's copy of the answer.
FD_FN void ap_is_identity(bool *ok, const fe *q, int r0) {
  fe got[G4_RANKS];
  int src[G4_RANKS];
  bool e[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) src[i] = r0 + i == 2 ? 1 : r0 + i;
  g4_shfl(got, q, src);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int r = r0 + i;
    e[i] = r == 0 ? fe_iszero(q[i]) : r == 2 ? fe_eq(got[i], q[i]) : true;
  }
#if defined(__CUDACC__)
  const int mine = e[0];
  ok[0] = __shfl_sync(0xffffffffu, mine, 0, 4) &&
          __shfl_sync(0xffffffffu, mine, 2, 4);
#else
  for (int i = 0; i < G4_RANKS; i++) ok[i] = e[0] && e[2];
#endif
}

// The whole tail for rank r0 of the lane (on the host: all four ranks,
// r0 = 0).  tab_a and tab_r are the rank's columns of the two variable
// tables, laid out as g4_dsm_chain's tab.  ok[i] is rank r0 + i's copy
// of the lane's bit.
FD_FN void ap_lane4(const ap_consts &c, const uint8_t *pub, const uint8_t *r,
                    const uint8_t *s, const uint8_t *digest, bool *ok,
                    uint32_t *tab_a, uint32_t *tab_r, int r0) {
  uint8_t mag[4][AP_NWIN], sgn[4][AP_NWIN];
  bool v_pos;
  const bool ok_s = ap_scalars(s, digest, mag, sgn, v_pos);
  ge na, rt;
  const bool ok_p = ap_points(c.v, pub, r, v_pos, na, rt);
  fe p[G4_RANKS], acc[G4_RANKS];
  g4_from_ge(p, na, r0);
  g4_niels_table(tab_a, p, c.v.d2, r0);
  g4_from_ge(p, rt, r0);
  g4_niels_table(tab_r, p, c.v.d2, r0);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe_set(acc[i], q == 1 || q == 2);   // the identity (0, 1, 1, 0)
  }
  for (int w = AP_NWIN - 1; w >= 0; w--) {
    if (w < AP_NWIN - 1) {   // the identity doubles to itself
      g4_double<false>(acc, r0);
      g4_double<false>(acc, r0);
      g4_double<false>(acc, r0);
      g4_double<true>(acc, r0);
    }
    g4_add_niels(acc, r0, tab_a, mag[0][w], sgn[0][w]);
    g4_add_niels(acc, r0, tab_r, mag[1][w], sgn[1][w]);
    g4_add_affine<true>(acc, r0, c.v.base[mag[2][w]], sgn[2][w]);
    g4_add_affine<false>(acc, r0, c.base_hi[mag[3][w]], sgn[3][w]);
  }
  ap_is_identity(ok, acc, r0);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) ok[i] = ok[i] && ok_s && ok_p;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define AP_THREADS 32             // one warp: 8 lanes of 4 ranks
#define AP_LANES (AP_THREADS / 4)
static_assert(AP_THREADS == G4_TAB_STRIDE, "tab is [entry][limb][thread]");

__global__ void __launch_bounds__(AP_THREADS)
    antipa_tail_kernel(const uint8_t *pub, long long pub_stride,
                       const uint8_t *r, long long r_stride,
                       const uint8_t *s, long long s_stride,
                       const uint8_t *digest, long long digest_stride,
                       const int32_t *consts, int n, uint8_t *ok) {
  __shared__ ap_consts c;
  __shared__ uint32_t tab_a[G4_TAB_WORDS * AP_THREADS];
  __shared__ uint32_t tab_r[G4_TAB_WORDS * AP_THREADS];
  uint32_t *cw = &c.v.base[0][0].v[0];
  for (int i = threadIdx.x; i < AP_NCONST * 10; i += blockDim.x)
    cw[i] = (uint32_t)consts[i];
  __syncthreads();
  // a partial last block runs its spare groups on the last lane and
  // drops their results: every thread of the warp takes part in every
  // shuffle
  const long long g = (long long)blockIdx.x * AP_LANES + threadIdx.x / 4;
  const long long lane = g < n ? g : n - 1;
  const int rank = threadIdx.x & 3;
  bool ok_l;
  ap_lane4(c, pub + lane * pub_stride, r + lane * r_stride,
           s + lane * s_stride, digest + lane * digest_stride, &ok_l,
           tab_a + threadIdx.x, tab_r + threadIdx.x, rank);
  if (g < n && rank == 0) ok[lane] = ok_l;
}

extern "C" int fd_antipa_tail(const uint8_t *pub, long long pub_stride,
                              const uint8_t *r, long long r_stride,
                              const uint8_t *s, long long s_stride,
                              const uint8_t *digest, long long digest_stride,
                              const int32_t *consts, int n, uint8_t *ok,
                              void *stream) {
  const int blocks = (n + AP_LANES - 1) / AP_LANES;
  antipa_tail_kernel<<<blocks, AP_THREADS, 0, (cudaStream_t)stream>>>(
      pub, pub_stride, r, r_stride, s, s_stride, digest, digest_stride,
      consts, n, ok);
  return (int)cudaGetLastError();
}
#endif
