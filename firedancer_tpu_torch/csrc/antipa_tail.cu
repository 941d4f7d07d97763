// The antipa verify tail: a block of four warps and 32 signatures, a
// prologue by role, then the chain on four threads per signature.
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
// carry out of the top window).  R~'s sign goes into |v|'s digits, so
// the R table is R's own: [|v|]R~ = [-v]R.  One chain of 33 windows then
// makes, per window, four doublings, two Niels adds from the [1..8](-A)
// and [1..8]R tables and two affine adds from the [0..8]B and
// [0..8](2^128 B) tables: 128 doublings against the strict chain's 256,
// at the cost of R's decompression, a second variable table and the
// scalar half.
//
// Field arithmetic: 10 x 25.5-bit uint32 limbs (fe25519.cuh); the chain
// runs on four threads a lane (dsm_chain.cuh: rank q holds coordinate q
// of the lane's points), as the strict tail's does.
//
// What bounds it: operations.  A lane does 1,026 field squarings and
// 1,553 products (tools/kernel_time.py AP_SQR, AP_MUL: two
// decompressions, two tables, 33 windows) of 55 and 100 32 x 32 -> 64
// multiply-adds, and the scalar half's 250 divsteps and 24 Lagrange
// rounds on 256-bit words, against 160 bytes read and 1 written.  At
// 4096 lanes one lane's latency sets the time, at 32768 the SMs' issue
// and the waves.  What the design does about it:
//  - no prologue step runs on all four ranks alike, nor twice.  Each
//    prologue step is one thread's serial work, so the prologue runs
//    by role, one thread a lane: warp 0 the scalar half (S < L, k mod
//    L, sc_halve, c and the digits), warp 1 A's decompression, warp 2
//    R's, at once; warp 3 waits.  A lane's prologue takes the longest
//    of the three (a decompression), not their sum, and a warp issues
//    a decompression for 32 lanes where four ranks issued two for 8.
//    The digits (a signed byte a digit, 132 B a lane), the points'
//    affine x and y and the prechecks go to the chain in shared memory
//    behind one barrier;
//  - residency: 32 lanes a block, so 4096 lanes take 128 blocks, at
//    most one an SM; the constants are one copy a block; the variable
//    tables hold 8 entries (the identity is picked from constants by
//    mask, g4_add_niels<true>) of 8 packed words (g4_pack), and the
//    points pass through the tables' space.  71 KB of dynamic shared
//    memory a block allow 3 blocks an SM, 12 warps, as many as 168
//    registers a thread allow;
//  - the chain's products spread over the lane's four ranks (12 rounds
//    a window instead of 43 products in series), a digit's pick is a
//    shared-memory read, and every select is by mask, so a warp's lanes
//    run one instruction stream.

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

// One rank's column of a variable table without the identity: 8 entries
// of 8 words, the limbs packed (g4_niels_table<true>).
#define AP_TAB_WORDS (8 * 8)

// The block: AP_WARPS warps of 8 lanes each for the chain; in the
// prologue thread t of warp 0 runs lane t's scalar half, of warp 1 its
// A, of warp 2 its R, and warp 3 waits.
#define AP_WARPS 4
#define AP_THREADS (32 * AP_WARPS)
#define AP_LANES (8 * AP_WARPS)
#define AP_MIN_BLOCKS 3   // blocks an SM: 12 warps, <= 168 registers

// The lane's prologue stays out of line on the device, as ge25519.cuh's
// point functions do: a shorter lane body for cicc, and the scalar
// half's words stay out of the chain's registers.
#if defined(__CUDACC__)
#define AP_FN __device__ __noinline__
#else
#define AP_FN static inline
#endif

// A timing-only build (-DAP_CLOCKS, made by tools/kernel_time.py
// --phases, never by kernels/build.py) stamps clock64() at the phase
// edges of each lane into an extra (n, AP_NSTAMP) int64 output:
// fd_antipa_tail_phases names the phases by their stamps.
#define AP_NSTAMP 10
#if defined(__CUDACC__) && defined(AP_CLOCKS)
#define AP_STAMP(st, j) ((st)[j] = clock64())
#define AP_ST_PARAM , long long *st
#define AP_ST_ARG , st
#else
#define AP_STAMP(st, j) ((void)0)
#define AP_ST_PARAM
#define AP_ST_ARG
#endif

// The scalar half of a lane: S < L (returned), k = digest mod L,
// (u, v) = sc_halve(k), c = v S mod L, and the 33 signed digits (-8..8,
// low first) of four scalars, packed as dig[w] byte j = digit w of
// scalar j (an int8): u mod 2^128 (j 0), -v as the digits of |v| mod
// 2^128 negated where v >= 0 (j 1; the chain adds [-v]R = [|v|]R~), c
// mod 2^128 (j 2) and c >> 128 (j 3).
AP_FN bool ap_scalars(const uint8_t *s, const uint8_t *digest,
                      uint32_t *dig) {
  uint32_t sw[8], dw[16], kl[10], k[8], u[8], av[8], c[8], l[8], nc[8];
  uint8_t mag[4][AP_NWIN], sgn[4][AP_NWIN];
  sc_load_words<8>(sw, s);
  const bool ok_s = sc_is_canonical(sw);
  sc_load_words<16>(dw, digest);
  sc_reduce512(kl, dw);
  sc_limbs_to_words(k, kl);
  const bool v_pos = sc_halve(u, av, k);
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
  for (int w = 0; w < AP_NWIN; w++) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const bool neg = sgn[j][w] != (j == 1 && v_pos);
      word |= (uint32_t)(uint8_t)(neg ? -mag[j][w] : mag[j][w]) << 8 * j;
    }
    dig[w] = word;
  }
  return ok_s;
}

// One of the lane's points, by one thread: A (is_r false) or R from
// its encoding, affine x and y.  Returns A's precheck (it decompresses
// and is not of small order) or R's (it decompresses and its encoded y
// is not one of the five small-order y values).
AP_FN bool ap_point(const vt_consts &c, const uint8_t *enc, bool is_r,
                    fe &x, fe &y) {
  bool small;
  const bool ok =
      ge_frombytes(x, y, small, enc, c.d, c.sqrt_m1, c.y8_0, c.y8_1);
  if (!is_r) return ok && !small;
  fe yc;
  fe_frombytes(yc, enc);
  fe_canonical(yc, yc);
  return ok && !ge_small_y(yc, c.y8_0, c.y8_1);
}

// The lane's two points in the layout, from the prologue's x and y:
// pa[i] gets rank r0 + i's coordinate of -A = (-x, y, 1, -xy), pr[i] of
// R = (x, y, 1, xy).
FD_FN void ap_lane_points(fe *pa, fe *pr, const fe &xa, const fe &ya,
                          const fe &xr, const fe &yr, int r0) {
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe nx, one, ta, tr;
    fe_neg(nx, xa);
    fe_set(one, 1);
    fe_mul(ta, nx, ya);
    fe_mul(tr, xr, yr);
    g4_sel(pa[i], r0 + i, nx, ya, one, ta);
    g4_sel(pr[i], r0 + i, xr, yr, one, tr);
  }
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

// A chain warp's part of a lane for rank r0 (on the host: all four
// ranks, r0 = 0): both tables from the lane's points pa and pr
// (ap_lane_points), then the 33 windows over the scalar half's digits dig
// (ap_scalars) and the identity test, folded with the prechecks pre.
// tab_a and tab_r are the rank's columns of the two variable tables,
// laid out as g4_dsm_chain's tab with 8 entries of 8 words.  ok[i] is
// rank r0 + i's copy of the lane's bit.
FD_FN void ap_chain_lane4(const ap_consts &c, const fe *pa, const fe *pr,
                          const uint32_t *dig, bool pre, bool *ok,
                          uint32_t *tab_a, uint32_t *tab_r,
                          int r0 AP_ST_PARAM) {
  fe acc[G4_RANKS];
  g4_niels_table<true>(tab_a, pa, c.v.d2, r0);
  g4_niels_table<true>(tab_r, pr, c.v.d2, r0);
  AP_STAMP(st, 8);
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
    const uint32_t d = dig[w];
    const int d0 = (int8_t)d, d1 = (int8_t)(d >> 8), d2 = (int8_t)(d >> 16),
              d3 = (int8_t)(d >> 24);
    g4_add_niels<true>(acc, r0, tab_a, d0 < 0 ? -d0 : d0, d0 < 0);
    g4_add_niels<true>(acc, r0, tab_r, d1 < 0 ? -d1 : d1, d1 < 0);
    g4_add_affine<true>(acc, r0, c.v.base[d2 < 0 ? -d2 : d2], d2 < 0);
    g4_add_affine<false>(acc, r0, c.base_hi[d3 < 0 ? -d3 : d3], d3 < 0);
  }
  ap_is_identity(ok, acc, r0);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) ok[i] = ok[i] && pre;
  AP_STAMP(st, 9);
}

#if !defined(__CUDACC__)
// The whole lane on the host, as the block runs it: the prologue's
// three parts (the scalar half, A and R), then the chain's four ranks
// in lockstep (r0 0), fed the points as the shared memory hands them on.
static inline void ap_lane4(const ap_consts &c, const uint8_t *pub,
                            const uint8_t *r, const uint8_t *s,
                            const uint8_t *digest, bool *ok,
                            uint32_t *tab_a, uint32_t *tab_r) {
  uint32_t dig[AP_NWIN];
  fe xa, ya, xr, yr, pa[G4_RANKS], pr[G4_RANKS];
  const bool ok_s = ap_scalars(s, digest, dig);
  const bool ok_a = ap_point(c.v, pub, false, xa, ya);
  const bool ok_r = ap_point(c.v, r, true, xr, yr);
  ap_lane_points(pa, pr, xa, ya, xr, yr, 0);
  ap_chain_lane4(c, pa, pr, dig, ok_s && ok_a && ok_r, ok, tab_a, tab_r, 0);
}
#endif

#if defined(__CUDACC__)
#include <cuda_runtime.h>

static_assert(G4_TAB_STRIDE == 32, "tab is [entry][word][thread of a warp]");

// Dynamic shared memory, in words: the constants; the digits
// [lane][window]; the prechecks, bytes [S < L, A, R][lane]; then each
// warp's two tables, whose first 40 x 8 words hold, until the warp has
// read them, its lanes' points [x_A, y_A, x_R, y_R limb][lane of the
// warp] as the prologue hands them on.
#define AP_DIG_OFF (AP_NCONST * 10)
#define AP_PRE_OFF (AP_DIG_OFF + AP_LANES * AP_NWIN)
#define AP_TAB_OFF (AP_PRE_OFF + 3 * AP_LANES / 4)
#define AP_WARP_WORDS (2 * AP_TAB_WORDS * 32)
#define AP_SMEM_WORDS (AP_TAB_OFF + AP_WARPS * AP_WARP_WORDS)
static_assert(sizeof(ap_consts) == AP_NCONST * 10 * 4, "constants layout");
static_assert(40 * 8 <= AP_WARP_WORDS, "the points fit a warp's tables");

#if defined(AP_CLOCKS)
#define AP_CLK_PARAM , long long *clk
#define AP_CLK_ARG , clk
#else
#define AP_CLK_PARAM
#define AP_CLK_ARG
#endif

__global__ void __launch_bounds__(AP_THREADS, AP_MIN_BLOCKS)
    antipa_tail_kernel(const uint8_t *pub, long long pub_stride,
                       const uint8_t *r, long long r_stride,
                       const uint8_t *s, long long s_stride,
                       const uint8_t *digest, long long digest_stride,
                       const int32_t *consts, int n,
                       uint8_t *ok AP_CLK_PARAM) {
  extern __shared__ uint32_t ap_smem[];
  const ap_consts &c = *reinterpret_cast<const ap_consts *>(ap_smem);
  uint32_t *digs = ap_smem + AP_DIG_OFF;
  uint8_t *pre = reinterpret_cast<uint8_t *>(ap_smem + AP_PRE_OFF);
  uint32_t *tabs = ap_smem + AP_TAB_OFF;
  for (int i = threadIdx.x; i < AP_NCONST * 10; i += AP_THREADS)
    ap_smem[i] = (uint32_t)consts[i];
  __syncthreads();
#if defined(AP_CLOCKS)
  long long st[AP_NSTAMP];
#endif
  // a partial last block runs its spare lanes on the last lane and drops
  // their results: every thread of a warp takes part in every shuffle
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const long long base = (long long)blockIdx.x * AP_LANES;
  AP_STAMP(st, 0);
  if (warp < 3) {   // the prologue: lane t's scalar half, A or R
    const long long g = base + t, lane = g < n ? g : n - 1;
    AP_STAMP(st, 1 + 2 * warp);
    if (warp == 0) {
      pre[t] = ap_scalars(s + lane * s_stride, digest + lane * digest_stride,
                          digs + t * AP_NWIN);
    } else {
      const bool is_r = warp == 2;
      fe x, y;
      pre[warp * AP_LANES + t] = ap_point(
          c.v, is_r ? r + lane * r_stride : pub + lane * pub_stride, is_r,
          x, y);
      uint32_t *pts = tabs + (t / 8) * AP_WARP_WORDS + t % 8 +
                      (is_r ? 20 * 8 : 0);
#pragma unroll
      for (int l = 0; l < 10; l++) {
        pts[l * 8] = x.v[l];
        pts[(10 + l) * 8] = y.v[l];
      }
    }
    AP_STAMP(st, 2 + 2 * warp);
#if defined(AP_CLOCKS)
    if (g < n) {
      clk[g * AP_NSTAMP + 1 + 2 * warp] = st[1 + 2 * warp];
      clk[g * AP_NSTAMP + 2 + 2 * warp] = st[2 + 2 * warp];
    }
#endif
  }
  __syncthreads();
  AP_STAMP(st, 7);
  // the chain: four ranks a lane
  const int li = warp * 8 + t / 4, rank = t % 4;
  const long long g = base + li, lane = g < n ? g : n - 1;
  uint32_t *tab_a = tabs + warp * AP_WARP_WORDS + t;
  const uint32_t *pts = tabs + warp * AP_WARP_WORDS + t / 4;
  fe xa, ya, xr, yr, pa, pr;
#pragma unroll
  for (int l = 0; l < 10; l++) {
    xa.v[l] = pts[l * 8];
    ya.v[l] = pts[(10 + l) * 8];
    xr.v[l] = pts[(20 + l) * 8];
    yr.v[l] = pts[(30 + l) * 8];
  }
  const bool ok_pre =
      pre[li] && pre[AP_LANES + li] && pre[2 * AP_LANES + li];
  __syncwarp();   // the points are read before the tables overwrite them
  ap_lane_points(&pa, &pr, xa, ya, xr, yr, rank);
  bool ok_l;
  ap_chain_lane4(c, &pa, &pr, digs + li * AP_NWIN, ok_pre, &ok_l, tab_a,
                 tab_a + AP_TAB_WORDS * 32, rank AP_ST_ARG);
  if (g < n && rank == 0) {
    ok[lane] = ok_l;
#if defined(AP_CLOCKS)
    clk[g * AP_NSTAMP] = st[0];
    for (int j = 7; j < AP_NSTAMP; j++) clk[g * AP_NSTAMP + j] = st[j];
#endif
  }
}

static int ap_prepare(size_t &smem) {
  smem = (size_t)AP_SMEM_WORDS * 4;
  cudaError_t e = cudaFuncSetAttribute(
      antipa_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(antipa_tail_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return (int)e;
}

extern "C" int fd_antipa_tail(const uint8_t *pub, long long pub_stride,
                              const uint8_t *r, long long r_stride,
                              const uint8_t *s, long long s_stride,
                              const uint8_t *digest, long long digest_stride,
                              const int32_t *consts, int n, uint8_t *ok,
                              void *stream AP_CLK_PARAM) {
  size_t smem;
  const int e = ap_prepare(smem);
  if (e) return e;
  const int blocks = (n + AP_LANES - 1) / AP_LANES;
  antipa_tail_kernel<<<blocks, AP_THREADS, smem, (cudaStream_t)stream>>>(
      pub, pub_stride, r, r_stride, s, s_stride, digest, digest_stride,
      consts, n, ok AP_CLK_ARG);
  return (int)cudaGetLastError();
}

// The kernel's residency: out[0..6] = registers a thread, static shared
// bytes, dynamic shared bytes a block, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), threads and lanes a
// block, local (stack) bytes a thread.
extern "C" int fd_antipa_tail_residency(int *out) {
  size_t smem;
  int e = ap_prepare(smem);
  if (e) return e;
  cudaFuncAttributes a;
  e = (int)cudaFuncGetAttributes(&a, antipa_tail_kernel);
  if (e) return e;
  int blocks = 0;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, antipa_tail_kernel, AP_THREADS, smem);
  if (e) return e;
  const int v[7] = {a.numRegs, (int)a.sharedSizeBytes, (int)smem, blocks,
                    AP_THREADS, AP_LANES, (int)a.localSizeBytes};
  for (int i = 0; i < 7; i++) out[i] = v[i];
  return 0;
}

#if defined(AP_CLOCKS)
// The phases of a lane, as name:first-last stamp, ';' between them (the
// prologue threads stamp 1-6, the chain's rank 0 0 and 7-9; one SM's
// clock), and the stamps a lane.
extern "C" const char *fd_antipa_tail_phases() {
  return "scalar half (warp 0):1-2;decompress A (warp 1):3-4;"
         "decompress R (warp 2):5-6;prologue to the barrier:0-7;"
         "tables:7-8;chain (33 windows):8-9;lane:0-9";
}

extern "C" int fd_antipa_tail_nstamp() { return AP_NSTAMP; }
#endif
#endif
