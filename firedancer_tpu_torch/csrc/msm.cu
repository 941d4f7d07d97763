// Lane-parallel multi-scalar multiply: one thread per (lane, point), then
// a tree per lane.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::msm, both selects:
//   MSM_LEGACY  _msm_kernel: unsigned 4-bit digits, a [0..15]P Niels
//               table per point (14 adds);
//   MSM_P16     _msm_kernel_p16: signed digits in [-8, 8] over nwin + 1
//               windows (the carry out of the top window appended), a
//               [0..8]P table (7 adds); a negative digit swaps Y - X and
//               Y + X and negates 2dT.
// The TPU's p16 select also packed two 12-bit limbs per 32-bit word
// (_pack16) to halve the data its select trees moved through the vector
// unit.  That was a TPU data-movement trick; it is not carried over: a
// thread here picks its table entry by index, and the limbs stay 10 x
// 25.5-bit in uint32 (fe25519.cuh).
//
// Layout, as the JAX package's: n points, m per lane, lanes = n / m.
// Lane l sums the flat points j * lanes + l (j < m); window w of point i
// is windows[w * n + i].  Thread (l, j) loads point j * lanes + l from
// the (10, n) int64 planes, builds that point's table, recodes its digits
// (p16) and runs its own chain [s]P: for each window, high first, four
// doublings (T only on the last, since a doubling never reads T) and one
// Niels add.  The lane's m partial points are then summed by a fixed
// tree of unified adds, the rule of curve25519.fold_lanes: level by
// level the low half plus the high half, an odd last partial carried up
// (at most 3 levels for m <= 8).  A block is one warp holding
// MSM_THREADS / m lanes, point-major (thread j * per + l), so the point
// and window loads of a point index are coalesced over neighbouring
// lanes and the tree moves partials between threads by warp shuffles.
// The (10, lanes) accumulators are written by the threads of point 0;
// the fold of the lanes to one point stays in torch (ops/msm.py), as it
// stayed in XLA on the TPU.
//
// What bounds it: operations.  A legacy thread at nwin = 64 does 1,024
// squarings and 1,513 products (table 142, chain 1,344, tree 27), p16
// 1,040 and 1,464, against 200 B read.  What held the design before this
// one back: one thread per lane ran the m points in one shared chain, so
// the 4,096 lanes of a 32,768-point MSM made 128 warps, one per SM and one
// of its four schedulers issuing, and the 512 lanes of a 4,096-point MSM
// filled 16 blocks on 16 of the 132 SMs; each thread's chain was about
// 6,100 products long, with m tables (20 KB legacy) in local memory.
// What this design does about it: m times the threads (4,096 threads on
// 128 SMs at 4,096 points; 32,768, about 8 warps per SM, at 32,768) and a
// critical path a third as long, at the cost of each point making its
// own doublings: a lane does about 2.5 times the operations of the
// shared chain.  A thread's one table (2.5 KB legacy, 1.4 KB p16) sits
// in local memory, which the L1 and L2 caches back.
// ptxas -v on the H100 (sm_90a): MSM_LEGACY 166 registers and 3,584
// bytes of stack, MSM_P16 168 and 2,464, no spills (one thread per lane
// took 130 registers and 22,880 / 13,920 bytes).  At 168 registers an SM
// holds 12 one-warp blocks, so the 1,024 blocks of a 32,768-point MSM
// run in one wave, 7 or 8 warps on each SM (two per scheduler), and the
// 128 blocks of a 4,096-point MSM one warp on each of 128 SMs.

#include "fe25519.cuh"
#include "ge25519.cuh"

#define MSM_LEGACY 0
#define MSM_P16 1
#define MSM_MAX_M 8
#define MSM_MAX_NWIN 64

// Unsigned 4-bit digits (low first) -> signed digits in [-8, 8], nwin + 1
// of them: a carry ripples low to high and the carry out of the top
// window becomes the extra window (curve_pallas.signed_windows_ext).
FD_FN void msm_signed_digits_ext(int8_t *dig, const uint8_t *nib, int nwin) {
  int carry = 0;
  for (int w = 0; w < nwin; w++) {
    const int d = nib[w] + carry;
    carry = d > 8;
    dig[w] = (int8_t)(carry ? d - 16 : d);
  }
  dig[nwin] = (int8_t)carry;
}

// One point: acc = [s]p, where window w of s is wins[w * w_stride].
// nwin <= MSM_MAX_NWIN.
template <int SEL>
FD_FN void msm_point(ge &acc, const ge &p, const uint8_t *wins,
                     long long w_stride, int nwin, const fe &d2) {
  constexpr int NT = SEL == MSM_LEGACY ? 16 : 9;
  ge_niels tab[NT];
  int8_t dig[MSM_MAX_NWIN + 1];
  ge_niels_table(tab, p, NT, d2);
  uint8_t nib[MSM_MAX_NWIN];
  for (int w = 0; w < nwin; w++) nib[w] = wins[w * w_stride];
  if (SEL == MSM_LEGACY) {
    for (int w = 0; w < nwin; w++) dig[w] = (int8_t)nib[w];
  } else {
    msm_signed_digits_ext(dig, nib, nwin);
  }
  const int nw = SEL == MSM_LEGACY ? nwin : nwin + 1;
  ge_identity(acc);
  for (int w = nw - 1; w >= 0; w--) {
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, true);
    // the sign only picks the operands, so the threads of a warp make the
    // one add together whatever their digits' signs
    const int d = dig[w];
    const ge_niels &e = tab[d < 0 ? -d : d];
    fe t2d = e.T2d;
    if (d < 0) fe_neg(t2d, e.T2d);
    ge_add_niels(acc, acc, d < 0 ? e.Yp : e.Ym, d < 0 ? e.Ym : e.Yp, e.Z,
                 t2d);
  }
}

// One level of a lane's tree over c partials (indexed by point): partial
// j < c / 2 adds partial j + c / 2, an odd last partial moves to c / 2,
// and c / 2 + c % 2 partials remain.  msm_tree_src is the partial that j
// reads at this level (its own where it reads none); msm_tree_step
// applies the level to j's partial acc, given that one.
FD_FN int msm_tree_src(int j, int c) {
  const int half = c / 2;
  if (j < half) return j + half;
  return (c & 1) && j == half ? c - 1 : j;
}

FD_FN void msm_tree_step(ge &acc, const ge &other, int j, int c,
                         const fe &d2) {
  const int half = c / 2;
  if (j < half)
    ge_add(acc, acc, other, d2);
  else if ((c & 1) && j == half)
    acc = other;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// One warp per block: a lane's m threads never span warps.
#define MSM_THREADS 32

__device__ __forceinline__ void fe_shfl(fe &r, const fe &a, int src) {
#pragma unroll
  for (int i = 0; i < 10; i++) r.v[i] = __shfl_sync(0xffffffffu, a.v[i], src);
}

template <int SEL>
__global__ void __launch_bounds__(MSM_THREADS)
    msm_kernel(const uint8_t *wins, const int64_t *x, const int64_t *y,
               const int64_t *z, const int64_t *t, const int32_t *d2_limbs,
               int n, int m, int nwin, int64_t *xo, int64_t *yo, int64_t *zo,
               int64_t *to) {
  const long long lanes = n / m;
  const int per = MSM_THREADS / m;           // lanes per block
  const int j = threadIdx.x / per, k = threadIdx.x % per;
  const long long l = (long long)blockIdx.x * per + k;
  // threads past m * per, and past the last lane, hold no point but take
  // part in the shuffles
  const bool live = j < m && l < lanes;
  fe d2;
  for (int i = 0; i < 10; i++) d2.v[i] = (uint32_t)d2_limbs[i];
  ge acc;
  if (live) {
    const long long idx = j * lanes + l;
    ge p;
    ge_load(p, x, y, z, t, n, idx);
    msm_point<SEL>(acc, p, wins + idx, n, nwin, d2);
  } else {
    ge_identity(acc);
  }
  for (int c = m; c > 1; c = c / 2 + c % 2) {
    const int src = msm_tree_src(j, c) * per + k;
    ge other;
    fe_shfl(other.X, acc.X, src);
    fe_shfl(other.Y, acc.Y, src);
    fe_shfl(other.Z, acc.Z, src);
    fe_shfl(other.T, acc.T, src);
    if (live) msm_tree_step(acc, other, j, c, d2);
  }
  if (!live || j) return;
  fe_store(xo, lanes, l, acc.X);
  fe_store(yo, lanes, l, acc.Y);
  fe_store(zo, lanes, l, acc.Z);
  fe_store(to, lanes, l, acc.T);
}

extern "C" int fd_msm(const uint8_t *wins, const int64_t *x, const int64_t *y,
                      const int64_t *z, const int64_t *t,
                      const int32_t *d2_limbs, int n, int m, int nwin,
                      int select, int64_t *xo, int64_t *yo, int64_t *zo,
                      int64_t *to, void *stream) {
  if (m < 1 || m > MSM_MAX_M || n % m || nwin < 1 || nwin > MSM_MAX_NWIN ||
      (select != MSM_LEGACY && select != MSM_P16))
    return (int)cudaErrorInvalidValue;
  const int lanes = n / m, per = MSM_THREADS / m;
  const int blocks = (lanes + per - 1) / per;
  cudaStream_t s = (cudaStream_t)stream;
  if (select == MSM_LEGACY)
    msm_kernel<MSM_LEGACY><<<blocks, MSM_THREADS, 0, s>>>(
        wins, x, y, z, t, d2_limbs, n, m, nwin, xo, yo, zo, to);
  else
    msm_kernel<MSM_P16><<<blocks, MSM_THREADS, 0, s>>>(
        wins, x, y, z, t, d2_limbs, n, m, nwin, xo, yo, zo, to);
  return (int)cudaGetLastError();
}
#endif
