// Lane-parallel Straus multi-scalar multiply: one thread per MSM lane.
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
// Lane l accumulates the flat points j * lanes + l (j < m); window w of
// point i is windows[w * n + i] (rows w * m + j over lanes, in the TPU
// kernel's terms).  Each thread loads its m points from the (10, n)
// int64 planes, builds their tables, recodes their digits (p16), and runs
// the shared chain: for each window, high first, four doublings (T only
// on the last, since a doubling never reads T) and m Niels adds.  It
// writes its accumulator's X, Y, Z, T as (10, lanes) int64 planes; the
// fold of the lanes to one point stays in torch (ops/msm.py), as it
// stayed in XLA on the TPU.
//
// What bounds it: operations.  A legacy lane at m = 8, nwin = 64 does
// about 1,024 squarings and 6,100 products (table 1,136, chain 4,928)
// against 2.1 KB read and 320 B written.  What the design does about it:
// the accumulator stays in registers; the tables (m x 16 x 160 B = 20 KB
// legacy, 11.5 KB p16 at m = 8) sit in the thread's local memory, which
// the L1 and L2 caches back; blocks of MSM_THREADS spread the 4,096 lanes
// of a 32,768-signature batch over the SMs.  One thread per lane leaves
// most warp schedulers idle at that lane count; that is for a later
// change.

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

// One lane: acc = sum over j < m of [s_j] pts[j], where window w of s_j is
// wins[w * w_stride + j * j_stride].  m <= MSM_MAX_M, nwin <= MSM_MAX_NWIN.
template <int SEL>
FD_FN void msm_lane(ge &acc, const ge *pts, const uint8_t *wins,
                    long long w_stride, long long j_stride, int m, int nwin,
                    const fe &d2) {
  constexpr int NT = SEL == MSM_LEGACY ? 16 : 9;
  ge_niels tab[MSM_MAX_M][NT];
  int8_t dig[MSM_MAX_M][MSM_MAX_NWIN + 1];
  for (int j = 0; j < m; j++) {
    ge_niels_table(tab[j], pts[j], NT, d2);
    uint8_t nib[MSM_MAX_NWIN];
    for (int w = 0; w < nwin; w++) nib[w] = wins[w * w_stride + j * j_stride];
    if (SEL == MSM_LEGACY) {
      for (int w = 0; w < nwin; w++) dig[j][w] = (int8_t)nib[w];
    } else {
      msm_signed_digits_ext(dig[j], nib, nwin);
    }
  }
  const int nw = SEL == MSM_LEGACY ? nwin : nwin + 1;
  ge_identity(acc);
  for (int w = nw - 1; w >= 0; w--) {
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, true);
    for (int j = 0; j < m; j++) {
      // the sign only picks the operands, so the threads of a warp make
      // the one add together whatever their digits' signs
      const int d = dig[j][w];
      const ge_niels &e = tab[j][d < 0 ? -d : d];
      fe t2d = e.T2d;
      if (d < 0) fe_neg(t2d, e.T2d);
      ge_add_niels(acc, acc, d < 0 ? e.Yp : e.Ym, d < 0 ? e.Ym : e.Yp, e.Z,
                   t2d);
    }
  }
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define MSM_THREADS 32

template <int SEL>
__global__ void __launch_bounds__(MSM_THREADS)
    msm_kernel(const uint8_t *wins, const int64_t *x, const int64_t *y,
               const int64_t *z, const int64_t *t, const int32_t *d2_limbs,
               int n, int m, int nwin, int64_t *xo, int64_t *yo, int64_t *zo,
               int64_t *to) {
  const long long lanes = n / m;
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lanes) return;
  fe d2;
  for (int i = 0; i < 10; i++) d2.v[i] = (uint32_t)d2_limbs[i];
  ge pts[MSM_MAX_M];
  for (int j = 0; j < m; j++) ge_load(pts[j], x, y, z, t, n, j * lanes + l);
  ge acc;
  msm_lane<SEL>(acc, pts, wins + l, n, lanes, m, nwin, d2);
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
  const int lanes = n / m;
  const int blocks = (lanes + MSM_THREADS - 1) / MSM_THREADS;
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
