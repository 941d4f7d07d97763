// Batched point decompression with the small-order test: one thread per
// point.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::decompress
// (_decompress_kernel).  Per lane: y from the 32 bytes, u = y^2 - 1 and
// v = d y^2 + 1, the square-root chain, the sign fix, the small-order bit
// and T = x y (ge_frombytes in ge25519.cuh, which the verify tail calls
// too).  Writes ok and small as uint8 and X, Y, T as (10, n) int64 limb
// planes (ops/f25519.py layout); Z = 1 is left to the wrapper.  On the
// TPU the byte unpacking of y stayed in XLA; here the lane reads its row
// in place through the row stride, so the kernel is the whole function.
//
// What bounds it: operations.  A lane does some 255 squarings and 19
// products (the pow22523 chain dominates) against 32 bytes read and 242
// written.  What the design does about it: every intermediate stays in
// registers, and blocks of DC_THREADS spread a batch of a few thousand
// lanes over all SMs.  The four curve constants are read by every thread
// from the same addresses (a broadcast).

#include "fe25519.cuh"
#include "ge25519.cuh"

// Constants table, int32 (DC_NCONST, 10) limb rows: d, sqrt(-1) and the
// two order-8 y values.
#define DC_NCONST 4

struct dc_consts {
  fe d, sqrt_m1, y8_0, y8_1;
};

// One lane: returns ok; writes small, X, Y and T.
FD_FN bool dc_lane(const dc_consts &c, const uint8_t *b, bool &small, fe &x,
                   fe &y, fe &t) {
  const bool ok = ge_frombytes(x, y, small, b, c.d, c.sqrt_m1, c.y8_0, c.y8_1);
  fe_mul(t, x, y);
  return ok;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define DC_THREADS 64

__global__ void __launch_bounds__(DC_THREADS)
    decompress_kernel(const uint8_t *b, long long b_stride,
                      const int32_t *consts, int n, uint8_t *ok,
                      uint8_t *small, int64_t *x_out, int64_t *y_out,
                      int64_t *t_out) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  dc_consts c;
  uint32_t *cw = &c.d.v[0];
  for (int i = 0; i < DC_NCONST * 10; i++) cw[i] = (uint32_t)consts[i];
  fe x, y, t;
  bool sm;
  ok[lane] = dc_lane(c, b + lane * b_stride, sm, x, y, t);
  small[lane] = sm;
  for (int i = 0; i < 10; i++) {
    x_out[i * (long long)n + lane] = x.v[i];
    y_out[i * (long long)n + lane] = y.v[i];
    t_out[i * (long long)n + lane] = t.v[i];
  }
}

extern "C" int fd_decompress(const uint8_t *b, long long b_stride,
                             const int32_t *consts, int n, uint8_t *ok,
                             uint8_t *small, int64_t *x_out, int64_t *y_out,
                             int64_t *t_out, void *stream) {
  const int blocks = (n + DC_THREADS - 1) / DC_THREADS;
  decompress_kernel<<<blocks, DC_THREADS, 0, (cudaStream_t)stream>>>(
      b, b_stride, consts, n, ok, small, x_out, y_out, t_out);
  return (int)cudaGetLastError();
}
#endif
