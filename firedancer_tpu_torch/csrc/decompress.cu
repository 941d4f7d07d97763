// Batched point decompression with the small-order test: one thread per
// point.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::decompress
// (_decompress_kernel).  Per lane: y from the 32 bytes, u = y^2 - 1 and
// v = d y^2 + 1, the square-root chain, the sign fix, the small-order bit
// and T = x y (ge_frombytes in ge25519.cuh, which the verify tail calls
// too; inlined here).  One launch writes every output: ok and small as
// the bool planes of one (2, n) buffer, and X, Y, Z = 1 and T as the
// int64 (10, n) limb planes (ops/f25519.py layout) of one (4, 10, n)
// buffer.  A launch may take two row views of n rows each (A and R of the
// RLC check): lanes n .. 2n - 1 read the second and write the second half
// of each output.  On the TPU the byte unpacking of y stayed in XLA;
// here the lane reads its row in place through the row stride, so the
// kernel is the whole function.
//
// What bounds it: operations.  A lane does some 255 squarings and 19
// products (the pow22523 chain dominates) against 32 bytes read and 322
// written, one dependent chain.  What the design does about it: every
// intermediate stays in registers (the lane is inlined), and blocks of
// two warps spread a batch of a few thousand lanes over all SMs.  A
// pair's 2n lanes go in one launch: at a few thousand lanes a warp has
// its scheduler to itself, so the second view's lanes come nearly free.
// The grid is one wave of resident threads (fd_decompress).  The four
// curve constants are read by every thread from the same addresses (a
// broadcast).  Splitting each product over two threads by output column
// made 4096 lanes 1.26x faster and 32768 lanes 1.75x slower (PERF.md):
// the rotation of the operands by rank and the placement of the swapped
// sums cost as much as the multiply-adds they saved.

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
  const bool ok =
      ge_frombytes_inl(x, y, small, b, c.d, c.sqrt_m1, c.y8_0, c.y8_1);
  fe_mul(t, x, y);
  return ok;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define DC_THREADS 64
#define DC_WIDE_BLOCKS 8   // blocks an SM of the wide build: 128 registers

// Thread i runs lanes i, i + T, i + 2T, ... of the T threads launched;
// MINB blocks an SM bound the registers.
template <int MINB>
__global__ void __launch_bounds__(DC_THREADS, MINB)
    decompress_kernel(const uint8_t *b0, long long b0_stride,
                      const uint8_t *b1, long long b1_stride,
                      const int32_t *consts, int n, int lanes, uint8_t *bits,
                      int64_t *pts) {
  dc_consts c;
  uint32_t *cw = &c.d.v[0];
  for (int i = 0; i < DC_NCONST * 10; i++) cw[i] = (uint32_t)consts[i];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       lane < lanes; lane += stride) {
    const int which = lane >= n;
    const long long j = lane - (long long)which * n;
    const uint8_t *b = which ? b1 + j * b1_stride : b0 + j * b0_stride;
    fe x, y, t, one;
    bool small;
    const bool ok = dc_lane(c, b, small, x, y, t);
    uint8_t *bw = bits + (long long)which * 2 * n;
    bw[j] = ok;
    bw[n + j] = small;
    int64_t *pw = pts + (long long)which * 40 * n;
    fe_set(one, 1);
    fe_store(pw, n, j, x);
    fe_store(pw + 10LL * n, n, j, y);
    fe_store(pw + 20LL * n, n, j, one);
    fe_store(pw + 30LL * n, n, j, t);
  }
}

// lanes = n (b0 alone) or 2 n (b0, then b1).  The grid holds no more
// threads than the card keeps resident: a second wave would run its few
// warps alone, each at one lane chain's latency.  A batch that fits the
// unbounded build's wave (217 registers, 8 warps an SM) runs there, a
// lane a thread; a larger one (the RLC pair at 32768 signatures) runs on
// the build held to 128 registers (16 warps an SM, a few spills), whose
// threads take the fewest lanes each that fit the batch in one wave.
extern "C" int fd_decompress(const uint8_t *b0, long long b0_stride,
                             const uint8_t *b1, long long b1_stride,
                             const int32_t *consts, int n, int lanes,
                             uint8_t *bits, int64_t *pts, void *stream) {
  static long long resident[2];   // one kind of card a process
  if (!resident[0]) {
    int dev, sms, per_sm[2];
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[0], decompress_kernel<1>, DC_THREADS, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm[1], decompress_kernel<DC_WIDE_BLOCKS>, DC_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    for (int k = 0; k < 2; k++)
      resident[k] = (long long)sms * per_sm[k] * DC_THREADS;
  }
  const int wide = lanes > resident[0];
  const long long each = (lanes + resident[wide] - 1) / resident[wide];
  const long long threads = (lanes + each - 1) / each;
  const int blocks = (int)((threads + DC_THREADS - 1) / DC_THREADS);
  if (wide)
    decompress_kernel<DC_WIDE_BLOCKS>
        <<<blocks, DC_THREADS, 0, (cudaStream_t)stream>>>(
            b0, b0_stride, b1, b1_stride, consts, n, lanes, bits, pts);
  else
    decompress_kernel<1><<<blocks, DC_THREADS, 0, (cudaStream_t)stream>>>(
        b0, b0_stride, b1, b1_stride, consts, n, lanes, bits, pts);
  return (int)cudaGetLastError();
}
#endif
