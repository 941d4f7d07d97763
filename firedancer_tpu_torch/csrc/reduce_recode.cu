// S canonicity, the digest mod L and the signed recode of S and k: one
// thread per signature.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::reduce_recode
// (_reduce_recode_kernel), the first kernel of the split strict layout.
// Per lane: sc_reduce_recode (sc25519.cuh), the same code the fused tail
// runs.  Reads s (32 B) and the digest (64 B) through their row strides;
// writes ok_s (uint8, n) and the four uint8 planes smag, ssgn, kmag, ksgn
// as one (4, 64, n) array: window w of lane j at w * n + j, low window
// first, so the threads of a warp write neighbouring bytes.
//
// What bounds it: operations.  A lane does the 44 -> 23 limb fold ladder
// (495 products of 12-bit limbs), some 1,300 further int64 carry and
// compare steps, and two 64-window recodes, against 96 bytes read and
// 257 written.  What the design does about it: the limbs stay in the
// thread (registers and a few hundred bytes of local memory), and blocks
// of RR_THREADS spread a batch of a few thousand lanes over all SMs.

#include "sc25519.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define RR_THREADS 64

__global__ void __launch_bounds__(RR_THREADS)
    reduce_recode_kernel(const uint8_t *s, long long s_stride,
                         const uint8_t *digest, long long digest_stride,
                         int n, uint8_t *ok, uint8_t *wins) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint8_t w[4][64];
  ok[lane] = sc_reduce_recode(s + lane * s_stride,
                              digest + lane * digest_stride, w[0], w[1],
                              w[2], w[3]);
  for (int p = 0; p < 4; p++)
    for (int i = 0; i < 64; i++)
      wins[((long long)p * 64 + i) * n + lane] = w[p][i];
}

extern "C" int fd_reduce_recode(const uint8_t *s, long long s_stride,
                                const uint8_t *digest,
                                long long digest_stride, int n, uint8_t *ok,
                                uint8_t *wins, void *stream) {
  const int blocks = (n + RR_THREADS - 1) / RR_THREADS;
  reduce_recode_kernel<<<blocks, RR_THREADS, 0, (cudaStream_t)stream>>>(
      s, s_stride, digest, digest_stride, n, ok, wins);
  return (int)cudaGetLastError();
}
#endif
