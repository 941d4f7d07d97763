// The RLC batch check's scalar chain: one thread per signature.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::rlc_recode
// (_rlc_recode_kernel).  Per lane (rlc_lane): S < L, k = digest mod L,
// w = z k mod L and z s mod L (sc_mul_mod_l, a 22 x 11-limb product), the
// 64 unsigned 4-bit windows of w and the 32 of z.  Reads s (32 B), the
// digest (64 B) and z (16 B) through their row strides; writes ok_s
// (uint8, n), the windows as uint8 (64, n) and (32, n) planes and z s as
// int64 (22, n) limb planes (lane j of row i at i * n + j), which torch
// sums over the batch (scalar25519.sum_mod_l).
//
// On the TPU this chain stayed in XLA: the Pallas kernel ran each limb
// row as a (1, block) vector and used an eighth of every vector tile.
// Here a lane is a thread, and the whole chain stays in it.
//
// What bounds it: operations.  A lane does the digest's fold ladder (495
// products) and two products mod L (242 + 198 products each), some 4,000
// further int64 carry and compare steps, against 112 bytes read and 273
// written.  What the design does about it: the limbs stay in the thread
// (registers and local memory), and blocks of RLC_THREADS spread a batch
// of a few thousand lanes over all SMs.

#include "sc25519.cuh"

// One lane.  Returns ok_s; writes w's 64 windows, z's 32 and z s's 22
// canonical limbs.
FD_FN bool rlc_lane(const uint8_t *s, const uint8_t *digest,
                    const uint8_t *z, uint8_t *w_win, uint8_t *z_win,
                    int64_t *zs) {
  int64_t kl[22], sl[22], zl[11], wl[22];
  sc_reduce512(kl, digest);
  sc_bytes_to_limbs<32, 22>(sl, s);
  sc_bytes_to_limbs<16, 11>(zl, z);
  sc_mul_mod_l(wl, kl, zl);
  sc_mul_mod_l(zs, sl, zl);
  for (int i = 0; i < 64; i++) w_win[i] = sc_window(wl, i);
  for (int i = 0; i < 32; i++) z_win[i] = sc_window(zl, i);
  return sc_is_canonical(s);
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define RLC_THREADS 64

__global__ void __launch_bounds__(RLC_THREADS)
    rlc_recode_kernel(const uint8_t *s, long long s_stride,
                      const uint8_t *digest, long long digest_stride,
                      const uint8_t *z, long long z_stride, int n,
                      uint8_t *ok, uint8_t *w_out, uint8_t *z_out,
                      int64_t *zs_out) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint8_t ww[64], zw[32];
  int64_t zs[22];
  ok[lane] = rlc_lane(s + lane * s_stride, digest + lane * digest_stride,
                      z + lane * z_stride, ww, zw, zs);
  for (int i = 0; i < 64; i++) w_out[i * (long long)n + lane] = ww[i];
  for (int i = 0; i < 32; i++) z_out[i * (long long)n + lane] = zw[i];
  for (int i = 0; i < 22; i++) zs_out[i * (long long)n + lane] = zs[i];
}

extern "C" int fd_rlc_recode(const uint8_t *s, long long s_stride,
                             const uint8_t *digest, long long digest_stride,
                             const uint8_t *z, long long z_stride, int n,
                             uint8_t *ok, uint8_t *w_out, uint8_t *z_out,
                             int64_t *zs_out, void *stream) {
  const int blocks = (n + RLC_THREADS - 1) / RLC_THREADS;
  rlc_recode_kernel<<<blocks, RLC_THREADS, 0, (cudaStream_t)stream>>>(
      s, s_stride, digest, digest_stride, z, z_stride, n, ok, w_out, z_out,
      zs_out);
  return (int)cudaGetLastError();
}
#endif
