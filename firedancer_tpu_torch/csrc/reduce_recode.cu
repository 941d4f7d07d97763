// S canonicity, the digest mod L and the signed recode of S and k: two
// threads a signature.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::reduce_recode
// (_reduce_recode_kernel), the first kernel of the split strict layout.
// Per lane what sc_reduce_recode (sc25519.cuh) computes for the fused
// tail: S < L, k = digest mod L, and the signed windows of S (its bytes as
// they are) and of k, recoded by masks.  Reads s (32 B) and the digest
// (64 B) through their row strides; writes ok_s (n) and the four uint8
// planes smag, ssgn, kmag, ksgn as one (4, 64, n) array: window w of lane
// j at w * n + j, low window first.
//
// What bounds it: bytes.  A lane reads 96 bytes and writes 257; the least
// arithmetic for the function (the digest's three folds in 32-bit words,
// about 60 word products and their carries, S < L, and one operation for
// each of the 256 window bytes) is some 420 32-bit operations, a quarter
// of the bytes' time at the card's int32 rate.  What the design
// does about it: the rows are staged through shared memory by coalesced
// word loads, and the windows leave through shared memory too, a plane's
// 32-lane row as two 16-byte stores (writing each byte from registers
// took twice the instructions: an address, a shift and a store a byte).
// A lane is split over two warps, with nothing to exchange: role 0
// reduces the digest and recodes k, role 1 tests and recodes S.  So a
// batch of 4,096 lanes runs 256 warps, two an SM, and each lane's chain
// is shorter.

#include "sc25519.cuh"

#if defined(__CUDACC__)
#include <cuda_runtime.h>

// A warp's 64 window bytes a lane leave through shared memory:
// rr_put_tile puts window w of the warp's lane t at tile[32 w + t];
// rr_tile_out then writes row w's 32 bytes to out[w n + base ..], as two
// 16-byte stores when n is a multiple of 16 (each row then starts on 16
// bytes), else by bytes, skipping lanes past n.
__device__ __forceinline__ void rr_put_tile(uint8_t *tile, int q, uint32_t e,
                                            uint32_t o) {
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; j++) {
    tile[32 * (8 * q + 2 * j) + t] = (uint8_t)(e >> 8 * j);
    tile[32 * (8 * q + 2 * j + 1) + t] = (uint8_t)(o >> 8 * j);
  }
}

__device__ __forceinline__ void rr_tile_out(uint8_t *out, const uint8_t *tile,
                                            long long n, long long base) {
  const int t = threadIdx.x & 31;
  __syncwarp();
  if (n % 16 == 0) {
    const uint4 *src = reinterpret_cast<const uint4 *>(tile);
#pragma unroll
    for (int it = 0; it < 4; it++) {
      const int w = 16 * it + t / 2, h = t % 2;
      if (base + 16 * h < n)
        *reinterpret_cast<uint4 *>(out + w * n + base + 16 * h) =
            src[2 * w + h];
    }
  } else if (base + t < n) {
#pragma unroll 8
    for (int w = 0; w < 64; w++) out[w * n + base + t] = tile[32 * w + t];
  }
}

#define RR_LANES 32       // a block: one warp, 32 lanes of one role

// Block 2 b + r runs role r of lanes 32 b .. 32 b + 31.  aligned: bit 0
// s, bit 1 the digest (the view's base and row stride are multiples of
// 4).
__global__ void __launch_bounds__(RR_LANES)
    reduce_recode_kernel(const uint8_t *s, long long s_stride,
                         const uint8_t *digest, long long digest_stride,
                         int n, int aligned, uint8_t *ok, uint8_t *wins) {
  __shared__ uint32_t sm_x[RR_LANES * 17];
  __shared__ __align__(16) uint8_t tile[2][64 * RR_LANES];
  const int t = threadIdx.x, role = blockIdx.x & 1;
  const long long base = (long long)(blockIdx.x >> 1) * RR_LANES;
  const long long lane = base + t;
  const long long plane = 64 * (long long)n;
  uint32_t v[16];
  if (role == 0) {
    sc_load_rows<16>(v, digest, digest_stride, base, n, aligned & 2);
    sc_store_rows<16>(sm_x, v);
  } else {
    sc_load_rows<8>(v, s, s_stride, base, n, aligned & 1);
    sc_store_rows<8>(sm_x, v);
  }
  __syncwarp();
  uint32_t x[8];
  if (role == 0) {
    uint32_t dw[16], k[10];
#pragma unroll
    for (int c = 0; c < 16; c++) dw[c] = sm_x[t * 17 + c];
    sc_reduce512(k, dw);
    sc_limbs_to_words(x, k);
  } else {
#pragma unroll
    for (int c = 0; c < 8; c++) x[c] = sm_x[t * 9 + c];
    if (lane < n) ok[lane] = sc_is_canonical(x);
  }
  sc_signed_recode(x, [&](int q, uint32_t me, uint32_t mo, uint32_t se,
                          uint32_t so) {
    rr_put_tile(tile[0], q, me, mo);
    rr_put_tile(tile[1], q, se, so);
  });
  uint8_t *out = wins + (role == 0 ? 2 : 0) * plane;
  rr_tile_out(out, tile[0], n, base);
  rr_tile_out(out + plane, tile[1], n, base);
}

extern "C" int fd_reduce_recode(const uint8_t *s, long long s_stride,
                                const uint8_t *digest,
                                long long digest_stride, int n, int aligned,
                                uint8_t *ok, uint8_t *wins, void *stream) {
  const int groups = (n + RR_LANES - 1) / RR_LANES;
  reduce_recode_kernel<<<2 * groups, RR_LANES, 0, (cudaStream_t)stream>>>(
      s, s_stride, digest, digest_stride, n, aligned, ok, wins);
  return (int)cudaGetLastError();
}
#endif
