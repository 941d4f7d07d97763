// The RLC batch check's scalar chain, two threads a signature.
//
// Replaces firedancer_tpu/ops/curve_pallas.py::rlc_recode
// (_rlc_recode_kernel).  Per lane: S < L, k = digest mod L, w = z k mod L
// and z s mod L (sc25519.cuh: 28-bit limbs, 10 x 5-limb products), the 64
// unsigned 4-bit windows of w and the 32 of z.  Reads s (32 B), the digest
// (64 B) and z (16 B) through their row strides; writes ok_s (n), the
// windows as uint8 (64, n) and (32, n) planes and z s as int64 (22, n)
// canonical 12-bit limb planes (lane j of row i at i * n + j), which torch
// sums over the batch (scalar25519.sum_mod_l).
//
// On the TPU this chain stayed in XLA: the Pallas kernel ran each limb
// row as a (1, block) vector and used an eighth of every vector tile.
//
// What bounds it: bytes.  A lane reads 112 bytes and writes 273; the
// least arithmetic for the function, counted in 32-bit words (about 170
// word products of the digest's folds and the two products mod L, their
// carries and the 118 output values), is some 600 32-bit operations,
// under a third of the bytes' time at the card's int32 rate.  What the
// design does about it: the rows are staged through shared memory by
// coalesced word loads (a thread reading its own 64-byte row would touch
// 32 lines a load), and every output goes straight from registers to its
// plane, where a warp's store is 32 neighbouring bytes or words.  A lane
// is split by output over two warps, with nothing to exchange: role 0
// reduces the digest and makes w and its windows, role 1 tests S, makes
// z s and z's windows.  So a batch of 4,096 lanes runs 256 warps, two an
// SM, and each lane's chain is shorter.

#include "sc25519.cuh"

// Role 0 of a lane: k = digest mod L, w = z k mod L; sink gets w's
// windows (sc_windows).
template <typename Sink>
FD_FN void rlc_k_side(const uint32_t *digest, const uint32_t *z,
                      Sink &&sink) {
  uint32_t k[10], zl[5], w[10], ww[8];
  sc_reduce512(k, digest);
  sc_words_to_limbs<4, 5>(zl, z);
  sc_mul_mod_l(w, k, zl);
  sc_limbs_to_words(ww, w);
  sc_windows<8>(ww, sink);
}

// Role 1: S < L (returned) and zs = z s mod L as 8 words; sink gets z's
// windows.
template <typename Sink>
FD_FN bool rlc_s_side(const uint32_t *s, const uint32_t *z, uint32_t *zs,
                      Sink &&sink) {
  uint32_t sl[10], zl[5], r[10];
  sc_words_to_limbs<8, 10>(sl, s);
  sc_words_to_limbs<4, 5>(zl, z);
  sc_mul_mod_l(r, sl, zl);
  sc_limbs_to_words(zs, r);
  sc_windows<4>(z, sink);
  return sc_is_canonical(s);
}

// 12-bit limb i of a value's 8 words (the scalar25519 radix).
FD_FN int64_t rlc_limb12(const uint32_t *w, int i) {
  const int q = 12 * i / 32, r = 12 * i % 32;
  uint32_t v = w[q] >> r;
  if (r > 20 && q + 1 < 8) v |= w[q + 1] << (32 - r);
  return v & 0xfff;
}

// Window bytes of word q into uint8 planes: window w of lane j at out[w
// n + j], so a warp's store is 32 neighbouring bytes.
FD_FN void rlc_put_plane(uint8_t *out, long long n, long long lane, int q,
                         uint32_t e, uint32_t o) {
#pragma unroll
  for (int j = 0; j < 4; j++) {
    out[(8 * q + 2 * j) * n + lane] = (uint8_t)(e >> 8 * j);
    out[(8 * q + 2 * j + 1) * n + lane] = (uint8_t)(o >> 8 * j);
  }
}

// One lane, both roles.  Returns ok_s; writes w's 64 windows, z's 32 and
// z s's 22 canonical 12-bit limbs.
FD_FN bool rlc_lane(const uint8_t *s, const uint8_t *digest,
                    const uint8_t *z, uint8_t *w_win, uint8_t *z_win,
                    int64_t *zs) {
  uint32_t sw[8], dw[16], zw[4], r[8];
  sc_load_words<8>(sw, s);
  sc_load_words<16>(dw, digest);
  sc_load_words<4>(zw, z);
  rlc_k_side(dw, zw, [&](int q, uint32_t e, uint32_t o) {
    sc_put_windows(w_win, q, e, o);
  });
  const bool ok = rlc_s_side(sw, zw, r, [&](int q, uint32_t e, uint32_t o) {
    sc_put_windows(z_win, q, e, o);
  });
#pragma unroll
  for (int i = 0; i < 22; i++) zs[i] = rlc_limb12(r, i);
  return ok;
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define RLC_LANES 32      // a block: one warp, 32 lanes of one role

// Block 2 b + r runs role r of lanes 32 b .. 32 b + 31.  aligned: bit 0
// s, bit 1 the digest, bit 2 z (the view's base and row stride are
// multiples of 4).
__global__ void __launch_bounds__(RLC_LANES)
    rlc_recode_kernel(const uint8_t *s, long long s_stride,
                      const uint8_t *digest, long long digest_stride,
                      const uint8_t *z, long long z_stride, int n,
                      int aligned, uint8_t *ok, uint8_t *w_out,
                      uint8_t *z_out, int64_t *zs_out) {
  __shared__ uint32_t sm_x[RLC_LANES * 17], sm_z[RLC_LANES * 5];
  const int t = threadIdx.x, role = blockIdx.x & 1;
  const long long base = (long long)(blockIdx.x >> 1) * RLC_LANES;
  const long long lane = base + t;
  uint32_t vz[4], vx[16];
  sc_load_rows<4>(vz, z, z_stride, base, n, aligned & 4);
  if (role == 0) {
    sc_load_rows<16>(vx, digest, digest_stride, base, n, aligned & 2);
    sc_store_rows<16>(sm_x, vx);
  } else {
    sc_load_rows<8>(vx, s, s_stride, base, n, aligned & 1);
    sc_store_rows<8>(sm_x, vx);
  }
  sc_store_rows<4>(sm_z, vz);
  __syncwarp();
  uint32_t zw[4];
#pragma unroll
  for (int c = 0; c < 4; c++) zw[c] = sm_z[t * 5 + c];
  if (lane >= n) return;
  if (role == 0) {
    uint32_t dw[16];
#pragma unroll
    for (int c = 0; c < 16; c++) dw[c] = sm_x[t * 17 + c];
    rlc_k_side(dw, zw, [&](int q, uint32_t e, uint32_t o) {
      rlc_put_plane(w_out, n, lane, q, e, o);
    });
  } else {
    uint32_t sw[8], r[8];
#pragma unroll
    for (int c = 0; c < 8; c++) sw[c] = sm_x[t * 9 + c];
    ok[lane] = rlc_s_side(sw, zw, r, [&](int q, uint32_t e, uint32_t o) {
      rlc_put_plane(z_out, n, lane, q, e, o);
    });
#pragma unroll
    for (int i = 0; i < 22; i++)
      zs_out[i * (long long)n + lane] = rlc_limb12(r, i);
  }
}

extern "C" int fd_rlc_recode(const uint8_t *s, long long s_stride,
                             const uint8_t *digest, long long digest_stride,
                             const uint8_t *z, long long z_stride, int n,
                             int aligned, uint8_t *ok, uint8_t *w_out,
                             uint8_t *z_out, int64_t *zs_out, void *stream) {
  const int groups = (n + RLC_LANES - 1) / RLC_LANES;
  rlc_recode_kernel<<<2 * groups, RLC_LANES, 0, (cudaStream_t)stream>>>(
      s, s_stride, digest, digest_stride, z, z_stride, n, aligned, ok, w_out,
      z_out, zs_out);
  return (int)cudaGetLastError();
}
#endif
