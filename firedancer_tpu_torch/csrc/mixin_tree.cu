// Microblock mixins: the merkle root of each microblock's first
// signatures, one thread block a microblock, each node hashed on a pair
// of warps (a rounds warp and a schedule warp, as in poh_spans.cu).
//
// Replaces firedancer_tpu/ballet/entry.py::_mixin_roots, which the JAX
// package compiles with XLA (there is no Pallas kernel); in plain torch a
// tree is thousands of small launches a level.  sigs is
// (B, W, 64) with W a power of two, widths (B,) the live leaves of each
// tree (>= 1).  A leaf is SHA-256(0x00 || sig), an interior node
// SHA-256(0x01 || left || right).  The levels follow _mixin_roots' rule
// exactly: where a pair's right index falls past the live width w, the
// left node is hashed with itself; then w <- (w + 1) / 2, and once
// w <= 1 the root stays in column 0.  A width past W gives W's tree and
// a width below 1 the first leaf, as that rule does.  Roots out as
// (B, 32).
//
// What bounds it: a tree's levels are serial, and a node is two
// dependent compressions (65 bytes), so a tree of w leaves takes
// 2 (1 + ceil(log2 w)) compression latencies: 12 at the poh_dev tile's
// 31 leaves.  What the design does about it:
//  - a node's compressions run on a pair of warps (sha256.cuh): the
//    schedule warp computes K_t + W_t of rounds 16-63 of both blocks and
//    hands them over 16 words at a time, the rounds warp runs the rounds
//    with its two-input adds on the FMA pipe; the second block's 14
//    constant words and H0 fold into the rounds warp's first rounds;
//  - a handover is a bar.sync of the pair's two warps (its own named
//    barrier, 1 + pair), into one of two buffers in turn, so that the
//    schedule warp writes the next chunk while the rounds warp runs this
//    one; a block holds at most MIXIN_PAIRS pairs, and with more nodes
//    than rounds lanes a lane hashes several nodes of a level in turn;
//  - a leaf's 64 bytes come in as four 16-byte loads a lane, and each
//    message word is one byte permute of two of them; both warps of a
//    pair load the leaf, so the leaf level needs no handover of words;
//  - a level's digests go through shared memory, two level buffers in
//    turn, so a level costs one __syncthreads; only live nodes are
//    hashed, so a narrow tree stops at its own depth.

#include "sha256.cuh"

// Block 1 of a leaf, SHA-256(0x00 || sig): u is the signature as 16
// little-endian words (bytes 4i .. 4i + 3 in word i).  The message is
// the prefix byte and sig, so block 1's word i holds sig bytes 4i - 1 ..
// 4i + 2; w0b is block 2's first word, sig's last byte, then 0x80.
FD_FN void mixin_leaf_words(uint32_t w[16], uint32_t &w0b,
                            const uint32_t u[16]) {
  w[0] = s256_perm(0u, u[0], 0x0456u);
#pragma unroll
  for (int i = 1; i < 16; i++) w[i] = s256_perm(u[i - 1], u[i], 0x3456u);
  w0b = (u[15] & 0xff000000u) | 0x800000u;
}

// Block 1 of an interior node, SHA-256(0x01 || left || right): x is the
// two children's digests as 16 big-endian words.
FD_FN void mixin_node_words(uint32_t w[16], uint32_t &w0b,
                            const uint32_t x[16]) {
  w[0] = 0x01000000u | (x[0] >> 8);
#pragma unroll
  for (int i = 1; i < 16; i++) w[i] = (x[i - 1] << 24) | (x[i] >> 8);
  w0b = (x[15] << 24) | 0x800000u;
}

// The children of node k of a level over a level of n live nodes: 2k
// and 2k + 1, the left one again where 2k + 1 >= n.
FD_FN int mixin_right(int k, int n) {
  return 2 * k + 1 < n ? 2 * k + 1 : 2 * k;
}

// The schedule warp's part of a node: K_t + W_t of rounds 16-63 of block
// 1 (words w, overwritten) as chunks 0-2, then of block 2 (w0b, 14 zero
// words and the bit length 520) as chunks 3-5.  Block 2's ring takes in
// chunk 2's 0, so that its words wait for chunk 2's handover.
template <class Put>
FD_FN void mixin_schedule(uint32_t w[16], uint32_t w0b, Put put) {
  uint32_t z = 0;
  s256_schedule(w, [&](int c, const uint32_t *kw) { return z = put(c, kw); });
  w[0] = w0b ^ z;
#pragma unroll
  for (int i = 1; i < 15; i++) w[i] = 0;
  w[15] = 520u;
  s256_schedule(w, [&](int c, const uint32_t *kw) { return put(3 + c, kw); });
}

// The rounds warp's part of a node: h = the digest.  Block 1 runs from
// H0 on w; block 2 from block 1's digest, its rounds 0-15 on the constant
// words and w0b; rounds 16-63 of each take chunks from get(c, kw, v).
template <class Get>
FD_FN void mixin_rounds(uint32_t h[8], const uint32_t w[16], uint32_t w0b,
                        Get get) {
  uint32_t v[8];
  s256_rounds_h0(v, w, [&](int c, uint32_t *kw, const uint32_t *x) {
    get(c, kw, x);
  });
  s256_h0(h);
#pragma unroll
  for (int i = 0; i < 8; i++) v[i] = h[i] += v[i];
  const uint32_t k16[16] = {S256_K16};
  uint32_t kw[16];
#pragma unroll
  for (int i = 0; i < 16; i++) kw[i] = k16[i];
  kw[0] += w0b;
  kw[15] += 520u;
  // t0 8: the state is variable from the first round, K + W folds
  s256_rounds8(v, kw, 8);
  s256_rounds8(v, kw + 8, 8);
#pragma unroll 1
  for (int c = 3; c < 6; c++) {
    get(c, kw, v);
    s256_rounds8(v, kw, 16);
    s256_rounds8(v, kw + 8, 16);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] += v[i];
}

#if !defined(__CUDACC__)
// A node's digest on the host, the schedule warp's chunks then the
// rounds warp's rounds, in the order the pair's barriers impose.
static inline void mixin_hash(uint32_t h[8], const uint32_t w[16],
                              uint32_t w0b) {
  uint32_t ring[16], kws[96];
  for (int i = 0; i < 16; i++) ring[i] = w[i];
  mixin_schedule(ring, w0b, [&](int c, const uint32_t *kw) {
    for (int i = 0; i < 16; i++) kws[16 * c + i] = kw[i];
    return 0u;
  });
  mixin_rounds(h, w, w0b, [&](int c, uint32_t *kw, const uint32_t *) {
    for (int i = 0; i < 16; i++) kw[i] = kws[16 * c + i];
  });
}

// One tree as the kernel walks it: sigs its (W, 64) rows, w its width;
// level buffers of 8 words a node.
static inline void mixin_tree_host(const uint8_t *sigs, int W, int w,
                                   uint8_t root[32]) {
  w = w < 1 ? 1 : (w > W ? W : w);
  uint32_t *cur = new uint32_t[8 * W], *nxt = new uint32_t[8 * W];
  uint32_t m[16], x[16], u[16], w0b;
  for (int j = 0; j < w; j++) {
    for (int i = 0; i < 16; i++)
      u[i] = (uint32_t)sigs[64 * j + 4 * i] |
             ((uint32_t)sigs[64 * j + 4 * i + 1] << 8) |
             ((uint32_t)sigs[64 * j + 4 * i + 2] << 16) |
             ((uint32_t)sigs[64 * j + 4 * i + 3] << 24);
    mixin_leaf_words(m, w0b, u);
    mixin_hash(&cur[8 * j], m, w0b);
  }
  for (int n = w; n > 1; n = (n + 1) / 2) {
    for (int k = 0; k < (n + 1) / 2; k++) {
      const int a = 2 * k, b = mixin_right(k, n);
      for (int i = 0; i < 8; i++) {
        x[i] = cur[8 * a + i];
        x[8 + i] = cur[8 * b + i];
      }
      mixin_node_words(m, w0b, x);
      mixin_hash(&nxt[8 * k], m, w0b);
    }
    uint32_t *t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = 0; i < 8; i++) s256_store_be(root + 4 * i, cur[i]);
  delete[] cur;
  delete[] nxt;
}
#endif

#if defined(__CUDACC__)
#define MIXIN_MAX_W 1024
#define MIXIN_PAIRS 8   // pairs a block at most: 512 threads, barriers 1-8

// A pair's handover buffers: two chunks of K + W, 4 words a lane a row.
struct MixShared {
  uint4 kw[2][4][32];
};

__device__ __forceinline__ void mixin_sync(int bar) {
  asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
}

// Chunk c of a node (0-5) goes through buffer c & 1 at the pair's
// barrier.  The schedule warp reads its chunk back after the barrier and
// returns it XORed with itself, a 0 that keeps ptxas from starting the
// next chunk's words before the barrier; the rounds warp's barrier id
// takes its working words ANDed with S256_ZERO, so that it waits for the
// rounds before it.
struct MixPut {
  MixShared *sh;
  int l, bar;
  __device__ __forceinline__ uint32_t operator()(int c,
                                                 const uint32_t *kw) const {
#pragma unroll
    for (int q = 0; q < 4; q++)
      sh->kw[c & 1][q][l] =
          make_uint4(kw[4 * q], kw[4 * q + 1], kw[4 * q + 2], kw[4 * q + 3]);
    mixin_sync(bar);
    return sh->kw[c & 1][0][l].x ^ kw[0];
  }
};

struct MixGet {
  const MixShared *sh;
  int l, bar;
  __device__ __forceinline__ void operator()(int c, uint32_t *kw,
                                             const uint32_t *v) const {
    mixin_sync(bar + (int)((v[0] ^ v[4]) & S256_ZERO));
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const uint4 x = sh->kw[c & 1][q][l];
      kw[4 * q] = x.x; kw[4 * q + 1] = x.y;
      kw[4 * q + 2] = x.z; kw[4 * q + 3] = x.w;
    }
  }
};

// One node on the pair: the rounds warp's lanes end with the digest in h.
__device__ __forceinline__ void mixin_pair_hash(MixShared *sh, int l,
                                                int bar, bool rounds,
                                                uint32_t w[16], uint32_t w0b,
                                                uint32_t h[8]) {
  if (rounds)
    mixin_rounds(h, w, w0b, MixGet{sh, l, bar});
  else
    mixin_schedule(w, w0b, MixPut{sh, l, bar});
}

// A block of P pairs: warps 0 .. P - 1 are the rounds warps, P .. 2P - 1
// the schedule warps, so that each sub-partition holds both kinds; lane r
// of either kind works node base + r of a pass.  Shared memory: the
// pairs' buffers, then the level buffers, W and max(W / 2, 1) nodes of
// two uint4 each.
__global__ void __launch_bounds__(64 * MIXIN_PAIRS)
mixin_tree_kernel(const uint8_t *sigs, const int *widths, int W,
                  uint8_t *roots) {
  extern __shared__ uint4 smem[];
  const int P = blockDim.x / 64, R = 32 * P;
  const int b = blockIdx.x, t = threadIdx.x;
  const bool rounds = t < R;
  const int r = rounds ? t : t - R, p = r >> 5, l = r & 31;
  MixShared *sh = (MixShared *)smem + p;
  const int bar = 1 + p;
  uint4 *cur = smem + P * (sizeof(MixShared) / sizeof(uint4));
  uint4 *nxt = cur + 2 * W;
  int n = widths[b];
  n = n < 1 ? 1 : (n > W ? W : n);
  const uint4 *sig = (const uint4 *)(sigs + (long long)b * W * 64);
  uint32_t m[16], h[8], w0b;
  for (int base = 0; base < n; base += R) {
    if (base + 32 * p >= n) continue;          // the pair has no live leaf
    const int j = base + r < n ? base + r : n - 1;
    uint32_t u[16];
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const uint4 x = sig[4 * j + q];
      u[4 * q] = x.x; u[4 * q + 1] = x.y; u[4 * q + 2] = x.z;
      u[4 * q + 3] = x.w;
    }
    mixin_leaf_words(m, w0b, u);
    mixin_pair_hash(sh, l, bar, rounds, m, w0b, h);
    if (rounds && base + r < n) {
      cur[2 * j] = make_uint4(h[0], h[1], h[2], h[3]);
      cur[2 * j + 1] = make_uint4(h[4], h[5], h[6], h[7]);
    }
  }
  __syncthreads();
  for (; n > 1; n = (n + 1) / 2) {
    const int half = (n + 1) / 2;
    for (int base = 0; base < half; base += R) {
      if (base + 32 * p >= half) continue;
      const int k = base + r < half ? base + r : half - 1;
      const int a = 2 * k, c = mixin_right(k, n);
      uint32_t x[16];
      const uint4 q0 = cur[2 * a], q1 = cur[2 * a + 1];
      const uint4 q2 = cur[2 * c], q3 = cur[2 * c + 1];
      x[0] = q0.x; x[1] = q0.y; x[2] = q0.z; x[3] = q0.w;
      x[4] = q1.x; x[5] = q1.y; x[6] = q1.z; x[7] = q1.w;
      x[8] = q2.x; x[9] = q2.y; x[10] = q2.z; x[11] = q2.w;
      x[12] = q3.x; x[13] = q3.y; x[14] = q3.z; x[15] = q3.w;
      mixin_node_words(m, w0b, x);
      mixin_pair_hash(sh, l, bar, rounds, m, w0b, h);
      if (rounds && base + r < half) {
        nxt[2 * k] = make_uint4(h[0], h[1], h[2], h[3]);
        nxt[2 * k + 1] = make_uint4(h[4], h[5], h[6], h[7]);
      }
    }
    __syncthreads();
    uint4 *tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (t < 8) s256_store_be(roots + 32 * b + 4 * t, ((const uint32_t *)cur)[t]);
}

extern "C" int fd_mixin_tree(const uint8_t *sigs, const int *widths, int B,
                             int W, uint8_t *roots, void *stream) {
  if (W < 1 || W > MIXIN_MAX_W || (W & (W - 1)) || ((uintptr_t)sigs & 15))
    return -1;
  const int P = W / 32 < 1 ? 1 : (W / 32 > MIXIN_PAIRS ? MIXIN_PAIRS : W / 32);
  const size_t smem = P * sizeof(MixShared) +
                      (size_t)(2 * W + 2 * (W / 2 < 1 ? 1 : W / 2)) * 16;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mixin_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mixin_tree_kernel<<<B, 64 * P, smem, (cudaStream_t)stream>>>(sigs, widths,
                                                               W, roots);
  return (int)cudaGetLastError();
}
#endif
