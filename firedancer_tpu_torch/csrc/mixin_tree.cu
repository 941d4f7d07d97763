// Microblock mixins: the merkle root of each microblock's first
// signatures, one thread block a microblock and one thread a leaf.
//
// Replaces firedancer_tpu/ballet/entry.py::_mixin_roots, which the JAX
// package compiles with XLA (there is no Pallas kernel); in plain torch a
// tree is thousands of small launches a level.  sigs is
// (B, W, 64) with W a power of two, widths (B,) the live leaves of each
// tree (>= 1).  A leaf is SHA-256(0x00 || sig), an interior node
// SHA-256(0x01 || left || right).  The levels follow _mixin_roots' rule
// exactly: where a pair's right index falls past the live width w, the
// left node is hashed with itself; then w <- (w + 1) / 2, and once
// w <= 1 the root stays in column 0.  Roots out as (B, 32).
//
// What bounds it: a tree level is one dependent pair of compressions a
// thread, and the levels are serial, so a microblock of W leaves takes
// (1 + log2 W) hash latencies.  What the design does about it: the
// nodes live in shared memory as big-endian words, one level after each
// __syncthreads, so a tree costs one launch, not one a level; and the
// microblocks of a tick are the grid, side by side on the SMs.

#include "sha256.cuh"

// One node of a tree level, as _mixin_roots computes it: the pair
// (2k, 2k + 1) of the level below, the right one replaced by the left
// where 2k + 1 >= w.  nodes is the level, 8 words a node.
FD_FN void mixin_level_node(uint32_t out[8], const uint32_t *nodes, int k,
                            int w) {
  const int r = 2 * k + 1 < w ? 2 * k + 1 : 2 * k;
  uint32_t x[16];
  for (int i = 0; i < 8; i++) {
    x[i] = nodes[8 * (2 * k) + i];
    x[8 + i] = nodes[8 * r + i];
  }
  s256_prefixed64(out, 1, x);
}

// A leaf: SHA-256(0x00 || sig).
FD_FN void mixin_leaf(uint32_t out[8], const uint8_t *sig) {
  uint32_t x[16];
  for (int i = 0; i < 16; i++) x[i] = s256_load_be(sig + 4 * i);
  s256_prefixed64(out, 0, x);
}

#if defined(__CUDACC__)
#define MIXIN_MAX_W 1024

__global__ void mixin_tree_kernel(const uint8_t *sigs, const int *widths,
                                  int W, uint8_t *roots) {
  extern __shared__ uint32_t nodes[];  // W * 8 words
  const int b = blockIdx.x, t = threadIdx.x;
  uint32_t h[8];
  mixin_leaf(h, sigs + ((long long)b * W + t) * 64);
  for (int i = 0; i < 8; i++) nodes[8 * t + i] = h[i];
  int w = widths[b];
  for (int half = W / 2; half >= 1; half /= 2) {
    __syncthreads();
    const bool live = w > 1 && t < half;
    if (live) mixin_level_node(h, nodes, t, w);
    __syncthreads();
    if (live)
      for (int i = 0; i < 8; i++) nodes[8 * t + i] = h[i];
    if (w > 1) w = (w + 1) / 2;
  }
  __syncthreads();
  for (int i = t; i < 8; i += W) s256_store_be(roots + 32 * b + 4 * i, nodes[i]);
}

extern "C" int fd_mixin_tree(const uint8_t *sigs, const int *widths, int B,
                             int W, uint8_t *roots, void *stream) {
  if (W < 1 || W > MIXIN_MAX_W || (W & (W - 1))) return -1;
  mixin_tree_kernel<<<B, W, W * 8 * sizeof(uint32_t),
                      (cudaStream_t)stream>>>(sigs, widths, W, roots);
  return (int)cudaGetLastError();
}
#endif
