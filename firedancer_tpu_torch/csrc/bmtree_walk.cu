// Shred merkle proofs walked to their roots, one lane a proof.
//
// Replaces firedancer_tpu/ballet/bmtree.py::batch_walk_roots, which the
// JAX package compiles with XLA as one batched SHA-256 a level (there is
// no Pallas kernel); in plain torch each compression is hundreds of
// small launches.  Lane i hashes its leaf, SHA-256(LEAF_PREFIX_LONG ||
// leaf[i][:len[i]]) (26 + len bytes, up to 19 blocks), then walks
// min(depth[i], D) levels: the running node truncated to 20 bytes and
// the level's proof node, in the order the index bit (idx >> lvl) & 1
// gives (1: the proof node on the left), hashed as
// SHA-256(NODE_PREFIX_LONG || left || right) (66 bytes, 2 blocks).  The
// root is the last full 32-byte digest.  The wrapper refuses lengths
// outside [0, maxlen] and depths outside [0, D].
//
// What bounds it: the compressions, serial within a lane (a leaf of
// 1,164 bytes is 19, a depth-6 walk 12 more), and each lane's leaf row
// read once.  What the design does about it: a block is one warp, a
// thread a lane.  The warp first stages its lanes' leaf messages in
// shared memory, BMW_WIN blocks of each at a time (one window holds a
// leaf of up to 1,245 bytes, the shred's 1,164 among them): lane by
// lane, its threads copy the aligned 16-byte chunks that hold the row's
// bytes with cp.async, all in flight at once; then each thread writes
// its own lane's prefix and padding bytes around them.  The compressions
// then never wait on device memory, and a level's proof node is loaded
// while the level before it hashes.  The rows are views of any stride
// and alignment (the shred tile's are 8-byte aligned, 1,560 bytes
// apart), so a lane's message starts at its own byte offset in its
// staged row, and each message word is one byte permute of two staged
// words.  A 16-byte chunk that holds a byte of a row lies in that row's
// page, so reading all of it is safe.  Lanes whose leaf has fewer
// blocks, or whose depth is less, idle through the warp's longest.
//
// The functions also compile as host C++ (FD_FN), so the arithmetic can
// be checked on a machine without a GPU.

#include "sha256.cuh"

#define BMW_PREFIX_SZ 26
#define BMW_NODE_SZ 20
#define BMW_LANES 32                  // a block: one warp, a thread a lane
#define BMW_WIN 20                    // message blocks a lane stages at once
// a lane's staged window: up to 15 bytes before the message's first, its
// 64 BMW_WIN bytes, the 4 after them that the last word's permute reads,
// and a pad that makes the rows 83 chunks apart, so that 8 rows' chunks
// start in 8 different banks
#define BMW_STAGE_CHUNKS 83
#define BMW_STAGE_WORDS (4 * BMW_STAGE_CHUNKS)

S256_CONST uint8_t BMW_LEAF_PREFIX[BMW_PREFIX_SZ] = {
    0x00, 0x53, 0x4f, 0x4c, 0x41, 0x4e, 0x41, 0x5f, 0x4d, 0x45, 0x52, 0x4b, 0x4c,
    0x45, 0x5f, 0x53, 0x48, 0x52, 0x45, 0x44, 0x53, 0x5f, 0x4c, 0x45, 0x41, 0x46,
};  // "\x00SOLANA_MERKLE_SHREDS_LEAF"

// "\x01SOLANA_MERKLE_SHREDS_NODE" as big-endian words: bytes 0..23, and
// bytes 24..25 in the high half of word 6
S256_CONST uint32_t BMW_NODE_PREFIX_W[7] = {
    0x01534f4cu, 0x414e415fu, 0x4d45524bu, 0x4c455f53u,
    0x48524544u, 0x535f4e4fu, 0x44450000u,
};

// Blocks of a leaf message of len data bytes, padding included.
FD_FN int bmw_leaf_blocks(int len) {
  return (BMW_PREFIX_SZ + len + 9 + 63) / 64;
}

// Window w of a lane's leaf message: its blocks [BMW_WIN w, BMW_WIN (w +
// 1)), its bytes from P0 = 64 BMW_WIN w.  Staged chunk k is the 16 bytes
// at base + 16 k, base the 16-byte chunk that holds the message's byte P0
// (row byte P0 - 26); message byte P0 + j is then staged byte off + j.
// Returns off.
FD_FN int bmw_window(uint64_t row, int P0, uint64_t &base) {
  const uint64_t at = row + (uint64_t)(int64_t)(P0 - BMW_PREFIX_SZ);
  base = at & ~(uint64_t)15;
  return (int)(at & 15);
}

// Whether staged chunk k holds a byte of the row's first len.
FD_FN bool bmw_chunk_live(uint64_t base, int k, uint64_t row, int len) {
  const uint64_t c = base + 16ull * k;
  return c < row + (uint64_t)len && c + 16 > row;
}

// The window's message bytes that are not the row's, written over the
// staged chunks: the prefix (window 0), then after the row's len bytes
// the padding of a message of nb blocks, 0x80, zeros and the bit length
// (< 2^32) in the last 4 bytes.
FD_FN void bmw_fix(uint8_t *st, int off, int P0, int len, int nb) {
  const int end = P0 + 64 * BMW_WIN, m_end = 64 * nb;
  for (int p = P0; p < BMW_PREFIX_SZ && p < end; p++)
    st[off + p - P0] = BMW_LEAF_PREFIX[p];
  const uint32_t bits = (uint32_t)(BMW_PREFIX_SZ + len) * 8u;
  const int lo = BMW_PREFIX_SZ + len > P0 ? BMW_PREFIX_SZ + len : P0;
  const int hi = m_end < end ? m_end : end;
  for (int p = lo; p < hi; p++) {
    const int from_end = m_end - 1 - p;
    uint8_t v = p == BMW_PREFIX_SZ + len ? 0x80 : 0;
    if (from_end < 4) v = (uint8_t)(bits >> (8 * from_end));
    st[off + p - P0] = v;
  }
}

// Block blk of the staged window as 16 big-endian words: word i is
// staged bytes off + 64 blk + 4 i .. + 3, one permute of the two staged
// words that hold them.
FD_FN void bmw_block_words(uint32_t w[16], const uint32_t *st, int off,
                           int blk) {
  const uint32_t *s = st + (off >> 2) + 16 * blk;
  const uint32_t sel = 0x0123u + 0x1111u * (uint32_t)(off & 3);
  uint32_t lo = s[0];
#pragma unroll
  for (int i = 0; i < 16; i++) {
    const uint32_t hi = s[i + 1];
    w[i] = s256_perm(lo, hi, sel);
    lo = hi;
  }
}

// One level: h becomes SHA-256(NODE_PREFIX_LONG || left || right) of
// its own first 20 bytes and the proof node p (5 big-endian words),
// p on the left when right is set.  The 40 node bytes start at byte 26,
// half a word into word 6.
FD_FN void bmw_node(uint32_t h[8], const uint32_t p[5], int right) {
  uint32_t c[10], w[16];
#pragma unroll
  for (int i = 0; i < 5; i++) {
    c[i] = right ? p[i] : h[i];
    c[5 + i] = right ? h[i] : p[i];
  }
#pragma unroll
  for (int i = 0; i < 6; i++) w[i] = BMW_NODE_PREFIX_W[i];
  w[6] = BMW_NODE_PREFIX_W[6] | (c[0] >> 16);
#pragma unroll
  for (int i = 7; i < 16; i++) w[i] = (c[i - 7] << 16) | (c[i - 6] >> 16);
  s256_init(h);
  s256_compress(h, w);
  w[0] = (c[9] << 16) | 0x8000u;     // bytes 64, 65, then 0x80
#pragma unroll
  for (int i = 1; i < 15; i++) w[i] = 0;
  w[15] = (BMW_PREFIX_SZ + 2 * BMW_NODE_SZ) * 8;
  s256_compress(h, w);
}

// The proof node of a level: 20 bytes as 5 big-endian words.
FD_FN void bmw_load_node(uint32_t p[5], const uint8_t *node) {
#pragma unroll
  for (int i = 0; i < 5; i++) p[i] = s256_load_be(node + 4 * i);
}

#if !defined(__CUDACC__)
#include <string.h>

// A whole lane as one thread computes it, staging each window of its own
// row as the kernel's warp does (the host harness's form; like the
// kernel, it reads the aligned 16-byte chunks around the row): root = the
// walk of (row[:len], idx, proof[:depth]).
FD_FN void bmw_lane(uint8_t root[32], const uint8_t *row, int len, int idx,
                    const uint8_t *proof, int depth) {
  uint32_t st[BMW_STAGE_WORDS], h[8], w[16], p[5];
  const int nb = bmw_leaf_blocks(len);
  const uint64_t a = (uint64_t)(uintptr_t)row;
  s256_init(h);
  for (int w0 = 0; w0 < nb; w0 += BMW_WIN) {
    uint64_t base;
    const int off = bmw_window(a, 64 * w0, base);
    memset(st, 0, sizeof st);
    for (int k = 0; k < BMW_STAGE_CHUNKS; k++)
      if (bmw_chunk_live(base, k, a, len))
        memcpy(st + 4 * k, (const void *)(uintptr_t)(base + 16ull * k), 16);
    bmw_fix((uint8_t *)st, off, 64 * w0, len, nb);
    for (int blk = w0; blk < nb && blk < w0 + BMW_WIN; blk++) {
      bmw_block_words(w, st, off, blk - w0);
      s256_compress(h, w);
    }
  }
  for (int lvl = 0; lvl < depth; lvl++) {
    bmw_load_node(p, proof + BMW_NODE_SZ * lvl);
    bmw_node(h, p, (idx >> lvl) & 1);
  }
  for (int i = 0; i < 8; i++) s256_store_be(root + 4 * i, h[i]);
}
#endif

#if defined(__CUDACC__)
__device__ __forceinline__ void bmw_cp_async16(uint32_t *dst, uint64_t src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(BMW_LANES)
bmtree_walk_kernel(const uint8_t *leaf, long long leaf_row, const int *lens,
                   const int *idxs, const uint8_t *proofs,
                   long long proof_row, int D, const int *depths, int B,
                   uint8_t *roots) {
  __shared__ __align__(16) uint32_t stage[BMW_LANES * BMW_STAGE_WORDS];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * BMW_LANES;
  const long long lane = base + t;
  const bool live = lane < B;
  const int len = live ? lens[lane] : 0;
  const int nb = live ? bmw_leaf_blocks(len) : 0;
  const int depth = live ? depths[lane] : 0, idx = live ? idxs[lane] : 0;
  const uint8_t *proof = proofs + lane * proof_row;
  uint32_t p[5];
  if (depth > 0) bmw_load_node(p, proof);
  int nb_max = nb;
#pragma unroll
  for (int o = 16; o; o >>= 1)
    nb_max = max(nb_max, __shfl_xor_sync(0xffffffffu, nb_max, o));
  uint32_t *st = stage + t * BMW_STAGE_WORDS;
  uint32_t h[8], w[16];
  s256_init(h);
  for (int w0 = 0; w0 < nb_max; w0 += BMW_WIN) {
    const int P0 = 64 * w0;
    // lane L's row: the warp's threads take its chunks, 32 at a time
    for (int L = 0; L < BMW_LANES; L++) {
      const int len_l = __shfl_sync(0xffffffffu, len, L);
      const int nb_l = __shfl_sync(0xffffffffu, nb, L);
      if (w0 >= nb_l) continue;
      const uint64_t row = (uint64_t)(leaf + (base + L) * leaf_row);
      uint64_t cb;
      bmw_window(row, P0, cb);
      for (int k = t; k < BMW_STAGE_CHUNKS; k += 32)
        if (bmw_chunk_live(cb, k, row, len_l))
          bmw_cp_async16(stage + L * BMW_STAGE_WORDS + 4 * k, cb + 16ull * k);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    uint64_t cb;
    const int off = bmw_window((uint64_t)(leaf + lane * leaf_row), P0, cb);
    if (w0 < nb) bmw_fix((uint8_t *)st, off, P0, len, nb);
    const int w_end = min(nb_max, w0 + BMW_WIN);
    for (int blk = w0; blk < w_end; blk++) {
      if (blk < nb) {
        bmw_block_words(w, st, off, blk - w0);
        s256_compress(h, w);
      }
    }
    __syncwarp();
  }
  if (!live) return;
  for (int lvl = 0; lvl < depth; lvl++) {
    uint32_t pn[5];
    if (lvl + 1 < depth) bmw_load_node(pn, proof + BMW_NODE_SZ * (lvl + 1));
    bmw_node(h, p, (idx >> lvl) & 1);
#pragma unroll
    for (int i = 0; i < 5; i++) p[i] = pn[i];
  }
#pragma unroll
  for (int i = 0; i < 8; i++) s256_store_be(roots + 32 * lane + 4 * i, h[i]);
}

// B lanes: lane i's leaf row at leaf + i * leaf_row, its D proof nodes
// of 20 bytes at proofs + i * proof_row; lens, idxs and depths int32 on
// the device (lens in [0, maxlen], depths in [0, D]: the caller checks).
extern "C" int fd_bmtree_walk(const uint8_t *leaf, long long leaf_row,
                              const int *lens, const int *idxs,
                              const uint8_t *proofs, long long proof_row,
                              int D, const int *depths, int B,
                              uint8_t *roots, void *stream) {
  if (B < 1 || D < 0) return -1;
  bmtree_walk_kernel<<<(B + BMW_LANES - 1) / BMW_LANES, BMW_LANES, 0,
                       (cudaStream_t)stream>>>(leaf, leaf_row, lens, idxs,
                                               proofs, proof_row, D, depths,
                                               B, roots);
  return (int)cudaGetLastError();
}
#endif
