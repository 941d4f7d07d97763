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
// read once.  What the design does about it: a warp is 32 lanes; the
// rows are 1.2 KB apart, so a warp stages each 64-byte block of its 32
// lanes through shared memory, sixteen threads a lane building its
// padded words from consecutive bytes, before each lane compresses its
// own block from there (rows padded to 17 words, so the reads hit 32
// banks).  Lanes whose leaf has fewer blocks, or whose depth is less,
// idle through the warp's longest.
//
// The functions also compile as host C++ (FD_FN), so the arithmetic can
// be checked on a machine without a GPU.

#include "sha256.cuh"

#define BMW_PREFIX_SZ 26
#define BMW_NODE_SZ 20
#define BMW_WARPS 4                   // warps a block, 32 lanes each
#define BMW_ROW_WORDS 17              // a staged block: 16 words and a pad

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

// Byte p of the padded leaf message of nb blocks: the prefix, the row's
// first len bytes, 0x80, zeros, and the bit length big-endian in the
// last 8 bytes.
FD_FN uint32_t bmw_leaf_byte(const uint8_t *row, int len, int nb, int p) {
  if (p < BMW_PREFIX_SZ) return BMW_LEAF_PREFIX[p];
  const int t = p - BMW_PREFIX_SZ;
  if (t < len) return row[t];
  if (t == len) return 0x80;
  const int from_end = nb * 64 - 1 - p;
  if (from_end < 4)    // the bit length is < 2^32: its low 4 bytes
    return ((uint32_t)(BMW_PREFIX_SZ + len) * 8u >> (8 * from_end)) & 0xff;
  return 0;
}

// Word w of block blk of the padded leaf message.
FD_FN uint32_t bmw_leaf_word(const uint8_t *row, int len, int nb, int blk,
                             int w) {
  const int p = 64 * blk + 4 * w;
  return (bmw_leaf_byte(row, len, nb, p) << 24) |
         (bmw_leaf_byte(row, len, nb, p + 1) << 16) |
         (bmw_leaf_byte(row, len, nb, p + 2) << 8) |
         bmw_leaf_byte(row, len, nb, p + 3);
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

// A whole lane, as one thread computes it with no staging (the host
// harness's form): root = the walk of (row[:len], idx, proof[:depth]).
FD_FN void bmw_lane(uint8_t root[32], const uint8_t *row, int len, int idx,
                    const uint8_t *proof, int depth) {
  uint32_t h[8], w[16], p[5];
  const int nb = bmw_leaf_blocks(len);
  s256_init(h);
  for (int blk = 0; blk < nb; blk++) {
    for (int i = 0; i < 16; i++) w[i] = bmw_leaf_word(row, len, nb, blk, i);
    s256_compress(h, w);
  }
  for (int lvl = 0; lvl < depth; lvl++) {
    bmw_load_node(p, proof + BMW_NODE_SZ * lvl);
    bmw_node(h, p, (idx >> lvl) & 1);
  }
  for (int i = 0; i < 8; i++) s256_store_be(root + 4 * i, h[i]);
}

#if defined(__CUDACC__)
__global__ void __launch_bounds__(32 * BMW_WARPS)
bmtree_walk_kernel(const uint8_t *leaf, long long leaf_row, const int *lens,
                   const int *idxs, const uint8_t *proofs,
                   long long proof_row, int D, const int *depths, int B,
                   uint8_t *roots) {
  __shared__ uint32_t stage[BMW_WARPS][32 * BMW_ROW_WORDS];
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  const int base = (blockIdx.x * BMW_WARPS + warp) * 32;
  const int lane = base + t;
  const bool live = lane < B;
  const int len = live ? lens[lane] : 0;
  const int nb = live ? bmw_leaf_blocks(len) : 0;
  int nb_max = nb;
#pragma unroll
  for (int o = 16; o; o >>= 1)
    nb_max = max(nb_max, __shfl_xor_sync(0xffffffffu, nb_max, o));
  uint32_t *st = stage[warp];
  uint32_t h[8], w[16];
  s256_init(h);
  for (int blk = 0; blk < nb_max; blk++) {
    // two lanes a pass: threads 0-15 build lane L's 16 words, 16-31 lane
    // L + 1's, each word from 4 consecutive bytes of the lane's row
#pragma unroll 1
    for (int pair = 0; pair < 16; pair++) {
      const int L = 2 * pair + (t >> 4);
      const int len_l = __shfl_sync(0xffffffffu, len, L);
      const int nb_l = __shfl_sync(0xffffffffu, nb, L);
      if (blk < nb_l)
        st[L * BMW_ROW_WORDS + (t & 15)] = bmw_leaf_word(
            leaf + (long long)(base + L) * leaf_row, len_l, nb_l, blk,
            t & 15);
    }
    __syncwarp();
    if (blk < nb) {
#pragma unroll
      for (int i = 0; i < 16; i++) w[i] = st[t * BMW_ROW_WORDS + i];
      s256_compress(h, w);
    }
    __syncwarp();
  }
  if (!live) return;
  const int depth = depths[lane], idx = idxs[lane];
  const uint8_t *proof = proofs + (long long)lane * proof_row;
  uint32_t p[5];
  for (int lvl = 0; lvl < depth; lvl++) {
    bmw_load_node(p, proof + BMW_NODE_SZ * lvl);
    bmw_node(h, p, (idx >> lvl) & 1);
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
  const int lanes = 32 * BMW_WARPS;
  bmtree_walk_kernel<<<(B + lanes - 1) / lanes, lanes, 0,
                       (cudaStream_t)stream>>>(leaf, leaf_row, lens, idxs,
                                               proofs, proof_row, D, depths,
                                               B, roots);
  return (int)cudaGetLastError();
}
#endif
