// Reed-Solomon recover and encode over GF(2^8) as one GF(2) bit-matrix
// product a set, with the set's consistency flag, in one launch.
//
// Replaces firedancer_tpu/ballet/reedsol.py::_recover_batch_core and
// recover_blob (an XLA int8 matmul, no Pallas kernel) and _encode_device.
// A set b has K survivor rows of S bytes (surv), its N x K GF(2^8)
// reconstruction matrix M (bytes) and, for recovery, the N reference
// rows and the have flags of the survivors.  M stands for its GF(2)
// bit-matrix (reedsol._bitmatrix): entry [8r + j, 8c + i] is bit j of
// M[r, c] * x^i mod 0x11D.  Output row n, byte column s: bit j = parity
// over i < 8K of entry [8n + j, i] & surv bit i, where bit i of the
// column is bit (i % 8) of surv[i / 8][s] (_unpack_bits' order).  The
// set's ok flag is all((full == ref) | ~have) over its N x S bytes.
// Padding rows and columns are zero and compare equal, so they keep ok
// at 1.
//
// What bounds it: the product is 8N x 8K x S bit products a set, one
// 32-bit AND-XOR (LOP3) a 32-bit group once the bits are packed, then a
// parity (POPC) an output bit; the inputs are read once.  What the design
// does about it:
//  - the input is M, N x K bytes (2 KB for a 32:32 set), not its
//    bit-matrix (64 times that): each block builds the table of the 256
//    transposed 8 x 8 bit blocks (gf2_xt8), then expands M into the
//    packed bit-matrix rows in shared memory, four entries a word by
//    byte permutes (gf2_row_words), bit b of row word w being column
//    32w + b;
//  - a column's 8K survivor bits pack into ceil(K / 4) words in
//    registers (word w is bytes 4w .. 4w + 3 of the column), and an
//    output bit is a run of LOP3 over the row, read by 16-byte broadcast
//    loads, and a POPC;
//  - a set is a cluster of GF2_CLUSTER blocks of GF2_COLS byte columns
//    by GF2_GROUPS row groups (512 threads), the cluster's blocks taking
//    the set's column tiles in turn, so that 8 sets keep 128 SMs and
//    2,048 warps busy; 16 blocks is past the portable cluster size of 8,
//    which the launch allows for the kernel;
//  - the ok flag folds within the cluster: each block's mismatch OR goes
//    into the first block's shared memory (distributed shared memory),
//    which writes the flag after the cluster's barrier; nothing outside
//    the launch is zeroed or read.
// Measured slower on this card and not kept (PERF.md): the product on
// the binary tensor cores (BMMA, AND + POPC), whose output bytes take as
// many instructions to gather as the LOP3 product; 8-block clusters; and
// the first loads hoisted above the table's build.
//
// The functions also compile as host C++ (FD_FN), so the arithmetic can
// be checked on a machine without a GPU.

#include <stdint.h>

#ifndef FD_FN
#if defined(__CUDACC__)
#define FD_FN __device__ __forceinline__
#else
#define FD_FN static inline
#endif
#endif

#define GF2_MAX_K 67                  // DATA_SHREDS_MAX
#define GF2_MAX_N 134                 // data + parity shreds of one set
#define GF2_COLS 64                   // byte columns a block, a thread each
#define GF2_GROUPS 8                  // row groups a block
#define GF2_THREADS (GF2_COLS * GF2_GROUPS)
#define GF2_CLUSTER 16                // blocks a set: one thread block cluster

// The table entry of m: byte j holds bit j of m * x^i at bit i, i < 8 (the
// 8 x 8 block of m's bit-matrix rows, one byte a row).  Seven xtimes, then
// an 8 x 8 bit transpose (bit 8r + c to bit 8c + r).
FD_FN uint64_t gf2_xt8(uint32_t m) {
  uint64_t x = 0;
  for (int i = 0; i < 8; i++) {
    x |= (uint64_t)m << (8 * i);
    m = ((m << 1) ^ (m & 0x80u ? 0x11du : 0u)) & 0xffu;
  }
  uint64_t t;
  t = (x ^ (x >> 7)) & 0x00aa00aa00aa00aaull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000cccc0000ccccull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000f0f0f0f0ull;
  x ^= t ^ (t << 28);
  return x;
}

// Bytes sel's nibbles pick from hi:lo (__byte_perm).
FD_FN uint32_t gf2_perm(uint32_t lo, uint32_t hi, uint32_t sel) {
#if defined(__CUDACC__)
  return __byte_perm(lo, hi, sel);
#else
  const uint64_t x = ((uint64_t)hi << 32) | lo;
  uint32_t r = 0;
  for (int n = 0; n < 4; n++)
    r |= (uint32_t)((x >> (8 * ((sel >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
#endif
}

// Words w of the 8 bit-matrix rows 8r .. 8r + 7 of M's row r (K
// entries): out[j] takes byte j of the table entries of M[r][4w ..
// 4w + 3] (0 past K), entry e at byte e.  The table is 256 (lo, hi)
// word pairs.  A 4 x 4 byte transpose of the four entries' low words,
// then of their high words.
FD_FN void gf2_row_words(uint32_t out[8], const uint32_t *table,
                         const uint8_t *mrow, int K, int w) {
  uint32_t lo[4], hi[4];
  for (int e = 0; e < 4; e++) {
    const int c = 4 * w + e;
    const uint32_t m = c < K ? mrow[c] : 0u;
    lo[e] = table[2 * m];
    hi[e] = table[2 * m + 1];
  }
  for (int h = 0; h < 2; h++) {
    const uint32_t *x = h ? hi : lo;
    const uint32_t a = gf2_perm(x[0], x[1], 0x5140u);
    const uint32_t b = gf2_perm(x[2], x[3], 0x5140u);
    const uint32_t c = gf2_perm(x[0], x[1], 0x7362u);
    const uint32_t d = gf2_perm(x[2], x[3], 0x7362u);
    out[4 * h + 0] = gf2_perm(a, b, 0x5410u);
    out[4 * h + 1] = gf2_perm(a, b, 0x7632u);
    out[4 * h + 2] = gf2_perm(c, d, 0x5410u);
    out[4 * h + 3] = gf2_perm(c, d, 0x7632u);
  }
}

// Word w of a byte column s of K survivor rows (row stride S): bytes
// 4w .. 4w + 3, little-endian, so bit i of row r is bit 8r + i overall.
FD_FN uint32_t gf2_col_word(const uint8_t *surv, long long S, int K, int s,
                            int w) {
  uint32_t v = 0;
  for (int e = 0; e < 4; e++) {
    const int r = 4 * w + e;
    if (r < K) v |= (uint32_t)surv[(long long)r * S + s] << (8 * e);
  }
  return v;
}

#if defined(__CUDACC__)
typedef uint4 gf2_u4;
#else
struct gf2_u4 {
  uint32_t x, y, z, w;
};
#endif

FD_FN int gf2_parity(uint32_t x) {
#if defined(__CUDACC__)
  return __popc(x) & 1;
#else
  return __builtin_popcount(x) & 1;
#endif
}

// Output byte n of a column: rows holds the packed bit-matrix, KW4 groups
// of 4 words a row (zero past the row's bits), col the column's words
// likewise.  The kernel passes a constant KW4, so the loops unroll and
// col stays in registers.
FD_FN uint32_t gf2_out_byte(const gf2_u4 *rows, int KW4, int n,
                            const uint32_t *col) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const gf2_u4 *row = rows + (8 * n + j) * KW4;
    uint32_t x = 0;
#pragma unroll
    for (int q = 0; q < KW4; q++) {
      const gf2_u4 r = row[q];
      x ^= (r.x & col[4 * q]) ^ (r.y & col[4 * q + 1]) ^
           (r.z & col[4 * q + 2]) ^ (r.w & col[4 * q + 3]);
    }
    v |= (uint32_t)gf2_parity(x) << j;
  }
  return v;
}

#if defined(__CUDACC__)
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

// KW = ceil(K / 4) is a template parameter, so the column's words stay in
// registers.  Shared memory: the table (256 x 2 words), then 8N rows of
// KW4 4-word groups.
template <int KW>
__global__ void __cluster_dims__(GF2_CLUSTER, 1, 1)
__launch_bounds__(GF2_THREADS)
gf2_kernel(const uint8_t *surv, long long surv_row, const uint8_t *gfm,
           const uint8_t *ref, long long ref_row, const uint8_t *have,
           long long have_row, int K, int N, int S, uint8_t *full,
           long long full_row, uint8_t *ok, long long ok_row) {
  constexpr int KW4 = (KW + 3) / 4;
  extern __shared__ gf2_u4 smem[];
  __shared__ int set_bad;
  uint32_t *table = (uint32_t *)smem;
  gf2_u4 *rows = smem + 128;
  const int b = blockIdx.y, t = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  if (t < 256) {
    const uint64_t x = gf2_xt8((uint32_t)t);
    table[2 * t] = (uint32_t)x;
    table[2 * t + 1] = (uint32_t)(x >> 32);
  }
  if (t == 0) set_bad = 0;
  __syncthreads();
  const uint8_t *mb = gfm + (long long)b * N * K;
  uint32_t *rows32 = (uint32_t *)rows;
  for (int q = t; q < N * 4 * KW4; q += GF2_THREADS) {
    const int n = q / (4 * KW4), w = q % (4 * KW4);
    uint32_t o[8];
    gf2_row_words(o, table, mb + (long long)n * K, K, w);
#pragma unroll
    for (int j = 0; j < 8; j++) rows32[(8 * n + j) * 4 * KW4 + w] = o[j];
  }
  // the rows are in; with a flag to fold, every block of the set now runs
  // and the first one's set_bad is 0
  if (ok)
    cluster.sync();
  else
    __syncthreads();
  const int c = t % GF2_COLS, g = t / GF2_COLS;
  const uint8_t *sv = surv + (long long)b * surv_row;
  const uint8_t *rf = ref ? ref + (long long)b * ref_row : nullptr;
  const uint8_t *hv = have ? have + (long long)b * have_row : nullptr;
  uint8_t *out = full + (long long)b * full_row;
  int bad = 0;
  for (int s = blockIdx.x * GF2_COLS + c; s - c < S;
       s += GF2_CLUSTER * GF2_COLS) {
    if (s >= S) continue;
    uint32_t col[4 * KW4];
#pragma unroll
    for (int w = 0; w < 4 * KW4; w++)
      col[w] = w < KW ? gf2_col_word(sv, S, K, s, w) : 0u;
    for (int n = g; n < N; n += GF2_GROUPS) {
      const uint32_t v = gf2_out_byte(rows, KW4, n, col);
      out[(long long)n * S + s] = (uint8_t)v;
      if (hv && hv[n]) bad |= v != rf[(long long)n * S + s];
    }
  }
  if (ok) {
    bad = __syncthreads_or(bad);
    if (t == 0 && bad) atomicOr(cluster.map_shared_rank(&set_bad, 0), 1);
    cluster.sync();
    if (t == 0 && cluster.block_rank() == 0)
      ok[(long long)b * ok_row] = set_bad == 0;
  }
}

template <int KW>
static int gf2_launch(dim3 grid, cudaStream_t st, const uint8_t *surv,
                      long long surv_row, const uint8_t *gfm,
                      const uint8_t *ref, long long ref_row,
                      const uint8_t *have, long long have_row, int K, int N,
                      int S, uint8_t *full, long long full_row, uint8_t *ok,
                      long long ok_row) {
  const size_t smem =
      (128 + (size_t)8 * N * ((KW + 3) / 4)) * sizeof(gf2_u4);
  {
    const cudaError_t e = cudaFuncSetAttribute(
        gf2_kernel<KW>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf2_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gf2_kernel<KW><<<grid, GF2_THREADS, smem, st>>>(
      surv, surv_row, gfm, ref, ref_row, have, have_row, K, N, S, full,
      full_row, ok, ok_row);
  return (int)cudaGetLastError();
}

// B sets; set b's survivors at surv + b * surv_row (row r at + r * S),
// its N x K matrix at gfm + b * N * K, its reference rows and have flags
// likewise (have null: no check, as for encode), its output rows at
// full + b * full_row and its flag at ok + b * ok_row (ok null: no flag).
extern "C" int fd_gf2_recover(const uint8_t *surv, long long surv_row,
                              const uint8_t *gfm, const uint8_t *ref,
                              long long ref_row, const uint8_t *have,
                              long long have_row, int B, int K, int N, int S,
                              uint8_t *full, long long full_row, uint8_t *ok,
                              long long ok_row, void *stream) {
  if (K < 1 || K > GF2_MAX_K || N < 1 || N > GF2_MAX_N || S < 1 || B < 1 ||
      B > 65535)
    return -1;
  const dim3 grid(GF2_CLUSTER, B);
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((K + 3) / 4) {
#define GF2_CASE(kw)                                                       \
  case kw:                                                                 \
    return gf2_launch<kw>(grid, st, surv, surv_row, gfm, ref, ref_row,      \
                          have, have_row, K, N, S, full, full_row, ok,      \
                          ok_row);
    GF2_CASE(1) GF2_CASE(2) GF2_CASE(3) GF2_CASE(4) GF2_CASE(5) GF2_CASE(6)
    GF2_CASE(7) GF2_CASE(8) GF2_CASE(9) GF2_CASE(10) GF2_CASE(11)
    GF2_CASE(12) GF2_CASE(13) GF2_CASE(14) GF2_CASE(15) GF2_CASE(16)
    GF2_CASE(17)
#undef GF2_CASE
  }
  return -1;
}
#endif
