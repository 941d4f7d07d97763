// Reed-Solomon recover and encode over GF(2^8) as one GF(2) bit-matrix
// product a set, with the set's consistency flag, in one launch.
//
// Replaces firedancer_tpu/ballet/reedsol.py::_recover_batch_core and
// recover_blob (an XLA int8 matmul, no Pallas kernel) and _encode_device.
// A set b has K survivor rows of S bytes (surv), an (8N, 8K) int8
// bit-matrix (entries 0/1; only bit 0 is read, which gives the same
// parity as the integer product) and, for recovery, the N reference rows
// and the have flags of the survivors.  Output row n, byte column s:
// bit j = parity over i < 8K of bitmat[8n + j][i] & surv bit i, where
// bit i of the column is bit (i % 8) of surv[i / 8][s] (_unpack_bits'
// order), repacked with bit j at weight 2^j.  The set's ok flag is
// all((full == ref) | ~have) over its N x S bytes.  Padding rows and
// columns are zero and compare equal, so they keep ok at 1.
//
// What bounds it: the product is 8N x 8K x S bit products a set, a few
// word operations a 32-bit group once the bits are packed; the inputs
// are read once.  What the design does about it: a column's 8K survivor
// bits pack into ceil(K / 4) words in registers (word w is bytes 4w ..
// 4w + 3 of the column, which is the bit order above), the set's
// bit-matrix rows pack into words in shared memory, and an output bit is
// popc of the AND of a row with the column, one LOP3 a word and a popc.
// A block is one set's 128 byte columns, the grid every column tile of
// every set; the ok flag is a block's OR of mismatches, folded over the
// set's blocks by an atomic OR, and the set's last block to finish
// writes it.
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
#define GF2_MAX_KW ((GF2_MAX_K + 3) / 4)
#define GF2_THREADS 128               // one thread a byte column

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

// 4 int8 bit-matrix entries (a little-endian word) -> their bit 0s as a
// nibble, entry e at bit e.
FD_FN uint32_t gf2_nibble(uint32_t u) {
  u &= 0x01010101u;
  return (u | (u >> 7) | (u >> 14) | (u >> 21)) & 0xFu;
}

// Bits 32w .. 32w + 31 of a bit-matrix row of 8K int8 entries, given as
// 2K little-endian words.
FD_FN uint32_t gf2_row_word(const uint32_t *row4, int K, int w) {
  uint32_t v = 0;
  for (int q = 0; q < 8; q++) {
    const int at = 8 * w + q;        // word of 4 entries
    if (at < 2 * K) v |= gf2_nibble(row4[at]) << (4 * q);
  }
  return v;
}

// Output byte n of a column: rows holds the packed bit-matrix, KW words
// a row.  The kernel passes a constant KW, so the loops unroll and col
// stays in registers.
FD_FN uint32_t gf2_out_byte(const uint32_t *rows, int KW, int n,
                            const uint32_t *col) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    const uint32_t *row = rows + (8 * n + j) * KW;
    uint32_t x = 0;
#pragma unroll
    for (int w = 0; w < KW; w++) x ^= row[w] & col[w];
#if defined(__CUDACC__)
    v |= (uint32_t)(__popc(x) & 1) << j;
#else
    v |= (uint32_t)(__builtin_popcount(x) & 1) << j;
#endif
  }
  return v;
}

#if defined(__CUDACC__)
// The column's words stay in registers: KW is a template parameter, so
// the loops over them unroll.
template <int KW>
__global__ void __launch_bounds__(GF2_THREADS)
gf2_kernel(const uint8_t *surv, long long surv_row, const uint32_t *bitmat,
           const uint8_t *ref, long long ref_row, const uint8_t *have,
           long long have_row, int K, int N, int S, uint8_t *full,
           long long full_row, uint8_t *ok, long long ok_row, int *scratch) {
  extern __shared__ uint32_t rows[];        // 8N rows x KW words
  const int b = blockIdx.y, B = gridDim.y;
  const int s = blockIdx.x * GF2_THREADS + threadIdx.x;
  const uint32_t *bm = bitmat + (long long)b * 8 * N * 2 * K;
  for (int q = threadIdx.x; q < 8 * N * KW; q += GF2_THREADS)
    rows[q] = gf2_row_word(bm + (long long)(q / KW) * 2 * K, K, q % KW);
  __syncthreads();
  int bad = 0;
  if (s < S) {
    const uint8_t *sv = surv + (long long)b * surv_row;
    uint32_t col[KW];
#pragma unroll
    for (int w = 0; w < KW; w++) col[w] = gf2_col_word(sv, S, K, s, w);
    uint8_t *out = full + (long long)b * full_row + s;
    const uint8_t *rf = ref ? ref + (long long)b * ref_row + s : nullptr;
    const uint8_t *hv = have ? have + (long long)b * have_row : nullptr;
    for (int n = 0; n < N; n++) {
      const uint32_t v = gf2_out_byte(rows, KW, n, col);
      out[(long long)n * S] = (uint8_t)v;
      if (hv && hv[n]) bad |= v != rf[(long long)n * S];
    }
  }
  if (ok) {
    bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) {
      if (bad) atomicOr(&scratch[b], 1);
      __threadfence();
      const int done = atomicAdd(&scratch[B + b], 1);
      if (done == (int)gridDim.x - 1)
        ok[(long long)b * ok_row] = atomicOr(&scratch[b], 0) == 0;
    }
  }
}

template <int KW>
static int gf2_launch(dim3 grid, cudaStream_t st, const uint8_t *surv,
                      long long surv_row, const uint32_t *bitmat,
                      const uint8_t *ref, long long ref_row,
                      const uint8_t *have, long long have_row, int K, int N,
                      int S, uint8_t *full, long long full_row, uint8_t *ok,
                      long long ok_row, int *scratch) {
  const size_t smem = (size_t)8 * N * KW * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gf2_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gf2_kernel<KW><<<grid, GF2_THREADS, smem, st>>>(
      surv, surv_row, bitmat, ref, ref_row, have, have_row, K, N, S, full,
      full_row, ok, ok_row, scratch);
  return (int)cudaGetLastError();
}

// B sets; set b's survivors at surv + b * surv_row (row r at + r * S),
// its bit-matrix at bitmat + b * 8N * 8K (int8, 4-byte aligned), its
// reference rows and have flags likewise (have null: no check, as for
// encode), its output rows at full + b * full_row and its flag at
// ok + b * ok_row (ok null: no flag).  scratch: 2B zeroed ints.
extern "C" int fd_gf2_recover(const uint8_t *surv, long long surv_row,
                              const int8_t *bitmat, const uint8_t *ref,
                              long long ref_row, const uint8_t *have,
                              long long have_row, int B, int K, int N, int S,
                              uint8_t *full, long long full_row, uint8_t *ok,
                              long long ok_row, int *scratch, void *stream) {
  if (K < 1 || K > GF2_MAX_K || N < 1 || N > GF2_MAX_N || S < 1 || B < 1 ||
      ((uintptr_t)bitmat & 3) || (ok && !scratch))
    return -1;
  const dim3 grid((S + GF2_THREADS - 1) / GF2_THREADS, B);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t *bm = (const uint32_t *)bitmat;
  switch ((K + 3) / 4) {
#define GF2_CASE(kw)                                                       \
  case kw:                                                                 \
    return gf2_launch<kw>(grid, st, surv, surv_row, bm, ref, ref_row, have, \
                          have_row, K, N, S, full, full_row, ok, ok_row,    \
                          scratch);
    GF2_CASE(1) GF2_CASE(2) GF2_CASE(3) GF2_CASE(4) GF2_CASE(5) GF2_CASE(6)
    GF2_CASE(7) GF2_CASE(8) GF2_CASE(9) GF2_CASE(10) GF2_CASE(11)
    GF2_CASE(12) GF2_CASE(13) GF2_CASE(14) GF2_CASE(15) GF2_CASE(16)
    GF2_CASE(17)
#undef GF2_CASE
  }
  return -1;
}
#endif
