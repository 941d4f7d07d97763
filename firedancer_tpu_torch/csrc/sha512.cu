// Batched SHA-512 of R || A || M, one thread per signature, blocks of one
// warp.
//
// Replaces firedancer_tpu/ops/sha512_pallas.py::sha512 (_sha_kernel).
// Reads the packed rows in place through row strides: R and A come from
// the signature and public-key columns and M from the message columns,
// so no concatenated preimage is built in device memory.  The message
// length is the row's little-endian int32, clamped to [0, ml] as the host
// verifier clamps it; padding and the 128-bit big-endian bit length are
// generated in the thread, and each lane runs its own block count.
//
// What bounds it: operations, mostly.  A block is 80 rounds of about 40
// 64-bit operations (each two or three 32-bit instructions on this card)
// against 128 bytes read, so at full memory rate the ALUs are the limit.
// A lane's rounds are one dependent chain, so a batch of a few thousand
// lanes (about one warp a scheduler) waits on each warp's own chain.
// What the design does about it: words are native uint64 (the TPU split
// each into hi/lo uint32 planes), the 16-word schedule is a ring in
// registers, K sits in constant memory (every thread reads the same round
// constant at once), and the rounds are unrolled.  The loads stay off the
// chain: a block is one warp, and for each 128-byte message block the
// warp copies its 32 lanes' rows into shared memory, one row at a time as
// 32 words (coalesced), by cp.async into a two-stage ring, so block j + 1
// loads while block j compresses.  A row's pitch is 33 words, so a
// thread's reads of its own row are free of bank conflicts.  Each thread
// then builds its 16 big-endian words with __byte_perm and inserts the
// 0x80 byte and the length in registers.  Views whose base or row stride
// is not a multiple of 4 take byte loads into the same layout.  The
// digests leave through shared memory as 16-byte stores.

#include <stdint.h>

#if defined(__CUDACC__)
#define SHA_FN __device__ __forceinline__
#define SHA_CONST __constant__
#else
#define SHA_FN static inline
#define SHA_CONST static const
#endif

SHA_CONST uint64_t SHA512_K[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full, 0xe9b5dba58189dbbcull,
    0x3956c25bf348b538ull, 0x59f111f1b605d019ull, 0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull,
    0xd807aa98a3030242ull, 0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull, 0xc19bf174cf692694ull,
    0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull, 0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull,
    0x2de92c6f592b0275ull, 0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full, 0xbf597fc7beef0ee4ull,
    0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull, 0x06ca6351e003826full, 0x142929670a0e6e70ull,
    0x27b70a8546d22ffcull, 0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull, 0x92722c851482353bull,
    0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull, 0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull,
    0xd192e819d6ef5218ull, 0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull, 0x34b0bcb5e19b48a8ull,
    0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull, 0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull,
    0x748f82ee5defb2fcull, 0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull, 0xc67178f2e372532bull,
    0xca273eceea26619cull, 0xd186b8c721c0c207ull, 0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull,
    0x06f067aa72176fbaull, 0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull, 0x431d67c49c100d4cull,
    0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull, 0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull,
};

SHA_FN uint64_t sha_rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

SHA_FN void sha512_compress(uint64_t h[8], uint64_t w[16]) {
  uint64_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint64_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    if (t >= 16) {
      const uint64_t w15 = w[(t + 1) & 15], w2 = w[(t + 14) & 15];
      const uint64_t s0 = sha_rotr(w15, 1) ^ sha_rotr(w15, 8) ^ (w15 >> 7);
      const uint64_t s1 = sha_rotr(w2, 19) ^ sha_rotr(w2, 61) ^ (w2 >> 6);
      w[t & 15] += s0 + w[(t + 9) & 15] + s1;
    }
    const uint64_t S1 = sha_rotr(e, 14) ^ sha_rotr(e, 18) ^ sha_rotr(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = hh + S1 + ch + SHA512_K[t] + w[t & 15];
    const uint64_t S0 = sha_rotr(a, 28) ^ sha_rotr(a, 34) ^ sha_rotr(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + S0 + maj;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// __byte_perm(x, y, s): byte i of the result is byte (s >> 4i) & 7 of the
// eight bytes y:x (the host spells out the device intrinsic).
SHA_FN uint32_t sha_byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDACC__)
  return __byte_perm(x, y, s);
#else
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; i++)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
#endif
}

// Where word k of block blk of a lane's preimage R || A || M[:len] starts
// (byte p = 128 blk + 4k), and how many of its 4 bytes are data (avail, 4
// in R and A; <= 0 past the message, and src is then the message row).
SHA_FN const uint8_t *sha_src(const uint8_t *r, const uint8_t *a,
                              const uint8_t *msg, int len, int p,
                              int &avail) {
  avail = 4;
  if (p < 32) return r + p;
  if (p < 64) return a + p - 32;
  avail = len - (p - 64);
  return avail > 0 ? msg + p - 64 : msg;
}

// The staged word by byte loads: the avail data bytes little-endian, the
// rest 0 (what cp.async with src-size avail leaves in shared memory).
SHA_FN uint32_t sha_gather4(const uint8_t *src, int avail) {
  uint32_t x = 0;
#pragma unroll
  for (int e = 0; e < 4; e++)
    if (e < avail) x |= (uint32_t)src[e] << (8 * e);
  return x;
}

// A big-endian word of bytes q .. q + 3 with rem = total - q: the data
// bytes kept, byte total set to 0x80, bytes past it 0.
SHA_FN uint32_t sha_pad32(uint32_t v, int rem) {
  if (rem >= 4) return v;
  if (rem < 0) return 0;
  const uint32_t keep = rem ? ~(0xffffffffu >> (8 * rem)) : 0u;
  return (v & keep) | (0x80u << (24 - 8 * rem));
}

// The 16 schedule words of block blk from its staged row (32 words as
// memory holds the bytes), total = 64 + len bytes in nb blocks: each
// uint64 big-endian from two byte-swapped words, the 0x80 byte and the
// zeros after the data, and in the last block the bit length in word 15
// (bytes end - 16 .. end - 9, the length's high half, are past the data
// and already 0).
SHA_FN void sha_block_words(uint64_t w[16], const uint32_t *row, uint32_t blk,
                            uint32_t total, uint32_t nb) {
#pragma unroll
  for (int t = 0; t < 16; t++) {
    const int q = (int)(128 * blk) + 8 * t;
    const uint32_t hi = sha_pad32(sha_byte_perm(row[2 * t], 0, 0x0123),
                                  (int)total - q);
    const uint32_t lo = sha_pad32(sha_byte_perm(row[2 * t + 1], 0, 0x0123),
                                  (int)total - q - 4);
    w[t] = ((uint64_t)hi << 32) | lo;
  }
  if (blk + 1 == nb) w[15] |= (uint64_t)total * 8;
}

SHA_FN int sha_len(const uint8_t *len4, int ml) {
  int32_t len = (int32_t)((uint32_t)len4[0] | ((uint32_t)len4[1] << 8) |
                          ((uint32_t)len4[2] << 16) | ((uint32_t)len4[3] << 24));
  return len < 0 ? 0 : (len > ml ? ml : len);
}

SHA_FN uint32_t sha_blocks(uint32_t total) { return (total + 17 + 127) / 128; }

SHA_FN void sha_init(uint64_t h[8]) {
  const uint64_t iv[8] = {0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull,
                          0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
                          0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
                          0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] = iv[i];
}

// Block blk's schedule words as the host makes them: the block staged
// by byte loads into a 32-word row, then sha_block_words, as the kernel
// makes them from its shared-memory row.
SHA_FN void sha_lane_block(uint64_t w[16], const uint8_t *msg,
                           const uint8_t *r, const uint8_t *a, int len,
                           uint32_t blk, uint32_t nb) {
  uint32_t row[32];
  for (int k = 0; k < 32; k++) {
    int avail;
    const uint8_t *src = sha_src(r, a, msg, len, 128 * blk + 4 * k, avail);
    row[k] = sha_gather4(src, avail);
  }
  sha_block_words(w, row, blk, (uint32_t)len + 64, nb);
}

// One lane: digest of R || A || M[:clamp(len, 0, ml)] into out[0..63].
SHA_FN void sha512_lane(const uint8_t *msg, const uint8_t *r,
                        const uint8_t *a, const uint8_t *len4, int ml,
                        uint8_t *out) {
  const int len = sha_len(len4, ml);
  const uint32_t nb = sha_blocks((uint32_t)len + 64);
  uint64_t h[8];
  sha_init(h);
  for (uint32_t blk = 0; blk < nb; blk++) {
    uint64_t w[16];
    sha_lane_block(w, msg, r, a, len, blk, nb);
    sha512_compress(h, w);
  }
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(h[i] >> (56 - 8 * j));
  }
}

#if defined(__CUDACC__)
#include <cuda_runtime.h>

#define SHA_WARP 32
#define SHA_PITCH 33    // words a staged row: 132 B

__device__ __forceinline__ void sha_cp_async4(uint32_t *dst,
                                              const uint8_t *src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void sha_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void sha_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp stages block blk of each of its rows that has one: row i of
// the stage holds lane base + i's words, thread t copies word t.
__device__ __forceinline__ void sha_stage(
    uint32_t *stage, uint32_t blk, int len, uint32_t nb, bool aligned,
    long long base, const uint8_t *msg, long long msg_stride,
    const uint8_t *r, long long r_stride, const uint8_t *a,
    long long a_stride) {
  const int t = threadIdx.x;
  for (int i = 0; i < SHA_WARP; i++) {
    const int len_i = __shfl_sync(0xffffffffu, len, i);
    const uint32_t nb_i = __shfl_sync(0xffffffffu, nb, i);
    if (blk >= nb_i) continue;
    const long long row = base + i;
    int avail;
    const uint8_t *src = sha_src(r + row * r_stride, a + row * a_stride,
                                 msg + row * msg_stride, len_i,
                                 128 * blk + 4 * t, avail);
    uint32_t *dst = stage + i * SHA_PITCH + t;
    if (aligned)
      sha_cp_async4(dst, src, avail < 0 ? 0 : (avail > 4 ? 4 : avail));
    else
      *dst = sha_gather4(src, avail);
  }
}

__global__ void __launch_bounds__(SHA_WARP)
    sha512_ram_kernel(const uint8_t *msg, long long msg_stride,
                      const uint8_t *r, long long r_stride, const uint8_t *a,
                      long long a_stride, const uint8_t *len4,
                      long long len_stride, int ml, int n, int aligned,
                      uint8_t *out) {
  __shared__ __align__(16) uint32_t ring[2][SHA_WARP * SHA_PITCH];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * SHA_WARP;
  const bool live = base + t < n;
  const int len = live ? sha_len(len4 + (base + t) * len_stride, ml) : 0;
  const uint32_t total = (uint32_t)len + 64;
  const uint32_t nb = live ? sha_blocks(total) : 0;
  const uint32_t nb_max = __reduce_max_sync(0xffffffffu, nb);
  uint64_t h[8];
  sha_init(h);
  sha_stage(ring[0], 0, len, nb, aligned, base, msg, msg_stride, r, r_stride,
            a, a_stride);
  sha_cp_commit();
  for (uint32_t blk = 0; blk < nb_max; blk++) {
    if (blk + 1 < nb_max)
      sha_stage(ring[(blk + 1) & 1], blk + 1, len, nb, aligned, base, msg,
                msg_stride, r, r_stride, a, a_stride);
    sha_cp_commit();
    sha_cp_wait<1>();   // block blk has landed
    __syncwarp();
    uint64_t w[16];
    if (blk < nb) sha_block_words(w, ring[blk & 1] + t * SHA_PITCH, blk, total, nb);
    __syncwarp();       // the stage is read before it is refilled
    if (blk < nb) sha512_compress(h, w);
  }
  sha_cp_wait<0>();
  __syncwarp();
  // the warp's digests are 32 x 64 contiguous bytes of out
  uint4 *dig = reinterpret_cast<uint4 *>(&ring[0][0]);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint4 v;
    v.x = sha_byte_perm((uint32_t)(h[2 * k] >> 32), 0, 0x0123);
    v.y = sha_byte_perm((uint32_t)h[2 * k], 0, 0x0123);
    v.z = sha_byte_perm((uint32_t)(h[2 * k + 1] >> 32), 0, 0x0123);
    v.w = sha_byte_perm((uint32_t)h[2 * k + 1], 0, 0x0123);
    dig[4 * t + k] = v;
  }
  __syncwarp();
  uint4 *dst = reinterpret_cast<uint4 *>(out) + base * 4;
  const long long valid = (n - base < SHA_WARP ? n - base : SHA_WARP) * 4;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const int idx = k * SHA_WARP + t;
    if (idx < valid) dst[idx] = dig[idx];
  }
}

extern "C" int fd_sha512_ram(const uint8_t *msg, long long msg_stride,
                             const uint8_t *r, long long r_stride,
                             const uint8_t *a, long long a_stride,
                             const uint8_t *len4, long long len_stride,
                             int ml, int n, int aligned, uint8_t *out,
                             void *stream) {
  const int blocks = (n + SHA_WARP - 1) / SHA_WARP;
  sha512_ram_kernel<<<blocks, SHA_WARP, 0, (cudaStream_t)stream>>>(
      msg, msg_stride, r, r_stride, a, a_stride, len4, len_stride, ml, n,
      aligned, out);
  return (int)cudaGetLastError();
}
#endif
