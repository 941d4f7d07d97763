// Batched SHA-512 of R || A || M, one thread per signature.
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
// What the design does about it: words are native uint64 (the TPU split
// each into hi/lo uint32 planes), the 16-word schedule is a ring in
// registers, K sits in constant memory (every thread reads the same round
// constant at once), and the rounds are unrolled.

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

// Byte p of the padded preimage R || A || M[:len] | 0x80 | 0.. | bitlen.
SHA_FN uint32_t sha_byte(const uint8_t *r, const uint8_t *a,
                         const uint8_t *msg, uint32_t total, uint32_t end,
                         uint32_t p) {
  if (p < 32) return r[p];
  if (p < 64) return a[p - 32];
  if (p < total) return msg[p - 64];
  if (p == total) return 0x80;
  if (p >= end - 8) return (uint32_t)(((uint64_t)total * 8) >> (8 * (end - 1 - p))) & 0xff;
  return 0;
}

// One lane: digest of R || A || M[:clamp(len, 0, ml)] into out[0..63].
SHA_FN void sha512_lane(const uint8_t *msg, const uint8_t *r,
                        const uint8_t *a, const uint8_t *len4, int ml,
                        uint8_t *out) {
  int32_t len = (int32_t)((uint32_t)len4[0] | ((uint32_t)len4[1] << 8) |
                          ((uint32_t)len4[2] << 16) | ((uint32_t)len4[3] << 24));
  len = len < 0 ? 0 : (len > ml ? ml : len);
  const uint32_t total = (uint32_t)len + 64;
  const uint32_t nb = (total + 17 + 127) / 128;
  const uint32_t end = nb * 128;
  uint64_t h[8] = {0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull,
                   0x3c6ef372fe94f82bull, 0xa54ff53a5f1d36f1ull,
                   0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
                   0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};
  for (uint32_t blk = 0; blk < nb; blk++) {
    uint64_t w[16];
#pragma unroll
    for (int t = 0; t < 16; t++) {
      uint64_t x = 0;
#pragma unroll
      for (int j = 0; j < 8; j++)
        x = (x << 8) | sha_byte(r, a, msg, total, end, blk * 128 + 8 * t + j);
      w[t] = x;
    }
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

#define SHA_THREADS 64

__global__ void __launch_bounds__(SHA_THREADS)
    sha512_ram_kernel(const uint8_t *msg, long long msg_stride,
                      const uint8_t *r, long long r_stride, const uint8_t *a,
                      long long a_stride, const uint8_t *len4,
                      long long len_stride, int ml, int n, uint8_t *out) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  sha512_lane(msg + lane * msg_stride, r + lane * r_stride,
              a + lane * a_stride, len4 + lane * len_stride, ml,
              out + lane * 64);
}

extern "C" int fd_sha512_ram(const uint8_t *msg, long long msg_stride,
                             const uint8_t *r, long long r_stride,
                             const uint8_t *a, long long a_stride,
                             const uint8_t *len4, long long len_stride,
                             int ml, int n, uint8_t *out, void *stream) {
  const int blocks = (n + SHA_THREADS - 1) / SHA_THREADS;
  sha512_ram_kernel<<<blocks, SHA_THREADS, 0, (cudaStream_t)stream>>>(
      msg, msg_stride, r, r_stride, a, a_stride, len4, len_stride, ml, n,
      out);
  return (int)cudaGetLastError();
}
#endif
