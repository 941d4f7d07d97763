// Scalars mod L for one lane per thread: the S < L test, the SHA-512
// digest mod L, products mod L, and the 4-bit windows, unsigned and
// signed.  One copy for every kernel that reads a scalar (reduce_recode,
// rlc_recode, verify_tail, dsm).
//
// Radix: 28-bit limbs in uint32, with int64 accumulators, so a limb
// product is one 32 x 32 -> 64 multiply-add on the card.  252 = 9 x 28,
// so the fold 2^252 = -C mod L (L = 2^252 + C, C < 2^125) falls on a limb
// boundary: x = hi 2^252 + lo gives lo - C hi with hi the limbs from 9
// up.  C takes 5 limbs, a digest 19, a 256-bit S 10, z 5.  The windows
// are read from 32-bit words (8 nibbles each), where a mask of a digit
// property over the 64 windows is a handful of word operations.  The
// kernels hand torch the radix of ops/scalar25519.py (canonical 12-bit
// limbs, uint8 windows), converted once, at the end of a lane.

#pragma once
#include "fe25519.cuh"

#define SC_BITS 28
#define SC_MASK 0x0fffffff

// C = L - 2^252 in 28-bit limbs (125 bits).
FD_FN int32_t sc_c(int i) {
  return i == 0 ? 0xcf5d3ed : i == 1 ? 0x12631a5 : i == 2 ? 0x79cd658
       : i == 3 ? 0xf9dea2f : 0x14de;
}

// L in 32-bit words (little-endian).
FD_FN uint32_t sc_l_word(int i) {
  return i == 0 ? 0x5cf5d3edu : i == 1 ? 0x5812631au : i == 2 ? 0xa2f79cd6u
       : i == 3 ? 0x14def9deu : i == 7 ? 0x10000000u : 0u;
}

// N little-endian 32-bit words from 4 N bytes.
template <int N>
FD_FN void sc_load_words(uint32_t *w, const uint8_t *b) {
#pragma unroll
  for (int i = 0; i < N; i++)
    w[i] = b[4 * i] | b[4 * i + 1] << 8 | b[4 * i + 2] << 16 |
           (uint32_t)b[4 * i + 3] << 24;
}

// N words -> NL 28-bit limbs (limb i = bits 28 i .. 28 i + 27; bits past
// the last word read 0).
template <int N, int NL>
FD_FN void sc_words_to_limbs(uint32_t *l, const uint32_t *w) {
#pragma unroll
  for (int i = 0; i < NL; i++) {
    const int q = 28 * i / 32, r = 28 * i % 32;
    uint32_t v = q < N ? w[q] >> r : 0;
    if (r > 4 && q + 1 < N) v |= w[q + 1] << (32 - r);
    l[i] = v & SC_MASK;
  }
}

// 10 canonical limbs (a value below 2^256) -> 8 words.  A word starts at
// bit 28 i + r with r <= 24, so two limbs cover it.
FD_FN void sc_limbs_to_words(uint32_t *w, const uint32_t *l) {
#pragma unroll
  for (int q = 0; q < 8; q++) {
    const int i = 32 * q / 28, r = 32 * q % 28;
    w[q] = l[i] >> r | l[i + 1] << (28 - r);
  }
}

// Serial exact carry of N signed accumulators: limbs 0 .. N - 2 end in
// [0, 2^28) and the top one holds the value's floor over 2^(28 (N - 1)).
// Every caller keeps |x_i| < 2^62, so no step overflows.
template <int N, typename T>
FD_FN void sc_carry(T *x) {
#pragma unroll
  for (int i = 0; i < N - 1; i++) {
    x[i + 1] += x[i] >> SC_BITS;
    x[i] &= SC_MASK;
  }
}

// out (M accumulators) = lo - C hi, where x = hi 2^252 + lo, lo limbs 0 ..
// 8 of x and hi limbs 9 .. N - 1 (out may be x).  Each hi limb must fit
// an int32 (a 32 x 32 -> 64 product); out_i gets at most five products
// below 2^28 |hi_k|.
template <int N, int M>
FD_FN void sc_fold(int64_t *out, const int64_t *x) {
  int32_t h[N - 9];
#pragma unroll
  for (int k = 0; k < N - 9; k++) h[k] = (int32_t)x[9 + k];
#pragma unroll
  for (int i = 0; i < M; i++) out[i] = i < 9 ? x[i] : 0;
#pragma unroll
  for (int k = 0; k < N - 9; k++) {
#pragma unroll
    for (int j = 0; j < 5; j++) out[j + k] -= (int64_t)h[k] * sc_c(j);
  }
}

// x mod L, canonical in 10 limbs (limb 9 is 0 or 1), from 14 accumulators
// of a value |V| < 2^392 with |x_i| < 2^60: the folds after the first one
// of a digest and after a product's convolution.  x is clobbered.
FD_FN void sc_fold_tail(uint32_t *out, int64_t *x) {
  // |V| < 2^392: limbs 0 .. 12 in [0, 2^28), |x_13| < 2^28
  sc_carry<14>(x);
  // lo - C hi with |hi| < 2^140: |V| < 2^265; columns of five products
  // below 2^56 and a limb: |y_i| < 2^59
  int64_t y[10];
  sc_fold<14, 10>(y, x);
  // limbs 0 .. 8 exact, |y_9| < 2^14
  sc_carry<10>(y);
  // lo - C y_9: V in (-2^138, 2^252 + 2^138), |y_i| < 2^42
  sc_fold<10, 10>(y, y);
  // limbs 0 .. 8 exact, y_9 in {-1, 0, 1} (the value's sign and its
  // 2^252 bit); from here every step fits an int32
  sc_carry<10>(y);
  int32_t u[10], d[10];
  // V < 0: V + L, in (L - 2^138, L)
  const int32_t neg = (int32_t)(y[9] >> 63);
#pragma unroll
  for (int i = 0; i < 10; i++)
    u[i] = (int32_t)y[i] + (i < 5 ? sc_c(i) & neg : 0) - (i == 9 ? neg : 0);
  sc_carry<10>(u);
  // u in [0, 2^252 + 2^138): u - L if that is not negative
#pragma unroll
  for (int i = 0; i < 10; i++)
    d[i] = u[i] - (i < 5 ? sc_c(i) : 0) - (i == 9);
  sc_carry<10>(d);
  const bool ge = d[9] >= 0;
#pragma unroll
  for (int i = 0; i < 10; i++) out[i] = (uint32_t)(ge ? d[i] : u[i]);
}

// The SHA-512 digest (16 little-endian words) mod L -> 10 canonical
// limbs (reduce_512).  The first fold takes the 19 limbs, exact as read,
// to 14 accumulators: |V| < 2^385, |x_i| < 2^59.
FD_FN void sc_reduce512(uint32_t *out, const uint32_t *digest) {
  uint32_t l[19];
  sc_words_to_limbs<16, 19>(l, digest);
  int64_t x[19], y[14];
#pragma unroll
  for (int i = 0; i < 19; i++) x[i] = l[i];
  sc_fold<19, 14>(y, x);
  sc_fold_tail(out, y);
}

// a z mod L for a of 10 limbs below 2^264 (a canonical k, or S as its
// bytes are) and z of 5 below 2^128 -> 10 canonical limbs (mul_mod_l).
// The 10 x 5 convolution has columns of at most five products below
// 2^56, and its value is below 2^392.
FD_FN void sc_mul_mod_l(uint32_t *out, const uint32_t *a, const uint32_t *z) {
  int64_t x[14];
#pragma unroll
  for (int i = 0; i < 14; i++) x[i] = 0;
#pragma unroll
  for (int i = 0; i < 10; i++) {
#pragma unroll
    for (int j = 0; j < 5; j++) x[i + j] += (uint64_t)a[i] * z[j];
  }
  sc_fold_tail(out, x);
}

// S < L (fd_curve25519_scalar_validate) on S's 8 words: the borrow out
// of S - L.
FD_FN bool sc_is_canonical(const uint32_t *s) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint64_t t = (uint64_t)s[i] - sc_l_word(i) - borrow;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// The 8 N unsigned 4-bit windows of N words, low first: for word q,
// sink(q, e, o) with window 8 q + 2 j in byte j of e and window 8 q +
// 2 j + 1 in byte j of o.
template <int N, typename Sink>
FD_FN void sc_windows(const uint32_t *x, Sink &&sink) {
#pragma unroll
  for (int q = 0; q < N; q++)
    sink(q, x[q] & 0x0f0f0f0fu, x[q] >> 4 & 0x0f0f0f0fu);
}

// The signed recode of 64 windows (scalar25519.signed_windows) by masks,
// on the scalar's 8 words.  With G the windows whose digit exceeds 8 and
// P those equal to 8, the ripple's carry into window i is bit i of
// ((G | P) + G) ^ P, since an addition of G to G | P generates at G,
// passes a carry through P and stops it elsewhere.  Then sign = G | (P &
// carry), digit d = nibble + carry, magnitude sign ? 16 - d : d.  The
// masks hold window i at bit 4 i, and bits 4 i + 1 .. 4 i + 3 of the
// addend G | P are ones, through which a carry runs on to the next
// window; the carry out of the top window is dropped, as the ripple
// drops it.  For word q: sink(q, me, mo, se, so), the magnitudes and
// signs of windows 8 q + 2 j (byte j of me, se) and 8 q + 2 j + 1 (mo,
// so).
template <typename Sink>
FD_FN void sc_signed_recode(const uint32_t *x, Sink &&sink) {
  const uint32_t b0 = 0x11111111u, y0 = 0x01010101u, y4 = 0x0f0f0f0fu;
  uint32_t carry = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) {
    const uint32_t v = x[q], b3 = v >> 3;
    const uint32_t low = v | v >> 1 | v >> 2;     // bit 4 i: bits 0..2 of i
    const uint32_t g = b3 & low & b0, p = b3 & ~low & b0;
    const uint64_t sum = (uint64_t)((b3 & b0) | ~b0) + g + carry;
    carry = (uint32_t)(sum >> 32);
    const uint32_t c = ((uint32_t)sum ^ p) & b0;  // the carry into window i
    const uint32_t sg = g | (p & c);
    const uint32_t de = (v & y4) + (c & y0), dd = (v >> 4 & y4) + (c >> 4 & y0);
    const uint32_t se = sg & y0, so = sg >> 4 & y0;
    // per byte: 16 - d where the sign is set (0x10 - d never borrows)
    const uint32_t me = de ^ ((de ^ (0x10101010u - de)) & se * 0xffu);
    const uint32_t mo = dd ^ ((dd ^ (0x10101010u - dd)) & so * 0xffu);
    sink(q, me, mo, se, so);
  }
}

// Window bytes of word q (as the sinks above get them) into a uint8
// array, low window first.
FD_FN void sc_put_windows(uint8_t *out, int q, uint32_t e, uint32_t o) {
#pragma unroll
  for (int j = 0; j < 4; j++) {
    out[8 * q + 2 * j] = (uint8_t)(e >> 8 * j);
    out[8 * q + 2 * j + 1] = (uint8_t)(o >> 8 * j);
  }
}

// The signed recode of a scalar's 8 words into magnitude and sign arrays.
FD_FN void sc_signed_windows_of(uint8_t *mag, uint8_t *sgn,
                                const uint32_t *x) {
  sc_signed_recode(x, [&](int q, uint32_t me, uint32_t mo, uint32_t se,
                          uint32_t so) {
    sc_put_windows(mag, q, me, mo);
    sc_put_windows(sgn, q, se, so);
  });
}

// 64 unsigned 4-bit windows (low first) -> magnitudes 0..8 and signs 0/1
// (scalar25519.signed_windows), by the mask recode on the digits packed
// into words.  The carry out of the top window is dropped: it cannot
// occur below 2^253, and an S that large is rejected by the S < L test
// anyway.
FD_FN void sc_signed_windows(uint8_t *mag, uint8_t *sgn, const uint8_t *nib) {
  uint32_t x[8];
#pragma unroll
  for (int q = 0; q < 8; q++) {
    x[q] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) x[q] |= (uint32_t)nib[8 * q + i] << 4 * i;
  }
  sc_signed_windows_of(mag, sgn, x);
}

// The scalar half of the strict tail, one lane: S < L, k = digest mod L,
// and the signed windows of S (its bytes as they are) and of k.
FD_FN bool sc_reduce_recode(const uint8_t *s, const uint8_t *digest,
                            uint8_t *smag, uint8_t *ssgn, uint8_t *kmag,
                            uint8_t *ksgn) {
  uint32_t dw[16], k[10], kw[8], sw[8];
  sc_load_words<16>(dw, digest);
  sc_reduce512(k, dw);
  sc_limbs_to_words(kw, k);
  sc_signed_windows_of(kmag, ksgn, kw);
  sc_load_words<8>(sw, s);
  sc_signed_windows_of(smag, ssgn, sw);
  return sc_is_canonical(sw);
}

#if defined(__CUDACC__)
// Staging a warp's rows through shared memory: rows base .. base + 31 of
// a view of W-word rows, row i at sm[i (W + 1)] (an odd pitch, so a
// thread's reads of its own row are free of bank conflicts).  Thread t
// loads words t, t + 32, ..., so each load of the warp reads 32
// neighbouring words of 32 / W rows, where a thread reading its own row
// would touch 32 lines.  Rows past n repeat row n - 1.  sc_load_rows
// issues all of a thread's loads before anything waits on them (a view
// whose base or row stride is not a multiple of 4 is read by bytes);
// sc_store_rows puts them in place.  The caller syncs the warp after the
// stores, and can load a second view before it.
template <int W>
__device__ __forceinline__ void sc_load_rows(uint32_t *v, const uint8_t *src,
                                             long long stride,
                                             long long base, long long n,
                                             bool aligned) {
  const int t = threadIdx.x & 31;
  if (aligned) {
#pragma unroll
    for (int it = 0; it < W; it++) {
      const int k = 32 * it + t;
      const long long row = base + k / W < n ? base + k / W : n - 1;
      v[it] = __ldg(reinterpret_cast<const uint32_t *>(src + row * stride) +
                    k % W);
    }
  } else {
#pragma unroll
    for (int it = 0; it < W; it++) {
      const int k = 32 * it + t;
      const long long row = base + k / W < n ? base + k / W : n - 1;
      sc_load_words<1>(&v[it], src + row * stride + 4 * (k % W));
    }
  }
}

template <int W>
__device__ __forceinline__ void sc_store_rows(uint32_t *sm,
                                              const uint32_t *v) {
  const int t = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < W; it++) {
    const int k = 32 * it + t;
    sm[k / W * (W + 1) + k % W] = v[it];
  }
}
#endif
