// PoH spans: each lane extends its own SHA-256 chain through a list of
// steps, on a pair of warps: a rounds warp and a schedule warp.
//
// Replaces firedancer_tpu/ballet/poh_engine.py::poh_spans_blob and
// firedancer_tpu/ballet/poh.py::verify_entries (one step a lane), which
// the JAX package runs as a compiled lax.scan, not a Pallas kernel.  In
// plain torch each hash is some 2,000-3,000 small launches, so the chain
// needs a kernel of its own.  A row of the blob is
//
//   start[32] | steps * ( mixin[32] | n u32 LE | has_mixin u8 | active u8 )
//
// and a step does n - 1 plain appends, then one append that absorbs the
// mixin (has_mixin) or a plain one.  n <= 0 and an inactive step pass the
// state through.  The plain appends stop at the step's cap, as the JAX
// scan stops at its length: a step runs min(n - 1, caps[s]) of them.
// Every step's end state is written out big-endian, (lanes, steps * 32).
//
// What bounds it: a lane is one dependent chain of compressions, and the
// leader's chain is one lane, so one warp's issue rate sets its time, not
// the card's.  An SM sub-partition issues at most one warp instruction a
// cycle; its integer pipe is 16 lanes wide, so a shift, a LOP3 or an
// IADD3 holds it 2 cycles, and IMAD runs beside it on the FMA pipe.  One
// thread doing a whole hash (48 schedule words and 64 rounds, ~1,265
// integer-pipe instructions) took ~2,650 cycles.  What the design does
// about it (PERF.md has the measurements):
//  - the message schedule runs on a second warp, on another
//    sub-partition (warp 1 of the block; the rounds warp is warp 0).  For
//    each hash it takes the state through shared memory and writes
//    K_t + W_t of rounds 16-63 back, 16 words a named barrier, while the
//    rounds warp runs rounds 0-15 on the state words and the constant
//    tail, which need nothing from it.  The rounds warp keeps
//    ~16 instructions a round, 10 of them integer-pipe only (6 funnel
//    shifts, 4 LOP3), and issues them at ~2 cycles each: that, and the
//    schedule warp's fetch and handovers beside it, is the bound now;
//  - the rounds' two-input adds and the schedule's adds run on the FMA
//    pipe as IMAD, multiplies by a 1 that ptxas cannot see (POH_ONE), so
//    it cannot turn them back into IADD3.  Rotations and shifts stay SHF:
//    as IMAD.HI forms they were slower on this card;
//  - what is constant is folded: H0 through the first rounds, and an
//    append's pad words through its rounds 8-15;
//  - a mixin's second block is the constant table S256_PAD64_WK, on the
//    rounds warp alone;
//  - a pair runs each step to its longest lane's hash count with the
//    finished lanes masked, as the JAX scan masks, so both warps reach
//    every barrier equally often; a hash in which some lane absorbs its
//    mixin takes the unfolded path.
// The state stays in registers as big-endian words, which are also the
// next hash's message words.  A block is one pair, 32 lanes; the lanes
// of a re-check spread over as many SMs as they fill pairs.  Two or more
// pairs on one SM contend for its issue slots, and with the card full the
// pairs hash slower than one thread a lane did (PERF.md): no caller of
// the port launches that many lanes yet.

#include "sha256.cuh"

// ---- integer work on the FMA pipe ------------------------------------------
// The 1 is read from constant memory, which the host may rewrite, so the
// compiler cannot fold the multiply and turn it back into an IADD3.
S256_CONST uint32_t POH_ONE = 1u;

// x + y, as mad.lo(x, 1, y) on the FMA pipe where imad; a plain add where
// an operand may be a constant that the compiler should fold: rounds 0-3
// see H0's, and rounds 0-15 add K_t + W_t, an append's tail in 8-15.
FD_FN uint32_t poh_add(uint32_t x, uint32_t y, bool imad) {
  if (!imad) return x + y;
#if defined(__CUDA_ARCH__)
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(POH_ONE), "r"(y));
  return r;
#else
  return x * POH_ONE + y;
#endif
}

// Round t of a block's first compression, kw = K_t + W_t; the working
// words rotate by renaming.  The rotations stay funnel shifts (SHF): as
// two IMAD.HI forms each they were slower on this card (PERF.md).
#define POH_ROUND(a, b, c, d, e, f, g, h, kw, t)                             \
  do {                                                                      \
    const bool live_ = (t) >= 4;                                            \
    const uint32_t s1_ = s256_rotr(e, 6) ^ s256_rotr(e, 11) ^               \
                         s256_rotr(e, 25);                                  \
    const uint32_t s0_ = s256_rotr(a, 2) ^ s256_rotr(a, 13) ^               \
                         s256_rotr(a, 22);                                  \
    const uint32_t t1_ = poh_add(                                           \
        poh_add(poh_add(h, kw, (t) >= 16), (e & f) ^ (~e & g), live_),      \
        s1_, live_);                                                        \
    d = poh_add(d, t1_, live_);                                             \
    h = poh_add(poh_add(t1_, (a & b) ^ (a & c) ^ (b & c), live_), s0_,      \
                live_);                                                     \
  } while (0)

// Rounds t0 .. t0 + 7, kw[i] = K + W of round t0 + i.
FD_FN void poh_rounds8(uint32_t v[8], const uint32_t *kw, int t0) {
  uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
  uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
  POH_ROUND(a, b, c, d, e, f, g, h, kw[0], t0 + 0);
  POH_ROUND(h, a, b, c, d, e, f, g, kw[1], t0 + 1);
  POH_ROUND(g, h, a, b, c, d, e, f, kw[2], t0 + 2);
  POH_ROUND(f, g, h, a, b, c, d, e, kw[3], t0 + 3);
  POH_ROUND(e, f, g, h, a, b, c, d, kw[4], t0 + 4);
  POH_ROUND(d, e, f, g, h, a, b, c, kw[5], t0 + 5);
  POH_ROUND(c, d, e, f, g, h, a, b, kw[6], t0 + 6);
  POH_ROUND(b, c, d, e, f, g, h, a, kw[7], t0 + 7);
  v[0] = a; v[1] = b; v[2] = c; v[3] = d;
  v[4] = e; v[5] = f; v[6] = g; v[7] = h;
}

// H0 as literals, so that the compiler folds it (S256_H0 is constant
// memory).
FD_FN void poh_h0(uint32_t h[8]) {
  h[0] = 0x6a09e667u; h[1] = 0xbb67ae85u; h[2] = 0x3c6ef372u;
  h[3] = 0xa54ff53au; h[4] = 0x510e527fu; h[5] = 0x9b05688cu;
  h[6] = 0x1f83d9abu; h[7] = 0x5be0cd19u;
}

// The 16 message words of a lane's hash: the state, then the mixin at
// p (mix: this hash absorbs it) or a 32-byte message's constant tail.
FD_FN void poh_words(uint32_t w[16], const uint32_t st[8], const uint8_t *p,
                     bool mix) {
  const uint32_t tail[8] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0x100u};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    w[i] = st[i];
    w[8 + i] = mix ? s256_load_be(p + 4 * i) : tail[i];
  }
}

// The schedule warp's part of a hash: K_t + W_t of rounds 16-63 from the
// block's words w (overwritten by the schedule's ring), 16 at a time (a
// chunk); put(c, kw) hands chunk c over and returns 0, which the next word
// takes in (on the card a 0 that ptxas cannot see: PohPut).  Its adds run
// on the FMA pipe, its rotations and shifts as SHF.  A loop of one chunk a
// trip, so that the ring's indices stay constant and the warp's code is
// small: unrolled, the schedule warp's instruction fetch slowed the rounds
// warp beside it.
template <class Put>
FD_FN void poh_schedule(uint32_t w[16], Put put) {
#pragma unroll 1
  for (int i = 0; i < 3; i++) {
    uint32_t kw[16];
#pragma unroll
    for (int k = 0; k < 16; k++) {
      const uint32_t x15 = w[(k + 1) & 15], x2 = w[(k + 14) & 15];
      const uint32_t s0 = s256_rotr(x15, 7) ^ s256_rotr(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = s256_rotr(x2, 17) ^ s256_rotr(x2, 19) ^ (x2 >> 10);
      w[k] = poh_add(poh_add(poh_add(w[k], s0, true), w[(k + 9) & 15], true),
                     s1, true);
      kw[k] = w[k] + S256_K[16 + 16 * i + k];
    }
    w[0] ^= put(i, kw);
  }
}

// The rounds warp's part of a hash's first compression: v = the working
// words after 64 rounds from H0, rounds 0-15 on w, rounds 16-63 on the
// chunks that get(c, kw, v) hands over (v: the working words before
// them).
template <class Get>
FD_FN void poh_rounds(uint32_t v[8], const uint32_t w[16], Get get) {
  // the first 16 round constants as literals, so that an append's
  // K_t + W_t of rounds 8-15 folds
  const uint32_t k16[16] = {
      0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u,
      0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
      0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
      0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u};
  poh_h0(v);
#pragma unroll
  for (int c = 0; c < 2; c++) {
    uint32_t kw[8];
#pragma unroll
    for (int i = 0; i < 8; i++) kw[i] = k16[8 * c + i] + w[8 * c + i];
    poh_rounds8(v, kw, 8 * c);
  }
#pragma unroll
  for (int c = 0; c < 3; c++) {
    uint32_t kw[16];
    get(c, kw, v);
    poh_rounds8(v, kw, 16);  // rounds 16-63 take one set of forms
    poh_rounds8(v, kw + 8, 16);
  }
}

// A hash's end on the rounds warp: H0 + v, then a mixin's second block
// (the constant table S256_PAD64_WK); the lane's state takes it where go
// (its step still runs).
FD_FN void poh_close(uint32_t st[8], const uint32_t v[8], bool mix, bool go) {
  uint32_t h[8];
  poh_h0(h);
#pragma unroll
  for (int i = 0; i < 8; i++) h[i] += v[i];
  if (mix) s256_compress_wk(h, S256_PAD64_WK);
  if (go) {
#pragma unroll
    for (int i = 0; i < 8; i++) st[i] = h[i];
  }
}

// A step's hashes in a lane: min(n - 1, cap) plain appends and the last
// hash, or none (an inactive step, n <= 0).  p is the step's 38 bytes.
FD_FN int poh_step_hashes(const uint8_t *p, int cap) {
  const int n = (int)((uint32_t)p[32] | ((uint32_t)p[33] << 8) |
                      ((uint32_t)p[34] << 16) | ((uint32_t)p[35] << 24));
  if (p[37] == 0 || n <= 0) return 0;
  return (n - 1 < cap ? n - 1 : cap) + 1;
}

#if !defined(__CUDACC__)
// The pair's work for one lane on the host, in the order the kernel's
// barriers impose: st = the hash of st (an append), or of st and the
// mixin at p (mix).
static inline void poh_hash(uint32_t st[8], const uint8_t *p, bool mix) {
  uint32_t w[16], ring[16], kws[48], v[8];
  poh_words(w, st, p, mix);
  for (int i = 0; i < 16; i++) ring[i] = w[i];
  poh_schedule(ring, [&](int c, const uint32_t *kw) {
    for (int i = 0; i < 16; i++) kws[16 * c + i] = kw[i];
    return 0u;
  });
  poh_rounds(v, w, [&](int c, uint32_t *kw, const uint32_t *) {
    for (int i = 0; i < 16; i++) kw[i] = kws[16 * c + i];
  });
  poh_close(st, v, mix, true);
}

// One lane's steps: row is the lane's blob row, out its (steps * 32)
// output row.
static inline void poh_lane(const uint8_t *row, int steps, const int *caps,
                            uint8_t *out) {
  uint32_t st[8];
  for (int i = 0; i < 8; i++) st[i] = s256_load_be(row + 4 * i);
  for (int s = 0; s < steps; s++) {
    const uint8_t *p = row + 32 + 38 * s;
    const int hashes = poh_step_hashes(p, caps[s]);
    for (int i = 0; i < hashes; i++)
      poh_hash(st, p, p[36] != 0 && i == hashes - 1);
    for (int i = 0; i < 8; i++) s256_store_be(out + 32 * s + 4 * i, st[i]);
  }
}
#endif

#if defined(__CUDACC__)
#define POH_PAIR 64     // a block: the rounds warp, then the schedule warp
#define POH_BAR_ST 1    // named barrier: the state, rounds -> schedule warp
#define POH_BAR_KW 2    // named barriers 2..: a chunk each, schedule -> rounds
// The pair's shared memory: K + W of rounds 16-63, 4 words a lane a row,
// and the state the rounds warp hands over.
struct PohShared {
  uint4 kw[48 / 4][32];
  uint4 st[2][32];
};

// The handovers are named barriers of the pair's 64 threads
// (POH_PAIR): the state's, POH_BAR_ST, a bar.sync of both warps; chunk
// c's, POH_BAR_KW + c, bar.arrive by the schedule warp and bar.sync by
// the rounds warp.  ptxas moves arithmetic across a barrier freely in
// both directions; left to itself it started the rounds warp's first
// rounds only after chunk 0 came in, and it held the schedule warp's
// last arrivals back until all its words were done.  So each handover is
// tied into the data: the rounds warp reads the state back from shared
// memory after the state's barrier; its barrier ids take the working
// words ANDed with POH_ZERO (0, which ptxas cannot see), so that each
// waits for the rounds before it; and the schedule warp reads each chunk
// back after its arrival and folds it, XORed with itself, into the next
// word, so that ptxas issues the arrival as soon as the chunk is stored.
S256_CONST uint32_t POH_ZERO = 0u;

__device__ __forceinline__ void poh_sync(int bar) {
  asm volatile("bar.sync %0, 64;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void poh_arrive(int bar) {
  asm volatile("bar.arrive %0, 64;" ::"r"(bar) : "memory");
}

// The schedule warp hands over chunk c, and returns its first word as
// read back after the arrival XORed with itself; the rounds warp takes a
// chunk (v: its working words before it).
struct PohPut {
  PohShared *sh;
  int l;
  __device__ __forceinline__ uint32_t operator()(int c,
                                                 const uint32_t *kw) const {
    const int row = 4 * c;
#pragma unroll
    for (int q = 0; q < 4; q++)
      sh->kw[row + q][l] =
          make_uint4(kw[4 * q], kw[4 * q + 1], kw[4 * q + 2], kw[4 * q + 3]);
    poh_arrive(POH_BAR_KW + c);
    return sh->kw[row][l].x ^ kw[0];
  }
};

struct PohGet {
  const PohShared *sh;
  int l;
  __device__ __forceinline__ void operator()(int c, uint32_t *kw,
                                             const uint32_t *v) const {
    poh_sync(POH_BAR_KW + c + (int)((v[0] ^ v[4]) & POH_ZERO));
#pragma unroll
    for (int q = 0; q < 4; q++) {
      const uint4 x = sh->kw[4 * c + q][l];
      kw[4 * q] = x.x; kw[4 * q + 1] = x.y;
      kw[4 * q + 2] = x.z; kw[4 * q + 3] = x.w;
    }
  }
};

// One hash of the pair, for lane l.  MIXING: some lane of the pair
// absorbs its mixin in this hash (mix); otherwise every lane appends, and
// the constant tail folds.
template <bool MIXING>
__device__ __forceinline__ void poh_pair_hash(PohShared *sh, int l,
                                              bool rounds, uint32_t st[8],
                                              const uint8_t *p, bool mix,
                                              bool go) {
  if (rounds) {
    sh->st[0][l] = make_uint4(st[0], st[1], st[2], st[3]);
    sh->st[1][l] = make_uint4(st[4], st[5], st[6], st[7]);
  }
  poh_sync(POH_BAR_ST);
  const uint4 x = sh->st[0][l], y = sh->st[1][l];
  const uint32_t cur[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
  uint32_t w[16];
  poh_words(w, cur, p, MIXING && mix);
  if (rounds) {
    uint32_t v[8];
    poh_rounds(v, w, PohGet{sh, l});
    poh_close(st, v, MIXING && mix, go);
  } else {
    poh_schedule(w, PohPut{sh, l});
  }
}

__global__ void __launch_bounds__(POH_PAIR)
poh_spans_kernel(const uint8_t *blob, long long row_stride, int lanes,
                 int steps, const int *caps, uint8_t *out) {
  __shared__ PohShared sh;
  const int l = threadIdx.x & 31;
  const bool rounds = threadIdx.x < 32;
  const int lane = blockIdx.x * 32 + l;
  const bool valid = lane < lanes;
  const uint8_t *row = blob + (valid ? (long long)lane * row_stride : 0);
  uint32_t st[8];
#pragma unroll
  for (int i = 0; i < 8; i++) st[i] = s256_load_be(row + 4 * i);
  for (int s = 0; s < steps; s++) {
    const uint8_t *p = row + 32 + 38 * s;
    const int hashes = valid ? poh_step_hashes(p, caps[s]) : 0;
    const bool has = p[36] != 0;
    // both warps run every lane to the pair's longest count
    const int trips = (int)__reduce_max_sync(0xffffffffu, (unsigned)hashes);
    for (int i = 0; i < trips; i++) {
      const bool go = i < hashes;
      const bool mix = go && has && i == hashes - 1;
      if (__any_sync(0xffffffffu, mix)) {
        poh_pair_hash<true>(&sh, l, rounds, st, p, mix, go);
        __syncwarp();
      } else {
        poh_pair_hash<false>(&sh, l, rounds, st, p, false, go);
      }
    }
    if (rounds && valid) {
#pragma unroll
      for (int i = 0; i < 8; i++)
        s256_store_be(out + ((long long)lane * steps + s) * 32 + 4 * i, st[i]);
    }
  }
}

extern "C" int fd_poh_spans(const uint8_t *blob, long long row_stride,
                            int lanes, int steps, const int *caps,
                            uint8_t *out, void *stream) {
  const int blocks = (lanes + 31) / 32;
  poh_spans_kernel<<<blocks, POH_PAIR, 0, (cudaStream_t)stream>>>(
      blob, row_stride, lanes, steps, caps, out);
  return (int)cudaGetLastError();
}
#endif
