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
//    pipe as IMAD, multiplies by a 1 that ptxas cannot see (S256_ONE), so
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

// A hash's end on the rounds warp: H0 + v, then a mixin's second block
// (the constant table S256_PAD64_WK); the lane's state takes it where go
// (its step still runs).
FD_FN void poh_close(uint32_t st[8], const uint32_t v[8], bool mix, bool go) {
  uint32_t h[8];
  s256_h0(h);
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
  s256_schedule(ring, [&](int c, const uint32_t *kw) {
    for (int i = 0; i < 16; i++) kws[16 * c + i] = kw[i];
    return 0u;
  });
  s256_rounds_h0(v, w, [&](int c, uint32_t *kw, const uint32_t *) {
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
// words ANDed with S256_ZERO (0, which ptxas cannot see), so that each
// waits for the rounds before it; and the schedule warp reads each chunk
// back after its arrival and folds it, XORed with itself, into the next
// word, so that ptxas issues the arrival as soon as the chunk is stored.

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
    poh_sync(POH_BAR_KW + c + (int)((v[0] ^ v[4]) & S256_ZERO));
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
    s256_rounds_h0(v, w, PohGet{sh, l});
    poh_close(st, v, MIXING && mix, go);
  } else {
    s256_schedule(w, PohPut{sh, l});
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
