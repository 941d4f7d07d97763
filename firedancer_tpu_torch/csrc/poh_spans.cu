// PoH spans: each lane extends its own SHA-256 chain through a list of
// steps, one thread a lane.
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
// What bounds it: a lane is one dependent chain of compressions, but the
// round's recurrence (about three dependent operations) is not what
// binds.  The shifts, LOP3s and three-input adds all run on the SM
// sub-partition's integer pipe, 16 lanes wide, so a warp issues one of
// them every 2 cycles, whether it holds one lane (the leader's chain) or
// 32; a re-check of many lanes runs at that rate on each sub-partition
// it gives a warp.  What the design does about it: the state stays in
// registers as big-endian words, which are also the next hash's message
// words, so the chain never converts to bytes between hashes; the round
// constants sit in constant memory and the rounds are unrolled; blocks
// are one warp, so the lanes of a re-check spread over as many SMs as
// they fill warps.

#include "sha256.cuh"

// One lane's steps: row is the lane's blob row, out its (steps * 32)
// output row.
FD_FN void poh_lane(const uint8_t *row, int steps, const int *caps,
                    uint8_t *out) {
  uint32_t st[8];
  for (int i = 0; i < 8; i++) st[i] = s256_load_be(row + 4 * i);
  for (int s = 0; s < steps; s++) {
    const uint8_t *p = row + 32 + 38 * s;
    const int n = (int)((uint32_t)p[32] | ((uint32_t)p[33] << 8) |
                        ((uint32_t)p[34] << 16) | ((uint32_t)p[35] << 24));
    if (p[37] != 0 && n > 0) {
      const int m = n - 1 < caps[s] ? n - 1 : caps[s];
      for (int i = 0; i < m; i++) s256_fixed32(st);
      if (p[36] != 0) {
        uint32_t mix[8];
        for (int i = 0; i < 8; i++) mix[i] = s256_load_be(p + 4 * i);
        s256_fixed64(st, mix);
      } else {
        s256_fixed32(st);
      }
    }
    for (int i = 0; i < 8; i++) s256_store_be(out + 32 * s + 4 * i, st[i]);
  }
}

#if defined(__CUDACC__)
#define POH_WARP 32

__global__ void __launch_bounds__(POH_WARP)
poh_spans_kernel(const uint8_t *blob, long long row_stride, int lanes,
                 int steps, const int *caps, uint8_t *out) {
  const int lane = blockIdx.x * POH_WARP + threadIdx.x;
  if (lane >= lanes) return;
  poh_lane(blob + lane * row_stride, steps, caps,
           out + (long long)lane * steps * 32);
}

extern "C" int fd_poh_spans(const uint8_t *blob, long long row_stride,
                            int lanes, int steps, const int *caps,
                            uint8_t *out, void *stream) {
  const int blocks = (lanes + POH_WARP - 1) / POH_WARP;
  poh_spans_kernel<<<blocks, POH_WARP, 0, (cudaStream_t)stream>>>(
      blob, row_stride, lanes, steps, caps, out);
  return (int)cudaGetLastError();
}
#endif
