// The shared double-scalar chain acc = [s]B + [k]P for one lane per
// thread, over signed 4-bit windows: the loop of curve_pallas._dsm_chain,
// which the fused verify tail (verify_tail.cu) and the split and unfused
// kernels (dsm.cu) all run.  The formulas and their order are those of
// firedancer_tpu_torch/ops/curve25519.py double_scalar_mul_base, so the
// kernels and the torch code give equal coordinates.

#pragma once
#include "fe25519.cuh"
#include "ge25519.cuh"

// Constants table, int32 (VT_NCONST, 10) limb rows:
//   rows 4i .. 4i+3: [i]B as (y - x, y + x, 2dxy, -2dxy), i = 0..8
//   rows 36..40:     d, 2d, sqrt(-1), and the two order-8 y values
#define VT_NCONST 41

struct vt_consts {
  fe base[9][4];
  fe d, d2, sqrt_m1, y8_0, y8_1;
};

// acc = [s]B + [k]P for windows given as magnitude 0..8 and sign 0/1
// (64 each, low first).  P may have any Z; its T must be valid.  The
// [0..8]P table is built from P itself, in Niels form; [0..8]B comes
// from the constants.  High window first: four doublings (T on the last
// only), one Niels add from P's table, one affine add from B's (without
// T, since the next doubling never reads it).  A sign picks the operands
// and never branches around an add, so a warp whose lanes' signs differ
// makes each add once.  acc.T is stale on return.
FD_FN void ge_dsm_chain(ge &acc, const ge &p, const uint8_t *smag,
                        const uint8_t *ssgn, const uint8_t *kmag,
                        const uint8_t *ksgn, const vt_consts &c) {
  ge_niels tab[9];
  ge_niels_table(tab, p, 9, c.d2);
  ge_identity(acc);
  for (int w = 63; w >= 0; w--) {
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, false);
    ge_double(acc, acc, true);
    const ge_niels &e = tab[kmag[w]];
    const int kn = ksgn[w];
    fe t2d = e.T2d;
    if (kn) fe_neg(t2d, e.T2d);
    ge_add_niels(acc, acc, kn ? e.Yp : e.Ym, kn ? e.Ym : e.Yp, e.Z, t2d);
    const fe *b = c.base[smag[w]];
    const int sn = ssgn[w];
    ge_add_affine_niels(acc, acc, b[sn], b[1 - sn], b[2 + sn], false);
  }
}
