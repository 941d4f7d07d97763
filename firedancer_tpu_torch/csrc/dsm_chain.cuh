// The shared double-scalar chain acc = [s]B + [k]P over signed 4-bit
// windows: the loop of curve_pallas._dsm_chain, in two forms.
//
//   ge_dsm_chain    one lane per thread (the unfused layout's
//                   double_scalar_mul_base kernel, dsm.cu fd_dsm_base);
//   ge_dsm_chain4   one lane per group of four threads, the formulas'
//                   four products of a round run side by side (the fused
//                   tail, verify_tail.cu, and the split layout's
//                   dsm_tail_q kernel, dsm.cu fd_dsm_tail_q).
//
// The formulas and their order are those of
// firedancer_tpu_torch/ops/curve25519.py double_scalar_mul_base, and both
// forms make every field product with the same operands in the same
// order, so the kernels and the torch code give equal coordinates.

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

// The strict tail's projective y-compare Q.Y == y_R Q.Z; writes Q's X
// and Z.
FD_FN bool dsm_y_compare(const ge &q, const fe &y_r, fe &qx, fe &qz) {
  fe t;
  fe_mul(t, y_r, q.Z);
  qx = q.X;
  qz = q.Z;
  return fe_eq(q.Y, t);
}

// ---- The chain on four threads per lane ----
//
// The point formulas run as rounds of up to four independent field
// products (the parallel layout of the Hisil-Wong-Carter-Dawson
// formulas), made by four ranks: in a round rank q makes the q-th
// product, with the operands and argument order of the one-thread
// function in ge25519.cuh; the products are then gathered to every rank
// of the lane, and every rank makes the round's additions and
// subtractions itself, so all hold the same accumulator.
//   doubling         2 rounds: X^2, Y^2, Z^2, (X + Y)^2; then the four
//                    products of the finish (three without T)
//   Niels add        2 rounds: a, b, c, zz; then the finish
//   affine add       2 rounds: a, b, c (zz = 2Z is an addition; rank 3
//                    idles); then the finish without T
//   unified add      3 rounds: a, b, T T', Z Z'; c = (T T') 2d on every
//                    rank; then the finish
// On the device a lane is a group of four adjacent threads, rank r0 =
// threadIdx.x & 3, and the gather is 10 shuffles of width 4 per product.
// On the host (tests, where there are no warps) one call runs a lane's
// four ranks in lockstep, r0 = 0: each round makes the four ranks'
// products one after another, and the gather is an array.
// Operands are picked by rank with selects, never by branches, so the
// threads of a warp run one instruction stream.  These functions are
// inlined (FD_FN), unlike ge25519.cuh's out-of-line point functions:
// the accumulator then stays in registers, and cicc compiles them.
//
// P's table [0..8]P in Niels form: in round 1 of a Niels add rank q only
// ever reads column q of an entry (Y - X, Y + X, 2dT, Z), since the
// digit's sign swaps the roles of ranks 0 and 1 instead of their columns.
// So each rank keeps its own column, 9 entries x 10 limbs: limb l of
// entry e of rank r0 + i's column at tab[i + (e * 10 + l) *
// G4_TAB_STRIDE].  On the device tab is shared memory laid out
// [entry][limb][thread], so a lane's data-dependent pick of an entry is
// free of bank conflicts; on the host it holds the four columns.
#if defined(__CUDACC__)
#define G4_RANKS 1          // ranks a call runs: the thread's own
#define G4_TAB_STRIDE 32    // a block is one warp
#else
#define G4_RANKS 4
#define G4_TAB_STRIDE 4
#endif
#define G4_TAB_WORDS (9 * 10)   // one rank's column of P's table

// out = the q-th of a0..a3, by selects on q's bits.
FD_FN void g4_sel(fe &out, int q, const fe &a0, const fe &a1, const fe &a2,
                  const fe &a3) {
  const bool b0 = q & 1, b1 = q & 2;
#pragma unroll
  for (int l = 0; l < 10; l++)
    out.v[l] = b1 ? (b0 ? a3.v[l] : a2.v[l]) : (b0 ? a1.v[l] : a0.v[l]);
}

// out = c ? a : b.
FD_FN void g4_pick(fe &out, bool c, const fe &a, const fe &b) {
#pragma unroll
  for (int l = 0; l < 10; l++) out.v[l] = c ? a.v[l] : b.v[l];
}

// The gather of a round: all[j] = rank j's product for j < K, where
// mine[i] is the product of rank r0 + i.
template <int K>
FD_FN void g4_gather(fe *all, const fe *mine) {
#if defined(__CUDACC__)
#pragma unroll
  for (int j = 0; j < K; j++)
#pragma unroll
    for (int l = 0; l < 10; l++)
      all[j].v[l] = __shfl_sync(0xffffffffu, mine[0].v[l], j, 4);
#else
  for (int j = 0; j < K; j++) all[j] = mine[j];
#endif
}

// One round: rank q makes fe_mul(f_q, g_q); all[j] gets rank j's, j < K.
template <int K>
FD_FN void g4_mul(fe *all, int r0, const fe &f0, const fe &g0,
                  const fe &f1, const fe &g1, const fe &f2, const fe &g2,
                  const fe &f3, const fe &g3) {
  fe mine[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe f, g;
    g4_sel(f, r0 + i, f0, f1, f2, f3);
    g4_sel(g, r0 + i, g0, g1, g2, g3);
    fe_mul(mine[i], f, g);
  }
  g4_gather<K>(all, mine);
}

// The round that makes a point: p's X, Y, Z and T are ranks 0..3's
// products f_q g_q.  K = 3 leaves p.T as it was.
template <int K>
FD_FN void g4_point(ge &p, int r0, const fe &f0, const fe &g0, const fe &f1,
                    const fe &g1, const fe &f2, const fe &g2, const fe &f3,
                    const fe &g3) {
  fe all[4];
  g4_mul<K>(all, r0, f0, g0, f1, g1, f2, g2, f3, g3);
  p.X = all[0];
  p.Y = all[1];
  p.Z = all[2];
  if (K == 4) p.T = all[3];
}

// ge_finish: E = B - A, F = D - C, G = D + C, H = B + A; then (EF, GH,
// FG, EH).
template <int K>
FD_FN void g4_finish(ge &p, int r0, const fe &a, const fe &b, const fe &c,
                     const fe &d) {
  fe e, f, g, h;
  fe_sub(e, b, a);
  fe_sub(f, d, c);
  fe_add(g, d, c);
  fe_add(h, b, a);
  g4_point<K>(p, r0, e, f, g, h, f, g, e, h);
}

// ge_double in place.
template <bool WANT_T>
FD_FN void g4_double(ge &p, int r0) {
  fe xpy, all[4], sq[G4_RANKS];
  fe_add(xpy, p.X, p.Y);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe f;
    g4_sel(f, r0 + i, p.X, p.Y, p.Z, xpy);
    fe_sqr(sq[i], f);
  }
  g4_gather<4>(all, sq);    // X^2, Y^2, Z^2, (X + Y)^2
  fe zz2, yp, ym, ec, tc;
  fe_add(zz2, all[2], all[2]);
  fe_add(yp, all[1], all[0]);
  fe_sub(ym, all[1], all[0]);
  fe_sub(ec, all[3], yp);
  fe_sub(tc, zz2, ym);
  g4_point<WANT_T ? 4 : 3>(p, r0, ec, tc, yp, ym, ym, tc, ec, yp);
}

// Entry e of the column at col.
FD_FN void g4_load(fe &out, const uint32_t *col, int e) {
#pragma unroll
  for (int l = 0; l < 10; l++) out.v[l] = col[(e * 10 + l) * G4_TAB_STRIDE];
}

// ge_add_niels in place, with entry e of P's table, negated for neg:
// the one-thread chain passes (Yp, Ym, -2dT) then, where rank q here
// keeps column q and ranks 0 and 1 swap their left operands instead, so
// that rank 0 makes b and rank 1 makes a.
FD_FN void g4_add_niels(ge &p, int r0, const uint32_t *tab, int e,
                        bool neg) {
  fe ymx, ypx, l0, l1, all[4], mine[G4_RANKS];
  fe_sub(ymx, p.Y, p.X);
  fe_add(ypx, p.Y, p.X);
  g4_pick(l0, neg, ypx, ymx);
  g4_pick(l1, neg, ymx, ypx);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe col, ncol, f, g;
    g4_load(col, tab + i, e);
    fe_neg(ncol, col);
    g4_pick(g, neg && r0 + i == 2, ncol, col);
    g4_sel(f, r0 + i, l0, l1, p.T, p.Z);
    fe_mul(mine[i], f, g);
  }
  g4_gather<4>(all, mine);  // a, b (swapped for neg), c, Z Z'
  fe a, b, zz;
  g4_pick(a, neg, all[1], all[0]);
  g4_pick(b, neg, all[0], all[1]);
  fe_add(zz, all[3], all[3]);
  g4_finish<4>(p, r0, a, b, all[2], zz);
}

// ge_add_affine_niels in place without T, with B's entry bq (4 rows) and
// sign sn: rank 3 makes rank 2's product and drops it.
FD_FN void g4_add_affine(ge &p, int r0, const fe *bq, int sn) {
  fe ymx, ypx, all[4], mine[G4_RANKS];
  fe_sub(ymx, p.Y, p.X);
  fe_add(ypx, p.Y, p.X);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe f;
    g4_sel(f, q, ymx, ypx, p.T, p.T);
    fe_mul(mine[i], f, bq[q == 0 ? sn : q == 1 ? 1 - sn : 2 + sn]);
  }
  g4_gather<3>(all, mine);  // a, b, c
  fe zz;
  fe_add(zz, p.Z, p.Z);
  g4_finish<3>(p, r0, all[0], all[1], all[2], zz);
}

// ge_add: out = p + q (q's Y - X and Y + X given), T valid.
FD_FN void g4_add(ge &out, const ge &p, const ge &q, const fe &qym,
                  const fe &qyp, const fe &d2, int r0) {
  fe pym, pyp, c, zz, all[4];
  fe_sub(pym, p.Y, p.X);
  fe_add(pyp, p.Y, p.X);
  g4_mul<4>(all, r0, pym, qym, pyp, qyp, p.T, q.T, p.Z, q.Z);
  fe_mul(c, all[2], d2);            // every rank: no round of its own
  fe_add(zz, all[3], all[3]);
  g4_finish<4>(out, r0, all[0], all[1], c, zz);
}

// ge_to_niels of p into entry e: each rank stores its own column.
FD_FN void g4_store_niels(uint32_t *tab, int e, const ge &p, int r0,
                          const fe &d2) {
  fe ym, yp, t2d;
  fe_sub(ym, p.Y, p.X);
  fe_add(yp, p.Y, p.X);
  fe_mul(t2d, p.T, d2);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe col;
    g4_sel(col, r0 + i, ym, yp, t2d, p.Z);
#pragma unroll
    for (int l = 0; l < 10; l++)
      tab[i + (e * 10 + l) * G4_TAB_STRIDE] = col.v[l];
  }
}

// ge_niels_table(tab, p, 9, d2), each rank keeping its column.
FD_FN void g4_niels_table(uint32_t *tab, const ge &p, const fe &d2,
                          int r0) {
  ge cur;
  ge_identity(cur);
  g4_store_niels(tab, 0, cur, r0, d2);
  g4_store_niels(tab, 1, p, r0, d2);
  fe pym, pyp;
  fe_sub(pym, p.Y, p.X);
  fe_add(pyp, p.Y, p.X);
  cur = p;
  for (int e = 2; e < 9; e++) {
    ge nxt;
    g4_add(nxt, cur, p, pym, pyp, d2, r0);
    g4_store_niels(tab, e, nxt, r0, d2);
    cur = nxt;
  }
}

// ge_dsm_chain for rank r0 of the lane (on the host: all four ranks, r0
// = 0).  tab: the rank's column of P's table, laid out as above (on the
// host the four columns).  Every rank returns the same acc.
FD_FN void ge_dsm_chain4(ge &acc, const ge &p, const uint8_t *smag,
                         const uint8_t *ssgn, const uint8_t *kmag,
                         const uint8_t *ksgn, const vt_consts &c,
                         uint32_t *tab, int r0) {
  g4_niels_table(tab, p, c.d2, r0);
  ge_identity(acc);
  for (int w = 63; w >= 0; w--) {
    g4_double<false>(acc, r0);
    g4_double<false>(acc, r0);
    g4_double<false>(acc, r0);
    g4_double<true>(acc, r0);
    g4_add_niels(acc, r0, tab, kmag[w], ksgn[w]);
    g4_add_affine(acc, r0, c.base[smag[w]], ssgn[w]);
  }
}
