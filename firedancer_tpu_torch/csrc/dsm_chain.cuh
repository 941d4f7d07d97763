// The shared double-scalar chain acc = [s]B + [k]P over signed 4-bit
// windows (the loop of curve_pallas._dsm_chain), on four threads per
// lane, each holding one coordinate of the lane's points.  All three
// chain kernels run it: the fused tail (verify_tail.cu) and the split
// and unfused layouts' dsm_tail_q and double_scalar_mul_base (dsm.cu).
//
// The formulas and their order are those of
// firedancer_tpu_torch/ops/curve25519.py double_scalar_mul_base and of
// the one-thread functions in ge25519.cuh: every field product takes the
// same operands in the same argument order, every addition or
// subtraction the same operands in the same order, so the kernels and
// the torch code give equal coordinates.  (An addition's operands may
// come in either order: fe_add's limbs do not depend on it.)

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

// ---- The layout: a lane is four ranks, rank q holds coordinate q ----
//
// Rank q (threadIdx.x & 3 on the device) holds coordinate q of the
// lane's point: rank 0 X, rank 1 Y, rank 2 Z, rank 3 T.  A point step of
// the Hisil-Wong-Carter-Dawson formulas runs as two rounds of four
// independent products, and each product is made by the rank that owns
// its result: in the last round rank q makes coordinate q (EF, GH, FG,
// EH).  Between rounds an operand reaches a rank by a shuffle of width 4
// whose source lane depends on the rank, and each addition or
// subtraction is made only by the ranks that read it: ranks needing
// different sums run one fe_addsub, its sign chosen per rank.
//
// Per step, counted from the code (a shuffle moves one fe, 10 words):
//   doubling          1 S + 1 M per rank, 5 shuffles (X + Y to rank 0 and
//                     X to rank 3; the stage of Y^2 +- X^2 and 2Z^2; the
//                     stage of E, F; the two operands of the products)
//   Niels add         2 M, 4 shuffles (X and Y swapped between ranks 0
//                     and 1; then the finish's exchange and two operands)
//   affine add        2 M, 4 shuffles (as the Niels add; rank 2 makes
//                     2Z by an addition and rank 3 idles in the finish)
//   unified add       3 M, 4 shuffles (the table: a, b, Z Z', T T'; then
//                     (T T') 2d on rank 3 and, beside it, the table
//                     column 2dT of the point added to on rank 2; then
//                     the finish)
// so a window is 4 S + 8 M and 28 shuffles per rank, and the [0..8]P
// table 22 M and 29 shuffles.  Operands are picked by rank with selects,
// never by branches, so the threads of a warp run one instruction
// stream.
//
// On the host (tests, where there are no warps) one call runs a lane's
// four ranks in lockstep, r0 = 0: an fe array holds rank r0 + i's value
// at index i, each step loops over the ranks, and a shuffle is a copy
// between array entries.  On the device the arrays hold the thread's own
// value and r0 is its rank.  These functions are inlined (FD_FN), unlike
// ge25519.cuh's out-of-line point functions: the values then stay in
// registers, and cicc compiles them.
//
// P's table [0..8]P in Niels form: in round 1 of a Niels add rank q
// reads column q of an entry only (rank 0 Y - X, rank 1 Y + X, rank 2 Z,
// rank 3 2dT), since the digit's sign swaps the roles of ranks 0 and 1
// instead of their columns.  So each rank keeps its own column, 9
// entries x 10 limbs: limb l of entry e of rank r0 + i's column at
// tab[i + (e * 10 + l) * G4_TAB_STRIDE].  On the device tab is shared
// memory laid out [entry][limb][thread], so a lane's data-dependent pick
// of an entry is free of bank conflicts; on the host it holds the four
// columns.
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

// out[i] = the value of rank src[i] in v, for every rank r0 + i.
FD_FN void g4_shfl(fe *out, const fe *v, const int *src) {
#if defined(__CUDACC__)
#pragma unroll
  for (int l = 0; l < 10; l++)
    out[0].v[l] = __shfl_sync(0xffffffffu, v[0].v[l], src[0], 4);
#else
  for (int i = 0; i < G4_RANKS; i++) out[i] = v[src[i]];
#endif
}

// Orders the table's shared-memory stores before the ranks' reads.
FD_FN void g4_sync() {
#if defined(__CUDACC__)
  __syncwarp();
#endif
}

// The lane's point p in the layout: rank q takes coordinate q.
FD_FN void g4_from_ge(fe *out, const ge &p, int r0) {
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) g4_sel(out[i], r0 + i, p.X, p.Y, p.Z, p.T);
}

// ge_finish: E = B - A, F = D - C, G = D + C, H = B + A; then rank q
// makes coordinate q of (EF, GH, FG, EH).  v holds rank 0's A (B for
// neg), rank 1's B (A for neg), rank 2's D and rank 3's C.  One exchange
// between ranks 0 and 1 and between 2 and 3 gives rank 0 E (H for neg),
// rank 1 H (E), rank 2 G and rank 3 F; the products' operands then come
// by two shuffles.  WANT_T false: rank 3 keeps its coordinate.
template <bool WANT_T>
FD_FN void g4_finish(fe *p, const fe *v, int r0, bool neg) {
  fe got[G4_RANKS], w[G4_RANKS], f[G4_RANKS], g[G4_RANKS];
  int src[G4_RANKS], sf[G4_RANKS], sg[G4_RANKS];
  const int er = neg, hr = !neg;   // the ranks that hold E and H
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    src[i] = q ^ 1;
    sf[i] = q == 1 ? 2 : q == 2 ? 3 : er;   // E, G, F, E
    sg[i] = q == 0 ? 3 : q == 2 ? 2 : hr;   // F, H, G, H
  }
  g4_shfl(got, v, src);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe_addsub(w[i], got[i], v[i], q == 3 || (q < 2 && (q == 0) != neg));
  }
  g4_shfl(f, w, sf);
  g4_shfl(g, w, sg);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++)
    if (WANT_T || r0 + i != 3) fe_mul(p[i], f[i], g[i]);
}

// ge_double in place.  Round 1: rank 0 squares X + Y, rank 1 Y, rank 2
// Z and rank 3 X.  Then rank 1 makes Y^2 + X^2, rank 2 2Z^2 and rank 3
// Y^2 - X^2; then rank 1 ec = (X + Y)^2 - (Y^2 + X^2) and rank 3 tc =
// 2Z^2 - (Y^2 - X^2), while ranks 0 and 2 take Y^2 + X^2 and Y^2 - X^2.
// The last round makes (ec tc, yp ym, ym tc, ec yp).
template <bool WANT_T>
FD_FN void g4_double(fe *p, int r0) {
  fe got[G4_RANKS], sq[G4_RANKS], a[G4_RANKS], f[G4_RANKS], g[G4_RANKS];
  int s1[G4_RANKS], s2[G4_RANKS], s3[G4_RANKS], sf[G4_RANKS], sg[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    s1[i] = q == 0 ? 1 : q == 3 ? 0 : q;   // Y, Y, Z, X
    s2[i] = q == 1 ? 3 : q == 3 ? 1 : q;   // -, X^2, Z^2, Y^2
    s3[i] = q ^ 1;
    sf[i] = q == 1 ? 0 : q == 2 ? 2 : 1;   // ec, yp, ym, ec
    sg[i] = q == 1 ? 2 : q == 3 ? 0 : 3;   // tc, ym, tc, yp
  }
  g4_shfl(got, p, s1);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe xpy;
    fe_add(xpy, p[i], got[i]);
    g4_pick(xpy, r0 + i == 0, xpy, got[i]);
    fe_sqr(sq[i], xpy);                   // (X + Y)^2, Y^2, Z^2, X^2
  }
  g4_shfl(got, sq, s2);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe t;
    fe_addsub(t, got[i], sq[i], q == 3);
    g4_pick(a[i], q == 0, sq[i], t);      // (X + Y)^2, yp, zz2, ym
  }
  g4_shfl(got, a, s3);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe t;
    fe_sub(t, got[i], a[i]);
    g4_pick(a[i], (r0 + i) & 1, t, got[i]);   // yp, ec, ym, tc
  }
  g4_shfl(f, a, sf);
  g4_shfl(g, a, sg);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++)
    if (WANT_T || r0 + i != 3) fe_mul(p[i], f[i], g[i]);
}

// ge_add_niels in place with a Niels point given by column: col[i] is
// rank r0 + i's column (Y - X, Y + X, Z, 2dT), rank 3's already negated
// for neg.  Round 1: ranks 0 and 1 swap X and Y; rank 0 makes (Y - X)
// (Y - X)' = A and rank 1 (Y + X)(Y + X)' = B, or for neg, where the
// plain version (curve25519._add_signed) passes (Y + X)' as (Y - X)',
// rank 0 (Y + X)(Y - X)' = B and rank 1 (Y - X)(Y + X)' = A; rank 2 makes
// Z Z', doubled, and rank 3 T (2dT)' = C.
FD_FN void g4_add_niels_cols(fe *p, int r0, const fe *col, bool neg) {
  fe got[G4_RANKS], v[G4_RANKS];
  int src[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    src[i] = q < 2 ? q ^ 1 : q;
  }
  g4_shfl(got, p, src);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe y, x, l, zz2;
    g4_pick(y, q == 0, got[i], p[i]);
    g4_pick(x, q == 0, p[i], got[i]);
    fe_addsub(l, y, x, (q == 0) != neg);
    g4_pick(l, q < 2, l, p[i]);
    fe_mul(v[i], l, col[i]);
    fe_add(zz2, v[i], v[i]);
    g4_pick(v[i], q == 2, zz2, v[i]);
  }
  g4_finish<true>(p, v, r0, neg);
}

// Entry e of the column at col.
FD_FN void g4_load(fe &out, const uint32_t *col, int e) {
#pragma unroll
  for (int l = 0; l < 10; l++) out.v[l] = col[(e * 10 + l) * G4_TAB_STRIDE];
}

FD_FN void g4_store(uint32_t *col, int e, const fe &a) {
#pragma unroll
  for (int l = 0; l < 10; l++) col[(e * 10 + l) * G4_TAB_STRIDE] = a.v[l];
}

// ge_add_niels in place with entry e of P's table, negated for neg (the
// plain version passes (Y + X, Y - X, Z, -2dT) then).
FD_FN void g4_add_niels(fe *p, int r0, const uint32_t *tab, int e,
                        bool neg) {
  fe col[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe n;
    g4_load(col[i], tab + i, e);
    fe_neg(n, col[i]);
    g4_pick(col[i], neg && r0 + i == 3, n, col[i]);
  }
  g4_add_niels_cols(p, r0, col, neg);
}

// curve25519.add_affine_niels in place without T, with B's entry bq (4
// rows) and sign sn: ranks 0, 1 and 3 make A = (Y - X) bq[sn], B = (Y +
// X) bq[1 - sn] and C = T bq[2 + sn]; rank 2, which reads itself, makes
// 2Z by an addition and drops its product.
FD_FN void g4_add_affine(fe *p, int r0, const fe *bq, int sn) {
  fe got[G4_RANKS], v[G4_RANKS];
  int src[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    src[i] = q < 2 ? q ^ 1 : q;
  }
  g4_shfl(got, p, src);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe l, m;
    fe_addsub(l, got[i], p[i], q == 0);       // Y - X, Y + X, Z + Z
    g4_pick(m, q == 3, p[i], l);
    fe_mul(m, m, bq[q == 0 ? sn : q == 1 ? 1 - sn : 2 + sn]);
    g4_pick(v[i], q == 2, l, m);
  }
  g4_finish<false>(p, v, r0, false);
}

// The sums of a point that a unified add and a Niels column read: l gets
// rank 0's Y - X, rank 1's Y + X, rank 2's Z and rank 3's T; t gets, on
// rank 2, T.
FD_FN void g4_sums(fe *l, fe *t, const fe *p, int r0) {
  int src[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    src[i] = q == 0 ? 1 : q == 1 ? 0 : 3;
  }
  g4_shfl(t, p, src);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe s;
    fe_addsub(s, t[i], p[i], q == 0);
    g4_pick(l[i], q < 2, s, p[i]);
  }
}

// ge_add: out = c + p, T valid, from the sums lc, lp of both and c's T
// on rank 2 (tc, g4_sums).  Round 1: rank 0 A, rank 1 B, rank 2 Z Z' and
// rank 3 T T'; round 2: rank 3 C = (T T') 2d and rank 2 c's column 2dT
// of the Niels table, written to t2d; then the finish.
FD_FN void g4_add(fe *out, fe *t2d, const fe *lc, const fe *tc,
                  const fe *lp, const fe &d2, int r0) {
  fe v[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe m, zz2;
    fe_mul(m, lc[i], lp[i]);
    g4_pick(t2d[i], q == 2, tc[i], m);
    fe_mul(t2d[i], t2d[i], d2);
    fe_add(zz2, m, m);
    g4_pick(v[i], q == 2, zz2, q == 3 ? t2d[i] : m);
  }
  g4_finish<true>(out, v, r0, false);
}

// ge_niels_table(tab, p, 9, d2), each rank storing its column: entry 0
// the identity (1, 1, 1, 0), entry 1 P, then repeated unified adds of P.
// Rank 2 writes column 3 (2dT, made beside the next add's C) of every
// entry but the last, which takes a round of its own.
FD_FN void g4_niels_table(uint32_t *tab, const fe *p, const fe &d2,
                          int r0) {
  fe cur[G4_RANKS], lp[G4_RANKS], lc[G4_RANKS], tc[G4_RANKS],
      t2d[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe id;
    fe_set(id, r0 + i != 3);
    g4_store(tab + i, 0, id);
  }
  g4_sums(lp, tc, p, r0);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) lc[i] = lp[i];
  for (int e = 1; e < 9; e++) {
#pragma unroll
    for (int i = 0; i < G4_RANKS; i++)
      if (r0 + i != 3) g4_store(tab + i, e, lc[i]);
    if (e == 8) {
#pragma unroll
      for (int i = 0; i < G4_RANKS; i++) fe_mul(t2d[i], tc[i], d2);
    } else {
      g4_add(cur, t2d, lc, tc, lp, d2, r0);
    }
#pragma unroll
    for (int i = 0; i < G4_RANKS; i++)
      if (r0 + i == 2) g4_store(tab + i + 1, e, t2d[i]);
    if (e < 8) g4_sums(lc, tc, cur, r0);
  }
  g4_sync();
}

// acc = [s]B + [k]P for windows given as magnitude 0..8 and sign 0/1
// (64 each, low first), in the layout: p and acc hold rank r0 + i's
// coordinate at i.  P may have any Z; its T must be valid.  The [0..8]P
// table is built from P itself, in Niels form, into tab (the rank's
// column, laid out as above; on the host the four columns); [0..8]B
// comes from the constants.  High window first: four doublings (T on
// the last only), one Niels add from P's table, one affine add from B's
// (without T, since the next doubling never reads it).  A sign picks the
// operands and never branches around an add, so a warp whose lanes'
// signs differ makes each add once.  acc's T (rank 3) is stale on
// return.
FD_FN void g4_dsm_chain(fe *acc, const fe *p, const uint8_t *smag,
                        const uint8_t *ssgn, const uint8_t *kmag,
                        const uint8_t *ksgn, const vt_consts &c,
                        uint32_t *tab, int r0) {
  g4_niels_table(tab, p, c.d2, r0);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int q = r0 + i;
    fe_set(acc[i], q == 1 || q == 2);   // the identity (0, 1, 1, 0)
  }
  for (int w = 63; w >= 0; w--) {
    g4_double<false>(acc, r0);
    g4_double<false>(acc, r0);
    g4_double<false>(acc, r0);
    g4_double<true>(acc, r0);
    g4_add_niels(acc, r0, tab, kmag[w], ksgn[w]);
    g4_add_affine(acc, r0, c.base[smag[w]], ssgn[w]);
  }
}

// The strict tail's projective y-compare Q.Y == y_R Q.Z, on rank 2,
// which holds Z and takes Y from rank 1: ok[i] is rank r0 + i's answer,
// rank 2's the one that counts.
FD_FN void g4_y_compare(bool *ok, const fe *q, const fe &y_r, int r0) {
  fe got[G4_RANKS];
  int src[G4_RANKS];
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    const int r = r0 + i;
    src[i] = r == 2 ? 1 : r;
  }
  g4_shfl(got, q, src);
#pragma unroll
  for (int i = 0; i < G4_RANKS; i++) {
    fe t;
    fe_mul(t, y_r, q[i]);
    ok[i] = fe_eq(got[i], t);
  }
}
