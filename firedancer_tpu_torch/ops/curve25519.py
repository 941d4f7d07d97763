"""ed25519 curve arithmetic (twisted Edwards, a = -1) on torch tensors.

Counterpart of firedancer_tpu/ops/curve25519.py.  Points are extended
(X:Y:Z:T) NamedTuples of (10, batch) limb planes (ops/f25519.py).  The
double-scalar multiply is the TPU kernel's design (curve_pallas
_dsm_chain), not the XLA path's comb: one shared chain of 64 windows, each
four doublings, one add from a per-lane [0..8]A Niels table and one add
from the [0..8]B affine-Niels table, with signed 4-bit digits.  Only the
last doubling of a window computes T, and the base add that closes a
window skips it too, since the next doubling never reads T.  The CUDA
tail kernel (csrc/ge25519.cuh) runs the same formulas in the same order,
so the two produce equal X and Z, not merely the same projective point.

The RLC batch check adds the lane-parallel MSM (msm_lanes, the plain
version of csrc/msm.cu, which runs the same formulas in the same order:
each point's own chain, then a tree per lane), the tree fold over the
lanes as the JAX package folds them, and the fixed-base comb
scalar_mul_base.
"""

import functools
from typing import NamedTuple

import torch

from . import f25519 as fe
from . import scalar25519 as sc

P = fe.P
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = 2 * D % P
SQRT_M1 = fe.SQRT_M1

# order-8 subgroup y coordinates (ref fd_curve25519.h small-order table)
ORDER8_Y0 = int.from_bytes(bytes.fromhex(
    "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05"),
    "little") & ((1 << 255) - 1)
ORDER8_Y1 = int.from_bytes(bytes.fromhex(
    "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a"),
    "little") & ((1 << 255) - 1)

BASE_Y = 4 * pow(5, P - 2, P) % P
_u, _v = (BASE_Y * BASE_Y - 1) % P, (D * BASE_Y * BASE_Y + 1) % P
BASE_X = _u * pow(_v, 3, P) * pow(_u * pow(_v, 7, P), (P - 5) // 8, P) % P
if (_v * BASE_X * BASE_X - _u) % P:
    BASE_X = BASE_X * SQRT_M1 % P
if BASE_X & 1:
    BASE_X = P - BASE_X


class Point(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor


class Niels(NamedTuple):
    """(Y - X, Y + X, Z, 2dT): the unified add with the sums and the 2d
    product folded into the table entry."""

    Ym: torch.Tensor
    Yp: torch.Tensor
    Z: torch.Tensor
    T2d: torch.Tensor


def identity(batch: int, device) -> Point:
    z, one = fe.zeros(batch, device), fe.ones(batch, device)
    return Point(z, one, one, z)


def add(p: Point, q: Point) -> Point:
    """Unified addition (add-2008-hwcd-3), complete on the curve."""
    a = fe.mul(fe.sub(p.Y, p.X), fe.sub(q.Y, q.X))
    b = fe.mul(fe.add(p.Y, p.X), fe.add(q.Y, q.X))
    c = fe.mul(fe.mul(p.T, q.T), fe.const(D2, p.T.device, p.T.dim()))
    zz = fe.mul(p.Z, q.Z)
    return _finish(a, b, c, fe.add(zz, zz), True)


def _finish(a, b, c, d, want_t: bool, t_old=None) -> Point:
    e, f, g, h = fe.sub(b, a), fe.sub(d, c), fe.add(d, c), fe.add(b, a)
    return Point(fe.mul(e, f), fe.mul(g, h), fe.mul(f, g),
                 fe.mul(e, h) if want_t else t_old)


def double(p: Point, want_t: bool = True) -> Point:
    """dbl-2008-hwcd (every coordinate negated, the same projective
    point).  It never reads T, so want_t=False skips T's product."""
    xx, yy, zz = fe.sqr(p.X), fe.sqr(p.Y), fe.sqr(p.Z)
    zz2 = fe.add(zz, zz)
    xpy2 = fe.sqr(fe.add(p.X, p.Y))
    yp, ym = fe.add(yy, xx), fe.sub(yy, xx)
    ec, tc = fe.sub(xpy2, yp), fe.sub(zz2, ym)
    return Point(fe.mul(ec, tc), fe.mul(yp, ym), fe.mul(ym, tc),
                 fe.mul(ec, yp) if want_t else p.T)


def to_niels(p: Point) -> Niels:
    return Niels(fe.sub(p.Y, p.X), fe.add(p.Y, p.X), p.Z,
                 fe.mul(p.T, fe.const(D2, p.T.device, p.T.dim())))


def add_niels(p: Point, q: Niels) -> Point:
    a = fe.mul(fe.sub(p.Y, p.X), q.Ym)
    b = fe.mul(fe.add(p.Y, p.X), q.Yp)
    c = fe.mul(p.T, q.T2d)
    zz = fe.mul(p.Z, q.Z)
    return _finish(a, b, c, fe.add(zz, zz), True)


def add_affine_niels(p: Point, ym, yp, t2d, want_t: bool = True) -> Point:
    """p + q with q affine (Z = 1) in Niels form: no Z product."""
    a = fe.mul(fe.sub(p.Y, p.X), ym)
    b = fe.mul(fe.add(p.Y, p.X), yp)
    c = fe.mul(p.T, t2d)
    return _finish(a, b, c, fe.add(p.Z, p.Z), want_t, p.T)


def decompress(b):
    """Batch point decompression, b: uint8 (batch, 32).  Returns (ok,
    Point) with fd_ed25519_point_frombytes semantics: a non-canonical y
    is accepted mod p, and x = 0 with the sign bit set decompresses (the
    small-order test rejects it later).  Lanes with ok False hold an
    unspecified point."""
    y = fe.from_bytes(b)
    sign = (b[:, 31] >> 7).to(torch.int64)
    one = fe.ones(b.shape[0], b.device)
    yy = fe.sqr(y)
    u = fe.sub(yy, one)
    v = fe.add(fe.mul(yy, fe.const(D, b.device)), one)
    ok, x = fe.sqrt_ratio(u, v)
    x = torch.where(fe.sgn(x) != sign, fe.neg(x), x)
    return ok, Point(x, y, one, fe.mul(x, y))


def small_order_y(yc):
    """Canonical y in {0, y8_0, y8_1}: with x = 0 these are the affine
    points of order <= 8 (ref fd_ed25519_affine_is_small_order)."""
    out = (yc == 0).all(0)
    for v in (ORDER8_Y0, ORDER8_Y1):
        out = out | (yc == fe.const(v, yc.device)).all(0)
    return out


def is_small_order_affine(p: Point):
    """Order <= 8 test for affine (Z = 1) points: X == 0 or y small."""
    return fe.is_zero(p.X) | small_order_y(fe.canonical(p.Y))


def _pt_add_host(p, q):
    """Unified add on Python-int extended coordinates."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = (b - a) % P, (d - c) % P, (d + c) % P, (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def base_table_ints(base=None):
    """[0..8]B in affine Niels form as Python ints: rows (y - x, y + x,
    2dxy, -2dxy), the negated product precomputed so a negative digit
    costs a swap and a pick.  base, extended coordinates, replaces B."""
    rows = [(1, 1, 0, 0)]
    if base is None:
        base = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)
    pt = base
    for _ in range(8):
        x, y, z, _ = pt
        zi = pow(z, P - 2, P)
        x, y = x * zi % P, y * zi % P
        t2d = x * y * D2 % P
        rows.append(((y - x) % P, (y + x) % P, t2d, (P - t2d) % P))
        pt = _pt_add_host(pt, base)
    return rows


def base_table(device) -> torch.Tensor:
    """base_table_ints as a (9, 4, 10) limb tensor."""
    return torch.tensor([[fe.int_to_limbs(v) for v in row]
                         for row in base_table_ints()],
                        dtype=torch.int64, device=device)


def _pick(tab, idx):
    """tab (9, F, 10, batch) or (9, F, 10); idx (batch,) -> (F, 10, batch)."""
    if tab.dim() == 3:
        return tab[idx].permute(1, 2, 0)
    g = idx.reshape(1, 1, 1, -1).expand(1, *tab.shape[1:])
    return tab.gather(0, g)[0]


def niels_table(p: Point, n: int) -> torch.Tensor:
    """[0..n-1]P in Niels form as an (n, 4, 10, batch) tensor: entry 0
    the identity, entry 1 P itself, then repeated unified adds of P (the
    TPU kernels' table; the XLA path's scan reaches the same points
    through other coordinates)."""
    pts = [identity(p.X.shape[1], p.X.device), p]
    for _ in range(n - 2):
        pts.append(add(pts[-1], p))
    return torch.stack([torch.stack(list(to_niels(q))) for q in pts])


def _add_signed(acc: Point, tab, mag, sgn) -> Point:
    """acc + (-1)^sgn [mag]P from P's Niels table: a negative digit swaps
    Y - X with Y + X and negates 2dT."""
    ym, yp, z, t2d = _pick(tab, mag)
    neg = sgn == 1
    return add_niels(acc, Niels(torch.where(neg, yp, ym),
                                torch.where(neg, ym, yp), z,
                                torch.where(neg, fe.neg(t2d), t2d)))


def double_scalar_mul_base(s_mag, s_sgn, k_mag, k_sgn, a: Point) -> Point:
    """[s]B + [k]A over signed 4-bit windows (mag 0..8, sgn 0/1; each
    (64, batch)), high window first.  T of the result is stale."""
    batch, dev = a.X.shape[1], a.X.device
    tab_a = niels_table(a, 9)
    tab_b = base_table(dev)
    acc = identity(batch, dev)
    for w in range(63, -1, -1):
        for j in range(4):
            acc = double(acc, want_t=(j == 3))
        acc = _add_signed(acc, tab_a, k_mag[w], k_sgn[w])
        bym, byp, bt2d, bnt2d = _pick(tab_b, s_mag[w])
        neg_s = s_sgn[w] == 1
        acc = add_affine_niels(acc, torch.where(neg_s, byp, bym),
                               torch.where(neg_s, bym, byp),
                               torch.where(neg_s, bnt2d, bt2d),
                               want_t=False)
    return acc


def double_scalar_mul_halved(u_windows, v_windows, p: Point, q: Point,
                             nwin: int = 32) -> Point:
    """[u]P + [v]Q over nwin shared unsigned 4-bit windows (nwin, batch),
    low first: the antipa halved-scalar chain (ref curve25519
    double_scalar_mul_halved), 4 nwin doublings and two Niels adds a
    window from [0..15]P and [0..15]Q tables.  The plain version of the
    antipa_tail kernel's chain, which groups the same sum otherwise."""
    p_tab, q_tab = niels_table(p, 16), niels_table(q, 16)
    acc = identity(p.X.shape[1], p.X.device)
    for w in range(nwin - 1, -1, -1):
        for j in range(4):
            acc = double(acc, want_t=(j == 3))
        acc = add_niels(acc, Niels(*_pick(p_tab, u_windows[w].long())))
        acc = add_niels(acc, Niels(*_pick(q_tab, v_windows[w].long())))
    return acc


# ------------------------------------------------ the RLC batch check


def neg(p: Point) -> Point:
    return Point(fe.neg(p.X), p.Y, p.Z, fe.neg(p.T))


def is_identity(p: Point):
    """Projective p == (0 : 1 : 1): X = 0 and Y = Z."""
    return fe.is_zero(p.X) & fe.eq(p.Y, p.Z)


def _affine_host(p):
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P, 1, x * zi * y * zi % P)


@functools.lru_cache(maxsize=None)
def base_window_tables(device) -> torch.Tensor:
    """[i * 16^w]B for the fixed-base comb, in affine Niels form (y - x,
    y + x, 2dxy): a (64, 16, 3, 10) limb tensor (ref curve25519.py
    _base_window_tables)."""
    rows = []
    cur = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)
    for _ in range(64):
        acc, row = (0, 1, 1, 0), []
        for i in range(16):
            x, y, _, t = _affine_host(acc) if i else acc
            row.append([fe.int_to_limbs(v) for v in
                        ((y - x) % P, (y + x) % P, t * D2 % P)])
            acc = _pt_add_host(acc, cur)
        rows.append(row)
        for _ in range(4):
            cur = _pt_add_host(cur, cur)
        cur = _affine_host(cur)
    return torch.tensor(rows, dtype=torch.int64, device=device)


def scalar_mul_base(windows) -> Point:
    """[s]B by the fixed-base comb: windows (64, batch) of unsigned 4-bit
    digits, low first; the sum over w of [s_w * 16^w]B, one affine Niels
    add per window and no doublings."""
    batch, dev = windows.shape[1], windows.device
    tabs = base_window_tables(dev)
    acc = identity(batch, dev)
    for w in range(64):
        ym, yp, t2d = _pick(tabs[w], windows[w])
        acc = add_affine_niels(acc, ym, yp, t2d)
    return acc


def msm_lanes(windows, points: Point, m: int, nwin: int,
              select: str) -> Point:
    """The per-lane half of the lane-parallel MSM (the plain version of
    csrc/msm.cu, in its order).  windows (nwin, n) unsigned 4-bit digits
    of any integer dtype, low first; points (10, n) planes; lanes = n / m.
    Every point's own chain [s_i]P_i, all n at once: per window, high
    first, four doublings and one Niels add.  select "legacy" picks from
    [0..15]P tables; "p16" recodes to signed digits over nwin + 1 windows
    and picks from [0..8]P tables.  Then lane l sums its points j * lanes
    + l (j < m) by fold_lanes' tree over j.  Returns the (10, lanes)
    accumulators."""
    n = windows.shape[1]
    windows = windows.long()
    if select == "p16":
        mags, sgns = sc.signed_windows_ext(windows)
        ntab = 9
    else:
        mags, sgns, ntab = windows, None, 16
    tab = niels_table(points, ntab)
    acc = identity(n, windows.device)
    for w in range(mags.shape[0] - 1, -1, -1):
        for k in range(4):
            acc = double(acc, want_t=(k == 3))
        if sgns is None:
            acc = add_niels(acc, Niels(*_pick(tab, mags[w])))
        else:
            acc = _add_signed(acc, tab, mags[w], sgns[w])
    return fold_lanes(acc, n // m)


def fold_lanes(acc: Point, width: int = 1) -> Point:
    """Tree-fold (10, k * width) points, as k blocks of width columns, to
    one block, (10, width), as the JAX package folds its lanes: the low
    half of the blocks plus the high half, an odd last block carried into
    the next level.  width 1 folds every lane to one (10, 1) point."""
    while acc.X.shape[1] > width:
        k = acc.X.shape[1] // width
        half = k // 2 * width
        s = add(Point(*(t[:, :half] for t in acc)),
                Point(*(t[:, half:2 * half] for t in acc)))
        if k % 2:
            s = Point(*(torch.cat([ts, ta[:, 2 * half:]], 1)
                        for ts, ta in zip(s, acc)))
        acc = s
    return acc
