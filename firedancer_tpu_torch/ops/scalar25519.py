"""Arithmetic mod L (the ed25519 group order) on torch tensors.

Counterpart of firedancer_tpu/ops/scalar25519.py, same algorithm: radix
2^12 limbs, limb axis first, folding x = hi * 2^252 + lo into lo - C * hi
(L = 2^252 + C) until the value is below 2^253, then adding 2L and
subtracting L while it is not below L.  Limbs are int64 here, so no
product or column sum comes near overflow.  The CUDA tail kernel
(csrc/verify_tail.cu) transcribes the same steps.  The RLC scalar chain
(mul_mod_l, sum_mod_l and the extended signed recode) runs here in
torch, as it runs in XLA in the JAX package.
"""

import torch

from .f25519 import _byte_bits, pack_bits

B = 12
MASK = (1 << B) - 1
L = 2**252 + 27742317777372353535851937790883648493
C = L - 2**252

_C_LIMBS = [(C >> (B * i)) & MASK for i in range(11)]
_L_LIMBS = [(L >> (B * i)) & MASK for i in range(22)]
_L2_LIMBS = [(2 * L >> (B * i)) & MASK for i in range(22)]


def bytes_to_limbs(b, nlimb: int):
    """uint8 (*batch, nbytes) -> int64 limbs (nlimb, *batch), little-endian."""
    return pack_bits(_byte_bits(b), [B * i for i in range(nlimb)],
                     [B] * nlimb)


def _carry_signed(x, passes: int):
    """Parallel signed carry passes; the top limbs are headroom."""
    for _ in range(passes):
        hi = x >> B
        x = (x & MASK) + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])
    return x


def _fold_once(x):
    """x (n >= 22 limbs) -> lo(21 limbs) - C * hi, with 2 headroom limbs."""
    m = x.shape[0] - 21
    out = torch.zeros((max(21, m + 11) + 2,) + x.shape[1:],
                      dtype=x.dtype, device=x.device)
    out[:21] = x[:21]
    for i, c in enumerate(_C_LIMBS):
        out[i:i + m] -= c * x[21:]
    return out


def _cond_sub_l(x, times: int):
    """Serial exact carry, then `times` conditional subtractions of L.
    x: (n >= 22, *batch) signed limbs of a value in [0, 2^264)."""
    rows = list(x.unbind(0))
    for i in range(len(rows) - 1):
        rows[i + 1] = rows[i + 1] + (rows[i] >> B)
        rows[i] = rows[i] & MASK
    rows = rows[:22]
    for _ in range(times):
        borrow = torch.zeros_like(rows[0])
        diff = []
        for i in range(22):
            t = rows[i] + (1 << B) - _L_LIMBS[i] - borrow
            diff.append(t & MASK)
            borrow = 1 - (t >> B)
        ge = borrow == 0
        rows = [torch.where(ge, d, r) for d, r in zip(diff, rows)]
    return torch.stack(rows)


def _l2(x):
    return torch.tensor(_L2_LIMBS, dtype=x.dtype, device=x.device).reshape(
        (22,) + (1,) * (x.dim() - 1))


def reduce_512(digest_bytes):
    """SHA-512 digest (little-endian) mod L: uint8 (*batch, 64) -> int64
    limbs (22, *batch) canonical in [0, L) (ref
    fd_curve25519_scalar_reduce)."""
    x = bytes_to_limbs(digest_bytes, 44)
    for _ in range(3):
        x = _carry_signed(_fold_once(x), 2)
    x = torch.cat([x[:22] + _l2(x), x[22:]])
    return _cond_sub_l(_carry_signed(x, 3), times=4)


def is_canonical(scalar_bytes):
    """s < L (ref fd_curve25519_scalar_validate): uint8 (*batch, 32) ->
    bool (*batch)."""
    x = bytes_to_limbs(scalar_bytes, 22)
    borrow = torch.zeros_like(x[0])
    for i in range(22):
        t = x[i] + (1 << B) - _L_LIMBS[i] - borrow
        borrow = 1 - (t >> B)
    return borrow == 1


def mul_mod_l(a, b):
    """Products mod L: a (22, *batch) and b (nb <= 22, *batch) canonical
    limbs -> canonical (22, *batch).  A 22 x nb convolution, then the
    reduce_512 folds until 23 limbs remain."""
    nb = b.shape[0]
    x = torch.zeros((22 + nb,) + a.shape[1:], dtype=torch.int64,
                    device=a.device)
    for i in range(nb):
        x[i:i + 22] += b[i] * a
    x = _carry_signed(x, 3)
    while x.shape[0] > 23:
        x = _carry_signed(_fold_once(x), 2)
    x = _carry_signed(_fold_once(x), 2)
    x = torch.cat([x[:22] + _l2(x), x[22:]])
    return _cond_sub_l(_carry_signed(x, 3), times=4)


def sum_mod_l(limbs, axis: int):
    """Sum canonical (22, *batch) limb vectors over batch axis `axis`
    (counted after the limb axis), mod L.  A tree of halvings, the odd
    element carried into the next level, with a carry pass every eight
    levels, as the JAX package sums."""
    ax = axis + 1
    x = limbs
    steps = 0
    while x.shape[ax] > 1:
        n = x.shape[ax]
        half = n // 2
        s = x.narrow(ax, 0, half) + x.narrow(ax, half, half)
        if n % 2:
            s = torch.cat([s, x.narrow(ax, 2 * half, 1)], ax)
        x = s
        steps += 1
        if steps % 8 == 0:
            x = _carry_signed(x, 2)
    x = x.squeeze(ax)
    x = _carry_signed(torch.cat([x, torch.zeros_like(x[:2])]), 3)
    x = _carry_signed(_fold_once(x), 2)
    x = torch.cat([x[:22] + _l2(x), x[22:]])
    return _cond_sub_l(_carry_signed(x, 3), times=4)


def limbs_to_windows(limbs):
    """(22, *batch) 12-bit limbs -> (64, *batch) 4-bit windows, low first."""
    j = torch.arange(64, device=limbs.device)
    sh = (4 * (j % 3)).reshape((64,) + (1,) * (limbs.dim() - 1))
    return (limbs[j // 3] >> sh) & 0xF


def scalar_windows(scalar_bytes):
    """Little-endian 32-byte scalars -> (64, *batch) 4-bit windows."""
    return limbs_to_windows(bytes_to_limbs(scalar_bytes, 22))


def signed_windows(w):
    """(64, *batch) digits 0..15 -> (mag 0..8, sgn 0/1), value-preserving
    (ref curve_pallas.signed_windows): a carry ripples low to high.  Both
    ed25519 scalars are < 2^253, so the top window never overflows; a
    non-canonical S may, and then its lane is rejected anyway."""
    mags, sgns = [], []
    carry = torch.zeros_like(w[0])
    for i in range(w.shape[0]):
        d = w[i] + carry
        over = d > 8
        mags.append(torch.where(over, 16 - d, d))
        sgns.append(over.to(w.dtype))
        carry = over.to(w.dtype)
    return torch.stack(mags), torch.stack(sgns)


def signed_windows_ext(w):
    """signed_windows with the carry out of the top window appended as
    one more window: (nwin, *batch) -> (nwin + 1, *batch) each (ref
    curve_pallas.signed_windows_ext).  Value-preserving for any scalar
    width: the RLC z scalars fill all 32 windows of their 128 bits, so
    their top window can carry out, which signed_windows would drop."""
    mags, sgns = signed_windows(w)
    # a window recoded negative is exactly one that carries out
    return (torch.cat([mags, sgns[-1:]]),
            torch.cat([sgns, torch.zeros_like(sgns[-1:])]))


def to_int(limbs) -> int:
    """One (22,) limb vector -> Python int mod L."""
    return sum(int(v) << (B * i) for i, v in enumerate(limbs.tolist())) % L


# ------------------------------------------------------- antipa halving
# k -> (u, v) with u == v k (mod L) and u, |v| < 2^128, for the halved
# verify chain (ed25519.verify_batch_antipa), as the JAX package's
# scalar25519.halve_scalar computes it, step for step: DIVSTEP_ITERS
# Bernstein-Yang divsteps on (f, g) = (L, 2^DIVSTEP_ITERS k mod L),
# tracking the k-coefficients (bf, bg) of each row, so that after exactly
# DIVSTEP_ITERS steps f == bf k and g == bg k (mod L); then
# LAGRANGE_ITERS rounds of binary Lagrange reduction on the two vectors
# (f, bf) and (g, bg) under the sup norm; then the shorter vector, with
# u made non-negative.  The pair is the divstep model's exactly, not just
# any valid pair: antipa accepts a torsion forgery when the torsion's
# order divides v, so v's 2-adic valuation decides bits.  Values ride
# signed limb planes; f and g run without carries (the shift by one is
# exact on redundant limbs of an even value), bf and bg get one carry
# pass a step.  This is the plain version of the scalar half of the
# antipa_tail kernel (csrc/sc25519.cuh sc_halve).

DIVSTEP_ITERS = 250
LAGRANGE_ITERS = 24

_PRE_LIMBS = [(pow(2, DIVSTEP_ITERS, L) >> (B * i)) & MASK for i in range(22)]


def _canon_signed(x):
    """Serial exact carry: limbs 0 .. n - 2 in [0, 2^B), the top limb
    signed.  Value-preserving."""
    rows = list(x.unbind(0))
    for i in range(len(rows) - 1):
        rows[i + 1] = rows[i + 1] + (rows[i] >> B)
        rows[i] = rows[i] & MASK
    return torch.stack(rows)


def _shr1(x):
    """Exact value / 2 of an even-valued redundant signed limb plane."""
    up = torch.cat([(x & 1)[1:], torch.zeros_like(x[:1])])
    return (x >> 1) + up * (1 << (B - 1))


def _abs_cs(x):
    """Canonical-signed plane -> (|x| canonical, negative flag)."""
    neg = x[-1] < 0
    return torch.where(neg, _canon_signed(-x), x), neg


def _lt_nn(a, b):
    """a < b for non-negative canonical planes."""
    return _canon_signed(a - b)[-1] < 0


_BLEN_STEPS = 14   # bits a limb's length is read to (the top limb may
                   # hold a few more than B after a shift)


def _blen_nn(a):
    """Bit length of a non-negative canonical plane."""
    thr = torch.tensor([(1 << s) - 1 for s in range(_BLEN_STEPS)],
                       dtype=a.dtype, device=a.device).reshape(
                           (_BLEN_STEPS,) + (1,) * a.dim())
    bl = (a.unsqueeze(0) > thr).sum(0)
    out = torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        out = torch.where(a[i] > 0, B * i + bl[i], out)
    return out


def _shl_cs(x, t):
    """Canonical-signed plane times 2^t, t (*batch) in [0, 31]: limb
    rolls for the multiples of B (the dropped top limb is zero: the
    caller shifts the shorter vector no further than the longer one's bit
    length), then a per-limb multiply for the rest."""
    for _ in range(2):
        c = t >= B
        top = x[-2] + x[-1] * (1 << B)
        rolled = torch.cat([torch.zeros_like(x[:1]), x[:-2], top[None]])
        x = torch.where(c, rolled, x)
        t = t - torch.where(c, B, 0)
    for s in (8, 4, 2, 1):
        x = torch.where((t & s) != 0, x * (1 << s), x)
    return x


def _pairmax_nn(a, b):
    return torch.where(_lt_nn(a, b), b, a)


def _carry_keep_top(x):
    """One signed carry pass that leaves the top limb unsplit: it absorbs
    the carry from below, so a negative value keeps its sign."""
    lo = torch.cat([x[:-1] & MASK, x[-1:]])
    hi = x >> B
    return lo + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])


def _divstep_body(f, g, bf, bg, delta):
    odd = g[0] & 1
    swap = (delta > 0) & (odd == 1)
    delta = torch.where(swap, 1 - delta, 1 + delta)
    f_n = torch.where(swap, g, f)
    g_n = _shr1(torch.where(swap, g - f, g + odd * f))
    bf_n = _carry_keep_top(torch.where(swap, 2 * bg, 2 * bf))
    bg_n = _carry_keep_top(torch.where(swap, bg - bf, bg + odd * bf))
    return f_n, g_n, bf_n, bg_n, delta


def _norm(a, b):
    """The sup norm max(|a|, |b|) of a vector of canonical-signed planes."""
    return _pairmax_nn(_abs_cs(a)[0], _abs_cs(b)[0])


def _lagrange_body(f, bf, g, bg):
    nf, ng = _norm(f, bf), _norm(g, bg)
    swap = _lt_nn(nf, ng)
    f, g = torch.where(swap, g, f), torch.where(swap, f, g)
    bf, bg = torch.where(swap, bg, bf), torch.where(swap, bf, bg)
    nf, ng = torch.where(swap, ng, nf), torch.where(swap, nf, ng)
    t = (_blen_nn(nf) - _blen_nn(ng)).clamp(0, 31)
    sg, sbg = _shl_cs(g, t), _shl_cs(bg, t)
    p, pb = _canon_signed(f - sg), _canon_signed(bf - sbg)
    m, mb = _canon_signed(f + sg), _canon_signed(bf + sbg)
    np_, nm = _norm(p, pb), _norm(m, mb)
    use_m = _lt_nn(nm, np_)
    c, cb = torch.where(use_m, m, p), torch.where(use_m, mb, pb)
    better = _lt_nn(torch.where(use_m, nm, np_), nf)
    return torch.where(better, c, f), torch.where(better, cb, bf), g, bg


def halve_scalar(k_limbs):
    """k (22, *batch) canonical limbs in [0, L) -> (u, |v|, v >= 0): u and
    |v| canonical (22, *batch) limbs with u == v k (mod L), u >= 0 and,
    as measured, u, |v| < 2^128; k = 0 gives (0, 1)."""
    batch = k_limbs.shape[1:]
    dev = k_limbs.device
    pre = torch.tensor(_PRE_LIMBS, dtype=torch.int64, device=dev).reshape(
        (22,) + (1,) * len(batch))
    g = mul_mod_l(k_limbs.long(), pre.expand((22,) + tuple(batch)))
    f = torch.tensor(_L_LIMBS, dtype=torch.int64, device=dev).reshape(
        (22,) + (1,) * len(batch)).expand_as(g).clone()
    bf = torch.zeros_like(g)
    bg = torch.zeros_like(g)
    bg[0] = 1
    delta = torch.ones(batch, dtype=torch.int64, device=dev)
    for _ in range(DIVSTEP_ITERS):
        f, g, bf, bg, delta = _divstep_body(f, g, bf, bg, delta)
    f, g, bf, bg = (_canon_signed(x) for x in (f, g, bf, bg))
    for _ in range(LAGRANGE_ITERS):
        f, bf, g, bg = _lagrange_body(f, bf, g, bg)
    take_g = _lt_nn(_norm(g, bg), _norm(f, bf))
    u = torch.where(take_g, g, f)
    v = torch.where(take_g, bg, bf)
    au, u_neg = _abs_cs(u)
    v = torch.where(u_neg, _canon_signed(-v), v)
    av, v_neg = _abs_cs(v)
    return au, av, ~v_neg


def neg_mod_l(x):
    """(L - x) mod L for canonical (22, *batch) limbs of x in [0, L)."""
    y = _l2(x) - x
    return _cond_sub_l(torch.cat([y, torch.zeros_like(y[:2])]), times=2)
