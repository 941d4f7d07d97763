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
