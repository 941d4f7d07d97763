"""GF(2^255-19) arithmetic on torch tensors (the plain half of the port).

Counterpart of firedancer_tpu/ops/f25519.py.  A field element is a
``(10, *batch)`` int64 tensor of limbs in the mixed 26/25-bit radix of
the reference's portable fd_f25519 (ref10): limb i holds bits
``OFFS[i] .. OFFS[i] + WIDTHS[i]`` with widths 26, 25, 26, 25, ...  The
limb axis comes first, as in the JAX package, so a batch of elements is
a set of limb planes.  The CUDA kernels (csrc/fe25519.cuh) keep the same
radix in uint32 registers and write their results in this layout.

Magnitudes.  Every function returns TIGHT limbs: even limbs below
2^26 + 64, odd limbs below 2^25 + 64 (value below 2^255 + 2^32), all
non-negative.  ``mul`` accepts tight inputs: a column sums ten products
of at most (2^26 + 64)^2 * 38 < 2^57.3, so it stays below 2^61 in int64.
``sub`` adds 2p limb by limb before subtracting, which keeps every limb
non-negative for tight subtrahends.
"""

import functools

import torch

P = 2**255 - 19
NLIMB = 10
WIDTHS = tuple(26 if i % 2 == 0 else 25 for i in range(NLIMB))
OFFS = tuple(sum(WIDTHS[:i]) for i in range(NLIMB))
SQRT_M1 = pow(2, (P - 1) // 4, P)


def int_to_limbs(v: int) -> list[int]:
    """Python int (reduced mod p) -> the 10 radix limbs."""
    v %= P
    return [(v >> o) & ((1 << w) - 1) for o, w in zip(OFFS, WIDTHS)]


def limbs_to_int(limbs) -> int:
    """The 10 limbs of one element (any magnitudes) -> value mod p."""
    return sum(int(x) << o for x, o in zip(limbs, OFFS)) % P


@functools.lru_cache(maxsize=None)
def _layout(device: torch.device):
    """Per-device shift/mask/fold vectors and the product tables of mul."""
    w = torch.tensor(WIDTHS, dtype=torch.int64, device=device)[:, None]
    mask = (1 << w) - 1
    fold = torch.tensor([19] + [1] * (NLIMB - 1), dtype=torch.int64,
                        device=device)[:, None]
    # mul: column k sums a[i] * b[(k - i) % 10] * factor[i, k]; the factor
    # doubles odd*odd products (two half-bit offsets) and folds columns
    # past limb 9 with 2^255 = 19 (mod p)
    j = [[(k - i) % NLIMB for k in range(NLIMB)] for i in range(NLIMB)]
    fac = [[(2 if i % 2 and j[i][k] % 2 else 1)
            * (19 if i + j[i][k] >= NLIMB else 1)
            for k in range(NLIMB)] for i in range(NLIMB)]
    jidx = torch.tensor(j, dtype=torch.int64, device=device)
    factor = torch.tensor(fac, dtype=torch.int64, device=device)
    two_p = torch.tensor([2 * x for x in _P_LIMBS], dtype=torch.int64,
                         device=device)[:, None]
    return w, mask, fold, jidx, factor, two_p


_P_LIMBS = [(P >> o) & ((1 << w) - 1) for o, w in zip(OFFS, WIDTHS)]


def _shape(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(10, 1) per-limb vector -> broadcastable against x (10, *batch)."""
    return t.reshape((NLIMB,) + (1,) * (x.dim() - 1))


def _carry(h: torch.Tensor, passes: int) -> torch.Tensor:
    """Parallel carry passes: every limb sheds its high bits into the next
    limb at once, limb 9's carry wraps into limb 0 times 19."""
    w, mask, fold = (_shape(h, t) for t in _layout(h.device)[:3])
    for _ in range(passes):
        h = (h & mask) + torch.roll(h >> w, 1, 0) * fold
    return h


@functools.lru_cache(maxsize=None)
def const(v: int, device, ndim: int = 2) -> torch.Tensor:
    """Field constant as a (10, 1, ...) tensor broadcastable over a batch.
    Cached per device and never written: a copy from pageable host memory
    waits for the stream, so building it on every call would stall the
    host inside each dispatch."""
    return torch.tensor(int_to_limbs(v), dtype=torch.int64,
                        device=device).reshape((NLIMB,) + (1,) * (ndim - 1))


def zeros(batch: int, device) -> torch.Tensor:
    return torch.zeros((NLIMB, batch), dtype=torch.int64, device=device)


def ones(batch: int, device) -> torch.Tensor:
    out = zeros(batch, device)
    out[0] = 1
    return out


def add(a, b):
    return _carry(a + b, 1)


def sub(a, b):
    """a - b + 2p: b's tight limbs never exceed 2p's, so no limb goes
    negative."""
    return _carry(a + _shape(a, _layout(a.device)[5]) - b, 1)


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    _, _, _, jidx, factor, _ = _layout(a.device)
    extra = (1,) * (a.dim() - 1)
    prod = a.unsqueeze(1) * b[jidx] * factor.reshape(factor.shape + extra)
    return _carry(prod.sum(0), 3)


def sqr(a):
    return mul(a, a)


def _sqr_n(a, n: int):
    for _ in range(n):
        a = sqr(a)
    return a


def _pow_2_250_1(z):
    """(z^(2^250 - 1), z^11): the ref10 addition chain shared by the
    inversion and the square-root exponents."""
    z2 = sqr(z)
    z9 = mul(_sqr_n(z2, 2), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sqr(z11), z9)                        # 2^5 - 1
    z_10_0 = mul(_sqr_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(_sqr_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(_sqr_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(_sqr_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(_sqr_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(_sqr_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(_sqr_n(z_200_0, 50), z_50_0)
    return z_250_0, z11


def pow22523(z):
    """z^((p - 5) / 8) = z^(2^252 - 3) (ref fd_f25519_pow22523)."""
    z_250_0, _ = _pow_2_250_1(z)
    return mul(_sqr_n(z_250_0, 2), z)


def inv(z):
    """z^(p - 2); inv(0) = 0."""
    z_250_0, z11 = _pow_2_250_1(z)
    return mul(_sqr_n(z_250_0, 5), z11)


def batch_inv(a, stop: int = 128):
    """Montgomery batch inversion over the last axis, tree-shaped as in the
    JAX package: pair products up to `stop` lanes, one pow chain there,
    pair unwinds down.  a: (10, n), every lane nonzero (callers mask)."""
    n = a.shape[-1]
    if n <= stop:
        return inv(a)
    levels = []
    cur = a
    while cur.shape[-1] > stop:
        if cur.shape[-1] % 2:
            pad = torch.zeros_like(cur[:, :1])
            pad[0] = 1
            cur = torch.cat([cur, pad], dim=-1)
        levels.append(cur)
        cur = mul(cur[:, 0::2], cur[:, 1::2])
    down = inv(cur)
    for lvl in levels[::-1]:
        down = down[:, : lvl.shape[-1] // 2]
        pair = torch.stack([mul(down, lvl[:, 1::2]), mul(down, lvl[:, 0::2])],
                           dim=-1)
        down = pair.reshape(NLIMB, lvl.shape[-1])
    return down[:, :n]


def sqrt_ratio(u, v):
    """(ok, x) with x = sqrt(u / v) when u / v is a square (RFC 8032
    5.1.3); for a non-square ratio ok is False and x is unspecified."""
    v2 = sqr(v)
    v3 = mul(v2, v)
    v7 = mul(sqr(v2), v3)
    x = mul(mul(u, v3), pow22523(mul(u, v7)))
    vxx = mul(sqr(x), v)
    good = eq(vxx, u)
    flipped = eq(vxx, neg(u))
    x = torch.where(flipped, mul(x, const(SQRT_M1, x.device, x.dim())), x)
    return good | flipped, x


def canonical(a):
    """The unique representative in [0, p), limbs exactly in range."""
    w = list(WIDTHS)
    rows = list(a.unbind(0))
    for _ in range(2):                               # wrap carries
        for i in range(NLIMB):
            c = rows[i] >> w[i]
            rows[i] = rows[i] & ((1 << w[i]) - 1)
            if i + 1 < NLIMB:
                rows[i + 1] = rows[i + 1] + c
            else:
                rows[0] = rows[0] + 19 * c
    for i in range(NLIMB - 1):                       # limb 0's last bump
        c = rows[i] >> w[i]
        rows[i] = rows[i] & ((1 << w[i]) - 1)
        rows[i + 1] = rows[i + 1] + c
    # value v < 2^255 + 2^26 now; v >= p iff v + 19 carries out of bit 255,
    # and then v - p is v + 19 with that carry dropped
    t = [r.clone() for r in rows]
    t[0] = t[0] + 19
    for i in range(NLIMB - 1):
        t[i + 1] = t[i + 1] + (t[i] >> w[i])
        t[i] = t[i] & ((1 << w[i]) - 1)
    ge = (t[NLIMB - 1] >> w[NLIMB - 1]) > 0
    t[NLIMB - 1] = t[NLIMB - 1] & ((1 << w[NLIMB - 1]) - 1)
    return torch.where(ge, torch.stack(t), torch.stack(rows))


def eq(a, b):
    return (canonical(a) == canonical(b)).all(0)


def is_zero(a):
    return (canonical(a) == 0).all(0)


def sgn(a):
    """Low bit of the canonical representative (ref fd_f25519_sgn)."""
    return canonical(a)[0] & 1


def _byte_bits(b: torch.Tensor) -> torch.Tensor:
    """uint8 (*batch, n) -> int64 bits (8n, *batch), least significant
    first."""
    sh = torch.arange(8, device=b.device)
    bits = (b.to(torch.int64).unsqueeze(-1) >> sh) & 1
    return bits.reshape(*b.shape[:-1], -1).movedim(-1, 0)


@functools.lru_cache(maxsize=None)
def _gather_idx(offs, widths, nb: int, device) -> torch.Tensor:
    """pack_bits' gather index, cached per device as const is."""
    wmax = max(widths)
    return torch.tensor([[o + k if k < w and o + k < nb else nb
                          for k in range(wmax)]
                         for o, w in zip(offs, widths)], device=device)


def pack_bits(bits: torch.Tensor, offs, widths) -> torch.Tensor:
    """(nbits, *batch) bits -> limbs (len(offs), *batch); limb i gathers
    bits offs[i] .. offs[i] + widths[i] (bits past the end read 0)."""
    nb = bits.shape[0]
    wmax = max(widths)
    padded = torch.cat([bits, torch.zeros_like(bits[:1])], 0)
    sel = padded[_gather_idx(tuple(offs), tuple(widths), nb, bits.device)]
    sh = torch.arange(wmax, device=bits.device).reshape(
        (1, wmax) + (1,) * (bits.dim() - 1))
    return (sel << sh).sum(1)


def from_bytes(b):
    """Little-endian 32 bytes -> limbs.  b: uint8 (*batch, 32), any row
    stride.  Bit 255 (the compression sign) is dropped; values >= p are
    accepted, as fd_f25519_frombytes does."""
    return pack_bits(_byte_bits(b), OFFS, WIDTHS)


def to_bytes(a):
    """Canonical little-endian encoding -> uint8 (*batch, 32)."""
    c = canonical(a)
    limb = [i for i in range(NLIMB) for _ in range(WIDTHS[i])] + [0]
    shift = [k for i in range(NLIMB) for k in range(WIDTHS[i])] + [63]
    bits = (c[torch.tensor(limb, device=a.device)]
            >> torch.tensor(shift, device=a.device).reshape(
                (256,) + (1,) * (a.dim() - 1))) & 1
    by = (bits.reshape((32, 8) + bits.shape[1:])
          << torch.arange(8, device=a.device).reshape(
              (1, 8) + (1,) * (a.dim() - 1))).sum(1)
    return by.movedim(0, -1).to(torch.uint8)


def from_ints(vals, device) -> torch.Tensor:
    """Python ints -> (10, len(vals)) limbs."""
    return torch.tensor([int_to_limbs(v) for v in vals], dtype=torch.int64,
                        device=device).T.contiguous()


def to_ints(a) -> list[int]:
    """(10, n) limbs -> canonical Python ints."""
    cols = a.detach().cpu().T.tolist()
    return [limbs_to_int(c) for c in cols]
