"""Batched strict ed25519 verification on torch tensors.

Counterpart of firedancer_tpu/ops/ed25519.py: the same acceptance rules
(fd_ed25519_verify, Agave's verify_strict):

  1. S canonical: 0 <= S < L
  2. A and R decode per RFC 8032; a non-canonical y is accepted mod p
  3. A or R of small order (<= 8) is rejected
  4. k = SHA-512(R || A || M) mod L
  5. accept iff [S]B + [k](-A) == R (projective, no cofactor)

verify_batch and verify_blob take tail=, one of three layouts of the
same steps, as in the JAX package (which picks between them by
FDTPU_NO_FUSED and whether its Pallas kernels run); all give the same
bits.  Each starts with sha512_kernel.sha512_ram, k's digest straight from
the rows, and ends with the r_check kernel (ops/r_check.py), which
settles R from its bytes without decompressing it: Q's affine x by a
per-lane inverse, its parity against R's sign bit, R's small-order test.
Between them:

  "fused" (the default)  verify_tail.verify_tail: everything about A, S
                         and k and the y half of the R comparison, one
                         kernel;
  "split"                the decompress kernel for A, reduce_recode (S < L,
                         k mod L, the signed windows) and dsm_tail_q (the
                         chain and the y-compare): three kernels;
  "unfused"              the decompress kernel, S < L, k mod L and the
                         windows in torch, then the double_scalar_mul_base
                         kernel; the y-compare runs in r_check.

On a CUDA tensor the kernels launch; on a CPU tensor their plain versions
run.

verify_batch_rlc is the random-linear-combination batch check (one bit
for a whole batch): one decompress launch for A and R, the same SHA-512
kernel, the rlc_recode kernel for the per-signature scalars, the msm
kernel for the two multi-scalar sums, and a torch finish (the sum of the
z s products, the lane folds, the comb [c]B and the identity test).

The host helpers at the bottom (signing, a Python-int verifier) are this
package's own copies; it imports nothing of the JAX package.
"""

import hashlib

import torch

from . import curve25519 as cv
from . import f25519 as fe
from . import scalar25519 as sc
from .decompress import decompress, decompress_pair
from .dsm import double_scalar_mul_base, dsm_tail_q
from .msm import msm
from .r_check import r_check
from .reduce_recode import reduce_recode
from .rlc_recode import rlc_recode
from .scalar25519 import L
from .sha512_kernel import lens_to_bytes, sha512_ram
from .verify_tail import verify_tail

P = fe.P
D = cv.D
BASE_X, BASE_Y = cv.BASE_X, cv.BASE_Y

# Packed-blob row layout, as the JAX package defines it: one uint8 row per
# lane = msgs[0:ml] | sig 64 | pubkey 32 | msg_len le-int32 4, row width
# ml + PACKED_EXTRA.
PACKED_EXTRA = 100

# The strict layouts (verify_batch's tail=), the first the default.
TAILS = ("fused", "split", "unfused")


def _decompress_checked(b):
    """(ok, point): decompress, with a small-order point rejected."""
    return _checked(decompress(b))


def _checked(dec):
    ok, small, pt = dec
    return ok & ~small, pt


def _verify_rows(msgs, len4, r, s, pub, tail: str):
    if tail not in TAILS:
        raise ValueError(f"unknown strict tail {tail!r}; expected one of "
                         f"{TAILS}")
    digest = sha512_ram(msgs, r, pub, len4)
    if tail == "fused":
        ok_t, qx, qz = verify_tail(pub, s, digest, r)
        return r_check(qx, qz, r, ok_t)
    ok_a, a_pt = _decompress_checked(pub)
    if tail == "split":
        ok_s, wins = reduce_recode(s, digest)
        ok_y, qx, qz = dsm_tail_q(wins, a_pt, fe.from_bytes(r))
        ok_eq = r_check(qx, qz, r, ok_y)
    else:
        ok_s = sc.is_canonical(s)
        q = double_scalar_mul_base(
            sc.scalar_windows(s), sc.limbs_to_windows(sc.reduce_512(digest)),
            cv.neg(a_pt))
        ok_eq = r_check(q.X, q.Z, r, qy=q.Y)
    return ok_s & ok_a & ok_eq


def verify_batch(msgs, msg_len, sigs, pubkeys, tail: str = "fused"):
    """Verify a batch of detached signatures.

    msgs uint8 (batch, maxlen) zero-padded, msg_len int (batch,), sigs
    uint8 (batch, 64) = R || S, pubkeys uint8 (batch, 32); all on one
    device.  A length outside [0, maxlen] is clamped, as the host verifier
    clamps it.  tail is the layout, one of TAILS (the module docstring).
    Returns bool (batch,)."""
    return _verify_rows(msgs, lens_to_bytes(msg_len), sigs[:, :32],
                        sigs[:, 32:], pubkeys, tail)


def verify_blob(blob, tail: str = "fused"):
    """verify_batch over a packed blob (batch, ml + PACKED_EXTRA), read in
    place; the kernels read each row to its own length."""
    ml = blob.shape[1] - PACKED_EXTRA
    return _verify_rows(blob[:, :ml], blob[:, ml + 96:ml + 100],
                        blob[:, ml:ml + 32], blob[:, ml + 32:ml + 64],
                        blob[:, ml + 64:ml + 96], tail)


# ------------------------------------------------- RLC batch verification


def verify_batch_rlc(msgs, msg_len, sigs, pubkeys, z_bytes, m: int = 8,
                     select: str = "legacy"):
    """Random-linear-combination batch check: one bit for the batch.

    Checks [sum z_i s_i]B == sum [z_i]R_i + sum [z_i k_i]A_i, with z_i the
    caller's fresh random 128-bit scalars (z_bytes uint8 (batch, 16)), by
    two lane-parallel MSMs of m points per lane.  Each signature adds the
    term [z s mod L]B - [z k mod L]A - [z]R (rlc_term_host).  A forgery
    whose residual [S]B - R - [k]A has a part in the prime-order subgroup
    passes only with probability about 2^-125 over z.  A residual of
    small order does not: A and R of mixed order (a small-order part on
    a prime-order point) pass the small-order precheck, and [z]T is the
    identity for 1 in ord(T) draws, up to 1/2.  So this check can accept
    a signature the strict rules reject, and can reject a strictly valid
    one whose A is of mixed order.  The JAX package's check is the same
    (ROADMAP section 3).  A rejected batch is settled signature by
    signature (SigVerifier's descent) for exact bits.

    The arguments are verify_batch's, plus z_bytes, m (points per MSM
    lane; batch % m == 0) and select ("legacy" or "p16", the MSM kernel's
    table select; the JAX package reads it from FDTPU_RLC_SELECT).
    Returns (all_ok: bool scalar, prechecks: bool (batch,)) on the
    device, where prechecks is S < L and both A and R decompress to points
    not of small order."""
    r_bytes, s_bytes = sigs[:, :32], sigs[:, 32:]
    (ok_a, a_pt), (ok_r, r_pt) = map(_checked,
                                     decompress_pair(pubkeys, r_bytes))
    digest = sha512_ram(msgs, r_bytes, pubkeys, lens_to_bytes(msg_len))
    ok_s, w_windows, z_windows, c_windows = _rlc_scalars(digest, s_bytes,
                                                         z_bytes)
    acc_a = msm(w_windows, cv.neg(a_pt), m, 64, select)
    acc_r = msm(z_windows, cv.neg(r_pt), m, 32, select)
    pre = ok_s & ok_a & ok_r
    return pre.all() & _rlc_finish(acc_a, acc_r, c_windows), pre


def _rlc_scalars(digest, s_bytes, z_bytes):
    """The scalar chain: the rlc_recode kernel per signature (S < L, the
    windows of w = z k mod L (64, batch) and of z (32, batch), and z s mod
    L), then the sum of the z s in torch, c = sum z s mod L, and its
    windows (64, 1)."""
    ok_s, w_windows, z_windows, zs = rlc_recode(s_bytes, digest, z_bytes)
    c_limbs = sc.sum_mod_l(zs, axis=0)
    return (ok_s, w_windows, z_windows,
            sc.limbs_to_windows(c_limbs)[:, None])


def _rlc_finish(acc_a, acc_r, c_windows):
    """Q = [c]B - sum [w_i]A_i - sum [z_i]R_i is the identity (bool
    scalar): acc_a and acc_r are the two MSMs over the negated points."""
    q = cv.add(cv.add(acc_a, acc_r), cv.scalar_mul_base(c_windows))
    return cv.is_identity(q)[0]


# ------------------------------------------------------------- host side
# Key generation, signing and single-item verification on Python ints:
# control-plane operations, one item at a time.


def keypair_from_seed(seed: bytes):
    """seed (32 B) -> (public key bytes, secret scalar, prefix bytes)."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return _compress_host(_scalar_mul_base_host(a)), a, h[32:]


def sign(seed: bytes, msg: bytes) -> bytes:
    """Single-item host signer (ref fd_ed25519_sign)."""
    pub, a, prefix = keypair_from_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + msg).digest(), "little") % L
    big_r = _compress_host(_scalar_mul_base_host(r))
    k = int.from_bytes(hashlib.sha512(big_r + pub + msg).digest(),
                       "little") % L
    return big_r + ((r + k * a) % L).to_bytes(32, "little")


_pt_add_host = cv._pt_add_host


def _decompress_host(b: bytes):
    """Point decompression on Python ints -> extended coordinates, or None
    (fd_ed25519_point_frombytes semantics: non-canonical y accepted)."""
    enc = int.from_bytes(b, "little")
    sign_bit = enc >> 255
    y = (enc & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P)
    if (v * x * x - u) % P:
        x = x * cv.SQRT_M1 % P
        if (v * x * x - u) % P:
            return None
    x %= P
    if x == 0 and sign_bit:
        return None
    if x & 1 != sign_bit:
        x = P - x
    return (x, y, 1, x * y % P)


def _is_small_order_host(p) -> bool:
    q = p
    for _ in range(3):
        q = _pt_add_host(q, q)
    return q[0] % P == 0


def _scalar_mul_host(s: int, p):
    q = (0, 1, 1, 0)
    while s > 0:
        if s & 1:
            q = _pt_add_host(q, p)
        p = _pt_add_host(p, p)
        s >>= 1
    return q


def _scalar_mul_base_host(s: int):
    return _scalar_mul_host(s, (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P))


def _compress_host(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def prechecks_host(sig: bytes, pub: bytes):
    """Rules 1-3 on Python ints, the prechecks of both paths: (S, A, R)
    decoded, or None where S >= L or A or R does not decode or is of
    small order."""
    s = int.from_bytes(sig[32:], "little")
    a, r = _decompress_host(pub), _decompress_host(sig[:32])
    if (s >= L or a is None or r is None or _is_small_order_host(a)
            or _is_small_order_host(r)):
        return None
    return s, a, r


def _k_host(sig: bytes, msg: bytes, pub: bytes) -> int:
    return int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                          "little") % L


def _neg_host(p):
    return (-p[0] % P, p[1], p[2], -p[3] % P)


def _is_identity_host(p) -> bool:
    return p[0] % P == 0 and (p[1] - p[2]) % P == 0


def verify_one_host(sig: bytes, msg: bytes, pub: bytes) -> bool:
    """Single-item verify on Python ints, the same acceptance rules."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    dec = prechecks_host(sig, pub)
    if dec is None:
        return False
    s, a, r = dec
    xq, yq, zq, _ = _pt_add_host(
        _scalar_mul_base_host(s),
        _scalar_mul_host(_k_host(sig, msg, pub), _neg_host(a)))
    return (xq - r[0] * zq) % P == 0 and (yq - r[1] * zq) % P == 0


def has_torsion_host(p) -> bool:
    """Whether a point has a part of small order: [L]p is not the
    identity (the curve's group is Z/8 x Z/L)."""
    return not _is_identity_host(_scalar_mul_host(L, p))


def rlc_term_host(sig: bytes, msg: bytes, pub: bytes, z: int):
    """One signature's term of verify_batch_rlc's equation on Python ints,
    [z s mod L]B - [z k mod L]A - [z]R in extended coordinates, or None
    where the signature fails the prechecks."""
    dec = prechecks_host(sig, pub)
    if dec is None:
        return None
    s, a, r = dec
    t = _pt_add_host(
        _scalar_mul_base_host(z * s % L),
        _neg_host(_scalar_mul_host(z * _k_host(sig, msg, pub) % L, a)))
    return _pt_add_host(t, _neg_host(_scalar_mul_host(z, r)))


def rlc_batch_host(sigs, msgs, pubs, zs) -> bool:
    """verify_batch_rlc's bit on Python ints (bytes per signature, z as
    ints): every signature passes its prechecks and the terms sum to the
    identity.  Exact, so it shares the batch equation's blind spot for
    parts of small order."""
    acc = (0, 1, 1, 0)
    for sig, msg, pub, z in zip(sigs, msgs, pubs, zs):
        t = rlc_term_host(sig, msg, pub, z)
        if t is None:
            return False
        acc = _pt_add_host(acc, t)
    return _is_identity_host(acc)


def host_verify_blob(blob) -> "list[bool]":
    """verify_one_host over every row of a packed numpy blob (lengths
    clamped to [0, ml], as verify_blob clamps them)."""
    ml = blob.shape[1] - PACKED_EXTRA
    out = []
    for row in blob:
        ln = int.from_bytes(bytes(row[ml + 96:ml + 100]), "little",
                            signed=True)
        ln = max(0, min(ln, ml))
        out.append(verify_one_host(bytes(row[ml:ml + 64]), bytes(row[:ln]),
                                   bytes(row[ml + 64:ml + 96])))
    return out
