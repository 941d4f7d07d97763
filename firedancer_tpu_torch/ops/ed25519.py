"""Batched strict ed25519 verification on torch tensors.

Counterpart of firedancer_tpu/ops/ed25519.py: the same acceptance rules
(fd_ed25519_verify, Agave's verify_strict):

  1. S canonical: 0 <= S < L
  2. A and R decode per RFC 8032; a non-canonical y is accepted mod p
  3. A or R of small order (<= 8) is rejected
  4. k = SHA-512(R || A || M) mod L
  5. accept iff [S]B + [k](-A) == R (projective, no cofactor)

The path is two kernels and a torch finish: sha512_kernel.sha512_ram
computes k's digest straight from the rows, verify_tail.verify_tail does
everything about A, S and k and the y half of the R comparison, and
_compressed_r_check settles the rest of R from its bytes, without
decompressing it.  On a CUDA tensor both kernels launch; on a CPU tensor
their plain versions run.

The host helpers at the bottom (signing, a Python-int verifier) are this
package's own copies; it imports nothing of the JAX package.
"""

import hashlib

import torch

from . import curve25519 as cv
from . import f25519 as fe
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


def _parse_r_bytes(r_bytes):
    """R's encoded y (canonical limbs, mod p), its sign bit, and whether
    y is one of the five 8-torsion y values {0, 1, -1, y8_0, y8_1}."""
    yc = fe.canonical(fe.from_bytes(r_bytes))
    sign_r = (r_bytes[:, 31] >> 7).to(torch.int64)
    small = cv.small_order_y(yc)
    for v in (1, P - 1):
        small = small | (yc == fe.const(v, yc.device)).all(0)
    return yc, sign_r, small


def _compressed_r_check(qx, qz, r_bytes, ok_y):
    """Accept iff Q equals the point R's bytes encode, given ok_y (the
    projective y-compare the tail kernel ran), without decompressing R.
    Case by case, as in the JAX package: a non-canonical y compares mod p;
    an R off the curve has no point with its y, so the y-compare already
    failed; x = 0 with the sign bit set fails the parity test; a
    small-order R is recognised by its y; otherwise equal y and equal x
    parity make equal points.  The affine x comes from one batch
    inversion."""
    _, sign_r, small = _parse_r_bytes(r_bytes)
    z_ok = ~fe.is_zero(qz)
    one = fe.ones(qz.shape[1], qz.device)
    zi = fe.batch_inv(torch.where(z_ok, qz, one))
    x_aff = fe.mul(qx, zi)
    return z_ok & ~small & ok_y & (fe.sgn(x_aff) == sign_r)


def _verify_rows(msgs, len4, r, s, pub):
    digest = sha512_ram(msgs, r, pub, len4)
    ok_t, qx, qz = verify_tail(pub, s, digest, r)
    return _compressed_r_check(qx, qz, r, ok_t)


def verify_batch(msgs, msg_len, sigs, pubkeys):
    """Verify a batch of detached signatures.

    msgs uint8 (batch, maxlen) zero-padded, msg_len int (batch,), sigs
    uint8 (batch, 64) = R || S, pubkeys uint8 (batch, 32); all on one
    device.  A length outside [0, maxlen] is clamped, as the host verifier
    clamps it.  Returns bool (batch,)."""
    return _verify_rows(msgs, lens_to_bytes(msg_len), sigs[:, :32],
                        sigs[:, 32:], pubkeys)


def verify_blob(blob):
    """verify_batch over a packed blob (batch, ml + PACKED_EXTRA), read in
    place; the kernels read each row to its own length."""
    ml = blob.shape[1] - PACKED_EXTRA
    return _verify_rows(blob[:, :ml], blob[:, ml + 96:ml + 100],
                        blob[:, ml:ml + 32], blob[:, ml + 32:ml + 64],
                        blob[:, ml + 64:ml + 96])


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


def verify_one_host(sig: bytes, msg: bytes, pub: bytes) -> bool:
    """Single-item verify on Python ints, the same acceptance rules."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    a = _decompress_host(pub)
    r = _decompress_host(sig[:32])
    if a is None or r is None:
        return False
    if _is_small_order_host(a) or _is_small_order_host(r):
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                       "little") % L
    neg_a = (P - a[0], a[1], a[2], P - a[3])
    xq, yq, zq, _ = _pt_add_host(_scalar_mul_base_host(s),
                                 _scalar_mul_host(k, neg_a))
    return (xq - r[0] * zq) % P == 0 and (yq - r[1] * zq) % P == 0


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
