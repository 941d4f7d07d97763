"""The split and unfused strict layouts' kernels on the CPU: the plain
versions of reduce_recode, dsm_tail_q and double_scalar_mul_base against
the JAX package's Pallas kernels in interpret mode, at 8 lanes.

The lanes are those of tests/test_curve_pallas.py: valid signatures, a
tampered R, S = 2^256 - 1 (its recode carries out of the top window), a
key with no square root (with a digest of all 0xff), y = 0 with the sign
bit, the identity, and S = L - 1.  A
enters both packages scaled by a random lambda, (lX, lY, lZ, lT), so Z is
not 1.  Every comparison is exact (tolerance 0): windows and bits as
integers, points as canonical affine coordinates, since the two packages
reach the same point through other projective coordinates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import curve25519 as jcv
from firedancer_tpu.ops import curve_pallas as jcp
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import curve25519 as cv
from firedancer_tpu_torch.ops import dsm
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import reduce_recode as rr
from firedancer_tpu_torch.ops import sha512_kernel as sk

B = 8           # one interpret-mode block
L = 2**252 + 27742317777372353535851937790883648493


@pytest.fixture(scope="module")
def lanes():
    """(s, digest, r, pubs) as numpy, and A scaled by lambda (a port
    Point)."""
    msgs, lens, sigs, pubs = tv.make_example_batch(B, 64, True, 41,
                                                   sign_pool=B)
    sigs[1, 5] ^= 0xFF                                  # tampered R
    sigs[2, 32:] = 0xFF                                 # S = 2^256 - 1
    pubs[3] = 0x07                                      # no square root
    pubs[4] = 0
    pubs[4, 31] = 0x80                                  # y = 0, sign bit
    pubs[5] = 0
    pubs[5, 0] = 1                                      # the identity
    sigs[6, 32:] = np.frombuffer((L - 1).to_bytes(32, "little"), np.uint8)
    t = {k: torch.from_numpy(v) for k, v in
         (("m", msgs), ("s", sigs), ("p", pubs))}
    digest = sk.sha512_ram_plain(t["m"], t["s"][:, :32], t["p"],
                                 sk.lens_to_bytes(torch.from_numpy(lens)))
    digest[3] = 0xFF                                    # all-0xff digest
    _, a = cv.decompress(t["p"])
    rng = np.random.default_rng(42)
    lam = fe.from_ints([int.from_bytes(rng.bytes(32), "little") % fe.P
                        for _ in range(B)], "cpu")
    a = cv.Point(*(fe.mul(c, lam) for c in a))
    return sigs[:, 32:].copy(), digest.numpy(), sigs[:, :32].copy(), a


@pytest.fixture(scope="module")
def jax_wins(lanes):
    """cp.reduce_recode on the lanes, interpret mode (one run for the
    module: about a minute on a CPU host)."""
    s, digest, _, _ = lanes
    return jcp.reduce_recode(jnp.asarray(s), jnp.asarray(digest), blk=B,
                             interpret=True)


def _jax_point(p: cv.Point) -> jcv.Point:
    return jcv.Point(*(jnp.asarray(c) for c in interop.point_to_jax(p)))


def _affine(p) -> list[tuple[int, int]]:
    """Canonical affine (x, y) of a port Point or a JAX one."""
    xs, ys, zs = (interop.field_to_ints(
        c if isinstance(c, torch.Tensor) else np.asarray(c))
        for c in (p[0], p[1], p[2]))
    out = []
    for x, y, z in zip(xs, ys, zs):
        assert z % fe.P
        zi = pow(z, fe.P - 2, fe.P)
        out.append((x * zi % fe.P, y * zi % fe.P))
    return out


def test_reduce_recode_plain_matches_pallas_interpret(lanes, jax_wins):
    s, digest, _, _ = lanes
    ok_t, wins_t = rr.reduce_recode_plain(torch.from_numpy(s),
                                          torch.from_numpy(digest))
    ok_j, wins_j = jax_wins
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    assert ok_t.tolist() == [int.from_bytes(bytes(r), "little") < L
                             for r in s]
    for t, j in zip(wins_t, wins_j):
        assert t.dtype == torch.uint8 and t.shape == (64, B)
        assert t.tolist() == np.asarray(j).tolist()
    # the CPU wrapper is the plain version
    ok_w, wins_w = rr.reduce_recode(torch.from_numpy(s),
                                    torch.from_numpy(digest))
    assert torch.equal(ok_w, ok_t) and all(
        torch.equal(a, b) for a, b in zip(wins_w, wins_t))


def test_dsm_tail_q_plain_matches_pallas_interpret(lanes, jax_wins):
    """ok_y and Q's affine x (X / Z) from the same signed windows, the
    same A (Z != 1) and the same y_R, against cp.dsm_tail_q."""
    _, _, r, a = lanes
    wins_j = jax_wins[1]
    y_r_j = jed._parse_r_bytes(jnp.asarray(r))[0]
    ok_j, qx_j, qz_j = jcp.dsm_tail_q(wins_j, _jax_point(a), y_r_j, blk=B,
                                      interpret=True)
    wins = interop.signed_windows_from_jax(wins_j)
    y_r = interop.field_from_jax_limbs(np.asarray(y_r_j))
    ok_t, qx_t, qz_t = dsm.dsm_tail_q_plain(wins, a, y_r)
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    xt, zt = fe.to_ints(qx_t), fe.to_ints(qz_t)
    xj, zj = (interop.field_to_ints(np.asarray(c)) for c in (qx_j, qz_j))
    assert all(z % fe.P for z in zt + zj)
    assert [x * zb % fe.P for x, zb in zip(xt, zj)] == [
        x * za % fe.P for x, za in zip(xj, zt)]
    # the lanes with a valid signature pass the y-compare, the others
    # (R tampered, S past L, A without a point, ...) fail it
    assert ok_t.tolist() == [True, False, False, False, False, False,
                             False, True]
    ok_w, qx_w, qz_w = dsm.dsm_tail_q(wins, a, y_r)
    assert torch.equal(ok_w, ok_t)
    assert torch.equal(qx_w, qx_t) and torch.equal(qz_w, qz_t)


def test_double_scalar_mul_base_plain_matches_pallas_interpret(lanes):
    """[s]B + [k]A from unsigned windows (top windows that carry out
    included) and A with Z != 1: the affine x and y of
    cp.double_scalar_mul_base, and a valid T (T Z = X Y)."""
    *_, a = lanes
    rng = np.random.default_rng(43)
    w = rng.integers(0, 16, (2, 64, B)).astype(np.uint32)
    w[:, 63, :3] = 15
    w[0, :, 4] = 0                                      # s = 0
    w[1, :, 5] = 0                                      # k = 0
    got = dsm.double_scalar_mul_base_plain(
        *(torch.from_numpy(x.astype(np.int64)) for x in w), a)
    want = jcp.double_scalar_mul_base(jnp.asarray(w[0]), jnp.asarray(w[1]),
                                      _jax_point(a), blk=B, interpret=True)
    assert _affine(got) == _affine(want)
    x, y, z, t = (fe.to_ints(c) for c in got)
    assert all(ti * zi % fe.P == xi * yi % fe.P
               for xi, yi, zi, ti in zip(x, y, z, t))
    wx, wy, wz, wt = (interop.field_to_ints(np.asarray(c)) for c in want)
    assert all(ti * zi % fe.P == xi * yi % fe.P
               for xi, yi, zi, ti in zip(wx, wy, wz, wt))
    back = dsm.double_scalar_mul_base(
        *(torch.from_numpy(x.astype(np.int64)) for x in w), a)
    assert all(torch.equal(p, q) for p, q in zip(back, got))
