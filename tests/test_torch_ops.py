"""The port's plain torch modules against the JAX package on the CPU.

Field, scalar, SHA-512 and curve functions of firedancer_tpu_torch get
the same inputs (numpy, from seeds) as their JAX counterparts, and the
values must be equal exactly: all of it is integer arithmetic.  Field
elements are compared as canonical Python ints (interop.field_to_ints),
never as raw limbs, since the two packages use different radices.  The
last test holds the plain verify tail (the CUDA tail kernel's plain
version) against the XLA composition that the JAX package holds its own
fused tail kernel against.
"""

import hashlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import curve25519 as jcv
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu.ops import f25519 as jfe
from firedancer_tpu.ops import scalar25519 as jsc
from firedancer_tpu.ops import sha512 as jsh
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import curve25519 as cv
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import r_check as rc
from firedancer_tpu_torch.ops import scalar25519 as sc
from firedancer_tpu_torch.ops import sha512 as sh
from firedancer_tpu_torch.ops import sha512_kernel as sk
from firedancer_tpu_torch.ops import verify_tail as vt
from _torch_threads import one_torch_thread  # noqa: F401

P, L = fe.P, sc.L

# Importing Pallas (tests/test_curve_pallas.py does so while pytest
# collects, and this module is collected after it) makes absl attach a log
# handler to whatever sys.stderr is at that moment: under pytest, the
# capture stream.  A later logging.shutdown() (test_attribution's log test)
# closes that stream, and every later test of the worker then errors.
# absl's close() leaves the process's own stderr open, so point it there.
if "absl.logging" in sys.modules:
    sys.modules["absl.logging"].get_absl_handler().python_handler.setStream(
        sys.__stderr__)

EDGES = [0, 1, P - 1, P, P + 1, 2**255 - 20, 2**255 - 1, L - 1, L, L + 1,
         2**252, 2**256 - 1]


def _bytes32(seed: int, n: int) -> np.ndarray:
    """Edge values then random 256-bit values, as uint8 (len, 32)."""
    rng = np.random.default_rng(seed)
    edge = np.array([list(v.to_bytes(32, "little")) for v in EDGES],
                    np.uint8)
    return np.concatenate([edge, rng.integers(0, 256, (n, 32), np.uint8)])


def _ints(b: np.ndarray) -> list[int]:
    """uint8 (n, 32) -> field values (bit 255 dropped) mod p."""
    return [int.from_bytes(bytes(r), "little") % 2**255 % P for r in b]


def test_field_ops_match_jax():
    a_b, b_b = _bytes32(1, 20), _bytes32(2, 20)[::-1].copy()
    ja, jb = jfe.from_bytes(jnp.asarray(a_b)), jfe.from_bytes(jnp.asarray(b_b))
    ta, tb = fe.from_bytes(torch.from_numpy(a_b)), fe.from_bytes(
        torch.from_numpy(b_b))
    ints = interop.field_to_ints
    assert ints(ta) == ints(np.asarray(ja)) == _ints(a_b)
    for name in ("add", "sub", "mul"):
        want = ints(np.asarray(getattr(jfe, name)(ja, jb)))
        assert ints(getattr(fe, name)(ta, tb)) == want, name
    for name in ("neg", "sqr", "canonical"):
        want = ints(np.asarray(getattr(jfe, name)(ja)))
        assert ints(getattr(fe, name)(ta)) == want, name
    assert fe.to_bytes(ta).numpy().tolist() == np.asarray(
        jfe.to_bytes(ja)).tolist()
    assert fe.eq(ta, tb).tolist() == np.asarray(jfe.eq(ja, jb)).tolist()
    assert fe.eq(ta, ta).all()
    assert fe.is_zero(ta).tolist() == np.asarray(jfe.is_zero(ja)).tolist()
    assert fe.sgn(ta).tolist() == np.asarray(jfe.sgn(ja)).tolist()
    # canonical limbs are exact: every limb in range, value below p
    c = fe.canonical(ta)
    assert int(c.min()) >= 0 and fe.to_ints(c) == _ints(a_b)


def test_field_pow_chains_match_jax():
    a_b, b_b = _bytes32(3, 12), _bytes32(4, 12)
    ja, jb = jfe.from_bytes(jnp.asarray(a_b)), jfe.from_bytes(jnp.asarray(b_b))
    ta, tb = fe.from_bytes(torch.from_numpy(a_b)), fe.from_bytes(
        torch.from_numpy(b_b))
    ints = interop.field_to_ints
    assert ints(fe.inv(ta)) == ints(np.asarray(jfe.inv(ja)))
    assert ints(fe.pow22523(ta)) == ints(
        np.asarray(jfe.pow_const(ja, (P - 5) // 8)))
    ok_t, x_t = fe.sqrt_ratio(ta, tb)
    ok_j, x_j = jfe.sqrt_ratio(ja, jb)
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    assert ok_t.any() and not ok_t.all()
    for i in np.flatnonzero(ok_t.numpy()):
        assert ints(x_t[:, i:i + 1]) == ints(np.asarray(x_j)[:, i:i + 1])
    nz = [v or 1 for v in _ints(a_b)] * 3
    got = fe.batch_inv(fe.from_ints(nz, "cpu"), stop=8)
    want = jfe.batch_inv(jnp.asarray(np.array(
        [jfe._to_limbs_py(v) for v in nz]).T), stop=8)
    assert ints(got) == ints(np.asarray(want)) == [pow(v, P - 2, P)
                                                    for v in nz]


def test_interop_field_roundtrip():
    a_b = _bytes32(5, 8)
    planes = np.asarray(jfe.mul(jfe.from_bytes(jnp.asarray(a_b)),
                                jfe.from_bytes(jnp.asarray(a_b))))
    t = interop.field_from_jax_limbs(planes)
    assert t.shape == (fe.NLIMB, len(a_b))
    assert interop.field_to_ints(t) == [v * v % P for v in _ints(a_b)]


def test_scalar_ops_match_jax():
    rng = np.random.default_rng(6)
    s_b = _bytes32(7, 24)
    dig = np.concatenate([
        np.array([list(v.to_bytes(64, "little")) for v in
                  (0, 1, L - 1, L, 2 * L, 2**512 - 1, L * L)], np.uint8),
        rng.integers(0, 256, (24, 64), np.uint8)])
    ts, td = torch.from_numpy(s_b), torch.from_numpy(dig)
    js, jd = jnp.asarray(s_b), jnp.asarray(dig)
    assert sc.bytes_to_limbs(ts, 22).tolist() == np.asarray(
        jsc.bytes_to_limbs(js, 22)).tolist()
    k = sc.reduce_512(td)
    assert k.tolist() == np.asarray(jsc.reduce_512(jd)).tolist()
    assert [sc.to_int(k[:, i]) for i in range(len(dig))] == [
        int.from_bytes(bytes(r), "little") % L for r in dig]
    assert sc.is_canonical(ts).tolist() == np.asarray(
        jsc.is_canonical(js)).tolist()
    assert sc.is_canonical(ts).tolist() == [
        int.from_bytes(bytes(r), "little") < L for r in s_b]
    w = sc.limbs_to_windows(k)
    assert w.tolist() == np.asarray(
        jsc.limbs_to_windows(jnp.asarray(k.numpy().astype(np.int32)))).tolist()
    assert sc.scalar_windows(ts).tolist() == np.asarray(
        jcv.scalar_windows(js)).tolist()
    # The recode's reference is curve_pallas.signed_windows, transcribed
    # here so that this module does not import Pallas (and absl) itself.
    mag, sgn = sc.signed_windows(w)
    for lane in range(w.shape[1]):
        carry, want_m, want_s = 0, [], []
        for d in w[:, lane].tolist():
            d += carry
            carry = int(d > 8)
            want_m.append(16 - d if carry else d)
            want_s.append(carry)
        assert mag[:, lane].tolist() == want_m
        assert sgn[:, lane].tolist() == want_s
        assert sum(m * (-1) ** g * 16**i for i, (m, g) in enumerate(
            zip(want_m, want_s))) == sc.to_int(k[:, lane])


# message lengths where the padding spills into one more block, and 0
SHA_EDGE_LENS = [0, 1, 47, 48, 111, 112, 113, 127, 128, 175, 176, 239, 240,
                 241, 300]


def test_sha512_matches_jax_and_hashlib():
    rng = np.random.default_rng(8)
    maxlen = 300
    lens = np.array(SHA_EDGE_LENS + list(rng.integers(0, maxlen + 1, 9)),
                    np.int32)
    msgs = rng.integers(0, 256, (len(lens), maxlen), np.uint8)
    tm, tl = torch.from_numpy(msgs), torch.from_numpy(lens)
    nb = (maxlen + 17 + 127) // 128
    padded, nblocks = sh.pad_messages(tm, tl, nb)
    jpad, jnb = jsh.pad_messages(jnp.asarray(msgs), jnp.asarray(lens), nb)
    assert padded.tolist() == np.asarray(jpad).tolist()
    assert nblocks.tolist() == np.asarray(jnb).tolist()
    got = sh.sha512(tm, tl).numpy()
    want = np.asarray(jax.jit(jsh.sha512)(jnp.asarray(msgs),
                                          jnp.asarray(lens)))
    assert got.tolist() == want.tolist()
    for i, n in enumerate(lens):
        assert bytes(got[i]) == hashlib.sha512(bytes(msgs[i, :n])).digest()


def test_sha512_kernel_plain_reads_blob_rows():
    """The kernel's plain version over the columns of a packed blob:
    SHA-512(R || A || M[:len]) with the length clamped to [0, ml]."""
    rng = np.random.default_rng(9)
    ml = 200
    lens = np.array([0, 47, 48, 175, 176, 200, -3, 500], np.int32)
    n = len(lens)
    msgs = rng.integers(0, 256, (n, ml), np.uint8)
    sigs = rng.integers(0, 256, (n, 64), np.uint8)
    pubs = rng.integers(0, 256, (n, 32), np.uint8)
    blob = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs))
    out = sk.sha512_ram(blob[:, :ml], blob[:, ml:ml + 32],
                        blob[:, ml + 64:ml + 96], blob[:, ml + 96:])
    for i in range(n):
        ln = max(0, min(int(lens[i]), ml))
        want = hashlib.sha512(bytes(sigs[i, :32]) + bytes(pubs[i])
                              + bytes(msgs[i, :ln])).digest()
        assert bytes(out[i].tolist()) == want
    assert sk.lens_from_bytes(sk.lens_to_bytes(torch.from_numpy(lens))
                              ).tolist() == lens.tolist()


def test_decompress_matches_jax():
    _, _, sigs, pubs, _ = tv.make_adversarial_batch(22, 16)
    pts = np.concatenate([pubs, sigs[:, :32], _bytes32(10, 10)])
    ok_t, pt = cv.decompress(torch.from_numpy(pts))
    ok_j, jpt = jcv.decompress(jnp.asarray(pts))
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    assert cv.is_small_order_affine(pt).tolist() == np.asarray(
        jcv.is_small_order_affine(jpt)).tolist()
    ok = ok_t.numpy()
    for name in ("X", "Y", "T"):
        got = interop.field_to_ints(getattr(pt, name))
        want = interop.field_to_ints(np.asarray(getattr(jpt, name)))
        assert [g for g, o in zip(got, ok) if o] == [
            w for w, o in zip(want, ok) if o], name


def test_verify_tail_plain_matches_xla_composition():
    """verify_tail_plain (the CUDA tail kernel's plain version) against
    the XLA composition tests/test_curve_pallas.py holds the JAX fused
    tail against: cv.decompress + is_small_order_affine, sc.is_canonical,
    sc.reduce_512, cv.double_scalar_mul_base and _compressed_r_check, on
    every adversarial lane kind.  The bits must be equal, and so must Q's
    affine x wherever A decompresses (off the curve, Q depends on the
    formulas: the chain and the comb differ there) and Z != 0."""
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(22, 64)
    r_b, s_b = sigs[:, :32].copy(), sigs[:, 32:].copy()
    pre = np.concatenate([r_b, pubs, msgs], axis=1)
    digest = np.array(
        [list(hashlib.sha512(bytes(pre[i, :64 + lens[i]])).digest())
         for i in range(len(lens))], np.uint8)

    ok_t, qx, qz = vt.verify_tail_plain(
        torch.from_numpy(pubs), torch.from_numpy(s_b),
        torch.from_numpy(digest), torch.from_numpy(r_b))
    bits = rc.r_check(qx, qz, torch.from_numpy(r_b), ok_t)

    jpub, js, jr = jnp.asarray(pubs), jnp.asarray(s_b), jnp.asarray(r_b)
    on_curve, a_pt = jcv.decompress(jpub)
    ok_a = on_curve & ~jcv.is_small_order_affine(a_pt)
    ok_s = jsc.is_canonical(js)
    q = jcv.double_scalar_mul_base(
        jcv.scalar_windows(js),
        jsc.limbs_to_windows(jsc.reduce_512(jnp.asarray(digest))),
        jcv.neg(a_pt))
    y_r = jed._parse_r_bytes(jr)[0]
    want_tail = ok_s & ok_a & jfe.eq(q.Y, jfe.mul(y_r, q.Z))
    want = ok_s & ok_a & jed._compressed_r_check(q.X, q.Y, q.Z, jr)

    assert ok_t.tolist() == np.asarray(want_tail).tolist()
    assert bits.tolist() == np.asarray(want).tolist()
    assert [k for k, b in zip(kinds, bits.tolist()) if b] == ["valid"] * 2

    def affine_x(xs, zs):
        return [x * pow(z, P - 2, P) % P if z and on else None
                for x, z, on in zip(xs, zs, np.asarray(on_curve))]
    got_x = affine_x(interop.field_to_ints(qx), interop.field_to_ints(qz))
    want_x = affine_x(interop.field_to_ints(np.asarray(q.X)),
                      interop.field_to_ints(np.asarray(q.Z)))
    assert got_x == want_x
    assert sum(x is not None for x in got_x) >= 16
