"""The port's RLC batch-verify slice on the CPU, against the JAX package
and Python ints: the scalar chain (mul_mod_l, sum_mod_l, the extended
signed recode), decompression against the Pallas kernel in interpret
mode, and the rlc mode of SigVerifier (its bits against the host
verifier, and the strict calls of its descent).

The MSM and the whole verify_batch_rlc are held against the JAX package
in test_torch_rlc_msm.py and test_torch_rlc_batch.py: each compiles a
large JAX graph, and a parallel test run spreads files over workers.
Every comparison is exact: all of it is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import curve_pallas as jcp
from firedancer_tpu.ops import scalar25519 as jsc
from firedancer_tpu_torch import _device, interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import decompress as dc
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import msm as ms
from firedancer_tpu_torch.ops import scalar25519 as sc

L = sc.L


def _z_values(rng, n: int) -> list[int]:
    """128-bit z values: the edges, then random ones, a quarter of them
    with the top nibble >= 8 so that the signed recode carries out."""
    vals = [0, 1, 2**128 - 1, 2**127, 0x8 << 124]
    vals += [int.from_bytes(rng.bytes(16), "little") for _ in range(n - 5)]
    return [v | (0x8 << 124) if i % 4 == 3 else v for i, v in enumerate(vals)]


def _scalar_values(rng, n: int) -> list[int]:
    vals = [0, 1, L - 1, L - 2, 2**252]
    return vals + [int.from_bytes(rng.bytes(32), "little") % L
                   for _ in range(n - 5)]


def _le(vals, width: int) -> np.ndarray:
    return np.array([list(v.to_bytes(width, "little")) for v in vals],
                    np.uint8)


def test_z_limbs_read_zero_past_128_bits():
    """bytes_to_limbs(z, 11) covers 132 bits of a 16-byte z: the top four
    bits read 0 on both sides (pack_bits here, zero padding in JAX)."""
    zb = np.full((3, 16), 0xFF, np.uint8)
    got = sc.bytes_to_limbs(torch.from_numpy(zb), 11)
    assert got[10].tolist() == [0xFF] * 3
    assert got.tolist() == np.asarray(
        jsc.bytes_to_limbs(jnp.asarray(zb), 11)).tolist()
    assert sc.to_int(got[:, 0]) == (2**128 - 1) % L


def test_mul_sum_mod_l_match_jax_and_ints():
    rng = np.random.default_rng(41)
    n = 24
    s_vals, z_vals = _scalar_values(rng, n), _z_values(rng, n)
    s_b, z_b = _le(s_vals, 32), _le(z_vals, 16)
    s_t = sc.bytes_to_limbs(torch.from_numpy(s_b), 22)
    z_t = sc.bytes_to_limbs(torch.from_numpy(z_b), 11)
    s_j = jsc.bytes_to_limbs(jnp.asarray(s_b), 22)
    z_j = jsc.bytes_to_limbs(jnp.asarray(z_b), 11)
    prod = sc.mul_mod_l(s_t, z_t)
    assert prod.tolist() == np.asarray(jsc.mul_mod_l(s_j, z_j)).tolist()
    assert [sc.to_int(prod[:, i]) for i in range(n)] == [
        s * z % L for s, z in zip(s_vals, z_vals)]
    # odd and even counts exercise the carried odd element of the tree
    for k in (1, 5, n):
        got = sc.sum_mod_l(prod[:, :k], axis=0)
        assert got.tolist() == np.asarray(
            jsc.sum_mod_l(jsc.mul_mod_l(s_j[:, :k], z_j[:, :k]),
                          axis=0)).tolist()
        assert sc.to_int(got) == sum(
            s * z for s, z in zip(s_vals[:k], z_vals[:k])) % L


def test_signed_windows_ext_matches_pallas_and_value():
    rng = np.random.default_rng(42)
    z_vals = _z_values(rng, 20)
    z_t = sc.bytes_to_limbs(torch.from_numpy(_le(z_vals, 16)), 11)
    w = sc.limbs_to_windows(torch.cat([z_t, torch.zeros_like(z_t)]))[:32]
    mags, sgns = sc.signed_windows_ext(w)
    jm, js = jcp.signed_windows_ext(jnp.asarray(w.numpy().astype(np.uint32)))
    assert mags.shape == (33, 20)
    assert mags.tolist() == np.asarray(jm).tolist()
    assert sgns.tolist() == np.asarray(js).tolist()
    assert int(mags.max()) <= 8 and int(mags[32].max()) == 1
    for j, v in enumerate(z_vals):
        assert sum(int(mags[i, j]) * (-1) ** int(sgns[i, j]) * 16**i
                   for i in range(33)) == v


def test_decompress_plain_matches_pallas_interpret():
    """decompress_plain against curve_pallas.decompress in interpret mode
    on the adversarial encodings (no square root, y = 0 with the sign
    bit, the identity, order 8, y >= p) and random strings: ok, small and
    canonical X and T on every lane."""
    _, _, sigs, pubs, _ = tv.make_adversarial_batch(22, 16)
    rng = np.random.default_rng(43)
    b = np.concatenate([pubs, sigs[:, :32],
                        rng.integers(0, 256, (4, 32), np.uint8)])
    ok_t, small_t, pt = dc.decompress_plain(torch.from_numpy(b))
    ok_j, small_j, jpt = jcp.decompress(jnp.asarray(b), blk=8,
                                        interpret=True)
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    assert small_t.tolist() == np.asarray(small_j).tolist()
    assert ok_t.any() and not ok_t.all() and small_t.any()
    for name in ("X", "Y", "T"):
        assert interop.field_to_ints(getattr(pt, name)) == \
            interop.field_to_ints(np.asarray(getattr(jpt, name))), name
    assert pt.Z.tolist() == fe.ones(len(b), "cpu").tolist()


def test_decompress_pair_plain_matches_two_calls_and_jax():
    """decompress_pair's plain version (the RLC check's A and R, one
    launch on the card) on the keys and R values of adversarial lanes
    and random strings, read as row views of one buffer: each half equals
    its own decompress_plain call, and jitted JAX curve25519.decompress
    with is_small_order_affine (ok, small, and canonical X, Y, T where the
    point exists); the wrapper takes it for CPU tensors, launching
    nothing."""
    from firedancer_tpu.ops import curve25519 as jcv
    import jax
    _, _, sigs, pubs, _ = tv.make_adversarial_batch(22, 16)
    rng = np.random.default_rng(44)
    rows = np.concatenate([np.concatenate([pubs, sigs], axis=1),
                           rng.integers(0, 256, (6, 96), np.uint8)])
    buf = torch.from_numpy(rows)
    a, r = buf[:, :32], buf[:, 32:64]
    before = dc.decompress.launches
    got = dc.decompress_pair(a, r)
    assert dc.decompress.launches == before
    jdec = jax.jit(lambda b: (lambda ok, p: (ok, jcv.is_small_order_affine(p),
                                             p))(*jcv.decompress(b)))
    for (ok, small, pt), b in zip(got, (a, r)):
        ok_1, small_1, pt_1 = dc.decompress_plain(b)
        assert torch.equal(ok, ok_1) and torch.equal(small, small_1)
        assert all(torch.equal(u, v) for u, v in zip(pt, pt_1))
        ok_j, small_j, jpt = jdec(jnp.asarray(b.numpy()))
        assert ok.tolist() == np.asarray(ok_j).tolist()
        assert small.tolist() == np.asarray(small_j).tolist()
        mask = ok.numpy()
        for name in ("X", "Y", "T"):
            want = interop.field_to_ints(np.asarray(getattr(jpt, name)))
            have = interop.field_to_ints(getattr(pt, name))
            assert [g for g, o in zip(have, mask) if o] == [
                w for w, o in zip(want, mask) if o], name
    assert got[0][0].any() and not got[0][0].all() and got[1][1].any()


def test_decompress_wrapper_takes_the_plain_version_on_cpu():
    b = torch.zeros((3, 32), dtype=torch.uint8)
    before = dc.decompress.launches
    ok, small, _ = dc.decompress(b)
    assert dc.decompress.launches == before
    assert ok.all() and small.all()          # y = 0: x = sqrt(-1), small


# ------------------------------------------------- SigVerifier, rlc mode

BATCH, MAXLEN = 32, 64


@pytest.fixture(scope="module")
def clean():
    return tv.make_example_batch(BATCH, MAXLEN, True, 51, sign_pool=BATCH)


def _rlc_verifier(m=4, seed=5, **kw):
    return tv.SigVerifier(tv.VerifierConfig(BATCH, MAXLEN), mode="rlc",
                          msm_m=m, device="cpu",
                          rng=np.random.default_rng(seed), **kw)


def test_rlc_verifier_bits_match_host(clean):
    msgs, lens, sigs, pubs = clean
    ver = _rlc_verifier(rlc_select="p16")
    verdict = ver(msgs, lens, sigs, pubs)
    assert verdict.is_ready()
    verdict.copy_to_host_async()
    assert np.asarray(verdict).all() and verdict.all() and len(verdict) == 32
    bad = sigs.copy()
    bad[9, 40] ^= 1                  # a forged S (still canonical)
    bad[20, 5] ^= 0x40               # a forged R
    verdict = ver.packed_dispatch(msgs, lens, bad, pubs)
    want = ed.host_verify_blob(tv.pack_blob(msgs, lens, bad, pubs))
    assert np.asarray(verdict).tolist() == want
    assert want.count(False) == 2 and not verdict[9] and verdict[0]
    assert list(verdict) == want and verdict.any() and not verdict.all()
    with pytest.raises(ValueError, match="ambiguous"):
        bool(verdict)


def test_rlc_verifier_adversarial_lanes_match_host():
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(BATCH, MAXLEN)
    bits = np.asarray(_rlc_verifier()(msgs, lens, sigs, pubs))
    want = ed.host_verify_blob(tv.pack_blob(msgs, lens, sigs, pubs))
    assert bits.tolist() == want
    assert [k for k, b in zip(kinds, want) if b] == [
        k for k in kinds if k == "valid"]


def test_rlc_descent_goes_strict_on_one_leaf_only(clean):
    """A forgery in the last leaf: the halves that pass are accepted
    wholesale, and only the leaf that holds it is verified strictly."""
    msgs, lens, sigs, pubs = clean
    ver = _rlc_verifier()
    ver._SPLIT_LEAF = 8
    calls = {"strict": 0, "rlc": 0}
    strict, rlc = ver._fn, ver._rlc

    def counting_strict(*a):
        calls["strict"] += 1
        return strict(*a)

    def counting_rlc(args):
        calls["rlc"] += 1
        return rlc(args)

    ver._fn, ver._rlc = counting_strict, counting_rlc
    bad = sigs.copy()
    bad[BATCH - 3, 40] ^= 1
    bits = np.asarray(ver(msgs, lens, bad, pubs))
    want = np.ones(BATCH, bool)
    want[BATCH - 3] = False
    assert bits.tolist() == want.tolist()
    # 32 -> halves of 16 (two checks) -> the failing half's 8s (two more)
    assert calls == {"strict": 1, "rlc": 5}


def test_rlc_verifier_z_comes_from_the_given_rng(clean):
    """Two verifiers seeded alike draw the same z, and a batch check sees
    the z the verifier drew (same prechecks and verdict)."""
    msgs, lens, sigs, pubs = clean
    args = interop.batch_from_numpy(msgs, lens, sigs, pubs, "cpu")
    a, b = _rlc_verifier(seed=9), _rlc_verifier(seed=9)
    ok_a, pre_a = a._rlc(args)
    z = np.random.default_rng(9).integers(0, 256, (BATCH, 16), np.uint8)
    ok_z, pre_z = ed.verify_batch_rlc(*args, torch.from_numpy(z), m=4)
    assert bool(ok_a) and bool(ok_z) and torch.equal(pre_a, pre_z)
    assert b._rng.integers(0, 256, (BATCH, 16), np.uint8).tolist() == \
        z.tolist()


def test_rlc_verifier_rejects_bad_configuration(monkeypatch):
    cfg = tv.VerifierConfig(BATCH, MAXLEN)
    with pytest.raises(NotImplementedError, match="not ported"):
        tv.SigVerifier(cfg, mode="antipa", device="cpu")
    with pytest.raises(ValueError, match="unknown verifier mode"):
        tv.SigVerifier(cfg, mode="fast", device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        tv.SigVerifier(cfg, mode="rlc", msm_m=5, device="cpu")
    with pytest.raises(ValueError, match="rlc_select"):
        tv.SigVerifier(cfg, mode="rlc", device="cpu", rlc_select="p8")
    with pytest.raises(ValueError, match="strict-only"):
        _rlc_verifier().dispatch_blob(
            np.zeros((4, MAXLEN + ed.PACKED_EXTRA), np.uint8))
    with pytest.raises(ValueError, match="select"):
        ms.msm(torch.zeros((32, 8), dtype=torch.int64),
               ed.cv.identity(8, "cpu"), 2, 32, "p8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.SigVerifier(cfg, mode="rlc")
    assert _device.resolve_device("cpu") == torch.device("cpu")
