"""The port's antipa verify mode against the JAX package's, on the CPU.

The halving (scalar25519.halve_scalar and neg_mod_l) against the JAX
functions and against the divstep model on Python ints, on the edge
scalars and seeded corpora; the halved chain
(curve25519.double_scalar_mul_halved) against JAX's; the whole plain
path (ed25519.verify_batch_antipa and verify_blob_antipa: sha512_ram,
then antipa_tail's plain version) against JAX's verify_batch_antipa
on honest, corrupted and torsion-forged rows, and at lengths past the
row against the host twin; the host twin (verify_one_host_antipa)
against JAX's on the golden corpora; and the antipa tail's edge lanes,
fed digests directly, against the host.  Every comparison is exact.
The JAX graph runs eagerly at one shape (8 lanes: the whole path, the
halving and the chain, which then share their loops' compiles): its
compiles take most of this file's time."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import curve25519 as jcv
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu.ops import scalar25519 as jsc
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import antipa_tail as at
from firedancer_tpu_torch.ops import curve25519 as cv
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import scalar25519 as sc
from _torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import antipa_edge_ks, antipa_edge_lanes, torsion_forgeries
from test_scalar_divstep import _halve_model

L = sc.L
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
MAXLEN = 64
# the JAX graph's one shape in this file, rows x message bytes: that of
# tests/test_ed25519_antipa.py, so the two files' eager loops compile
# once between them (the XLA cache)
ROWS, JAX_ML = 16, 96


def _k_bytes(ks):
    return np.array([list(k.to_bytes(32, "little")) for k in ks], np.uint8)


def _limb_ints(limbs) -> list[int]:
    a = np.asarray(limbs)
    return [sum(int(a[i, j]) << (12 * i) for i in range(a.shape[0]))
            for j in range(a.shape[1])]


def _halved(u, av, v_pos) -> list[tuple[int, int]]:
    return [(x, y if p else -y) for x, y, p in zip(
        _limb_ints(u), _limb_ints(av), np.asarray(v_pos).tolist())]


def test_halve_scalar_matches_jax_and_the_model():
    """(u, v) of the port's halve_scalar == the JAX function's == the
    divstep model's, on the edge scalars, seeded scalars and seeded
    256-bit strings reduced mod L; the port's host twin of the model too."""
    rng = np.random.default_rng(907)
    ks = antipa_edge_ks()
    ks += [int.from_bytes(rng.bytes(32), "little") % L for _ in range(40)]
    ks += [(int.from_bytes(rng.bytes(32), "little") | (1 << 255)) % L
           for _ in range(7)]
    kb = _k_bytes(ks)
    got = _halved(*sc.halve_scalar(sc.bytes_to_limbs(torch.from_numpy(kb),
                                                     22)))
    # the JAX function on ROWS scalars a call, the shape of the halving
    # inside the JAX verify_batch_antipa below, whose loops it shares
    want = []
    for i in range(0, len(ks), ROWS):
        part = np.zeros((ROWS, 32), np.uint8)
        part[:len(kb[i:i + ROWS])] = kb[i:i + ROWS]
        want += _halved(*jsc.halve_scalar(
            jsc.bytes_to_limbs(jnp.asarray(part), 22)))
    want = want[:len(ks)]
    model = [_halve_model(k) for k in ks]
    assert got == want == model
    assert [ed._divstep_halve_host(k) for k in ks] == model
    assert [jed._divstep_halve_host(k) for k in ks] == model
    for k, (u, v) in zip(ks, got):
        assert u % L == v * k % L and 0 <= u < 1 << 128 and abs(v) < 1 << 128


def test_halve_scalar_corpus_matches_the_model():
    """2,048 seeded scalars through the port's batched halving at once,
    against the model on Python ints."""
    rng = np.random.default_rng(5150)
    ks = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(2048)]
    got = _halved(*sc.halve_scalar(sc.bytes_to_limbs(
        torch.from_numpy(_k_bytes(ks)), 22)))
    assert got == [_halve_model(k) for k in ks]


def test_neg_mod_l_matches_jax():
    rng = np.random.default_rng(3)
    xs = [0, 1, 2, L - 1, L - 2, 1 << 127] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(10)]
    kb = _k_bytes(xs)
    got = _limb_ints(sc.neg_mod_l(sc.bytes_to_limbs(torch.from_numpy(kb),
                                                    22)))
    want = _limb_ints(jsc.neg_mod_l(jsc.bytes_to_limbs(jnp.asarray(kb), 22)))
    assert got == want == [(L - x) % L for x in xs]


def _affine(p) -> list[tuple[int, int]]:
    xs, ys, zs = (interop.field_to_ints(
        c if isinstance(c, torch.Tensor) else np.asarray(c))
        for c in (p[0], p[1], p[2]))
    return [(x * pow(z, cv.P - 2, cv.P) % cv.P,
             y * pow(z, cv.P - 2, cv.P) % cv.P) for x, y, z in zip(xs, ys, zs)]


def test_double_scalar_mul_halved_matches_jax():
    """[u]P + [v]Q over 32 windows, seeded digits 0..15 and the points of
    seeded public keys, as affine points: the port's chain == JAX's.  On
    ROWS lanes, the shape of the chain inside the JAX verify_batch_antipa
    of test_verify_batch_antipa_matches_jax, which shares its loop."""
    rng = np.random.default_rng(17)
    n = ROWS
    pubs = np.array([list(ed.keypair_from_seed(rng.bytes(32))[0])
                     for _ in range(2 * n)], np.uint8)
    wins = rng.integers(0, 16, (2, 32, n)).astype(np.uint32)
    wins[:, -1, 0] = 15                     # a top window >= 8
    ok, pts = cv.decompress(torch.from_numpy(pubs))
    assert ok.all()
    p = cv.Point(*(c[:, :n] for c in pts))
    q = cv.Point(*(c[:, n:] for c in pts))
    got = cv.double_scalar_mul_halved(torch.from_numpy(wins[0]).long(),
                                      torch.from_numpy(wins[1]).long(), p, q)
    _, jpts = jcv.decompress(jnp.asarray(pubs))
    jp = jcv.Point(*(c[:, :n] for c in jpts))
    jq = jcv.Point(*(c[:, n:] for c in jpts))
    want = jcv.double_scalar_mul_halved(jnp.asarray(wins[0]),
                                        jnp.asarray(wins[1]), jp, jq)
    assert _affine(got) == _affine(want)


def _rows():
    """Eight rows: an honest one, a tampered R, S + L, A of order 8, and
    the torsion forgeries (order 2 with v even and odd, order 4 with v =
    0 mod 4 and not)."""
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(11, MAXLEN,
                                                              seed=91)
    pick = [kinds.index(k) for k in ("valid", "tampered_r", "s_plus_l",
                                      "a_order8")]
    m, ln, s, p = (np.ascontiguousarray(a[pick + pick])
                   for a in (msgs, lens, sigs, pubs))
    tmsg = bytes(range(32))
    for i, (sig, pub, *_) in enumerate(torsion_forgeries(tmsg), 4):
        m[i] = 0
        m[i, :32] = np.frombuffer(tmsg, np.uint8)
        ln[i] = 32
        s[i] = np.frombuffer(sig, np.uint8)
        p[i] = np.frombuffer(pub, np.uint8)
    return m, ln, s, p


def test_verify_batch_antipa_matches_jax():
    """The plain path's bits == JAX's verify_batch_antipa's (eager, at
    ROWS x JAX_ML: the rows past these and the bytes past a row are zero,
    and a lane's bit depends on its own row, to its length) == the host
    twin's, and the packed blob form's too: strict's bits on the honest
    and corrupted rows; on the torsion rows antipa accepts exactly the
    forgeries whose order divides v, where strict rejects them all."""
    m, ln, s, p = _rows()
    got = ed.verify_batch_antipa(*(torch.from_numpy(a) for a in (m, ln, s,
                                                                 p)))
    blob = ed.verify_blob_antipa(torch.from_numpy(tv.pack_blob(m, ln, s, p)))
    n = len(ln)
    pad = [np.zeros((ROWS, JAX_ML), np.uint8), np.zeros(ROWS, ln.dtype),
           np.zeros((ROWS, 64), np.uint8), np.zeros((ROWS, 32), np.uint8)]
    pad[0][:n, :m.shape[1]] = m
    for dst, a in zip(pad[1:], (ln, s, p)):
        dst[:n] = a
    want = np.asarray(jed.verify_batch_antipa(
        *(jnp.asarray(a) for a in pad))).tolist()[:n]
    host = [ed.verify_one_host_antipa(bytes(s[i]), bytes(m[i, :ln[i]]),
                                      bytes(p[i])) for i in range(len(m))]
    assert got.tolist() == blob.tolist() == want == host
    assert want == [True, False, False, False, True, False, True, False]
    strict = ed.verify_batch(*(torch.from_numpy(a) for a in (m, ln, s, p)))
    assert strict.tolist() == [True] + [False] * 7


def test_verify_batch_antipa_matches_strict_on_adversarial_rows():
    """Every adversarial kind of make_adversarial_batch (tampered R and
    message, S + L, A with no root, y = 0 with the sign bit, the
    identity, order 8, non-canonical y in A and R, all-zero padding):
    the antipa bits == strict's == the host twin's."""
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(33, MAXLEN,
                                                          seed=92)
    args = [torch.from_numpy(a) for a in (msgs, lens, sigs, pubs)]
    got = ed.verify_batch_antipa(*args).tolist()
    assert got == ed.verify_batch(*args).tolist() == tv.host_verify_blob(
        tv.pack_blob(msgs, lens, sigs, pubs), mode="antipa").tolist()
    assert any(got) and not all(got)


def test_verify_blob_antipa_clamps_lengths_as_the_host_twin():
    """Lengths past the row and below 0 are clamped to [0, ml], as the
    host twin clamps them (the JAX graph does not clamp, so it is not the
    reference here)."""
    msgs, lens, sigs, pubs = tv.make_example_batch(4, 48, seed=12,
                                                   lens=[48, 0, 17, 30])
    lens = np.array([200, -3, 17, 48], np.int32)
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    got = ed.verify_blob_antipa(torch.from_numpy(blob)).tolist()
    assert got == tv.host_verify_blob(blob, mode="antipa").tolist()
    assert got == [True, True, True, False]


def _golden():
    vecs = []
    for name in ("wycheproof", "cctv", "malleability"):
        with open(os.path.join(_GOLDEN, f"{name}_ed25519.json")) as f:
            vecs += json.load(f)
    return vecs


def test_host_twin_matches_jax_on_the_golden_corpora():
    """verify_one_host_antipa == JAX's on every wycheproof, cctv and
    malleability vector (the golden verdicts are strict's; antipa is
    lax on some of the torsion vectors)."""
    got, want = [], []
    for v in _golden():
        sig, msg, pub = (bytes.fromhex(v[k]) for k in ("sig", "msg", "pub"))
        got.append(ed.verify_one_host_antipa(sig, msg, pub))
        want.append(jed.verify_one_host_antipa(sig, msg, pub))
    assert got == want
    assert sum(got) > 0


def test_antipa_tail_edge_lanes_match_the_host():
    """The tail's plain version fed digests directly (the edge scalars
    and k + L, a c whose 32nd window is >= 8, the torsion rows, the
    prechecks' edges) == antipa_k_host on each lane."""
    rows = antipa_edge_lanes()
    b = torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8)
                         .reshape(len(rows), 160).copy())
    got = at.antipa_tail(b[:, :32], b[:, 32:64], b[:, 64:96], b[:, 96:])
    want = [ed.antipa_k_host(r[32:96], r[:32],
                             int.from_bytes(r[96:], "little") % L)
            for r in rows]
    assert got.tolist() == want
    assert sum(want) > len(want) // 2 and not all(want)
