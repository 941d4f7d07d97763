"""The three strict layouts on the CPU (the kernels' plain versions):
verify_batch(tail="fused" | "split" | "unfused") and
SigVerifier(strict_tail=...) give the same bits, those of the host
verifier and of the golden corpora; and the JAX package's device graph
on malformed message lengths, beside the port and both host verifiers.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.models import verifier as jver
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import decompress as dc
from firedancer_tpu_torch.ops import dsm
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import reduce_recode as rr
from firedancer_tpu_torch.ops import verify_tail as vt

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _adversarial(n: int = 30, maxlen: int = 64):
    """make_adversarial_batch's lanes (a tampered R or message, S + L, a
    key with no square root, y = 0 with the sign bit, the identity and
    an order-8 point as A, non-canonical y in A or R, zero padding with
    length 0), plus R of small order: the identity and an order-8 point."""
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(n, maxlen)
    for i, y in ((n - 2, 1), (n - 1, ed.cv.ORDER8_Y0)):
        sigs[i, :32] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
        kinds[i] = "r_small_order"
    return msgs, lens, sigs, pubs, kinds


def _launches():
    return (vt.verify_tail.launches, dc.decompress.launches,
            rr.reduce_recode.launches, dsm.dsm_tail_q.launches,
            dsm.double_scalar_mul_base.launches)


def test_layouts_agree_on_adversarial_lanes():
    msgs, lens, sigs, pubs, kinds = _adversarial()
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    host = ed.host_verify_blob(blob)
    assert host == jver.host_verify_blob(blob).tolist()
    assert [k for k, h in zip(kinds, host) if h] == [
        "valid"] * kinds.count("valid")
    before = _launches()
    arrays = interop.batch_from_numpy(msgs, lens, sigs, pubs, "cpu")
    for tail in ed.TAILS:
        assert ed.verify_blob(torch.from_numpy(blob), tail=tail).tolist() \
            == host, tail
        assert ed.verify_batch(*arrays, tail=tail).tolist() == host, tail
    assert _launches() == before          # CPU tensors launch nothing


def test_unknown_tail_is_refused():
    msgs, lens, sigs, pubs = tv.make_example_batch(2, 16, True, 5)
    with pytest.raises(ValueError, match="unknown strict tail"):
        ed.verify_batch(*interop.batch_from_numpy(msgs, lens, sigs, pubs,
                                                  "cpu"), tail="splt")
    with pytest.raises(ValueError, match="unknown strict_tail"):
        tv.SigVerifier(tv.VerifierConfig(2, 16), device="cpu",
                       strict_tail="fused2")


def test_corpus_every_eighth_vector_in_each_layout():
    vecs = []
    for name in ("wycheproof", "cctv", "malleability"):
        with open(os.path.join(_GOLDEN, f"{name}_ed25519.json")) as f:
            vecs += json.load(f)
    vecs = vecs[::8]
    msgs_b = [bytes.fromhex(v["msg"]) for v in vecs]
    ml = max(len(m) for m in msgs_b)
    msgs = np.zeros((len(vecs), ml), np.uint8)
    for i, m in enumerate(msgs_b):
        msgs[i, :len(m)] = np.frombuffer(m, np.uint8)
    lens = np.array([len(m) for m in msgs_b], np.int32)
    sigs = np.array([list(bytes.fromhex(v["sig"])) for v in vecs], np.uint8)
    pubs = np.array([list(bytes.fromhex(v["pub"])) for v in vecs], np.uint8)
    golden = [v["ok"] for v in vecs]
    assert any(golden) and not all(golden)
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    for tail in ed.TAILS:
        ver = tv.SigVerifier(tv.VerifierConfig(len(vecs), ml), device="cpu",
                             strict_tail=tail)
        assert np.asarray(ver.dispatch_blob(blob)).tolist() == golden, tail


@pytest.mark.parametrize("tail", ["split", "unfused"])
def test_sig_verifier_surfaces_in_each_layout(tail):
    """dispatch_blob, __call__ and packed_dispatch in the layout, and the
    rlc mode's strict leaves: one forged S settles to exact bits."""
    msgs, lens, sigs, pubs, _ = _adversarial(22, 48)
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    host = ed.host_verify_blob(blob)
    ver = tv.SigVerifier(tv.VerifierConfig(22, 48), device="cpu",
                         strict_tail=tail)
    assert ver.strict_tail == tail
    for verdict in (ver.dispatch_blob(blob), ver(msgs, lens, sigs, pubs),
                    ver.packed_dispatch(msgs, lens, sigs, pubs)):
        assert np.asarray(verdict).tolist() == host
    clean = tv.make_example_batch(16, 48, True, 6, sign_pool=16)
    bad = clean[2].copy()
    bad[9, 40] ^= 1
    rver = tv.SigVerifier(tv.VerifierConfig(16, 48), mode="rlc", msm_m=4,
                          device="cpu", rng=np.random.default_rng(7),
                          strict_tail=tail)
    assert rver._fn.keywords == {"tail": tail}
    bits = np.asarray(rver(clean[0], clean[1], bad, clean[3]))
    assert bits.tolist() == [i != 9 for i in range(16)]


def test_malformed_lengths_against_the_jax_device_graph():
    """Lengths outside [0, ml], through the JAX package's verify_batch run
    eagerly (its XLA graph, not jitted), the port's three layouts and
    both host verifiers, on these lanes (ml = 64):
      0: len = ml + 16, signed over the row's bytes and 16 zero bytes;
      1: len = -1, signed over the empty message;
      2: len = 2^31 - 1, signed over the row's ml bytes;
      3: len = ml, a valid signature.
    The port and both host verifiers clamp a length to [0, ml] (no kernel
    reads past its row): lanes 1-3 accept, lane 0 rejects.  The JAX
    device graph does not clamp: it hashes past the row (zeros) for lane
    0 and accepts it; it hashes a 63-byte prefix of R || A for lane 1 and
    a wrapped int32 length for lane 2, and rejects both.  That is a fault
    of the reference (its device graph disagrees with its own host
    verifier), pinned here as it stands until both packages settle it
    together (ROADMAP section 3)."""
    ml = 64
    seed = bytes(range(32))
    pub = ed.keypair_from_seed(seed)[0]
    msg = np.random.default_rng(8).bytes(ml)
    rows = [(ml + 16, ed.sign(seed, msg + bytes(16))),
            (-1, ed.sign(seed, b"")),
            (2**31 - 1, ed.sign(seed, msg)),
            (ml, ed.sign(seed, msg))]
    n = len(rows)
    msgs = np.tile(np.frombuffer(msg, np.uint8), (n, 1))
    lens = np.array([ln for ln, _ in rows], np.int32)
    sigs = np.array([list(sg) for _, sg in rows], np.uint8)
    pubs = np.tile(np.frombuffer(pub, np.uint8), (n, 1))
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    clamped = [False, True, True, True]
    assert ed.host_verify_blob(blob) == clamped
    assert jver.host_verify_blob(blob).tolist() == clamped
    for tail in ed.TAILS:
        assert ed.verify_blob(torch.from_numpy(blob),
                              tail=tail).tolist() == clamped, tail
    device = np.asarray(jed.verify_batch(
        jnp.asarray(msgs), jnp.asarray(lens), jnp.asarray(sigs),
        jnp.asarray(pubs)))
    assert device.tolist() == [True, False, False, True]
