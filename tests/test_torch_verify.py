"""The port's verify slice as a whole, on the CPU (the kernels' plain
versions), against the JAX package.

One jitted ed.verify_batch shape (batch 16, maxlen 64) is the reference
for the packed-blob path: a module fixture compiles it once.  The real
conformance corpora (1,443 vectors) go through the port's verify_batch
and must give their golden bits and agree with the JAX package's host
verifier.  The serving surface (SigVerifier, its verdict future, device
resolution) is checked here too.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.models import verifier as jver
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch import _device, interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import sha512_kernel as sk
from firedancer_tpu_torch.ops import verify_tail as vt
from _torch_threads import one_torch_thread  # noqa: F401

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BATCH, MAXLEN = 16, 64


@pytest.fixture(scope="module")
def slice_batch():
    """Adversarial lanes plus ragged valid ones, with the JAX package's
    jitted verify_batch bits (one compile for the module)."""
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(BATCH, MAXLEN)
    rng = np.random.default_rng(11)
    ragged = rng.integers(0, MAXLEN + 1, BATCH - 11).astype(np.int32)
    m2, l2, s2, p2 = tv.make_example_batch(BATCH - 11, MAXLEN, True, 12,
                                           lens=ragged)
    msgs[11:], lens[11:], sigs[11:], pubs[11:] = m2, l2, s2, p2
    kinds[11:] = ["valid"] * (BATCH - 11)
    want = np.asarray(jax.jit(jed.verify_batch)(
        jnp.asarray(msgs), jnp.asarray(lens), jnp.asarray(sigs),
        jnp.asarray(pubs)))
    return msgs, lens, sigs, pubs, kinds, want


def test_verify_blob_matches_jax_verify_batch(slice_batch):
    msgs, lens, sigs, pubs, kinds, want = slice_batch
    blob_np = tv.pack_blob(msgs, lens, sigs, pubs)
    got = ed.verify_blob(interop.blob_from_numpy(blob_np, "cpu")).numpy()
    assert got.tolist() == want.tolist()
    assert [k for k, w in zip(kinds, want) if w] == [
        k for k in kinds if k == "valid"]
    assert got.tolist() == ed.host_verify_blob(blob_np)
    assert got.tolist() == jver.host_verify_blob(blob_np).tolist()


def test_verify_batch_four_arrays_matches_blob(slice_batch):
    msgs, lens, sigs, pubs, _, want = slice_batch
    got = ed.verify_batch(*interop.batch_from_numpy(msgs, lens, sigs, pubs,
                                                    "cpu"))
    assert got.numpy().tolist() == want.tolist()


def test_sig_verifier_dispatch_surfaces(slice_batch):
    msgs, lens, sigs, pubs, _, want = slice_batch
    ver = tv.SigVerifier(tv.VerifierConfig(BATCH, MAXLEN), device="cpu")
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    for verdict in (ver.dispatch_blob(blob), ver(msgs, lens, sigs, pubs),
                    ver.packed_dispatch(msgs, lens, sigs, pubs)):
        assert verdict.is_ready()
        verdict.copy_to_host_async()
        assert np.asarray(verdict).tolist() == want.tolist()
    with pytest.raises(ValueError):
        ver.dispatch_blob(np.zeros((BATCH + 1, MAXLEN + ed.PACKED_EXTRA),
                                   np.uint8))


def test_padding_rows_and_malformed_lengths_reject():
    """Zero rows (pipeline padding) reject; a length past ml or below 0
    is clamped as the host verifier clamps it."""
    msgs, lens, sigs, pubs = tv.make_example_batch(4, 32, True, 3)
    lens = lens.copy()
    lens[1], lens[2] = 1000, -7
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    blob[3] = 0
    got = ed.verify_blob(torch.from_numpy(blob)).tolist()
    assert got == ed.host_verify_blob(blob)
    assert got == jver.host_verify_blob(blob).tolist()
    assert got[0] and not got[3]


def test_cpu_tensors_take_the_plain_versions():
    """No kernel launches for CPU tensors: the launch counters stay put."""
    before = (sk.sha512_ram.launches, vt.verify_tail.launches)
    msgs, lens, sigs, pubs = tv.make_example_batch(2, 16, True, 4)
    assert ed.verify_blob(torch.from_numpy(
        tv.pack_blob(msgs, lens, sigs, pubs))).all()
    assert (sk.sha512_ram.launches, vt.verify_tail.launches) == before


def test_default_device_is_the_gpu(monkeypatch):
    """device=None resolves to CUDA, and raises where there is none: no
    silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.SigVerifier(tv.VerifierConfig(4, 16))
    assert _device.resolve_device("cpu") == torch.device("cpu")


def _corpus():
    vecs = []
    for name in ("wycheproof", "cctv", "malleability"):
        with open(os.path.join(_GOLDEN, f"{name}_ed25519.json")) as f:
            vecs += [(bytes.fromhex(v["msg"]), bytes.fromhex(v["sig"]),
                      bytes.fromhex(v["pub"]), v["ok"]) for v in json.load(f)]
    return vecs


def test_real_corpora_through_the_port():
    """All 1,443 Wycheproof / CCTV / malleability vectors through the
    port's verify_batch: golden bits, and the JAX package's host verifier
    agrees lane by lane."""
    vecs = _corpus()
    assert len(vecs) == 133 + 914 + 396
    maxlen = max(len(v[0]) for v in vecs)
    msgs = np.zeros((len(vecs), maxlen), np.uint8)
    lens = np.array([len(v[0]) for v in vecs], np.int32)
    for i, v in enumerate(vecs):
        msgs[i, :len(v[0])] = np.frombuffer(v[0], np.uint8)
    sigs = np.array([list(v[1]) for v in vecs], np.uint8)
    pubs = np.array([list(v[2]) for v in vecs], np.uint8)
    got = ed.verify_batch(*interop.batch_from_numpy(
        msgs, lens, sigs, pubs, "cpu")).tolist()
    assert got == [v[3] for v in vecs]
    assert got == [jed.verify_one_host(v[1], v[0], v[2]) for v in vecs]
    assert got == [ed.verify_one_host(v[1], v[0], v[2]) for v in vecs]


def test_host_signer_matches_jax_package():
    seed = bytes(range(32))
    assert ed.keypair_from_seed(seed)[0] == jed.keypair_from_seed(seed)[0]
    assert ed.sign(seed, b"abc") == jed.sign(seed, b"abc")
