"""The port's verify slice as a whole, on the CPU (the kernels' plain
versions).

The real conformance corpora (1,443 vectors) go through the port's
verify_batch and must give their golden bits and agree with the JAX
package's host verifier; zero rows and malformed lengths reject or clamp
as the host verifiers do; CPU tensors take the plain versions; device
resolution raises without a card.  The slice against the JAX package's
jitted verify_batch (the packed-blob path, the SigVerifier surfaces, the
three strict layouts, malformed lengths against the device graph) is
tests/test_torch_pipeline.py's, beside the pipeline, so that one compile
of the JAX reference serves every strict comparison.
"""

import json
import os

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
