"""The strict finish (firedancer_tpu_torch/ops/r_check.py) on the CPU, where
r_check runs its plain version, and the three strict layouts that end
with it, against the JAX package.

Seeded rows (adversarial lanes and ragged valid ones) go through the
port's verify_blob in each layout, the JAX package's jitted verify_batch
(one compile, at the shape tests/test_torch_verify.py compiles) and both
host verifiers; the 1,443 Wycheproof / CCTV / malleability vectors go
through each layout against their golden bits.  The kernel against the
plain version is tests/test_torch_kernels.py's (marked gpu).
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
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import r_check as rc
from _torch_threads import one_torch_thread  # noqa: F401

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BATCH, MAXLEN = 16, 64


@pytest.fixture(scope="module")
def rows():
    """Adversarial lanes, then ragged valid ones, as a packed blob, with
    the JAX package's jitted verify_batch bits."""
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(BATCH, MAXLEN,
                                                              seed=17)
    m2, l2, s2, p2 = tv.make_example_batch(
        BATCH - 11, MAXLEN, True, 18,
        lens=np.random.default_rng(19).integers(0, MAXLEN + 1, BATCH - 11))
    msgs[11:], lens[11:], sigs[11:], pubs[11:] = m2, l2, s2, p2
    kinds[11:] = ["valid"] * (BATCH - 11)
    want = np.asarray(jax.jit(jed.verify_batch)(
        jnp.asarray(msgs), jnp.asarray(lens), jnp.asarray(sigs),
        jnp.asarray(pubs)))
    return tv.pack_blob(msgs, lens, sigs, pubs), kinds, want


@pytest.mark.parametrize("tail", ed.TAILS)
def test_layouts_match_jax_verify_batch_and_host(rows, tail):
    blob_np, kinds, want = rows
    got = ed.verify_blob(interop.blob_from_numpy(blob_np, "cpu"),
                         tail=tail).tolist()
    assert got == want.tolist()
    assert got == ed.host_verify_blob(blob_np)
    assert got == jver.host_verify_blob(blob_np).tolist()
    assert [k for k, b in zip(kinds, got) if b] == [
        k for k in kinds if k == "valid"]


def _corpus_blob():
    vecs = []
    for name in ("wycheproof", "cctv", "malleability"):
        with open(os.path.join(_GOLDEN, f"{name}_ed25519.json")) as f:
            vecs += json.load(f)
    msgs = [bytes.fromhex(v["msg"]) for v in vecs]
    ml = max(map(len, msgs))
    m = np.zeros((len(vecs), ml), np.uint8)
    for i, x in enumerate(msgs):
        m[i, :len(x)] = np.frombuffer(x, np.uint8)
    sigs = np.array([list(bytes.fromhex(v["sig"])) for v in vecs], np.uint8)
    pubs = np.array([list(bytes.fromhex(v["pub"])) for v in vecs], np.uint8)
    lens = np.array(list(map(len, msgs)), np.int32)
    return tv.pack_blob(m, lens, sigs, pubs), [v["ok"] for v in vecs]


@pytest.mark.parametrize("tail", ed.TAILS)
def test_layouts_give_the_corpora_golden_bits(tail):
    """All 1,443 vectors through verify_blob in each layout."""
    blob_np, golden = _corpus_blob()
    assert len(golden) == 133 + 914 + 396
    got = ed.verify_blob(torch.from_numpy(blob_np), tail=tail).tolist()
    assert got == golden


def test_r_check_forms_and_arguments():
    """Exactly one of ok_y and qy; no lanes give an empty bool; the ok_y
    form passes the caller's y-compare through."""
    n = 3
    one = fe.ones(n, "cpu")
    r = torch.zeros((n, 32), dtype=torch.uint8)
    r[:, 0] = 5                       # y = 5, no small order
    with pytest.raises(ValueError, match="exactly one"):
        rc.r_check(one, one, r)
    with pytest.raises(ValueError, match="exactly one"):
        rc.r_check(one, one, r, torch.ones(n, dtype=torch.bool), qy=one)
    empty = fe.ones(0, "cpu")
    for got in (rc.r_check(empty, empty, r[:0],
                           torch.ones(0, dtype=torch.bool)),
                rc.r_check(empty, empty, r[:0], qy=empty)):
        assert got.dtype == torch.bool and got.shape == (0,)
    ok_y = torch.tensor([True, False, True])
    # x = 1 (odd) against R's sign bit 0, then 1
    assert rc.r_check(one, one, r, ok_y).tolist() == [False] * 3
    r[:, 31] = 0x80
    assert rc.r_check(one, one, r, ok_y).tolist() == [True, False, True]
