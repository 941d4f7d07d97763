"""The port's verify_batch_rlc against the JAX package's, jitted, with the
same z on both sides: the batch bit and the per-lane prechecks must be
equal on a clean batch, a batch with one forged S, a batch with one
non-canonical S and a batch of the adversarial lane kinds, for both MSM
selects of the port.  One more batch holds a golden vector whose R is
of mixed order: both packages accept it under a z that the small-order
part divides, though the strict rules reject it (ROADMAP section 3).

The JAX function runs under jax.jit, as every caller runs it (used
eagerly it crashes this jaxlib's CPU compiler, see
tests/test_ed25519_rlc.py).  Its one compile, shared by the module, takes
minutes on a CPU host: this file holds nothing else.  Each batch is a
case a select, so the module's many cases put it early in a
file-by-file schedule of workers (pytest-xdist's loadfile orders files
by their count of tests), where its compile overlaps the others'.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops.msm import SELECTS
from _torch_threads import one_torch_thread  # noqa: F401

BATCH, MAXLEN, M = 16, 64, 4


def _clean():
    return tv.make_example_batch(BATCH, MAXLEN, True, 61, sign_pool=BATCH)


def _forged_s():
    msgs, lens, sigs, pubs = _clean()
    sigs[7, 40] ^= 1                     # S stays canonical
    return msgs, lens, sigs, pubs


def _noncanonical_s():
    msgs, lens, sigs, pubs = _clean()
    sigs[3, 32:] = 0xFF
    return msgs, lens, sigs, pubs


def _adversarial():
    return tv.make_adversarial_batch(BATCH, MAXLEN, seed=62)[:4]


BATCHES = {"clean": _clean, "forged_s": _forged_s,
           "noncanonical_s": _noncanonical_s, "adversarial": _adversarial}


@pytest.fixture(scope="module")
def jax_rlc():
    return jax.jit(functools.partial(jed.verify_batch_rlc, m=M))


@pytest.mark.parametrize("select", SELECTS)
@pytest.mark.parametrize("name", list(BATCHES))
def test_verify_batch_rlc_matches_jax(jax_rlc, name, select):
    arrs = BATCHES[name]()
    z = np.random.default_rng(len(name)).integers(0, 256, (BATCH, 16),
                                                  np.uint8)
    want_ok, want_pre = (np.asarray(t) for t in jax_rlc(*arrs, z))
    args = interop.batch_from_numpy(*arrs, "cpu")
    ok, pre = ed.verify_batch_rlc(*args, torch.from_numpy(z), m=M,
                                  select=select)
    assert bool(ok) == bool(want_ok)
    assert pre.tolist() == want_pre.tolist()
    assert bool(want_ok) == (name == "clean")
    if name == "noncanonical_s":
        assert want_pre.tolist() == [i != 3 for i in range(BATCH)]


@pytest.mark.parametrize("select", SELECTS)
@pytest.mark.parametrize("z_low", [0, 1])
def test_mixed_order_r_passes_under_even_z_in_both_packages(jax_rlc, z_low,
                                                            select):
    """cctv vector 388: R has a part of order 2 and the residual [S]B - R
    - [k]A is that part, so the batch equation holds for every even z."""
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "cctv_ed25519.json")) as f:
        vec = json.load(f)[388]
    sig, msg, pub = (bytes.fromhex(vec[k]) for k in ("sig", "msg", "pub"))
    msgs, lens, sigs, pubs = _clean()
    msgs[5] = 0
    msgs[5, :len(msg)] = np.frombuffer(msg, np.uint8)
    lens[5] = len(msg)
    sigs[5], pubs[5] = np.frombuffer(sig, np.uint8), np.frombuffer(pub,
                                                                   np.uint8)
    z = np.random.default_rng(388).integers(0, 256, (BATCH, 16), np.uint8)
    z[5, 0] = (z[5, 0] & 0xF8) | z_low
    want_ok, want_pre = (np.asarray(t) for t in jax_rlc(msgs, lens, sigs,
                                                        pubs, z))
    args = interop.batch_from_numpy(msgs, lens, sigs, pubs, "cpu")
    ok, pre = ed.verify_batch_rlc(*args, torch.from_numpy(z), m=M,
                                  select=select)
    assert bool(ok) == bool(want_ok)
    assert pre.tolist() == want_pre.tolist()
    assert want_pre.all() and not vec["ok"]
    assert not ed.verify_one_host(sig, msg, pub)
    assert bool(want_ok) == (z_low == 0)
    zs = [int.from_bytes(bytes(r), "little") for r in z]
    assert ed.rlc_batch_host([bytes(r) for r in sigs],
                             [bytes(m[:n]) for m, n in zip(msgs, lens)],
                             [bytes(r) for r in pubs], zs) == bool(want_ok)
