"""verify_batch_rlc's batch bit, one golden vector at a time: each vector
alone among m - 1 valid signatures, against the exact batch equation on
Python ints (ed25519.rlc_batch_host) and against golden.

The vectors are one of each kind the corpora hold among those that pass
the prechecks, told apart by whether A or R has a part of small order and
by the order of the residual [S]B - R - [k]A.  Where neither A nor R has
one, z does not matter and the bit is golden's.  Where one has, the bit
depends on z: the batch equation is cofactorless, and a residual of small
order vanishes for 1 in ord draws of z (the JAX package's check is the
same; ROADMAP section 3).  Those vectors run with z = 0 mod 8 and with z
odd.  The vectors that fail the prechecks run together, and their lanes'
prechecks must be the host's.
"""

import json
import os

import numpy as np
import pytest
import torch

from firedancer_tpu_torch import interop
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import ed25519 as ed
from _torch_threads import one_torch_thread  # noqa: F401

M, MAXLEN = 4, 64
_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# (index in wycheproof + cctv + malleability, small-order part in A or R,
# what the vector is)
ALONE = [
    (0, False, "wycheproof, accepted"),
    (31, False, "wycheproof, residual of prime order"),
    (438, False, "cctv, accepted"),
    (1047, False, "malleability, accepted"),
    (29, True, "wycheproof, R of mixed order, residual of prime order"),
    (183, True, "cctv, A of mixed order, accepted"),
    (140, True, "cctv, A and R of mixed order, accepted"),
    (521, True, "cctv, R of mixed order, residual of order 2"),
    (966, True, "cctv, A of mixed order, residual of order 2"),
    (249, True, "cctv, A and R of mixed order, residual of order 2"),
    (400, True, "cctv, R of mixed order, residual of order 4"),
    (184, True, "cctv, A of mixed order, residual of order 4"),
    (139, True, "cctv, A and R of mixed order, residual of order 4"),
    (469, True, "cctv, R of mixed order, residual of order 8"),
    (572, True, "cctv, A of mixed order, residual of order 8"),
    (218, True, "cctv, A and R of mixed order, residual of order 8"),
]
# R alone has the small-order part and the residual is of small order:
# the batch check accepts these forgeries whenever ord divides z
R_ONLY_SMALL_RESIDUAL = (521, 400, 469)
# S >= L, A or R that does not decode, A or R of small order
FAIL_PRECHECKS = (12, 19, 9, 191, 133, 1247, 1255)


@pytest.fixture(scope="module")
def corpus():
    vecs = []
    for name in ("wycheproof", "cctv", "malleability"):
        with open(os.path.join(_GOLDEN, f"{name}_ed25519.json")) as f:
            vecs += [(bytes.fromhex(v["sig"]), bytes.fromhex(v["msg"]),
                      bytes.fromhex(v["pub"]), v["ok"]) for v in json.load(f)]
    return vecs


@pytest.fixture(scope="module")
def pads():
    msgs, lens, sigs, pubs = tv.make_example_batch(M - 1, MAXLEN, True, 71)
    return [(bytes(s), bytes(m[:n]), bytes(p))
            for m, n, s, p in zip(msgs, lens, sigs, pubs)]


def _rlc_bit(rows, zs, select):
    """(device bit, prechecks, exact host bit) of one batch of (sig, msg,
    pub) rows with z values zs."""
    msgs = np.zeros((len(rows), MAXLEN), np.uint8)
    for i, (_, m, _) in enumerate(rows):
        msgs[i, :len(m)] = np.frombuffer(m, np.uint8)
    lens = np.array([len(m) for _, m, _ in rows], np.int32)
    sigs = np.array([list(s) for s, _, _ in rows], np.uint8)
    pubs = np.array([list(p) for _, _, p in rows], np.uint8)
    z = np.array([list(v.to_bytes(16, "little")) for v in zs], np.uint8)
    ok, pre = ed.verify_batch_rlc(
        *interop.batch_from_numpy(msgs, lens, sigs, pubs, "cpu"),
        torch.from_numpy(z), m=M, select=select)
    host = ed.rlc_batch_host([r[0] for r in rows], [r[1] for r in rows],
                             [r[2] for r in rows], zs)
    return bool(ok), pre.tolist(), host


@pytest.mark.parametrize("idx,torsion,what", ALONE,
                         ids=[str(a[0]) for a in ALONE])
def test_vector_alone_matches_the_exact_batch_equation(corpus, pads, idx,
                                                       torsion, what):
    sig, msg, pub, golden = corpus[idx]
    _, a, r = ed.prechecks_host(sig, pub)
    assert torsion == (ed.has_torsion_host(a) or ed.has_torsion_host(r))
    rng = np.random.default_rng(idx)
    pad_z = [int.from_bytes(rng.bytes(16), "little") for _ in pads]
    z = int.from_bytes(rng.bytes(16), "little")
    draws = ([(z & ~7, "legacy"), (z | 1, "p16")] if torsion
             else [(z, "legacy")])
    bits = []
    for zv, select in draws:
        bit, pre, host = _rlc_bit([(sig, msg, pub)] + pads, [zv] + pad_z,
                                  select)
        assert pre == [True] * M
        assert bit == host, (zv % 8, select)
        bits.append(bit)
    if not torsion:
        assert bits == [golden]
    if idx in R_ONLY_SMALL_RESIDUAL:
        assert not golden and bits == [True, False]


def test_precheck_failures_show_per_lane(corpus, pads):
    rows = [corpus[i][:3] for i in FAIL_PRECHECKS] + [pads[0]]
    assert len(rows) % M == 0
    zs = [int.from_bytes(np.random.default_rng(i).bytes(16), "little")
          for i in range(len(rows))]
    bit, pre, host = _rlc_bit(rows, zs, "legacy")
    assert pre == [ed.prechecks_host(s, p) is not None
                   for s, _, p in rows] == [False] * (len(rows) - 1) + [True]
    assert not bit and not host
