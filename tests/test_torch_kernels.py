"""The port's CUDA kernels against their plain torch versions, on a GPU.

Marked `gpu`: each test decides inside the `cuda` fixture whether a card
is present and skips without one (this file's tests then count no pass).
On the card, `python3 chip_smoke.py` is the full check: the same
comparisons at the serving shapes, the corpora and the timed paths.
"""

import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import curve25519 as cv
from firedancer_tpu_torch.ops import decompress as dc
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import msm as ms
from firedancer_tpu_torch.ops import sha512_kernel as sk
from firedancer_tpu_torch.ops import verify_tail as vt

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cols(blob, ml):
    return (blob[:, :ml], blob[:, ml:ml + 32], blob[:, ml + 32:ml + 64],
            blob[:, ml + 64:ml + 96], blob[:, ml + 96:])


@pytest.mark.parametrize("n,ml", [(1, 0), (33, 300), (257, 1232)])
def test_sha512_kernel_matches_plain_and_hashlib(cuda, n, ml):
    rng = np.random.default_rng(n)
    lens = rng.integers(-2, ml + 3, n).astype(np.int32)
    msgs = rng.integers(0, 256, (n, ml), np.uint8)
    sigs = rng.integers(0, 256, (n, 64), np.uint8)
    pubs = rng.integers(0, 256, (n, 32), np.uint8)
    blob = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs))
    m, r, _, a, ln = _cols(blob.to(cuda), ml)
    before = sk.sha512_ram.launches
    got = sk.sha512_ram(m, r, a, ln).cpu()
    assert sk.sha512_ram.launches == before + 1
    m, r, _, a, ln = _cols(blob, ml)
    assert torch.equal(got, sk.sha512_ram_plain(m, r, a, ln))
    for i in range(n):
        k = max(0, min(int(lens[i]), ml))
        assert bytes(got[i].tolist()) == hashlib.sha512(
            bytes(sigs[i, :32]) + bytes(pubs[i]) + bytes(msgs[i, :k])).digest()


def test_verify_tail_kernel_matches_plain(cuda):
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(66, 64)
    blob = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs))

    def run(b):
        m, r, s, a, ln = _cols(b, 64)
        return vt.verify_tail(a, s, sk.sha512_ram(m, r, a, ln), r)

    before = vt.verify_tail.launches
    ok_k, x_k, z_k = (t.cpu() for t in run(blob.to(cuda)))
    assert vt.verify_tail.launches == before + 1
    ok_p, x_p, z_p = run(blob)
    assert torch.equal(ok_k, ok_p)
    assert fe.to_ints(x_k) == fe.to_ints(x_p)
    assert fe.to_ints(z_k) == fe.to_ints(z_p)


def test_sig_verifier_on_the_card_matches_host(cuda):
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(44, 128)
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    ver = tv.SigVerifier(tv.VerifierConfig(64, 128))
    assert ver.device.type == "cuda"
    verdict = ver.dispatch_blob(blob)
    verdict.copy_to_host_async()
    assert np.asarray(verdict).tolist() == ed.host_verify_blob(blob)


def _canon_equal(got, want) -> bool:
    return all(fe.to_ints(k.cpu()) == fe.to_ints(p.cpu())
               for k, p in zip(got, want))


@pytest.mark.parametrize("n", [1, 63, 1055])
def test_decompress_kernel_matches_plain(cuda, n):
    _, _, sigs, pubs, _ = tv.make_adversarial_batch(528, 16)
    b = torch.from_numpy(np.concatenate([pubs, sigs[:, :32]])[:n])
    before = dc.decompress.launches
    ok_k, sm_k, p_k = dc.decompress(b.to(cuda))
    assert dc.decompress.launches == before + 1
    ok_p, sm_p, p_p = dc.decompress_plain(b)
    assert torch.equal(ok_k.cpu(), ok_p) and torch.equal(sm_k.cpu(), sm_p)
    assert _canon_equal(p_k, p_p)


@pytest.mark.parametrize("select", ms.SELECTS)
@pytest.mark.parametrize("m,nwin", [(8, 64), (4, 32)])
def test_msm_kernel_matches_plain(cuda, select, m, nwin):
    """Per-lane accumulators over the negated decompressed keys (valid,
    small-order and off-curve ones) with random digits."""
    _, _, _, pubs, _ = tv.make_adversarial_batch(264, 16)
    _, _, pt = dc.decompress_plain(torch.from_numpy(pubs))
    pts = cv.neg(pt)
    wins = torch.from_numpy(np.random.default_rng(m).integers(
        0, 16, (nwin, len(pubs))))
    before = ms.msm_lanes.launches[select]
    got = ms.msm_lanes(wins.to(cuda), cv.Point(*(t.to(cuda) for t in pts)),
                       m, nwin, select)
    assert ms.msm_lanes.launches[select] == before + 1
    assert _canon_equal(got, cv.msm_lanes(wins, pts, m, nwin, select))


@pytest.mark.parametrize("m,nwin", [(9, 32), (2, 65)])
def test_msm_kernel_refuses_past_its_limits(cuda, m, nwin):
    before = ms.msm_lanes.launches["legacy"]
    with pytest.raises(ValueError, match="m <= 8 and nwin <= 64"):
        ms.msm_lanes(torch.zeros((nwin, 18), dtype=torch.uint8,
                                 device=cuda), cv.identity(18, cuda), m,
                     nwin, "legacy")
    assert ms.msm_lanes.launches["legacy"] == before


def test_rlc_verifier_on_the_card_matches_host(cuda):
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(64, 128)
    ver = tv.SigVerifier(tv.VerifierConfig(64, 128), mode="rlc")
    assert ver.device.type == "cuda"
    clean = tv.make_example_batch(64, 128, True, 3, sign_pool=64)
    assert np.asarray(ver(*clean)).all()
    verdict = ver(msgs, lens, sigs, pubs)
    verdict.copy_to_host_async()
    assert np.asarray(verdict).tolist() == ed.host_verify_blob(
        tv.pack_blob(msgs, lens, sigs, pubs))
