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
from firedancer_tpu_torch.ops import dsm
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import msm as ms
from firedancer_tpu_torch.ops import reduce_recode as rr
from firedancer_tpu_torch.ops import rlc_recode as rl
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


# lane counts of the four-rank chain kernels (verify_tail, dsm_tail_q):
# blocks of 8 lanes, so 1 and 7 give a partial block alone, 4095 and 4097
# a partial last block
_CHAIN_SHAPES = [1, 7, 8, 66, 4095, 4097]


@pytest.mark.parametrize("n", _CHAIN_SHAPES)
def test_verify_tail_kernel_matches_plain(cuda, n):
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(n, 64)
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
@pytest.mark.parametrize("m,nwin", [(8, 64), (4, 32), (3, 16), (1, 64),
                                    (2, 32), (5, 16), (6, 64), (7, 32)])
def test_msm_kernel_matches_plain(cuda, select, m, nwin):
    """Per-lane accumulators over the negated decompressed keys (valid,
    small-order and off-curve ones) with random digits, on the largest
    multiple of m of 264 points: m 3 gives a lane tree with an odd
    partial and blocks of 10 lanes, the last one partial; m 1 no tree;
    m 2, 5, 6 and 7 leave 0, 2, 2 and 4 threads of a warp without a point,
    and a partial last block."""
    _, _, _, pubs, _ = tv.make_adversarial_batch(264, 16)
    pubs = pubs[:len(pubs) - len(pubs) % m]
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


_L = 2**252 + 27742317777372353535851937790883648493


def _scalar_rows(n: int, seed: int, dev):
    """s (n, 32), digest (n, 64) and z (n, 16) as row views of one
    (n, 120) buffer on the device (row stride 120), edges first: S = L -
    1, L and 2^256 - 1, a digest of all 0xff, z = 0 and 2^128 - 1; S
    non-canonical in half the other lanes."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, (n, 120), np.uint8)
    buf[::2, 31] &= 0x0F
    for i, v in enumerate((_L - 1, _L, 2**256 - 1)[:n]):
        buf[i, :32] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    buf[:2, 32:96] = 0xFF
    buf[0, 96:112] = 0
    buf[1:2, 96:112] = 0xFF
    t = torch.from_numpy(buf).to(dev)
    return t[:, :32], t[:, 32:96], t[:, 96:112]


def _scaled_points(n: int, dev) -> cv.Point:
    """Decompressed keys and R values of adversarial lanes (off-curve and
    small-order ones included), scaled by a random lambda: Z != 1."""
    _, _, sigs, pubs, _ = tv.make_adversarial_batch((n + 1) // 2 + 1, 16)
    b = torch.from_numpy(np.concatenate([pubs, sigs[:, :32]])[:n]).to(dev)
    _, _, pt = dc.decompress_plain(b)
    rng = np.random.default_rng(n)
    lam = fe.from_ints([int.from_bytes(rng.bytes(32), "little") % fe.P
                        for _ in range(n)], dev)
    return cv.Point(*(fe.mul(c, lam) for c in pt))


_SHAPES = [1, 31, 4096, 4097]


@pytest.mark.parametrize("n", _SHAPES)
def test_reduce_recode_kernel_matches_plain(cuda, n):
    s, digest, _ = _scalar_rows(n, n, cuda)
    assert s.stride(0) == 120
    before = rr.reduce_recode.launches
    ok_k, wins_k = rr.reduce_recode(s, digest)
    assert rr.reduce_recode.launches == before + 1
    ok_p, wins_p = rr.reduce_recode_plain(s, digest)
    assert torch.equal(ok_k, ok_p)
    assert all(torch.equal(k, p) for k, p in zip(wins_k, wins_p))


@pytest.mark.parametrize("n", _SHAPES)
def test_rlc_recode_kernel_matches_plain(cuda, n):
    s, digest, z = _scalar_rows(n, n + 1, cuda)
    before = rl.rlc_recode.launches
    got = rl.rlc_recode(s, digest, z)
    assert rl.rlc_recode.launches == before + 1
    want = rl.rlc_recode_plain(s, digest, z)
    assert all(torch.equal(k, p) for k, p in zip(got, want))


@pytest.mark.parametrize("n", sorted({*_SHAPES, *_CHAIN_SHAPES}))
def test_dsm_tail_q_kernel_matches_plain(cuda, n):
    """The split layout's chain from reduce_recode's windows (the block
    taken in place) and from windows in separate int64 tensors (copied),
    A with Z != 1, y_R of random bytes."""
    s, digest, z = _scalar_rows(n, n + 2, cuda)
    _, wins = rr.reduce_recode(s, digest)
    a = _scaled_points(n, cuda)
    y_r = fe.from_bytes(torch.cat([z, z], 1))
    want = dsm.dsm_tail_q_plain(wins, a, y_r)
    for w in (wins, tuple(x.long() for x in wins)):
        before = dsm.dsm_tail_q.launches
        got = dsm.dsm_tail_q(w, a, y_r)
        assert dsm.dsm_tail_q.launches == before + 1
        assert torch.equal(got[0], want[0])
        assert _canon_equal(got[1:], want[1:])


@pytest.mark.parametrize("n", _SHAPES)
def test_double_scalar_mul_base_kernel_matches_plain(cuda, n):
    a = _scaled_points(n, cuda)
    w = torch.from_numpy(np.random.default_rng(n).integers(
        0, 16, (2, 64, n))).to(cuda)
    w[:, 63, :8] = 15                   # recodes that carry out of the top
    before = dsm.double_scalar_mul_base.launches
    got = dsm.double_scalar_mul_base(w[0], w[1], a)
    assert dsm.double_scalar_mul_base.launches == before + 1
    assert _canon_equal(got, dsm.double_scalar_mul_base_plain(w[0], w[1], a))


@pytest.mark.parametrize("tail", ed.TAILS)
def test_strict_layouts_on_the_card_match_host(cuda, tail):
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(44, 128)
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    ver = tv.SigVerifier(tv.VerifierConfig(64, 128), strict_tail=tail)
    assert np.asarray(ver.dispatch_blob(blob)).tolist() == \
        ed.host_verify_blob(blob)
