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
from firedancer_tpu_torch.ops import r_check as rc
from firedancer_tpu_torch.ops import reduce_recode as rr
from firedancer_tpu_torch.ops import rlc_recode as rl
from firedancer_tpu_torch.ops import scalar25519 as sc
from firedancer_tpu_torch.ops import sha512_kernel as sk
from firedancer_tpu_torch.ops import verify_tail as vt
from chip_smoke import write_r_edges

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


@pytest.mark.parametrize("n", [1, 33, 4097])
def test_sha512_kernel_on_unaligned_rows(cuda, n):
    """A packed blob of ml 127 (rows 227 bytes apart, R at column 127):
    the kernel stages by byte loads, and still equals hashlib."""
    ml = 127
    rng = np.random.default_rng(n + ml)
    lens = rng.integers(0, ml + 1, n).astype(np.int32)
    msgs = rng.integers(0, 256, (n, ml), np.uint8)
    sigs = rng.integers(0, 256, (n, 64), np.uint8)
    pubs = rng.integers(0, 256, (n, 32), np.uint8)
    blob = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs)).to(cuda)
    m, r, _, a, ln = _cols(blob, ml)
    assert m.stride(0) % 4 and r.data_ptr() % 4
    got = sk.sha512_ram(m, r, a, ln).cpu()
    for i in range(n):
        assert bytes(got[i].tolist()) == hashlib.sha512(
            bytes(sigs[i, :32]) + bytes(pubs[i]) + bytes(msgs[i, :lens[i]])
        ).digest()


# lane counts of the four-rank chain kernels (verify_tail, dsm_tail_q,
# double_scalar_mul_base):
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


@pytest.mark.parametrize("n", [1, 33, 4096, 4097])
def test_r_check_kernel_matches_plain(cuda, n):
    """The finish in both forms on the fused tail's and the unfused
    chain's Q of adversarial rows, the edge lanes (chip_smoke's
    r_check_edges) written over the first ones, R read in place from the
    blob: the kernel's bits equal the plain version's, one launch a
    call."""
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(n, 64)
    blob = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs)).to(cuda)
    m, r, s, a, ln = _cols(blob, 64)
    digest = sk.sha512_ram(m, r, a, ln)
    ok_t, qx, qz = vt.verify_tail(a, s, digest, r)
    q = dsm.double_scalar_mul_base(
        sc.scalar_windows(s), sc.limbs_to_windows(sc.reduce_512(digest)),
        cv.neg(dc.decompress(a)[2]))
    qy = q.Y.clone()
    write_r_edges(qx, qz, qy, ok_t, r)
    write_r_edges(q.X, q.Z, q.Y, ok_t.clone(), r)
    for args, kw in (((qx, qz, r, ok_t), {}),
                     ((q.X, q.Z, r), {"qy": q.Y})):
        before = rc.r_check.launches
        got = rc.r_check(*args, **kw)
        assert rc.r_check.launches == before + 1
        assert torch.equal(got, rc.r_check_plain(*args, **kw))


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


@pytest.mark.parametrize("n", [1, 63, 1055, 70001])
def test_decompress_kernel_matches_plain(cuda, n):
    """The adversarial encodings, repeated to n lanes: 70001 lanes are
    more than one wave of the card's resident threads, so a thread takes
    two lanes."""
    _, _, sigs, pubs, _ = tv.make_adversarial_batch(528, 16)
    enc = np.concatenate([pubs, sigs[:, :32]])
    b = torch.from_numpy(np.tile(enc, (-(-n // len(enc)), 1))[:n])
    before = dc.decompress.launches
    ok_k, sm_k, p_k = dc.decompress(b.to(cuda))
    assert dc.decompress.launches == before + 1
    assert ok_k.dtype == sm_k.dtype == torch.bool
    assert all(t.is_contiguous() and t.shape == (fe.NLIMB, n) for t in p_k)
    ok_p, sm_p, p_p = dc.decompress_plain(b)
    assert torch.equal(ok_k.cpu(), ok_p) and torch.equal(sm_k.cpu(), sm_p)
    assert _canon_equal(p_k, p_p)


@pytest.mark.parametrize("n", [1, 4097, 32768])
def test_decompress_pair_kernel_matches_plain(cuda, n):
    """One launch over the keys and R values of n signatures (adversarial
    encodings, repeated), read as row views of one packed buffer: each
    half equals its own decompress_plain call."""
    _, _, sigs, pubs, _ = tv.make_adversarial_batch(528, 16)
    reps = -(-n // len(pubs))
    rows = np.concatenate([np.tile(pubs, (reps, 1))[:n],
                           np.tile(sigs, (reps, 1))[:n]], axis=1)
    buf = torch.from_numpy(rows)
    a, r = buf[:, :32], buf[:, 32:64]
    before = dc.decompress.launches
    got = dc.decompress_pair(a.to(cuda), r.to(cuda))
    assert dc.decompress.launches == before + 1
    for (ok_k, sm_k, p_k), b in zip(got, (a, r)):
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


def _scalar_rows(n: int, seed: int, dev, stride: int = 120):
    """s (n, 32), digest (n, 64) and z (n, 16) as row views of one
    (n, stride) buffer on the device, edges first: S = L - 1, L and 2^256
    - 1, a digest of all 0xff, z = 0 and 2^128 - 1; S non-canonical in
    half the other lanes.  At an odd stride every view after the first
    starts off a multiple of 4 too."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, (n, stride), np.uint8)
    buf[::2, 31] &= 0x0F
    for i, v in enumerate((_L - 1, _L, 2**256 - 1)[:n]):
        buf[i, :32] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    buf[:2, 32:96] = 0xFF
    buf[0, 96:112] = 0
    buf[1:2, 96:112] = 0xFF
    t = torch.from_numpy(buf).to(dev)
    off = stride - 120
    return t[:, :32], t[:, 32 + off:96 + off], t[:, 96 + off:112 + off]


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
# the two scalar kernels also at the RLC bucket
_SCALAR_SHAPES = [*_SHAPES, 32768]


@pytest.mark.parametrize("n", _SCALAR_SHAPES)
def test_reduce_recode_kernel_matches_plain(cuda, n):
    s, digest, _ = _scalar_rows(n, n, cuda)
    assert s.stride(0) == 120
    before = rr.reduce_recode.launches
    ok_k, wins_k = rr.reduce_recode(s, digest)
    assert rr.reduce_recode.launches == before + 1
    ok_p, wins_p = rr.reduce_recode_plain(s, digest)
    assert torch.equal(ok_k, ok_p)
    assert all(torch.equal(k, p) for k, p in zip(wins_k, wins_p))


@pytest.mark.parametrize("n", _SCALAR_SHAPES)
def test_rlc_recode_kernel_matches_plain(cuda, n):
    s, digest, z = _scalar_rows(n, n + 1, cuda)
    before = rl.rlc_recode.launches
    got = rl.rlc_recode(s, digest, z)
    assert rl.rlc_recode.launches == before + 1
    want = rl.rlc_recode_plain(s, digest, z)
    assert all(torch.equal(k, p) for k, p in zip(got, want))


@pytest.mark.parametrize("n", [33, 4097])
def test_scalar_kernels_on_unaligned_rows(cuda, n):
    """Both scalar kernels on views whose row stride (121) and, for the
    digest and z, base are not multiples of 4: the rows are read by
    bytes."""
    s, digest, z = _scalar_rows(n, n + 2, cuda, stride=121)
    assert s.stride(0) % 4 and digest.data_ptr() % 4 and z.data_ptr() % 4
    ok_k, wins_k = rr.reduce_recode(s, digest)
    ok_p, wins_p = rr.reduce_recode_plain(s, digest)
    assert torch.equal(ok_k, ok_p)
    assert all(torch.equal(k, p) for k, p in zip(wins_k, wins_p))
    got = rl.rlc_recode(s, digest, z)
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


@pytest.mark.parametrize("n", _CHAIN_SHAPES)
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


# -- the leader lane's kernels (csrc/poh_spans.cu, csrc/mixin_tree.cu) -----

@pytest.mark.parametrize("lanes,steps", [(1, 3), (40, 4), (513, 1)])
def test_poh_spans_kernel_matches_plain_and_hashlib(cuda, lanes, steps):
    from firedancer_tpu_torch.ops import poh_spans as ps
    rng = np.random.default_rng(lanes)
    caps = tuple(int(c) for c in rng.integers(0, 10, steps))
    rows = np.zeros((lanes, ps.row_bytes(steps)), np.uint8)
    rows[:, :32] = rng.integers(0, 256, (lanes, 32))
    for s in range(steps):
        b = 32 + 38 * s
        rows[:, b:b + 32] = rng.integers(0, 256, (lanes, 32))
        n = rng.integers(0, 14, lanes).astype("<u4")
        rows[:, b + 32:b + 36] = n.view(np.uint8).reshape(lanes, 4)
        rows[:, b + 36] = rng.integers(0, 2, lanes)
        rows[:, b + 37] = rng.integers(0, 4, lanes) > 0
    blob = torch.from_numpy(rows)
    before = ps.poh_spans.launches
    got = ps.poh_spans(blob.to(cuda), steps, caps).cpu()
    assert ps.poh_spans.launches == before + 1
    assert torch.equal(got, ps.poh_spans_plain(blob, steps, caps))
    for i in range(min(lanes, 40)):
        h = bytes(rows[i, :32])
        for s in range(steps):
            b = 32 + 38 * s
            n = int.from_bytes(bytes(rows[i, b + 32:b + 36]), "little")
            if rows[i, b + 37] and n > 0:
                for _ in range(min(n - 1, caps[s])):
                    h = hashlib.sha256(h).digest()
                h = hashlib.sha256(h + bytes(rows[i, b:b + 32])
                                   if rows[i, b + 36] else h).digest()
            assert bytes(got[i, 32 * s:32 * s + 32].tolist()) == h


@pytest.mark.parametrize("lanes", [1, 33])
def test_poh_spans_kernel_long_chains_match_hashlib(cuda, lanes):
    """Chains of thousands of hashes, the lanes of a pair of warps of
    different lengths, a mixin at the end of some: every hash is a round
    of the pair's barriers."""
    from firedancer_tpu_torch.ops import poh_spans as ps
    rng = np.random.default_rng(4000 + lanes)
    rows = np.zeros((lanes, ps.row_bytes(1)), np.uint8)
    rows[:, :32] = rng.integers(0, 256, (lanes, 32))
    rows[:, 32:64] = rng.integers(0, 256, (lanes, 32))
    n = rng.integers(2000, 5000, lanes).astype("<u4")
    rows[:, 64:68] = n.view(np.uint8).reshape(lanes, 4)
    rows[:, 68] = np.arange(lanes) % 2
    rows[:, 69] = 1
    got = ps.poh_spans(torch.from_numpy(rows).to(cuda), 1, (4096,)).cpu()
    for i in range(lanes):
        h = bytes(rows[i, :32])
        for _ in range(min(int(n[i]) - 1, 4096)):
            h = hashlib.sha256(h).digest()
        h = hashlib.sha256(h + bytes(rows[i, 32:64])
                           if rows[i, 68] else h).digest()
        assert bytes(got[i].tolist()) == h


@pytest.mark.parametrize("B,W", [(3, 1), (33, 64), (8, 32), (2, 1024)])
def test_mixin_tree_kernel_matches_plain(cuda, B, W):
    from firedancer_tpu_torch.ops import mixin_tree as mt
    rng = np.random.default_rng(B * W)
    sigs = torch.from_numpy(rng.integers(0, 256, (B, W, 64), np.uint8))
    widths = torch.from_numpy(
        rng.integers(1, W + 1, B).astype(np.int32))
    before = mt.mixin_tree.launches
    got = mt.mixin_tree(sigs.to(cuda), widths.to(cuda)).cpu()
    assert mt.mixin_tree.launches == before + 1
    assert torch.equal(got, mt.mixin_tree_plain(sigs, widths))


def _recover_sets(rng, B, K, N, S):
    """B sets of K survivors with their reconstruction matrices; set 1
    (when B > 1) has one survivor corrupted."""
    from firedancer_tpu_torch.ballet import reedsol as rs
    surv = np.zeros((B, K, S), np.uint8)
    bm = np.zeros((B, N, K), np.uint8)
    ref = np.zeros((B, N, S), np.uint8)
    have = np.zeros((B, N), bool)
    for b in range(B):
        use = tuple(sorted(rng.choice(N, K, replace=False).tolist()))
        data = rng.integers(0, 256, (K, S), np.uint8)
        cw = np.concatenate([data, rs.encode(data, N - K, device=False)])
        surv[b] = cw[list(use)]
        bm[b] = rs._recover_gfmat(K, N, use)
        ref[b] = cw
        have[b, list(use)] = True
    if B > 1:
        ref[1, np.flatnonzero(have[1])[-1], S - 1] ^= 1
    return [torch.from_numpy(a) for a in (surv, bm, ref, have)]


@pytest.mark.parametrize("B,K,N,S", [(8, 32, 64, 1019), (3, 1, 2, 1119),
                                     (2, 67, 134, 130), (5, 5, 9, 1),
                                     (1, 32, 64, 1019), (4, 32, 64, 127),
                                     (4, 32, 64, 129), (2, 67, 134, 1025)])
def test_gf2_recover_kernel_matches_plain(cuda, B, K, N, S):
    from firedancer_tpu_torch.ops import gf2_recover as gf2
    args = _recover_sets(np.random.default_rng(B * K + S), B, K, N, S)
    before = gf2.gf2_recover.launches
    full, ok = gf2.gf2_recover(*[a.to(cuda) for a in args])
    assert gf2.gf2_recover.launches == before + 1
    pf, pok = gf2.gf2_recover_plain(*args)
    assert torch.equal(full.cpu(), pf) and torch.equal(ok.cpu(), pok)
    assert ok.cpu().tolist() == [b != 1 for b in range(B)]


def test_gf2_recover_blob_and_encode_match_plain(cuda):
    from firedancer_tpu_torch.ballet import reedsol as rs
    from firedancer_tpu_torch.ops import gf2_recover as gf2
    surv, bm, ref, have = _recover_sets(np.random.default_rng(3), 8, 32,
                                        64, 1019)
    blob = torch.cat([surv.reshape(8, -1), ref.reshape(8, -1),
                      have.to(torch.uint8)], 1)
    got = gf2.recover_blob(blob.to(cuda), bm.to(cuda), 32, 64, 1019)
    assert torch.equal(got.cpu(), gf2.recover_blob_plain(blob, bm, 32, 64,
                                                         1019))
    data = surv[0].numpy()
    par = rs.encode(data, 32)
    assert np.array_equal(par, rs.encode(data, 32, device=False))


@pytest.mark.parametrize("B", [1, 31, 32, 33, 127, 128, 129, 4096])
def test_bmtree_walk_kernel_matches_plain(cuda, B):
    from firedancer_tpu_torch.ballet import bmtree as bm
    from firedancer_tpu_torch.ops import bmtree_walk as bw
    rng = np.random.default_rng(B)
    ml, D = 1164, 15
    leaf = torch.from_numpy(rng.integers(0, 256, (B, ml), np.uint8))
    lens = rng.integers(0, ml + 1, B).astype(np.int32)
    edge = [0, 1, 29, 30, 37, 38, 93, 94, 101, 102, 1164][:B]
    lens[:len(edge)] = edge
    idxs = rng.integers(0, 1 << 15, B).astype(np.int32)
    proofs = torch.from_numpy(rng.integers(0, 256, (B, D, 20), np.uint8))
    depths = (np.arange(B) % (D + 1)).astype(np.int32)
    before = bw.bmtree_walk.launches
    got = bw.bmtree_walk(leaf.to(cuda), lens, idxs, proofs.to(cuda),
                         depths).cpu()
    assert bw.bmtree_walk.launches == before + 1
    assert torch.equal(got, bw.bmtree_walk_plain(
        leaf, torch.from_numpy(lens), torch.from_numpy(idxs), proofs,
        torch.from_numpy(depths)))
    k = min(B, 40)
    assert [bytes(r) for r in got[:k].numpy()] == bm.np_batch_walk_roots(
        [leaf[i, :lens[i]].numpy() for i in range(k)], idxs[:k].tolist(),
        [list(proofs[i, :depths[i]].numpy()) for i in range(k)])


@pytest.mark.parametrize("at", range(16))
def test_bmtree_walk_kernel_on_unaligned_rows(cuda, at):
    """Leaf rows at offset at of a blob whose rows are 1,560 bytes apart
    (the shred tile's), 40 lanes over two blocks: the kernel's roots equal
    the plain version's on the rows copied out."""
    from firedancer_tpu_torch.ops import bmtree_walk as bw
    rng = np.random.default_rng(at)
    B, ml, D = 40, 1164, 15
    blob = torch.from_numpy(rng.integers(0, 256, (B, 1560), np.uint8))
    lens = rng.integers(0, ml + 1, B).astype(np.int32)
    lens[:11] = [0, 1, 29, 30, 37, 38, 93, 94, 101, 102, 1164]
    idxs = rng.integers(0, 1 << 15, B).astype(np.int32)
    proofs = torch.from_numpy(rng.integers(0, 256, (B, D, 20), np.uint8))
    depths = (np.arange(B) % (D + 1)).astype(np.int32)
    got = bw.bmtree_walk(blob.to(cuda)[:, at:at + ml], lens, idxs,
                         proofs.to(cuda), depths).cpu()
    assert torch.equal(got, bw.bmtree_walk_plain(
        blob[:, at:at + ml].contiguous(), torch.from_numpy(lens),
        torch.from_numpy(idxs), proofs, torch.from_numpy(depths)))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 31, 32, 33, 4097])
def test_antipa_tail_kernel_matches_plain_and_host(cuda, n):
    """antipa_tail on chip_smoke's edge lanes (fed digests directly) and
    adversarial lanes with their real digests, at lane counts around its
    warps of 8 lanes and its blocks of 32: bits equal the plain
    version's and antipa_k_host's, one
    launch a call; and the antipa mode's dispatch_blob equals strict's
    on the adversarial rows."""
    from chip_smoke import antipa_edge_lanes
    from firedancer_tpu_torch.ops import antipa_tail as at
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(33, 64)
    blob = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs))
    dig = sk.sha512_ram(*[c for i, c in enumerate(_cols(blob, 64))
                          if i != 2]).numpy()
    rows = antipa_edge_lanes() + [bytes(pubs[i]) + bytes(sigs[i])
                                  + bytes(dig[i]) for i in range(33)]
    lanes = np.resize(np.frombuffer(b"".join(rows), np.uint8)
                      .reshape(-1, 160), (n, 160))
    t = torch.from_numpy(lanes).to(cuda)
    args = (t[:, :32], t[:, 32:64], t[:, 64:96], t[:, 96:])
    before = at.antipa_tail.launches
    got = at.antipa_tail(*args).cpu()
    assert at.antipa_tail.launches == before + 1
    assert torch.equal(got, at.antipa_tail_plain(*args).cpu())
    host = [ed.antipa_k_host(r[32:96], r[:32],
                             int.from_bytes(r[96:], "little") % ed.L)
            for r in rows[:n]]
    assert got.tolist() == np.resize(host, n).tolist()
    sv = tv.SigVerifier(tv.VerifierConfig(33, 64), mode="antipa")
    assert np.asarray(sv.dispatch_blob(blob.numpy())).tolist() == \
        ed.verify_blob(blob.to(cuda)).cpu().tolist()
