"""The CUDA kernels' per-lane code, compiled as host C++, against the
plain torch versions.

Each kernel in csrc/ keeps its per-lane body (sha512_lane and the
schedule words of a staged block, vt_lane4, dc_lane, msm_point and
msm_tree_step, sc_reduce_recode, dsm_tail_q_lane4, dsm_base_lane4,
rlc_lane, and the scalar primitives under the last three: sc_mul_mod_l,
sc_reduce512 and the mask recode) in functions that also compile as
plain C++ outside nvcc.  This test builds them with the host
C++ compiler into a small harness and runs the same lanes through them
and through the plain torch versions, so the kernels' arithmetic is
checked on a machine with no GPU.  Where a kernel runs a lane on several
threads (msm's points, the four ranks of the chain in vt_lane4,
dsm_tail_q_lane4 and dsm_base_lane4, each holding one coordinate), the
harness runs those threads in lockstep and passes what the warp's
shuffles would through arrays; each point step of the four-rank chain is
also held alone against its plain function.  The launch, the grid and
the memory layout are not checked here: chip_smoke.py checks those on
the card.
"""

import hashlib
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.ops import curve25519 as cv
from firedancer_tpu_torch.ops import decompress as dc
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import msm as ms
from firedancer_tpu_torch.ops import sha512_kernel as sk
from firedancer_tpu_torch.ops import verify_tail as vt
from _torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(__file__).resolve().parent.parent / "firedancer_tpu_torch" / "csrc"

HARNESS = r"""
#include "decompress.cu"
#include "dsm.cu"
#include "msm.cu"
#include "reduce_recode.cu"
#include "rlc_recode.cu"
#include "sha512.cu"
#include "verify_tail.cu"
#include <cstdio>
#include <cstdlib>
#include <vector>
static void rd(void *p, size_t n) {
  if (fread(p, 1, n, stdin) != n) exit(2);
}
int main() {
  char mode; int n, ml;
  rd(&mode, 1); rd(&n, 4); rd(&ml, 4);
  if (mode == 's') {            // packed rows -> digests
    const size_t w = ml + 100;
    std::vector<uint8_t> rows(n * w), out(64);
    rd(rows.data(), rows.size());
    for (int i = 0; i < n; i++) {
      const uint8_t *row = &rows[i * w];
      sha512_lane(row, row + ml, row + ml + 64, row + ml + 96, ml, out.data());
      fwrite(out.data(), 1, 64, stdout);
    }
  } else if (mode == 'w') {     // packed rows -> nb, then each block's
    const size_t w = ml + 100;      // 16 schedule words
    std::vector<uint8_t> rows(n * w);
    rd(rows.data(), rows.size());
    for (int i = 0; i < n; i++) {
      const uint8_t *row = &rows[i * w];
      const int len = sha_len(row + ml + 96, ml);
      const uint32_t nb = sha_blocks((uint32_t)len + 64);
      fwrite(&nb, 4, 1, stdout);
      for (uint32_t blk = 0; blk < nb; blk++) {
        uint64_t words[16];
        sha_lane_block(words, row, row + ml, row + ml + 64, len, blk, nb);
        fwrite(words, 8, 16, stdout);
      }
    }
  } else if (mode == 'd') {     // consts, then 32-byte encodings
    dc_consts c;
    rd(&c, sizeof c);
    std::vector<uint8_t> in(n * 32);
    rd(in.data(), in.size());
    for (int i = 0; i < n; i++) {
      fe x, y, t;
      bool small;
      const uint8_t ok = dc_lane(c, &in[i * 32], small, x, y, t);
      const uint8_t sm = small;
      fwrite(&ok, 1, 1, stdout);
      fwrite(&sm, 1, 1, stdout);
      fwrite(x.v, 4, 10, stdout);
      fwrite(y.v, 4, 10, stdout);
      fwrite(t.v, 4, 10, stdout);
    }
  } else if (mode == 'm') {     // select, m, nwin, 2d, then per lane its
    int sel, m, nwin;           // m points and its windows (w * m + j)
    rd(&sel, 4); rd(&m, 4); rd(&nwin, 4);
    fe d2;
    rd(&d2, sizeof d2);
    for (int i = 0; i < n; i++) {
      ge pts[MSM_MAX_M];
      uint8_t wins[MSM_MAX_M * MSM_MAX_NWIN];
      rd(pts, m * sizeof(ge));
      rd(wins, m * nwin);
      ge part[MSM_MAX_M], prev[MSM_MAX_M];
      for (int j = 0; j < m; j++) {   // thread j of the lane: its point
        if (sel == MSM_LEGACY)
          msm_point<MSM_LEGACY>(part[j], pts[j], wins + j, m, nwin, d2);
        else
          msm_point<MSM_P16>(part[j], pts[j], wins + j, m, nwin, d2);
      }
      // the tree: at each level every thread reads the partials as the
      // level found them, as the warp's shuffles do
      for (int c = m; c > 1; c = c / 2 + c % 2) {
        for (int j = 0; j < m; j++) prev[j] = part[j];
        for (int j = 0; j < m; j++)
          msm_tree_step(part[j], prev[msm_tree_src(j, c)], j, c, d2);
      }
      fwrite(&part[0], sizeof(ge), 1, stdout);
    }
  } else if (mode == 'q') {     // (a 10, z 5) 28-bit limbs -> a z mod L
    for (int i = 0; i < n; i++) {
      uint32_t a[10], z[5], out[10];
      rd(a, sizeof a);
      rd(z, sizeof z);
      sc_mul_mod_l(out, a, z);
      fwrite(out, sizeof out, 1, stdout);
    }
  } else if (mode == 'k') {     // 64-byte digests -> digest mod L (10
    for (int i = 0; i < n; i++) {   // 28-bit limbs)
      uint8_t in[64];
      uint32_t w[16], out[10];
      rd(in, sizeof in);
      sc_load_words<16>(w, in);
      sc_reduce512(out, w);
      fwrite(out, sizeof out, 1, stdout);
    }
  } else if (mode == 'x') {     // 64 digits 0..15 -> mag, sgn (the mask
    for (int i = 0; i < n; i++) {   // recode)
      uint8_t nib[64], mag[64], sgn[64];
      rd(nib, sizeof nib);
      sc_signed_windows(mag, sgn, nib);
      fwrite(mag, 1, 64, stdout);
      fwrite(sgn, 1, 64, stdout);
    }
  } else if (mode == 'r') {     // (s, digest) -> ok_s, smag ssgn kmag ksgn
    for (int i = 0; i < n; i++) {
      uint8_t in[96], w[4][64];
      rd(in, sizeof in);
      const uint8_t ok = sc_reduce_recode(in, in + 32, w[0], w[1], w[2], w[3]);
      fwrite(&ok, 1, 1, stdout);
      fwrite(w, sizeof w, 1, stdout);
    }
  } else if (mode == 'l') {     // (s, digest, z) -> ok_s, w, z windows, zs
    for (int i = 0; i < n; i++) {
      uint8_t in[112], ww[64], zw[32];
      int64_t zs[22];
      rd(in, sizeof in);
      const uint8_t ok = rlc_lane(in, in + 32, in + 96, ww, zw, zs);
      fwrite(&ok, 1, 1, stdout);
      fwrite(ww, 1, 64, stdout);
      fwrite(zw, 1, 32, stdout);
      fwrite(zs, sizeof zs, 1, stdout);
    }
  } else if (mode == 'T' || mode == 'b') {
    vt_consts c;                // consts, then per lane its windows (4 x 64
    rd(&c, sizeof c);           // signed for T, 2 x 64 unsigned for b), A
    for (int i = 0; i < n; i++) {   // and for T y_R; the lane's four ranks
      uint8_t w[4][64];             // run in lockstep
      ge a;
      fe a4[4], q[4];
      uint32_t tab[G4_TAB_WORDS * G4_RANKS];
      rd(w, (mode == 'b' ? 2 : 4) * 64);
      rd(&a, sizeof a);
      g4_from_ge(a4, a, 0);
      if (mode == 'T') {
        fe y_r;
        bool ok[4];
        rd(&y_r, sizeof y_r);
        dsm_tail_q_lane4(c, w[0], w[1], w[2], w[3], a4, y_r, q, ok, tab, 0);
        const uint8_t ok2 = ok[2];
        fwrite(&ok2, 1, 1, stdout);
        fwrite(q[0].v, 4, 10, stdout);
        fwrite(q[2].v, 4, 10, stdout);
      } else {
        dsm_base_lane4(c, w[0], w[1], a4, q, tab, 0);
        fwrite(q, sizeof q, 1, stdout);
      }
    }
  } else if (mode == 'g') {     // one point step (ml): consts, then per
    vt_consts c;                // lane p, an operand of four fe and a sign
    rd(&c, sizeof c);
    for (int i = 0; i < n; i++) {
      ge p, o;
      uint8_t sgn;
      rd(&p, sizeof p);
      rd(&o, sizeof o);
      rd(&sgn, 1);
      fe p4[4], o4[4], t2d[4];
      uint32_t tab[G4_TAB_WORDS * G4_RANKS];
      g4_from_ge(p4, p, 0);
      g4_from_ge(o4, o, 0);   // Niels columns, B's rows, or a point q
      fe_set(t2d[2], 0);
      if (ml == 0) {
        g4_double<false>(p4, 0);
      } else if (ml == 1) {
        g4_double<true>(p4, 0);
      } else if (ml == 2) {
        for (int r = 0; r < 4; r++) g4_store(tab + r, 0, o4[r]);
        g4_add_niels(p4, 0, tab, 0, sgn);
      } else if (ml == 3) {
        g4_add_affine(p4, 0, o4, sgn);
      } else {                  // p + q; rank 2's t2d is p's 2dT
        fe lp[4], tp[4], lq[4], tq[4];
        g4_sums(lp, tp, p4, 0);
        g4_sums(lq, tq, o4, 0);
        g4_add(p4, t2d, lp, tp, lq, c.d2, 0);
      }
      fwrite(p4, sizeof p4, 1, stdout);
      fwrite(t2d[2].v, 4, 10, stdout);
    }
  } else {                      // consts, then (pub, s, digest, r) lanes,
    vt_consts c;                // the four ranks of a lane in lockstep
    rd(&c, sizeof c);
    std::vector<uint8_t> in(n * 160);
    rd(in.data(), in.size());
    for (int i = 0; i < n; i++) {
      const uint8_t *p = &in[i * 160];
      fe q[4];
      bool ok[4];
      uint32_t tab[G4_TAB_WORDS * G4_RANKS];
      vt_lane4(c, p, p + 32, p + 64, p + 128, q, ok, tab, 0);
      const uint8_t ok2 = ok[2];
      fwrite(&ok2, 1, 1, stdout);
      fwrite(q[0].v, 4, 10, stdout);
      fwrite(q[2].v, 4, 10, stdout);
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-O1", "-std=c++17", "-Wall", "-Werror",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(exe),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)

    def run(mode: bytes, n: int, ml: int, payload: bytes) -> bytes:
        return subprocess.run(
            [str(exe)], input=mode + struct.pack("<ii", n, ml) + payload,
            capture_output=True, check=True, timeout=300).stdout
    return run


def test_sha512_lane_matches_plain_and_hashlib(harness):
    rng = np.random.default_rng(21)
    ml = 300
    lens = np.array([0, 1, 46, 47, 48, 49, 111, 112, 175, 176, 177, 236, 300,
                     -5, 400] + list(rng.integers(0, ml + 1, 17)), np.int32)
    n = len(lens)
    msgs = rng.integers(0, 256, (n, ml), np.uint8)
    sigs = rng.integers(0, 256, (n, 64), np.uint8)
    pubs = rng.integers(0, 256, (n, 32), np.uint8)
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    got = np.frombuffer(harness(b"s", n, ml, blob.tobytes()),
                        np.uint8).reshape(n, 64)
    bt = torch.from_numpy(blob)
    plain = sk.sha512_ram_plain(bt[:, :ml], bt[:, ml:ml + 32],
                                bt[:, ml + 64:ml + 96], bt[:, ml + 96:])
    assert got.tolist() == plain.tolist()
    for i in range(n):
        k = max(0, min(int(lens[i]), ml))
        assert bytes(got[i]) == hashlib.sha512(
            bytes(sigs[i, :32]) + bytes(pubs[i]) + bytes(msgs[i, :k])).digest()


@pytest.mark.parametrize("mode", [b"V"], ids=["four_ranks"])
def test_verify_tail_lane_matches_plain(harness, mode):
    """The tail's lane on the four ranks of a group, run in lockstep: the
    ok bit of rank 2 and canonical X (rank 0) and Z (rank 2) equal the
    plain version's."""
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(33, 64)
    bt = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs))
    r, s, a = bt[:, 64:96], bt[:, 96:128], bt[:, 128:160]
    digest = sk.sha512_ram(bt[:, :64], r, a, bt[:, 160:])
    ok_p, x_p, z_p = vt.verify_tail_plain(a, s, digest, r)
    consts = vt.kernel_consts(torch.device("cpu")).numpy().astype(np.int32)
    lanes = np.concatenate([pubs, sigs[:, 32:], digest.numpy(), sigs[:, :32]],
                           axis=1)
    n = len(lanes)
    rec = np.frombuffer(harness(mode, n, 0, consts.tobytes()
                                + lanes.tobytes()), np.uint8).reshape(n, 81)
    x, z = _planes(rec[:, 1:].copy().view(np.uint32), 2)
    assert rec[:, 0].astype(bool).tolist() == ok_p.tolist()
    assert fe.to_ints(x) == fe.to_ints(x_p)
    assert fe.to_ints(z) == fe.to_ints(z_p)
    assert ok_p.any() and not ok_p.all()


def _planes(raw: np.ndarray, k: int) -> list[torch.Tensor]:
    """(n, 10 k) uint32 limbs from the harness -> k (10, n) int64 planes."""
    limbs = raw.astype(np.int64)
    return [torch.from_numpy(limbs[:, 10 * i:10 * i + 10].T.copy())
            for i in range(k)]


def _encodings() -> np.ndarray:
    """The adversarial keys and R values, plus random 32-byte strings
    (most have no point, some set bit 255)."""
    _, _, sigs, pubs, _ = tv.make_adversarial_batch(33, 16)
    rng = np.random.default_rng(22)
    return np.concatenate([pubs, sigs[:, :32],
                           rng.integers(0, 256, (14, 32), np.uint8)])


def test_decompress_lane_matches_plain(harness):
    b = _encodings()
    n = len(b)
    consts = dc.kernel_consts(torch.device("cpu")).numpy().astype(np.int32)
    rec = np.frombuffer(harness(b"d", n, 0, consts.tobytes() + b.tobytes()),
                        np.uint8).reshape(n, 122)
    x, y, t = _planes(rec[:, 2:].copy().view(np.uint32), 3)
    ok_p, small_p, pt = dc.decompress_plain(torch.from_numpy(b))
    assert rec[:, 0].astype(bool).tolist() == ok_p.tolist()
    assert rec[:, 1].astype(bool).tolist() == small_p.tolist()
    assert ok_p.any() and not ok_p.all() and small_p.any()
    # every lane, those without a point included: the same steps
    for got, want in ((x, pt.X), (y, pt.Y), (t, pt.T)):
        assert fe.to_ints(got) == fe.to_ints(want)


def test_sha512_block_words_match_padding(harness):
    """The schedule words the kernel builds from a staged row
    (sha_block_words: __byte_perm to big-endian, the 0x80 byte, the zeros
    and the bit length), through the host's byte-load staging: equal to
    the padded preimage R || A || M || 0x80 || 0.. || len, block by block,
    where the preimage is 111, 112, 239 and 240 bytes (the padding fits
    or spills), ends at a block edge (128, 256), and at message lengths
    111, 112, 239, 240, 0, ml and clamped ones."""
    ml = 300
    lens = np.array([47, 48, 175, 176, 64, 192, 111, 112, 239, 240, 0, ml,
                     -3, ml + 9, 1, 63], np.int32)
    n = len(lens)
    rng = np.random.default_rng(36)
    msgs = rng.integers(0, 256, (n, ml), np.uint8)
    sigs = rng.integers(0, 256, (n, 64), np.uint8)
    pubs = rng.integers(0, 256, (n, 32), np.uint8)
    out = harness(b"w", n, ml, tv.pack_blob(msgs, lens, sigs, pubs).tobytes())
    off = 0
    for i in range(n):
        k = max(0, min(int(lens[i]), ml))
        pre = bytes(sigs[i, :32]) + bytes(pubs[i]) + bytes(msgs[i, :k])
        pad = pre + b"\x80" + bytes(-(len(pre) + 17) % 128) + (
            8 * len(pre)).to_bytes(16, "big")
        nb = struct.unpack_from("<I", out, off)[0]
        off += 4
        assert nb == len(pad) // 128
        words = struct.unpack_from(f"<{16 * nb}Q", out, off)
        off += 128 * nb
        assert list(words) == [int.from_bytes(pad[8 * j:8 * j + 8], "big")
                               for j in range(16 * nb)]
    assert off == len(out)


@pytest.mark.parametrize("select,m", [
    *((sel, 4) for sel in ms.SELECTS),
    *((sel, m) for m in (1, 3, 8) for sel in ms.SELECTS)],
    ids=[*ms.SELECTS, *(f"{sel}-m{m}" for m in (1, 3, 8)
                        for sel in ms.SELECTS)])
def test_msm_lane_matches_plain(harness, select, m):
    """A lane of the kernel, each of its m threads' chains and then the
    tree, over the negated decompressed encodings (points off the curve
    and of small order included) with random digits, full 128-bit windows
    among them and top windows that carry out: per-lane X, Y, Z, T equal
    the plain version's, canonically."""
    nwin = 32
    b = _encodings()[:48]
    n, lanes = len(b), len(b) // m
    _, _, pt = dc.decompress_plain(torch.from_numpy(b))
    pts = cv.neg(pt)
    rng = np.random.default_rng(23)
    wins = rng.integers(0, 16, (nwin, n)).astype(np.uint8)
    wins[-1, :8] = 15          # top windows that carry out (p16)
    want = cv.msm_lanes(torch.from_numpy(wins).long(), pts, m, nwin, select)
    # lane l holds points j * lanes + l: gather them per lane for the
    # harness, limbs as uint32, windows in w * m + j order
    limbs = torch.stack(list(pts)).numpy().astype(np.uint32)   # (4, 10, n)
    payload = struct.pack("<ii", ms.SELECTS.index(select), m) + struct.pack(
        "<i", nwin) + np.array(fe.int_to_limbs(cv.D2), np.uint32).tobytes()
    for lane in range(lanes):
        idx = [j * lanes + lane for j in range(m)]
        payload += np.ascontiguousarray(
            limbs[:, :, idx].transpose(2, 0, 1)).tobytes()
        payload += np.ascontiguousarray(wins[:, idx]).tobytes()
    rec = np.frombuffer(harness(b"m", lanes, 0, payload),
                        np.uint32).reshape(lanes, 40)
    for got, plane in zip(_planes(rec, 4), want):
        assert fe.to_ints(got) == fe.to_ints(plane)


_L = 2**252 + 27742317777372353535851937790883648493


def _int_limbs(v: int, n: int, bits: int = 12) -> list[int]:
    return [(v >> (bits * i)) & ((1 << bits) - 1) for i in range(n)]


def _limbs_int(row, bits: int = 28) -> int:
    return sum(int(v) << (bits * i) for i, v in enumerate(row))


def test_mul_mod_l_lane_matches_ints_and_plain(harness):
    """sc_mul_mod_l, the 10 x 5-limb product mod L of rlc_recode (28-bit
    limbs), on the edges (a = 0, 1, L - 1, L, 2^256 - 1 and the widest a
    it takes, 2^264 - 1; z = 0, 1, 2^127 and 2^128 - 1) and random values:
    equal to Python ints and to scalar25519.mul_mod_l."""
    from firedancer_tpu_torch.ops import scalar25519 as sc
    rng = np.random.default_rng(24)
    a_vals = [0, 1, _L - 1, _L, 2**256 - 1, 2**264 - 1]
    z_vals = [0, 1, 2**127, 2**128 - 1]
    pairs = [(a, z) for a in a_vals for z in z_vals] + [
        (int.from_bytes(rng.bytes(32), "little"),
         int.from_bytes(rng.bytes(16), "little")) for _ in range(16)]
    payload = b"".join(
        np.array(_int_limbs(a, 10, 28) + _int_limbs(z, 5, 28),
                 np.uint32).tobytes() for a, z in pairs)
    got = np.frombuffer(harness(b"q", len(pairs), 0, payload),
                        np.uint32).reshape(len(pairs), 10)
    assert [_limbs_int(row) for row in got] == [a * z % _L for a, z in pairs]
    assert all(int(row[9]) <= 1 and int(row[:9].max()) < 2**28
               for row in got)
    a_l = np.array([_int_limbs(a, 22) for a, _ in pairs], np.int64)
    z_l = np.array([_int_limbs(z, 11) for _, z in pairs], np.int64)
    plain = sc.mul_mod_l(torch.from_numpy(a_l.T.copy()),
                         torch.from_numpy(z_l.T.copy()))
    assert [_int_limbs(_limbs_int(row), 22) for row in got] == \
        plain.T.tolist()


def test_reduce512_lane_matches_ints_and_plain(harness):
    """sc_reduce512, the digest mod L in 28-bit limbs, on 0, L - 1, L,
    2L, 2^512 - 1, 2^252 k +- 1 and random digests: canonical and equal
    to Python ints and to scalar25519.reduce_512."""
    from firedancer_tpu_torch.ops import scalar25519 as sc
    rng = np.random.default_rng(27)
    vals = [0, 1, _L - 1, _L, 2 * _L, 2**512 - 1, 2**252 - 1, 2**252,
            2**385 - 1, 2**511] + [
        int.from_bytes(rng.bytes(64), "little") for _ in range(24)]
    d = np.array([np.frombuffer(v.to_bytes(64, "little"), np.uint8)
                  for v in vals])
    got = np.frombuffer(harness(b"k", len(vals), 0, d.tobytes()),
                        np.uint32).reshape(len(vals), 10)
    assert [_limbs_int(row) for row in got] == [v % _L for v in vals]
    assert all(int(row[9]) <= 1 and int(row[:9].max()) < 2**28
               for row in got)
    plain = sc.reduce_512(torch.from_numpy(d))
    assert [_int_limbs(_limbs_int(row), 22) for row in got] == \
        plain.T.tolist()


def _digit_rows(case: str) -> np.ndarray:
    """(n, 64) digits 0..15, low window first, for the recode cases."""
    rng = np.random.default_rng(28)
    if case == "runs_of_8":     # runs of 8s behind digits that carry or not
        rows = []
        for start in (0, 1, 7, 8, 31, 32, 60):
            for lead in (9, 15, 8, 7, 0):
                for length in (1, 5, 63 - start):
                    r = rng.integers(0, 16, 64)
                    r[start] = lead
                    r[start + 1:start + 1 + length] = 8
                    rows.append(r)
        return np.array(rows, np.uint8)
    if case == "all_15":
        return np.array([[15] * 64, [0] + [15] * 63, [15] * 63 + [0]],
                        np.uint8)
    if case == "nine_then_eights":
        return np.array([[9] + [8] * 63, [8] * 64, [9] + [8] * 62 + [7]],
                        np.uint8)
    if case == "edges":         # one digit set, the rest 0 or 15
        rows = []
        for w in (0, 7, 8, 31, 63):
            for d in (8, 9, 15):
                for fill in (0, 15):
                    r = np.full(64, fill)
                    r[w] = d
                    rows.append(r)
        return np.array(rows, np.uint8)
    if case == "few_digits":    # digits from {7, 8, 9}: long carry chains
        return rng.choice(np.array([7, 8, 9], np.uint8), (64, 64))
    return rng.integers(0, 16, (256, 64)).astype(np.uint8)


@pytest.mark.parametrize("case", ["runs_of_8", "all_15", "nine_then_eights",
                                  "edges", "few_digits", "random"])
def test_signed_recode_by_masks_matches_plain(harness, case):
    """The mask recode (sc_signed_recode, through sc_signed_windows)
    against the ripple of scalar25519.signed_windows: magnitudes and
    signs, the carry out of the top window dropped."""
    from firedancer_tpu_torch.ops import scalar25519 as sc
    rows = _digit_rows(case)
    n = len(rows)
    rec = np.frombuffer(harness(b"x", n, 0, rows.tobytes()),
                        np.uint8).reshape(n, 2, 64)
    mag, sgn = sc.signed_windows(torch.from_numpy(rows.T.astype(np.int64)))
    assert rec[:, 0].T.tolist() == mag.tolist()
    assert rec[:, 1].T.tolist() == sgn.tolist()


def _scalar_lanes(n: int, seed: int):
    """s (n, 32), digest (n, 64), z (n, 16): the edges first (S = L - 1,
    L and 2^256 - 1; a digest of all 0xff; z = 0, 1 and 2^128 - 1), then
    random bytes, S non-canonical in half the random lanes."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 256, (n, 32), np.uint8)
    s[::2, 31] &= 0x0F
    d = rng.integers(0, 256, (n, 64), np.uint8)
    z = rng.integers(0, 256, (n, 16), np.uint8)
    for i, v in enumerate((_L - 1, _L, 2**256 - 1)):
        s[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    d[:2] = 0xFF
    z[0], z[1], z[2] = 0, 0, 0xFF
    z[1, 0] = 1
    return s, d, z


def test_reduce_recode_lane_matches_plain(harness):
    from firedancer_tpu_torch.ops import reduce_recode as rr
    s, d, _ = _scalar_lanes(24, 25)
    n = len(s)
    rec = np.frombuffer(harness(b"r", n, 0, np.concatenate(
        [s, d], axis=1).tobytes()), np.uint8).reshape(n, 257)
    ok_p, wins_p = rr.reduce_recode_plain(torch.from_numpy(s),
                                          torch.from_numpy(d))
    assert rec[:, 0].astype(bool).tolist() == ok_p.tolist()
    assert ok_p.any() and not ok_p.all()
    got = rec[:, 1:].reshape(n, 4, 64).transpose(1, 2, 0)
    for g, w in zip(got, wins_p):
        assert g.tolist() == w.tolist()


def test_rlc_lane_matches_plain(harness):
    from firedancer_tpu_torch.ops import rlc_recode as rl
    s, d, z = _scalar_lanes(24, 26)
    n = len(s)
    rec = np.frombuffer(harness(b"l", n, 0, np.concatenate(
        [s, d, z], axis=1).tobytes()), np.uint8).reshape(n, 273)
    ok_p, ww_p, zw_p, zs_p = rl.rlc_recode_plain(
        *(torch.from_numpy(a) for a in (s, d, z)))
    assert rec[:, 0].astype(bool).tolist() == ok_p.tolist()
    assert rec[:, 1:65].T.tolist() == ww_p.tolist()
    assert rec[:, 65:97].T.tolist() == zw_p.tolist()
    zs = rec[:, 97:].copy().view(np.int64)
    assert zs.T.tolist() == zs_p.tolist()


def _scaled_points(seed: int):
    """The decompressed encodings (points off the curve and of small
    order included) in extended coordinates scaled by a random lambda,
    (lX, lY, lZ, lT): Z != 1, so a table built as if Z were 1 fails."""
    b = _encodings()
    _, _, pt = dc.decompress_plain(torch.from_numpy(b))
    rng = np.random.default_rng(seed)
    lam = fe.from_ints([int.from_bytes(rng.bytes(32), "little") % fe.P
                        for _ in range(len(b))], "cpu")
    return cv.Point(*(fe.mul(t, lam) for t in pt))


def _ge_payload(pts: cv.Point) -> np.ndarray:
    """(n, 160) bytes: each lane's X, Y, Z, T as uint32 limbs."""
    limbs = torch.stack(list(pts)).numpy().astype(np.uint32)  # (4, 10, n)
    return np.ascontiguousarray(limbs.transpose(2, 0, 1)).view(
        np.uint8).reshape(limbs.shape[2], 160)


@pytest.mark.parametrize("mode", [b"T"], ids=["four_ranks"])
def test_dsm_tail_q_lane_matches_plain(harness, mode):
    """The chain of the split layout on the four ranks of a group, in
    lockstep, from an A with Z != 1, signed windows of random S
    (non-canonical ones included) and k, and y_R of random bytes: ok_y
    (rank 2) and canonical X (rank 0) and Z (rank 2) equal the plain
    version's."""
    from firedancer_tpu_torch.ops import dsm
    from firedancer_tpu_torch.ops import reduce_recode as rr
    a = _scaled_points(27)
    n = a.X.shape[1]
    s, d, _ = _scalar_lanes(n, 28)
    _, wins = rr.reduce_recode_plain(torch.from_numpy(s), torch.from_numpy(d))
    r = np.random.default_rng(29).integers(0, 256, (n, 32), np.uint8)
    y_r = fe.from_bytes(torch.from_numpy(r))
    ok_p, x_p, z_p = dsm.dsm_tail_q_plain(wins, a, y_r)
    consts = dsm.kernel_consts(torch.device("cpu")).numpy().astype(np.int32)
    w = torch.stack(wins).numpy().transpose(2, 0, 1).reshape(n, 256)
    yr = y_r.numpy().astype(np.uint32).T.copy().view(np.uint8)
    payload = consts.tobytes() + np.concatenate(
        [w, _ge_payload(a), yr], axis=1).tobytes()
    rec = np.frombuffer(harness(mode, n, 0, payload), np.uint8).reshape(n, 81)
    x, z = _planes(rec[:, 1:].copy().view(np.uint32), 2)
    assert rec[:, 0].astype(bool).tolist() == ok_p.tolist()
    assert fe.to_ints(x) == fe.to_ints(x_p)
    assert fe.to_ints(z) == fe.to_ints(z_p)


def test_dsm_base_lane_matches_plain(harness):
    """double_scalar_mul_base's lane on the four ranks of a group, in
    lockstep, from an A with Z != 1 and unsigned windows whose recode
    carries out of the top window: canonical X, Y, Z, T (ranks 0-3) equal
    the plain version's, and T Z = X Y."""
    from firedancer_tpu_torch.ops import dsm
    a = _scaled_points(30)
    n = a.X.shape[1]
    rng = np.random.default_rng(31)
    wins = rng.integers(0, 16, (2, 64, n)).astype(np.uint8)
    wins[:, 63, :8] = 15
    want = dsm.double_scalar_mul_base_plain(
        *(torch.from_numpy(w) for w in wins), a)
    consts = dsm.kernel_consts(torch.device("cpu")).numpy().astype(np.int32)
    payload = np.concatenate(
        [wins.transpose(2, 0, 1).reshape(n, 128), _ge_payload(a)], axis=1)
    rec = np.frombuffer(harness(b"b", n, 0, consts.tobytes()
                                + payload.tobytes()),
                        np.uint32).reshape(n, 40)
    got = _planes(rec, 4)
    for g, plane in zip(got, want):
        assert fe.to_ints(g) == fe.to_ints(plane)
    x, y, z, t = (fe.to_ints(g) for g in got)
    assert all(ti * zi % fe.P == xi * yi % fe.P
               for xi, yi, zi, ti in zip(x, y, z, t))


_STEPS = ["double", "double_t", "niels", "niels_neg", "affine",
          "affine_neg", "add"]


@pytest.mark.parametrize("step", _STEPS)
def test_chain_step_matches_plain(harness, step):
    """One point step of the four-rank chain (dsm_chain.cuh), its four
    ranks in lockstep, on points with Z != 1 (off the curve and of small
    order among them), against its plain function: the coordinates read
    off ranks 0-3 equal cv.double (with and without T), cv.add_niels
    (either digit sign, the entry as _add_signed passes it),
    cv.add_affine_niels (either sign, without T) and cv.add canonically.
    The unified add also makes the table's column 2dT of its first point
    on rank 2."""
    from firedancer_tpu_torch.ops import dsm
    p = _scaled_points(32)
    n = p.X.shape[1]
    q = _scaled_points(33)
    q = cv.Point(*(t.flip(1) for t in q))
    neg = step.endswith("_neg")
    sgn = torch.full((n,), neg)
    kind = next(i for i, k in enumerate(
        ("double", "double_t", "niels", "affine", "add"))
        if step.removesuffix("_neg") == k)
    if kind < 2:
        operand = q
        want = cv.double(p, want_t=kind == 1)
    elif kind == 2:
        operand = cv.to_niels(q)
        ym, yp, z, t2d = operand
        want = cv.add_niels(p, cv.Niels(
            torch.where(sgn, yp, ym), torch.where(sgn, ym, yp), z,
            torch.where(sgn, fe.neg(t2d), t2d)))
    elif kind == 3:
        mag = np.random.default_rng(34).integers(0, 9, n)
        rows = cv.base_table("cpu")[torch.from_numpy(mag)]   # (n, 4, 10)
        operand = cv.Point(*(rows[:, k].T.contiguous() for k in range(4)))
        bym, byp, bt2d, bnt2d = operand
        want = cv.add_affine_niels(p, torch.where(sgn, byp, bym),
                                   torch.where(sgn, bym, byp),
                                   torch.where(sgn, bnt2d, bt2d),
                                   want_t=False)
    else:
        operand = q
        want = cv.add(p, q)
    consts = dsm.kernel_consts(torch.device("cpu")).numpy().astype(np.int32)
    payload = np.concatenate([_ge_payload(p), _ge_payload(operand),
                              np.full((n, 1), neg, np.uint8)], axis=1)
    rec = np.frombuffer(harness(b"g", n, kind, consts.tobytes()
                                + payload.tobytes()),
                        np.uint32).reshape(n, 50)
    got = _planes(rec, 5)
    for g, plane in zip(got, want):
        assert fe.to_ints(g) == fe.to_ints(plane)
    if kind == 4:
        assert fe.to_ints(got[4]) == fe.to_ints(cv.to_niels(p).T2d)
