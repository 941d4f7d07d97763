"""The CUDA kernels' per-lane code, compiled as host C++, against the
plain torch versions.

Each kernel in csrc/ keeps its per-lane body (sha512_lane, vt_lane,
dc_lane, msm_lane) in functions that also compile as plain C++ outside
nvcc.  This test builds them with the host C++ compiler into
a small harness and runs the same lanes through them and through the plain
torch versions, so the kernels' arithmetic is checked on a machine with no
GPU.  The launch, the grid and the memory layout are not: chip_smoke.py
checks those on the card.
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

CSRC = Path(__file__).resolve().parent.parent / "firedancer_tpu_torch" / "csrc"

HARNESS = r"""
#include "decompress.cu"
#include "msm.cu"
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
      ge acc;
      if (sel == MSM_LEGACY)
        msm_lane<MSM_LEGACY>(acc, pts, wins, m, 1, m, nwin, d2);
      else
        msm_lane<MSM_P16>(acc, pts, wins, m, 1, m, nwin, d2);
      fwrite(&acc, sizeof acc, 1, stdout);
    }
  } else {                      // consts, then (pub, s, digest, r) lanes
    vt_consts c;
    rd(&c, sizeof c);
    std::vector<uint8_t> in(n * 160);
    rd(in.data(), in.size());
    for (int i = 0; i < n; i++) {
      const uint8_t *p = &in[i * 160];
      fe qx, qz;
      const uint8_t ok = vt_lane(c, p, p + 32, p + 64, p + 128, qx, qz);
      fwrite(&ok, 1, 1, stdout);
      fwrite(qx.v, 4, 10, stdout);
      fwrite(qz.v, 4, 10, stdout);
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


def test_verify_tail_lane_matches_plain(harness):
    msgs, lens, sigs, pubs, _ = tv.make_adversarial_batch(33, 64)
    bt = torch.from_numpy(tv.pack_blob(msgs, lens, sigs, pubs))
    r, s, a = bt[:, 64:96], bt[:, 96:128], bt[:, 128:160]
    digest = sk.sha512_ram(bt[:, :64], r, a, bt[:, 160:])
    ok_p, x_p, z_p = vt.verify_tail_plain(a, s, digest, r)
    consts = vt.kernel_consts(torch.device("cpu")).numpy().astype(np.int32)
    lanes = np.concatenate([pubs, sigs[:, 32:], digest.numpy(), sigs[:, :32]],
                           axis=1)
    n = len(lanes)
    rec = np.frombuffer(harness(b"v", n, 0, consts.tobytes() + lanes.tobytes()),
                        np.uint8).reshape(n, 81)
    limbs = rec[:, 1:].copy().view(np.uint32).astype(np.int64)
    assert rec[:, 0].astype(bool).tolist() == ok_p.tolist()
    assert fe.to_ints(torch.from_numpy(limbs[:, :10].T)) == fe.to_ints(x_p)
    assert fe.to_ints(torch.from_numpy(limbs[:, 10:].T)) == fe.to_ints(z_p)
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


@pytest.mark.parametrize("select", ms.SELECTS)
def test_msm_lane_matches_plain(harness, select):
    """The lane body over the negated decompressed encodings (points off
    the curve and of small order included) with random digits, full
    128-bit windows among them: per-lane X, Y, Z, T equal the plain
    chain's, canonically."""
    m, nwin = 4, 32
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
