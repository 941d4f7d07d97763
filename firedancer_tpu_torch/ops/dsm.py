"""The double-scalar multiply of the split and unfused strict layouts
(csrc/dsm.cu, replacing firedancer_tpu/ops/curve_pallas.py::dsm_tail_q
and ::double_scalar_mul_base; both run the fused tail's chain).

dsm_tail_q(wins, a, y_r) -> (ok_y, X, Z): Q = [s]B + [k](-A) from the
signed windows wins = (smag, ssgn, kmag, ksgn) that reduce_recode
returns, A negated inside, and ok_y the projective y-compare Q.Y ==
y_R Q.Z.  double_scalar_mul_base(s_windows, k_windows, a) -> Point:
[s]B + [k]A from unsigned 4-bit windows, recoded inside (the carry out of
the top window dropped), with T valid (one add of the identity after the
chain).  Windows are (64, n) planes of any integer dtype, low window
first; A is a Point of (10, n) int64 planes with tight limbs and any Z
(as every ops/f25519 function returns them); y_r is (10, n).  Outputs are
(10, n) int64 planes; kernel and plain give equal canonical coordinates.
On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import curve25519 as cv
from . import f25519 as fe
from . import scalar25519 as sc


@functools.lru_cache(maxsize=None)
def kernel_consts(device) -> torch.Tensor:
    """The chain's int32 (41, 10) constants, shared with the fused tail:
    [0..8]B rows, then d, 2d, sqrt(-1) and the two order-8 y values
    (csrc/dsm_chain.cuh vt_consts)."""
    rows = [v for row in cv.base_table_ints() for v in row]
    rows += [cv.D, cv.D2, cv.SQRT_M1, cv.ORDER8_Y0, cv.ORDER8_Y1]
    return torch.tensor([fe.int_to_limbs(v) for v in rows],
                        dtype=torch.int32, device=device)


def dsm_tail_q_plain(wins, a: cv.Point, y_r):
    """The plain torch version: the chain on -A, then the y-compare."""
    s_mag, s_sgn, k_mag, k_sgn = (w.long() for w in wins)
    q = cv.double_scalar_mul_base(s_mag, s_sgn, k_mag, k_sgn, cv.neg(a))
    return fe.eq(q.Y, fe.mul(y_r, q.Z)), q.X, q.Z


def double_scalar_mul_base_plain(s_windows, k_windows, a: cv.Point):
    """The plain torch version: recode, the chain, the identity add."""
    s_mag, s_sgn = sc.signed_windows(s_windows.long())
    k_mag, k_sgn = sc.signed_windows(k_windows.long())
    q = cv.double_scalar_mul_base(s_mag, s_sgn, k_mag, k_sgn, a)
    n, dev = a.X.shape[1], a.X.device
    one = fe.ones(n, dev)
    return cv.add_niels(q, cv.Niels(one, one, one, fe.zeros(n, dev)))


def _window_block(wins, n: int, dev) -> torch.Tensor:
    """The window planes as one contiguous uint8 (len(wins), 64, n) block:
    taken in place when they already lie so (reduce_recode's output),
    copied otherwise."""
    for w in wins:
        if w.shape != (64, n) or w.device != dev:
            raise ValueError(f"windows must be (64, {n}) on {dev}, got "
                             f"{tuple(w.shape)} on {w.device}")
    base = wins[0]
    if all(w.dtype == torch.uint8 and w.is_contiguous()
           and w.data_ptr() == base.data_ptr() + i * 64 * n
           for i, w in enumerate(wins)):
        return base
    return torch.stack([w.to(torch.uint8) for w in wins])


def _planes(planes, n: int, dev, name: str):
    for t in planes:
        if t.shape != (fe.NLIMB, n) or t.device != dev:
            raise ValueError(f"{name} must be ({fe.NLIMB}, {n}) planes on "
                             f"{dev}, got {tuple(t.shape)} on {t.device}")
    return [t.to(torch.int64).contiguous() for t in planes]


@functools.lru_cache(maxsize=None)
def _fns():
    lib = build.load("dsm")
    p, i = ctypes.c_void_p, ctypes.c_int
    tail_q, base = lib.fd_dsm_tail_q, lib.fd_dsm_base
    tail_q.argtypes = [p] * 7 + [i] + [p] * 4
    base.argtypes = [p] * 6 + [i] + [p] * 5
    tail_q.restype = base.restype = i
    return tail_q, base


def _launch(fn, name: str, *args):
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def dsm_tail_q(wins, a: cv.Point, y_r):
    dev = y_r.device
    if dev.type == "cpu":
        return dsm_tail_q_plain(wins, a, y_r)
    n = y_r.shape[1]
    block = _window_block(wins, n, dev)
    pts = _planes([*a, y_r], n, dev, "A and y_r")
    ok = torch.empty(n, dtype=torch.uint8, device=dev)
    x, z = (torch.empty((fe.NLIMB, n), dtype=torch.int64, device=dev)
            for _ in range(2))
    if n:
        with torch.cuda.device(dev):
            _launch(_fns()[0], "dsm_tail_q", block.data_ptr(),
                    *(t.data_ptr() for t in pts),
                    kernel_consts(dev).data_ptr(), n, ok.data_ptr(),
                    x.data_ptr(), z.data_ptr())
        dsm_tail_q.launches += 1
    return ok.bool(), x, z


def double_scalar_mul_base(s_windows, k_windows, a: cv.Point) -> cv.Point:
    dev = a.X.device
    if dev.type == "cpu":
        return double_scalar_mul_base_plain(s_windows, k_windows, a)
    n = a.X.shape[1]
    block = _window_block((s_windows, k_windows), n, dev)
    pts = _planes(a, n, dev, "A")
    out = [torch.empty((fe.NLIMB, n), dtype=torch.int64, device=dev)
           for _ in range(4)]
    if n:
        with torch.cuda.device(dev):
            _launch(_fns()[1], "double_scalar_mul_base", block.data_ptr(),
                    *(t.data_ptr() for t in pts),
                    kernel_consts(dev).data_ptr(), n,
                    *(t.data_ptr() for t in out))
        double_scalar_mul_base.launches += 1
    return cv.Point(*out)


dsm_tail_q.launches = 0
double_scalar_mul_base.launches = 0
