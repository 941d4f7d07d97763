"""Lane-parallel multi-scalar multiply, sum_i [s_i]P_i (csrc/msm.cu,
replacing firedancer_tpu/ops/curve_pallas.py::msm, both selects).

msm(windows, points, m, nwin, select) -> one Point as (10, 1) planes.
windows: (nwin, n) unsigned 4-bit digits of the scalars, low window
first (any integer dtype); points: a Point of (10, n) int64 planes with
tight limbs (as every ops/f25519 function returns them); n % m == 0.  The
n points go to n / m lanes as in the JAX package (lane l takes the flat
points j * lanes + l); the kernel (msm_lanes) runs each point's own
chain on a thread of its own and sums each lane's m points by a tree,
then torch tree-folds the lanes to one point (curve25519.fold_lanes).
select is "legacy" (unsigned digits, [0..15]P tables) or "p16" (signed
digits over nwin + 1 windows, [0..8]P tables); both give the same group
element, in other coordinates.

On a CUDA tensor msm_lanes launches the kernel or raises; on a CPU
tensor it runs the plain version, curve25519.msm_lanes.  The kernel
takes m <= 8 and nwin <= 64 (csrc/msm.cu MSM_MAX_M, MSM_MAX_NWIN) and
returns cudaErrorInvalidValue for more, which msm_lanes raises as
ValueError.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import curve25519 as cv
from . import f25519 as fe

SELECTS = ("legacy", "p16")
_INVALID_VALUE = 1          # cudaErrorInvalidValue


def _check(windows, points: cv.Point, m: int, nwin: int, select: str):
    if select not in SELECTS:
        raise ValueError(f"unknown msm select {select!r}; "
                         f"expected one of {SELECTS}")
    if windows.dim() != 2 or windows.shape[0] != nwin:
        raise ValueError(f"windows must be (nwin={nwin}, n), got "
                         f"{tuple(windows.shape)}")
    n = windows.shape[1]
    if m < 1 or n % m:
        raise ValueError(f"n ({n}) must be a multiple of m ({m})")
    for t in points:
        if t.shape != (fe.NLIMB, n) or t.device != windows.device:
            raise ValueError(f"points must be ({fe.NLIMB}, {n}) planes on "
                             f"{windows.device}, got {tuple(t.shape)} on "
                             f"{t.device}")


@functools.lru_cache(maxsize=None)
def _d2(device) -> torch.Tensor:
    return torch.tensor(fe.int_to_limbs(cv.D2), dtype=torch.int32,
                        device=device)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("msm").fd_msm
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p, p, p]
    fn.restype = i
    return fn


def msm_lanes(windows, points: cv.Point, m: int, nwin: int,
              select: str) -> cv.Point:
    """The per-lane accumulators, (10, n / m) planes."""
    _check(windows, points, m, nwin, select)
    if windows.device.type == "cpu":
        return cv.msm_lanes(windows, points, m, nwin, select)
    n, dev = windows.shape[1], windows.device
    lanes = n // m
    wins = windows.to(torch.uint8).contiguous()
    pts = [t.contiguous() for t in points]
    out = [torch.empty((fe.NLIMB, lanes), dtype=torch.int64, device=dev)
           for _ in range(4)]
    if n:
        with torch.cuda.device(dev):
            rc = _fn()(wins.data_ptr(), *(t.data_ptr() for t in pts),
                       _d2(dev).data_ptr(), n, m, nwin, SELECTS.index(select),
                       *(t.data_ptr() for t in out),
                       torch.cuda.current_stream().cuda_stream)
        if rc == _INVALID_VALUE:
            raise ValueError(f"the msm kernel takes m <= 8 and nwin <= 64 "
                             f"(csrc/msm.cu), got m={m}, nwin={nwin}")
        if rc:
            raise RuntimeError(f"msm kernel launch failed: CUDA error {rc}")
        msm_lanes.launches[select] += 1
    return cv.Point(*out)


# kernel launches per select
msm_lanes.launches = dict.fromkeys(SELECTS, 0)


def msm(windows, points: cv.Point, m: int = 8, nwin: int = 64,
        select: str = "legacy") -> cv.Point:
    return cv.fold_lanes(msm_lanes(windows, points, m, nwin, select))


def msm_plain(windows, points: cv.Point, m: int = 8, nwin: int = 64,
              select: str = "legacy") -> cv.Point:
    """The plain version on any device: curve25519.msm_lanes, then the
    same fold."""
    _check(windows, points, m, nwin, select)
    return cv.fold_lanes(cv.msm_lanes(windows, points, m, nwin, select))
