"""The strict verify's finish: the last kernel of all three strict
layouts of ed25519.verify_batch (csrc/r_check.cu, replacing the XLA step
firedancer_tpu/ops/ed25519.py::_compressed_r_check and its
firedancer_tpu/ops/f25519.py::batch_inv).

r_check(qx, qz, r_bytes, ok_y=None, *, qy=None) -> bool (n,): accept iff
Q equals the point R's bytes encode, without decompressing R.  qx, qz
(and qy) are Q's (10, n) int64 limb planes; r_bytes is a uint8 (n, 32)
row view of any row stride.  The projective y-compare comes either as
ok_y (bool or uint8 (n,): the fused and split layouts' kernels ran it)
or from Q's Y, compared here in affine form (qy: the unfused layout).
On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs r_check_plain, the same steps in torch.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import curve25519 as cv
from . import f25519 as fe
from .sha512_kernel import _rows

P = fe.P


def _parse_r_bytes(r_bytes):
    """R's encoded y (canonical limbs, mod p), its sign bit, and whether
    y is one of the five 8-torsion y values {0, 1, -1, y8_0, y8_1}."""
    yc = fe.canonical(fe.from_bytes(r_bytes))
    sign_r = (r_bytes[:, 31] >> 7).to(torch.int64)
    small = cv.small_order_y(yc)
    for v in (1, P - 1):
        small = small | (yc == fe.const(v, yc.device)).all(0)
    return yc, sign_r, small


def _check_forms(ok_y, qy):
    if (ok_y is None) == (qy is None):
        raise ValueError("give exactly one of ok_y and qy")


def r_check_plain(qx, qz, r_bytes, ok_y=None, *, qy=None):
    """The plain torch version.  Case by case, as in the JAX package: a
    non-canonical y compares mod p; an R off the curve has no point with
    its y, so the y-compare already failed; x = 0 with the sign bit set
    fails the parity test; a small-order R is recognised by its y;
    otherwise equal y and equal x parity make equal points.  The affine x
    comes from one batch inversion."""
    _check_forms(ok_y, qy)
    y_r, sign_r, small = _parse_r_bytes(r_bytes)
    z_ok = ~fe.is_zero(qz)
    one = fe.ones(qz.shape[1], qz.device)
    zi = fe.batch_inv(torch.where(z_ok, qz, one))
    x_aff = fe.mul(qx, zi)
    if ok_y is None:
        ok_y = fe.eq(fe.mul(qy, zi), y_r)
    return z_ok & ~small & ok_y.bool() & (fe.sgn(x_aff) == sign_r)


@functools.lru_cache(maxsize=None)
def kernel_consts(device) -> torch.Tensor:
    """The kernel's int32 (2, 10) constants: the two order-8 y values
    (csrc/r_check.cu rc_consts)."""
    return torch.tensor([fe.int_to_limbs(v)
                         for v in (cv.ORDER8_Y0, cv.ORDER8_Y1)],
                        dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("r_check").fd_r_check
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    return fn


def _plane(t, n: int, dev, name: str):
    if (t.dtype != torch.int64 or tuple(t.shape) != (fe.NLIMB, n)
            or not t.is_contiguous() or t.device != dev):
        raise ValueError(f"{name}: need a contiguous int64 ({fe.NLIMB}, {n}) "
                         f"limb plane on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def r_check(qx, qz, r_bytes, ok_y=None, *, qy=None):
    _check_forms(ok_y, qy)
    dev, n = qx.device, r_bytes.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return r_check_plain(qx, qz, r_bytes, ok_y, qy=qy)
    _rows(r_bytes, 32, "r_bytes")
    if r_bytes.device != dev:
        raise ValueError("r_bytes: device differs")
    for t, name in ((qx, "qx"), (qz, "qz")) + (((qy, "qy"),) if qy
                                                is not None else ()):
        _plane(t, n, dev, name)
    if ok_y is not None:
        if ok_y.dtype not in (torch.bool, torch.uint8) or tuple(
                ok_y.shape) != (n,) or ok_y.device != dev:
            raise ValueError(f"ok_y: need a bool or uint8 ({n},) vector on "
                             f"{dev}, got {ok_y.dtype} {tuple(ok_y.shape)} "
                             f"on {ok_y.device}")
        ok_y = ok_y.contiguous()
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    consts = kernel_consts(dev)
    with torch.cuda.device(dev):
        rc = _fn()(qx.data_ptr(), qz.data_ptr(),
                   None if qy is None else qy.data_ptr(),
                   None if ok_y is None else ok_y.data_ptr(),
                   r_bytes.data_ptr(), r_bytes.stride(0), consts.data_ptr(),
                   n, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"r_check kernel launch failed: CUDA error {rc}")
    r_check.launches += 1
    return out.view(torch.bool)


r_check.launches = 0
