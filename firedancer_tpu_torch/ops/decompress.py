"""Batched point decompression with the small-order test
(csrc/decompress.cu, replacing
firedancer_tpu/ops/curve_pallas.py::decompress).

decompress(b) -> (ok, small, Point).  b is a uint8 (n, 32) row view of
any row stride.  ok: the encoded y has a point (RFC 8032 decoding, a y >=
p accepted mod p); small: the point has order <= 8; both bool (n,).  The
Point has X, Y, T as int64 (10, n) limb planes (ops/f25519.py), Y the
encoded y as fe.from_bytes reads it, and Z = 1.  Lanes with ok False hold
an unspecified point that is safe to compute with.  On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs the plain
version.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import curve25519 as cv
from . import f25519 as fe
from .sha512_kernel import _rows


def decompress_plain(b):
    """The plain torch version, the same steps in the same order."""
    ok, pt = cv.decompress(b)
    return ok, cv.is_small_order_affine(pt), pt


@functools.lru_cache(maxsize=None)
def kernel_consts(device) -> torch.Tensor:
    """The kernel's int32 (4, 10) constants: d, sqrt(-1) and the two
    order-8 y values (csrc/decompress.cu)."""
    rows = [cv.D, cv.SQRT_M1, cv.ORDER8_Y0, cv.ORDER8_Y1]
    return torch.tensor([fe.int_to_limbs(v) for v in rows],
                        dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("decompress").fd_decompress
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, i, p, p, p, p, p, p]
    fn.restype = i
    return fn


def decompress(b):
    if b.device.type == "cpu":
        return decompress_plain(b)
    _rows(b, 32, "b")
    n, dev = b.shape[0], b.device
    ok = torch.empty(n, dtype=torch.uint8, device=dev)
    small = torch.empty(n, dtype=torch.uint8, device=dev)
    x, y, t = (torch.empty((fe.NLIMB, n), dtype=torch.int64, device=dev)
               for _ in range(3))
    if n:
        with torch.cuda.device(dev):
            rc = _fn()(b.data_ptr(), b.stride(0),
                       kernel_consts(dev).data_ptr(), n, ok.data_ptr(),
                       small.data_ptr(), x.data_ptr(), y.data_ptr(),
                       t.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(
                f"decompress kernel launch failed: CUDA error {rc}")
        decompress.launches += 1
    return ok.bool(), small.bool(), cv.Point(x, y, fe.ones(n, dev), t)


decompress.launches = 0
