"""Batched point decompression with the small-order test
(csrc/decompress.cu, replacing
firedancer_tpu/ops/curve_pallas.py::decompress).

decompress(b) -> (ok, small, Point).  b is a uint8 (n, 32) row view of
any row stride.  ok: the encoded y has a point (RFC 8032 decoding, a y >=
p accepted mod p); small: the point has order <= 8; both bool (n,).  The
Point has X, Y, Z, T as int64 (10, n) limb planes (ops/f25519.py), Y the
encoded y as fe.from_bytes reads it, and Z = 1.  Lanes with ok False hold
an unspecified point that is safe to compute with.

decompress_pair(a, r) -> ((ok, small, Point), (ok, small, Point)): the
same for two row views of n rows each (the keys and the R values of the
RLC check) in one launch over 2n lanes.

On a CUDA tensor a wrapper makes one launch, which writes every output
(the bits as bool planes of one buffer, the coordinates as the planes of
one (4, 10, n) buffer, (2, 4, 10, n) for a pair), or raises; on a CPU
tensor it runs the plain version.
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


def decompress_pair_plain(a, r):
    return decompress_plain(a), decompress_plain(r)


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
    fn.argtypes = [p, ll, p, ll, p, i, i, p, p, p]
    fn.restype = i
    return fn


def _launch(*named):
    """One launch over the rows of k = 1 or 2 (name, view) pairs of n rows
    each: a (ok, small, Point) triple a view, from bits (k, 2, n) bool
    and points (k, 4, 10, n) int64."""
    views = [b for _, b in named]
    n, dev = views[0].shape[0], views[0].device
    for name, b in named:
        _rows(b, 32, name)
        if b.device != dev or b.shape[0] != n:
            raise ValueError(f"{name}: device or row count differs")
    k = len(views)
    bits = torch.empty((k, 2, n), dtype=torch.bool, device=dev)
    pts = torch.empty((k, 4, fe.NLIMB, n), dtype=torch.int64, device=dev)
    if n:
        b1 = views[-1]
        with torch.cuda.device(dev):
            rc = _fn()(views[0].data_ptr(), views[0].stride(0),
                       b1.data_ptr(), b1.stride(0),
                       kernel_consts(dev).data_ptr(), n, k * n,
                       bits.data_ptr(), pts.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(
                f"decompress kernel launch failed: CUDA error {rc}")
        decompress.launches += 1
    return tuple((bits[i, 0], bits[i, 1], cv.Point(*pts[i].unbind(0)))
                 for i in range(k))


def decompress(b):
    if b.device.type == "cpu":
        return decompress_plain(b)
    return _launch(("b", b))[0]


def decompress_pair(a, r):
    if a.device.type == "cpu":
        return decompress_pair_plain(a, r)
    return _launch(("a", a), ("r", r))


decompress.launches = 0
