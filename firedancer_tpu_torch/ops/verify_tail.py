"""The fused strict-verify tail: kernel 2 of the verify path in its
default layout, ed25519.verify_batch(tail="fused") (csrc/verify_tail.cu,
replacing firedancer_tpu/ops/curve_pallas.py::verify_tail_fused).

verify_tail(pub, s, digest, r) -> (ok, X, Z).  ok folds: A decompresses,
A is not of small order, S < L, and the projective y-compare Q.Y == y_R *
Q.Z holds for Q = [S]B + [k](-A), k = digest mod L, y_R = R's encoded y
mod p.  X and Z are Q's (10, n) int64 limb planes, for the x-parity check
that the r_check kernel (ops/r_check.py) finishes with.  Inputs are uint8 row
views of any row stride: pub, s and r (n, 32), digest (n, 64).  On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it runs
the plain version, built from ops/f25519, scalar25519 and curve25519.

The other two layouts run the same steps as separate calls: "split" the
decompress, reduce_recode and dsm_tail_q kernels, "unfused" the
decompress kernel, the scalar steps in torch and the
double_scalar_mul_base kernel.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import curve25519 as cv
from . import f25519 as fe
from .dsm import dsm_tail_q_plain, kernel_consts
from .reduce_recode import reduce_recode_plain
from .sha512_kernel import _rows


def verify_tail_plain(pub, s, digest, r):
    """The plain torch version, the same steps in the same order."""
    ok_a, a = cv.decompress(pub)
    small = cv.is_small_order_affine(a)
    ok_s, wins = reduce_recode_plain(s, digest)
    ok_y, qx, qz = dsm_tail_q_plain(wins, a, fe.from_bytes(r))
    return ok_a & ~small & ok_s & ok_y, qx, qz


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("verify_tail").fd_verify_tail
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, ll, p, ll, p, ll, p, i, p, p, p, p]
    fn.restype = i
    return fn


def verify_tail(pub, s, digest, r):
    if pub.device.type == "cpu":
        return verify_tail_plain(pub, s, digest, r)
    n = pub.shape[0]
    for t, w, name in ((pub, 32, "pub"), (s, 32, "s"), (digest, 64, "digest"),
                       (r, 32, "r")):
        _rows(t, w, name)
        if t.device != pub.device or t.shape[0] != n:
            raise ValueError(f"{name}: device or row count differs")
    dev = pub.device
    ok = torch.empty(n, dtype=torch.uint8, device=dev)
    x = torch.empty((fe.NLIMB, n), dtype=torch.int64, device=dev)
    z = torch.empty((fe.NLIMB, n), dtype=torch.int64, device=dev)
    if n == 0:
        return ok.bool(), x, z
    consts = kernel_consts(dev)
    with torch.cuda.device(dev):
        rc = _fn()(pub.data_ptr(), pub.stride(0), s.data_ptr(), s.stride(0),
                   digest.data_ptr(), digest.stride(0), r.data_ptr(),
                   r.stride(0), consts.data_ptr(), n, ok.data_ptr(),
                   x.data_ptr(), z.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"verify_tail kernel launch failed: CUDA error {rc}")
    verify_tail.launches += 1
    return ok.bool(), x, z


verify_tail.launches = 0
