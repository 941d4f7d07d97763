"""S canonicity, k = digest mod L and the signed recode of S and k: the
first kernel of the split strict layout (csrc/reduce_recode.cu, replacing
firedancer_tpu/ops/curve_pallas.py::reduce_recode).

reduce_recode(s, digest) -> (ok_s, (smag, ssgn, kmag, ksgn)).  s and
digest are uint8 row views of any row stride, (n, 32) and (n, 64).  ok_s
is bool (n,), S < L; the four windows are uint8 (64, n) planes, low
window first: magnitudes 0..8 and signs 0/1 of S (its bytes as they are,
the carry out of the top window dropped) and of k.  On a CUDA tensor the
wrapper makes one launch, which writes every output, or raises; on a CPU
tensor it runs the plain version.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import scalar25519 as sc
from .sha512_kernel import _aligned_bits, _rows


def reduce_recode_plain(s, digest):
    """The plain torch version: the scalar steps of verify_tail_plain."""
    k_mag, k_sgn = sc.signed_windows(
        sc.limbs_to_windows(sc.reduce_512(digest)))
    s_mag, s_sgn = sc.signed_windows(sc.scalar_windows(s))
    return sc.is_canonical(s), tuple(
        t.to(torch.uint8) for t in (s_mag, s_sgn, k_mag, k_sgn))


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("reduce_recode").fd_reduce_recode
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, ll, i, i, p, p, p]
    fn.restype = i
    return fn


def reduce_recode(s, digest):
    if s.device.type == "cpu":
        return reduce_recode_plain(s, digest)
    n, dev = s.shape[0], s.device
    for t, w, name in ((s, 32, "s"), (digest, 64, "digest")):
        _rows(t, w, name)
        if t.device != dev or t.shape[0] != n:
            raise ValueError(f"{name}: device or row count differs")
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    wins = torch.empty((4, 64, n), dtype=torch.uint8, device=dev)
    if n:
        with torch.cuda.device(dev):
            rc = _fn()(s.data_ptr(), s.stride(0), digest.data_ptr(),
                       digest.stride(0), n, _aligned_bits(s, digest),
                       ok.data_ptr(), wins.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(
                f"reduce_recode kernel launch failed: CUDA error {rc}")
        reduce_recode.launches += 1
    return ok, tuple(wins.unbind(0))


reduce_recode.launches = 0
