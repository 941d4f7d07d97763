"""The RLC batch check's per-signature scalar chain (csrc/rlc_recode.cu,
replacing firedancer_tpu/ops/curve_pallas.py::rlc_recode).

rlc_recode(s, digest, z) -> (ok_s, w_windows, z_windows, zs).  s, digest
and z are uint8 row views of any row stride, (n, 32), (n, 64) and
(n, 16).  ok_s is bool (n,), S < L; w_windows uint8 (64, n) are the
unsigned 4-bit windows of w = z k mod L for k = digest mod L; z_windows
uint8 (32, n) those of z; zs int64 (22, n) the canonical 12-bit limbs of
z s mod L (S as its bytes are), which ed25519._rlc_scalars sums over the
batch.  On a CUDA tensor the wrapper makes one launch, which writes every
output, or raises; on a CPU tensor it runs the plain version.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import scalar25519 as sc
from .sha512_kernel import _aligned_bits, _rows


def rlc_recode_plain(s, digest, z):
    """The plain torch version, as the JAX package's XLA chain computes
    it."""
    z_limbs = sc.bytes_to_limbs(z, 11)
    w_limbs = sc.mul_mod_l(sc.reduce_512(digest), z_limbs)
    zs = sc.mul_mod_l(sc.bytes_to_limbs(s, 22), z_limbs)
    z_windows = sc.limbs_to_windows(
        torch.cat([z_limbs, torch.zeros_like(z_limbs)]))[:32]
    return (sc.is_canonical(s), sc.limbs_to_windows(w_limbs).to(torch.uint8),
            z_windows.to(torch.uint8), zs)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("rlc_recode").fd_rlc_recode
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, ll, p, ll, i, i, p, p, p, p, p]
    fn.restype = i
    return fn


def rlc_recode(s, digest, z):
    if s.device.type == "cpu":
        return rlc_recode_plain(s, digest, z)
    n, dev = s.shape[0], s.device
    for t, w, name in ((s, 32, "s"), (digest, 64, "digest"), (z, 16, "z")):
        _rows(t, w, name)
        if t.device != dev or t.shape[0] != n:
            raise ValueError(f"{name}: device or row count differs")
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    w_win = torch.empty((64, n), dtype=torch.uint8, device=dev)
    z_win = torch.empty((32, n), dtype=torch.uint8, device=dev)
    zs = torch.empty((22, n), dtype=torch.int64, device=dev)
    if n:
        with torch.cuda.device(dev):
            rc = _fn()(s.data_ptr(), s.stride(0), digest.data_ptr(),
                       digest.stride(0), z.data_ptr(), z.stride(0), n,
                       _aligned_bits(s, digest, z), ok.data_ptr(),
                       w_win.data_ptr(), z_win.data_ptr(), zs.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(
                f"rlc_recode kernel launch failed: CUDA error {rc}")
        rlc_recode.launches += 1
    return ok, w_win, z_win, zs


rlc_recode.launches = 0
