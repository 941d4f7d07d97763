"""k = SHA-512(R || A || M) for a batch of signatures: kernel 1 of the
strict verify path (csrc/sha512.cu, replacing
firedancer_tpu/ops/sha512_pallas.py::sha512).

Inputs are uint8 row views of any row stride (the columns of a packed
blob, or separate arrays): msgs (n, ml), r and a (n, 32) and the
little-endian int32 message lengths as bytes, len4 (n, 4).  A length is
clamped to [0, ml].  On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it runs the plain version.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import sha512 as sh


def lens_from_bytes(len4):
    """(n, 4) little-endian bytes -> int64 (n,) signed int32 values."""
    sh_ = torch.tensor([0, 8, 16, 24], device=len4.device)
    v = (len4.to(torch.int64) << sh_).sum(1)
    return torch.where(v >= 2**31, v - 2**32, v)


def lens_to_bytes(lens):
    """int (n,) lengths -> their (n, 4) little-endian int32 bytes."""
    return lens.to(torch.int32).contiguous().view(torch.uint8).reshape(-1, 4)


def sha512_ram_plain(msgs, r, a, len4):
    """The plain torch version: ops/sha512.py over the concatenation."""
    lens = lens_from_bytes(len4).clamp(0, msgs.shape[1])
    return sh.sha512(torch.cat([r, a, msgs], 1), lens + 64)


def _rows(t, width: int | None, name: str):
    if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name}: need a uint8 (n, w) view with unit "
                         f"column stride, got {t.dtype} {tuple(t.shape)} "
                         f"strides {t.stride()}")
    if width is not None and t.shape[1] != width:
        raise ValueError(f"{name}: need width {width}, got {t.shape[1]}")


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("sha512").fd_sha512_ram
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, ll, p, ll, p, ll, i, i, p, p]
    fn.restype = i
    return fn


def sha512_ram(msgs, r, a, len4):
    """Digests uint8 (n, 64) of R || A || M[:clamp(len, 0, ml)]."""
    if msgs.device.type == "cpu":
        return sha512_ram_plain(msgs, r, a, len4)
    n = msgs.shape[0]
    for t, w, name in ((msgs, None, "msgs"), (r, 32, "r"), (a, 32, "a"),
                       (len4, 4, "len4")):
        _rows(t, w, name)
        if t.device != msgs.device or t.shape[0] != n:
            raise ValueError(f"{name}: device or row count differs")
    out = torch.empty((n, 64), dtype=torch.uint8, device=msgs.device)
    if n == 0:
        return out
    with torch.cuda.device(msgs.device):
        rc = _fn()(msgs.data_ptr(), msgs.stride(0), r.data_ptr(),
                   r.stride(0), a.data_ptr(), a.stride(0), len4.data_ptr(),
                   len4.stride(0), msgs.shape[1], n, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"sha512 kernel launch failed: CUDA error {rc}")
    sha512_ram.launches += 1
    return out


sha512_ram.launches = 0
