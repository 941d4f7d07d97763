"""Microblock mixins: the merkle root of each microblock's first
signatures (csrc/mixin_tree.cu, replacing
firedancer_tpu/ballet/entry.py::_mixin_roots).

sigs: uint8 (B, W, 64), W a power of two, rows past a tree's width
ignored; widths: int32 (B,) >= 1.  A leaf is SHA-256(0x00 || sig), an
interior node SHA-256(0x01 || left || right); where a pair's right index
falls past the live width the left node is hashed with itself.  Returns
the roots, uint8 (B, 32), bit-identical to entry.txn_mixin per tree.  A
width past W gives W's tree.  On
a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import sha256 as sh

LEAF_PREFIX = 0x00
INTERIOR_PREFIX = 0x01
MAX_W = 1024   # one block a tree, at most 8 pairs of warps


def mixin_tree_plain(sigs, widths):
    """The plain torch version: _mixin_roots, one batched SHA-256 a
    level over every tree."""
    B, W, _ = sigs.shape
    dev = sigs.device
    pre = torch.full((B, W, 1), LEAF_PREFIX, dtype=torch.uint8, device=dev)
    buf = torch.cat([pre, sigs], 2).reshape(B * W, 65)
    lens = torch.full((B * W,), 65, dtype=torch.int64, device=dev)
    nodes = sh.sha256(buf, lens).reshape(B, W, 32)
    w = widths.to(torch.int64)
    while W > 1:
        half = W // 2
        left, right = nodes[:, 0::2], nodes[:, 1::2]
        use_self = (torch.arange(half, device=dev) * 2 + 1)[None, :] \
            >= w[:, None]
        right = torch.where(use_self[:, :, None], left, right)
        ipre = torch.full((B, half, 1), INTERIOR_PREFIX, dtype=torch.uint8,
                          device=dev)
        ibuf = torch.cat([ipre, left, right], 2).reshape(B * half, 65)
        hashed = sh.sha256(ibuf, lens[:B * half]).reshape(B, half, 32)
        done = w <= 1             # tree already reduced: root in column 0
        nodes = torch.where(done[:, None, None], nodes[:, :half], hashed)
        w = torch.where(done, w, (w + 1) // 2)
        W = half
    return nodes[:, 0]


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("mixin_tree").fd_mixin_tree
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, p, p]
    fn.restype = i
    return fn


def mixin_tree(sigs, widths):
    """Roots uint8 (B, 32) of B trees over sigs (B, W, 64)."""
    if sigs.dtype != torch.uint8 or sigs.dim() != 3 or sigs.shape[2] != 64:
        raise ValueError(f"sigs: need uint8 (B, W, 64), got {sigs.dtype} "
                         f"{tuple(sigs.shape)}")
    B, W, _ = sigs.shape
    if W < 1 or W & (W - 1) or W > MAX_W:
        raise ValueError(f"width {W}: need a power of two <= {MAX_W}")
    if widths.shape != (B,) or widths.device != sigs.device:
        raise ValueError("widths: need (B,) on the sigs' device")
    if sigs.device.type == "cpu":
        return mixin_tree_plain(sigs, widths)
    sigs = sigs.contiguous()
    if sigs.data_ptr() % 16:        # the kernel loads a leaf as 4 x 16 bytes
        sigs = sigs.clone()
    widths = widths.to(torch.int32).contiguous()
    out = torch.empty((B, 32), dtype=torch.uint8, device=sigs.device)
    if B == 0:
        return out
    with torch.cuda.device(sigs.device):
        rc = _fn()(sigs.data_ptr(), widths.data_ptr(), B, W, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"mixin_tree kernel launch failed: CUDA error {rc}")
    mixin_tree.launches += 1
    return out


mixin_tree.launches = 0
