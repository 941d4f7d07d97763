"""Shred merkle proofs walked to their 32-byte roots, one lane a proof
(csrc/bmtree_walk.cu, replacing
firedancer_tpu/ballet/bmtree.py::batch_walk_roots).

leaf_data uint8 (B, maxlen), lengths (B,), indices (B,) the leaves' tree
indices, proofs uint8 (B, D, 20), depths (B,).  Lane i's leaf hash is
SHA-256(LEAF_PREFIX_LONG || leaf_data[i][:lengths[i]]); each of its
depths[i] levels hashes NODE_PREFIX_LONG || left || right of the running
node's first 20 bytes and the level's proof node, the proof node on the
left where bit lvl of the index is set.  Returns the full last digests,
uint8 (B, 32).  Lengths outside [0, maxlen] and depths outside [0, D]
raise ValueError (the JAX function reads zeros past the row there; the
port refuses them instead).  On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version.
"""

import ctypes
import functools

import numpy as np
import torch

from ..kernels import build
from . import sha256 as sh

LEAF_PREFIX_LONG = b"\x00SOLANA_MERKLE_SHREDS_LEAF"
NODE_PREFIX_LONG = b"\x01SOLANA_MERKLE_SHREDS_NODE"
MERKLE_NODE_SZ = 20


def _prefix(p: bytes, B: int, device):
    return torch.tensor(list(p), dtype=torch.uint8,
                        device=device)[None, :].expand(B, len(p))


def bmtree_walk_plain(leaf_data, lengths, indices, proofs, depths):
    """The plain torch version: batch_walk_roots' batched SHA-256 a
    level, each level masked by depth."""
    B = leaf_data.shape[0]
    D = proofs.shape[1]
    dev = leaf_data.device
    npre = len(NODE_PREFIX_LONG)
    h = sh.sha256(torch.cat([_prefix(LEAF_PREFIX_LONG, B, dev), leaf_data],
                            1),
                  lengths.to(torch.int64) + len(LEAF_PREFIX_LONG))
    idx = indices.to(torch.int64)
    node_pre = _prefix(NODE_PREFIX_LONG, B, dev)
    lens = torch.full((B,), npre + 2 * MERKLE_NODE_SZ, dtype=torch.int64,
                      device=dev)
    for lvl in range(D):
        t = h[:, :MERKLE_NODE_SZ]
        p = proofs[:, lvl, :]
        right_child = (((idx >> lvl) & 1) != 0)[:, None]
        left = torch.where(right_child, p, t)
        right = torch.where(right_child, t, p)
        h2 = sh.sha256(torch.cat([node_pre, left, right], 1), lens)
        h = torch.where((depths.to(torch.int64) > lvl)[:, None], h2, h)
    return h


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("bmtree_walk").fd_bmtree_walk
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, q, p, p, p, q, i, p, i, p, p]
    fn.restype = i
    return fn


def _host_ints(x, B: int, what: str) -> np.ndarray:
    """An int column as a host int64 array: numpy and CPU tensors are
    read where they are; a device tensor is copied back (a sync)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    x = np.ascontiguousarray(x, dtype=np.int64)
    if x.shape != (B,):
        raise ValueError(f"{what}: need ({B},), got {x.shape}")
    return x


def _check_ranges(lengths, depths, B: int, maxlen: int, D: int):
    lens = _host_ints(lengths, B, "lengths")
    deps = _host_ints(depths, B, "depths")
    if B and (lens.min() < 0 or lens.max() > maxlen):
        raise ValueError(f"lengths outside [0, {maxlen}]: "
                         f"{lens.min()}..{lens.max()}")
    if B and (deps.min() < 0 or deps.max() > D):
        raise ValueError(f"depths outside [0, {D}]: "
                         f"{deps.min()}..{deps.max()}")
    return lens, deps


def bmtree_walk(leaf_data, lengths, indices, proofs, depths):
    """Roots uint8 (B, 32).  leaf_data and proofs are tensors on one
    device, each row's bytes contiguous (rows may be views into a wider
    blob); lengths, indices and depths are int arrays on the host (numpy
    or CPU tensors, uploaded here) or on that device."""
    if leaf_data.dtype != torch.uint8 or leaf_data.dim() != 2:
        raise ValueError(f"leaf_data: need uint8 (B, maxlen), got "
                         f"{leaf_data.dtype} {tuple(leaf_data.shape)}")
    B, maxlen = leaf_data.shape
    if (proofs.dtype != torch.uint8 or proofs.dim() != 3
            or proofs.shape[0] != B or proofs.shape[2] != MERKLE_NODE_SZ
            or proofs.device != leaf_data.device):
        raise ValueError(f"proofs: need uint8 ({B}, D, {MERKLE_NODE_SZ}) "
                         f"on the leaves' device, got {proofs.dtype} "
                         f"{tuple(proofs.shape)}")
    D = proofs.shape[1]
    lens, deps = _check_ranges(lengths, depths, B, maxlen, D)
    idxs = _host_ints(indices, B, "indices")
    dev = leaf_data.device
    if dev.type == "cpu":
        return bmtree_walk_plain(leaf_data, torch.from_numpy(lens),
                                 torch.from_numpy(idxs), proofs,
                                 torch.from_numpy(deps))
    out = torch.empty((B, 32), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    if leaf_data.stride(1) != 1:
        leaf_data = leaf_data.contiguous()
    if proofs.stride(2) != 1 or proofs.stride(1) != MERKLE_NODE_SZ:
        proofs = proofs.contiguous()
    ints = torch.from_numpy(np.stack([lens, idxs, deps]).astype(np.int32))
    ints = ints.pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        rc = _fn()(leaf_data.data_ptr(), leaf_data.stride(0),
                   ints[0].data_ptr(), ints[1].data_ptr(), proofs.data_ptr(),
                   proofs.stride(0), D, ints[2].data_ptr(), B,
                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"bmtree_walk kernel launch failed: CUDA error "
                           f"{rc}")
    bmtree_walk.launches += 1
    return out


bmtree_walk.launches = 0
