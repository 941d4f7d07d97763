"""Binary merkle trees (20- and 32-byte nodes): the port's own copy of
firedancer_tpu/ballet/bmtree.py's host trees and batched proof walk (ref:
src/ballet/bmtree/).  Domain separation follows the Solana protocol:
leaf = sha256(0x00 || data), interior = sha256(0x01 || left || right), an
odd node paired with itself; shred trees use the long prefixes and
20-byte interior nodes.

The device tree of a microblock's mixin is ops/mixin_tree.py; the
batched shred proof walk (batch_walk_roots) is ops/bmtree_walk.py, one
kernel launch a burst.  hash_leaves, root_from_leaves and commit (the
JAX package's whole-tree device commit, which nothing outside its tests
calls) are not ported.
"""

import hashlib

import numpy as np
import torch

from .._device import resolve_device
from ..ops import bmtree_walk as bw

LEAF_PREFIX = 0x00
INTERIOR_PREFIX = 0x01

# Long domain-separation prefixes used by the Solana shred merkle tree
# (fd_bmtree.c:141-142); the 1-byte short prefixes above are the generic
# 32-byte-tree form.
LEAF_PREFIX_LONG = bw.LEAF_PREFIX_LONG
NODE_PREFIX_LONG = bw.NODE_PREFIX_LONG

# ---------------------------------------------------------------------------
# Batched proof walk (shred trees): B inclusion proofs -> B untruncated
# roots in one kernel launch.  The walk is the device twin of
# shred.walk_merkle_root: leaf = sha256(LEAF_PREFIX_LONG || data), each
# level truncates the running node to 20 bytes, pairs it with the sibling
# by the index bit, and rehashes under NODE_PREFIX_LONG; the ROOT is the
# final full 32-byte digest.

MERKLE_NODE_SZ = bw.MERKLE_NODE_SZ


def _on(x, dev):
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8)).to(dev)


def batch_walk_roots(leaf_data, lengths, indices, proofs, depths,
                     device=None):
    """leaf_data u8 (B, maxlen); lengths (B,); indices (B,) = leaf tree
    index; proofs u8 (B, D, 20); depths (B,) <= D.  Returns u8 (B, 32)
    roots, a tensor on the leaves' device.  Tensors stay where they are;
    numpy leaves and proofs go to `device` (None: the GPU).  The int
    columns may stay on the host.  Lengths outside [0, maxlen] and depths
    outside [0, D] raise ValueError."""
    dev = (leaf_data.device if isinstance(leaf_data, torch.Tensor)
           else resolve_device(device))
    return bw.bmtree_walk(_on(leaf_data, dev), lengths, indices,
                          _on(proofs, dev), depths)


def np_batch_walk_roots(leaf_datas, indices, proofs) -> list[bytes]:
    """Host golden twin of batch_walk_roots (ragged lists, hashlib)."""
    out = []
    for leaf, idx, proof in zip(leaf_datas, indices, proofs):
        h = _np_sha256(LEAF_PREFIX_LONG + bytes(leaf))
        for p in proof:
            t = h[:MERKLE_NODE_SZ]
            pair = (bytes(p) + t) if idx & 1 else (t + bytes(p))
            h = _np_sha256(NODE_PREFIX_LONG + pair)
            idx >>= 1
        out.append(h)
    return out


# ---------------------------------------------------------------------------
# Host-side proof plumbing — control plane, mirrors the device tree.


def _np_sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def np_tree(
    leaves: list[bytes],
    node_sz: int = 32,
    leaf_prefix: bytes = bytes([LEAF_PREFIX]),
    node_prefix: bytes = bytes([INTERIOR_PREFIX]),
) -> list[list[bytes]]:
    """All levels bottom-up; leaves are raw data (prefixed + hashed here).
    Pass LEAF_PREFIX_LONG/NODE_PREFIX_LONG + node_sz=20 for shred trees."""
    level = [_np_sha256(leaf_prefix + d)[:node_sz] for d in leaves]
    levels = [level]
    while len(level) > 1:
        if len(level) % 2:
            level = level + [level[-1]]
        level = [
            _np_sha256(node_prefix + level[i] + level[i + 1])[:node_sz]
            for i in range(0, len(level), 2)
        ]
        levels.append(level)
    return levels


def np_proof(levels: list[list[bytes]], idx: int) -> list[bytes]:
    """Inclusion proof (sibling path) for leaf idx."""
    proof = []
    for level in levels[:-1]:
        sib = idx ^ 1
        if sib >= len(level):
            sib = idx  # odd promotion: sibling is self
        proof.append(level[sib])
        idx //= 2
    return proof


def np_verify_proof(
    leaf_data: bytes,
    idx: int,
    proof: list[bytes],
    root: bytes,
    node_sz: int = 32,
    leaf_prefix: bytes = bytes([LEAF_PREFIX]),
    node_prefix: bytes = bytes([INTERIOR_PREFIX]),
) -> bool:
    node = _np_sha256(leaf_prefix + leaf_data)[:node_sz]
    for sib in proof:
        pair = (node + sib) if idx % 2 == 0 else (sib + node)
        node = _np_sha256(node_prefix + pair)[:node_sz]
        idx //= 2
    return node == root
