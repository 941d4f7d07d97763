"""Binary merkle trees with 32-byte nodes, host side: the port's own copy
of the host part of firedancer_tpu/ballet/bmtree.py (ref:
src/ballet/bmtree/), which entry.txn_mixin uses.  Domain separation
follows the Solana protocol: leaf = sha256(0x00 || data), interior =
sha256(0x01 || left || right), an odd node paired with itself.

The device tree of a microblock's mixin is ops/mixin_tree.py; the shred
trees' device walks are not ported.
"""

import hashlib

LEAF_PREFIX = 0x00
INTERIOR_PREFIX = 0x01


def _np_sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def np_tree(
    leaves: list[bytes],
    node_sz: int = 32,
    leaf_prefix: bytes = bytes([LEAF_PREFIX]),
    node_prefix: bytes = bytes([INTERIOR_PREFIX]),
) -> list[list[bytes]]:
    """All levels bottom-up; leaves are raw data (prefixed + hashed here)."""
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
