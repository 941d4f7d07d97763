"""PoH entry wire format and the microblock mixins (ref: the entry batches
fd_poh/fd_shred exchange, src/disco/poh/fd_poh_tile.c and
src/disco/shred/fd_shredder.c); the port's own copy of
firedancer_tpu/ballet/entry.py.

    u64 num_hashes | hash[32] | u64 txn_cnt | txn_cnt * (u32 len | bytes)

An entry with txn_cnt == 0 is a tick.  The chain rule is the reference's
(fd_poh_append / mixin): the hash advances num_hashes - 1 times, then the
last step absorbs the mixin, the merkle root of the entry's txns' first
signatures.

txn_mixins_device computes a batch of mixins in one launch of the
mixin-tree kernel (ops/mixin_tree.py, replacing the JAX package's
_mixin_roots); on device "cpu" it runs the kernel's plain version.
"""

import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..ops.mixin_tree import mixin_tree
from . import bmtree


@dataclass
class Entry:
    num_hashes: int
    hash: bytes                    # chain state after this entry
    txns: list[bytes] = field(default_factory=list)

    @property
    def is_tick(self) -> bool:
        return not self.txns

    def serialize(self) -> bytes:
        out = bytearray(struct.pack("<Q", self.num_hashes))
        out += self.hash
        out += struct.pack("<Q", len(self.txns))
        for t in self.txns:
            out += struct.pack("<I", len(t)) + t
        return bytes(out)

    @classmethod
    def deserialize(cls, buf: bytes, off: int = 0) -> tuple["Entry", int]:
        (num_hashes,) = struct.unpack_from("<Q", buf, off)
        off += 8
        h = bytes(buf[off : off + 32])
        off += 32
        (n,) = struct.unpack_from("<Q", buf, off)
        off += 8
        txns = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", buf, off)
            off += 4
            txns.append(bytes(buf[off : off + ln]))
            off += ln
        return cls(num_hashes, h, txns), off


def serialize_batch(entries: list[Entry]) -> bytes:
    out = bytearray(struct.pack("<Q", len(entries)))
    for e in entries:
        out += e.serialize()
    return bytes(out)


def deserialize_batch(buf: bytes) -> list[Entry]:
    """Parse one or more concatenated serialize_batch blobs until the
    buffer is exhausted.  Up to 7 bytes of trailing padding are
    tolerated; a truncated batch raises ValueError."""
    off = 0
    out = []
    try:
        while off + 8 <= len(buf):
            (n,) = struct.unpack_from("<Q", buf, off)
            off += 8
            for _ in range(n):
                e, off = Entry.deserialize(buf, off)
                out.append(e)
    except (struct.error, IndexError) as e:
        raise ValueError(f"corrupt entry batch at {off}: {e}") from None
    return out


def serialize_txn_batch(txns: list[bytes]) -> bytes:
    """The pack -> PoH microblock frag payload: u32 cnt | cnt * (u32 len |
    bytes), the per-txn framing of Entry.serialize."""
    out = bytearray(struct.pack("<I", len(txns)))
    for t in txns:
        out += struct.pack("<I", len(t)) + t
    return bytes(out)


def deserialize_txn_batch(buf: bytes, off: int = 0) -> tuple[list[bytes], int]:
    """Inverse of serialize_txn_batch.  Raises ValueError on truncation."""
    try:
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        txns = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<I", buf, off)
            off += 4
            if off + ln > len(buf):
                raise ValueError(f"txn batch overruns buffer at {off}")
            txns.append(bytes(buf[off : off + ln]))
            off += ln
    except struct.error as e:
        raise ValueError(f"corrupt txn batch at {off}: {e}") from None
    return txns, off


def txn_mixin(txns: list[bytes]) -> bytes:
    """The mixin absorbed into the PoH chain for a txn entry: the 32-byte
    merkle root of the txns' first signatures."""
    sigs = [t[1 : 1 + 64] for t in txns]
    return bmtree.np_tree(sigs)[-1][0]


def next_hash(prev: bytes, num_hashes: int, mixin: bytes | None) -> bytes:
    """Advance the PoH chain: num_hashes-1 plain appends, then one append
    absorbing `mixin` (or num_hashes plain appends for a tick)."""
    h = prev
    plain = num_hashes - (1 if mixin is not None else 0)
    for _ in range(plain):
        h = hashlib.sha256(h).digest()
    if mixin is not None:
        h = hashlib.sha256(h + mixin).digest()
    return h


def _pow2_at_least(n: int) -> int:
    w = 1
    while w < n:
        w *= 2
    return w


def txn_mixins_device(txn_batches: list[list[bytes]], pad_batch: int = 0,
                      pad_width: int = 0, device=None) -> np.ndarray:
    """Mixins of a batch of microblocks in one launch of the mixin-tree
    kernel.  txn_batches: non-empty lists of raw wire txns (the first
    signature t[1:65] is the leaf, as txn_mixin).  pad_batch / pad_width
    pad the batch and leaf axes, as the JAX package does for its compiled
    shape.  device=None is the GPU.  Returns uint8 (len(txn_batches), 32)."""
    B = len(txn_batches)
    if B == 0:
        return np.zeros((0, 32), dtype=np.uint8)
    widths = np.array([len(ts) for ts in txn_batches], dtype=np.int32)
    if (widths < 1).any():
        raise ValueError("empty microblock has no mixin (tick instead)")
    Bp = max(B, int(pad_batch))
    W = _pow2_at_least(max(int(widths.max()), int(pad_width), 1))
    sigs = np.zeros((Bp, W, 64), dtype=np.uint8)
    for i, ts in enumerate(txn_batches):
        for j, t in enumerate(ts):
            sigs[i, j] = np.frombuffer(bytes(t[1:65]), dtype=np.uint8)
    wp = np.ones((Bp,), dtype=np.int32)
    wp[:B] = widths
    dev = resolve_device(device)
    out = mixin_tree(torch.from_numpy(sigs).to(dev),
                     torch.from_numpy(wp).to(dev))
    return out.cpu().numpy()[:B]


def warm_txn_mixins(batch: int, max_width: int, device=None) -> int:
    """Build the mixin-tree kernel and launch it at every power-of-two
    width up to max_width at `batch` trees; returns the shape count (the
    JAX package's compiled shapes)."""
    n = 0
    w = 1
    while True:
        txn_mixins_device([[b"\x00" * 65] * w], pad_batch=batch,
                          device=device)
        n += 1
        if w >= max_width:
            break
        w *= 2
    return n


def verify_chain(start: bytes, entries: list[Entry]) -> bool:
    """Host-side sequential chain check (the batched re-check over many
    entries is ballet.poh.verify_entries)."""
    h = start
    for e in entries:
        mix = None if e.is_tick else txn_mixin(e.txns)
        h = next_hash(h, e.num_hashes, mix)
        if h != e.hash:
            return False
    return True
