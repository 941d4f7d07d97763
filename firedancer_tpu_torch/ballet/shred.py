"""Shred wire format: parse/construct, shredder, and FEC recovery; the
port's own copy of firedancer_tpu/ballet/shred.py.

Reference role: src/ballet/shred/ (fd_shred.h wire layout),
src/disco/shred/fd_shredder.c (entry batch -> FEC sets: data shreds +
Reed-Solomon parity + merkle commitment + leader signature) and
fd_fec_resolver.c (incoming side: collect a partial FEC set, recover the
erasures, verify the merkle inclusion of every shred).

Merkle-variant shreds only (what mainnet emits today): the leader signs
the 20-byte-node merkle root committing to the whole FEC set, and every
shred carries its inclusion proof, so a receiver can authenticate any
single packet in isolation.  Layouts/constants follow fd_shred.h:10-232
exactly; domain prefixes for the tree are the long Solana prefixes
(fd_bmtree.c:141-142).

Device hooks: parity generation and FecResolver.recover ride
ballet/reedsol's GF(2) kernel (torch_device picks the card: None is the
GPU, "cpu" runs the kernel's plain version); the batched merkle walk of
a burst is bmtree.batch_walk_roots.  Wire parse/construct is host work.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import bmtree, reedsol

MAX_SZ = 1228
MIN_SZ = 1203
DATA_HEADER_SZ = 0x58  # 88
CODE_HEADER_SZ = 0x59  # 89
SIGNATURE_SZ = 64
MERKLE_NODE_SZ = 20
MERKLE_ROOT_SZ = 32

TYPE_LEGACY_DATA = 0xA0
TYPE_LEGACY_CODE = 0x50
TYPE_MERKLE_DATA = 0x80
TYPE_MERKLE_CODE = 0x40
TYPE_MERKLE_DATA_CHAINED = 0x90
TYPE_MERKLE_CODE_CHAINED = 0x60
TYPE_MERKLE_DATA_CHAINED_RESIGNED = 0xB0
TYPE_MERKLE_CODE_CHAINED_RESIGNED = 0x70

TYPEMASK_DATA = TYPE_MERKLE_DATA
TYPEMASK_CODE = TYPE_MERKLE_CODE

FLAG_SLOT_COMPLETE = 0x80
FLAG_DATA_COMPLETE = 0x40
REF_TICK_MASK = 0x3F

MAX_PER_SLOT = 1 << 15


def shred_type(variant: int) -> int:
    return variant & 0xF0


def is_data(variant: int) -> bool:
    # all data types have the 0x80 bit set (0xA0/0x80/0x90/0xB0); no code
    # type does (0x50/0x40/0x60/0x70)
    return bool(shred_type(variant) & TYPEMASK_DATA)


def _merkle_cnt(variant: int) -> int:
    """Number of non-root proof nodes (low nibble, merkle variants)."""
    return variant & 0x0F


@dataclass
class Shred:
    """Parsed shred header (fd_shred_t) + the raw buffer."""

    raw: bytes
    signature: bytes
    variant: int
    slot: int
    idx: int
    version: int
    fec_set_idx: int
    # data shreds
    parent_off: int = 0
    flags: int = 0
    size: int = 0  # headers + payload
    # code shreds
    data_cnt: int = 0
    code_cnt: int = 0
    code_idx: int = 0

    @property
    def type(self) -> int:
        return shred_type(self.variant)

    @property
    def is_data(self) -> bool:
        return is_data(self.variant)

    @property
    def merkle_proof_len(self) -> int:
        return _merkle_cnt(self.variant) if self.type not in (
            TYPE_LEGACY_DATA,
            TYPE_LEGACY_CODE,
        ) else 0

    def payload(self) -> bytes:
        if self.is_data:
            return self.raw[DATA_HEADER_SZ : self.size]
        return self.raw[CODE_HEADER_SZ : CODE_HEADER_SZ + self._code_payload_sz()]

    def _code_payload_sz(self) -> int:
        return len(self.raw) - CODE_HEADER_SZ - self._trailer_sz()

    def _trailer_sz(self) -> int:
        """Wire trailer past the payload: [chained merkle root (32)]
        [proof nodes (20 each, NO root stored)] [retransmitter sig (64)]
        — the root is COMPUTED by walking the proof (fd_shred.h layout;
        round-4 fix: the r3 layout materialized the root in the trailer,
        which no real Agave shred does)."""
        t = self.type
        sz = 0
        if t in (TYPE_MERKLE_DATA_CHAINED, TYPE_MERKLE_CODE_CHAINED,
                 TYPE_MERKLE_DATA_CHAINED_RESIGNED, TYPE_MERKLE_CODE_CHAINED_RESIGNED):
            sz += MERKLE_ROOT_SZ
        if t not in (TYPE_LEGACY_DATA, TYPE_LEGACY_CODE):
            sz += MERKLE_NODE_SZ * self.merkle_proof_len
        if t in (TYPE_MERKLE_DATA_CHAINED_RESIGNED, TYPE_MERKLE_CODE_CHAINED_RESIGNED):
            sz += SIGNATURE_SZ
        return sz

    def _proof_off(self) -> int:
        end = len(self.raw)
        t = self.type
        if t in (TYPE_MERKLE_DATA_CHAINED_RESIGNED, TYPE_MERKLE_CODE_CHAINED_RESIGNED):
            end -= SIGNATURE_SZ
        return end - MERKLE_NODE_SZ * self.merkle_proof_len

    def proof_nodes(self) -> list[bytes]:
        """The stored inclusion proof (sibling path, leaf upward)."""
        t = self.type
        if t in (TYPE_LEGACY_DATA, TYPE_LEGACY_CODE):
            return []
        start = self._proof_off()
        return [
            self.raw[start + i * MERKLE_NODE_SZ : start + (i + 1) * MERKLE_NODE_SZ]
            for i in range(self.merkle_proof_len)
        ]

    def tree_index(self, data_cnt: int | None = None) -> int:
        """Leaf index in the FEC set's tree: data shreds sit at
        idx - fec_set_idx; parity at data_cnt + code_idx (the fec
        resolver's shred_idx recipe, fd_fec_resolver.c:352)."""
        if self.is_data:
            return self.idx - self.fec_set_idx
        return (self.data_cnt if data_cnt is None else data_cnt) + self.code_idx

    def merkle_root(self, data_cnt: int | None = None) -> bytes | None:
        """The 32-byte root the leader SIGNS, computed by hashing the leaf
        and walking the stored proof (interior children truncate to 20
        bytes; the root itself is the untruncated sha256 — validated
        against the real capture, tests/golden/demo-shreds.pcap)."""
        if self.type in (TYPE_LEGACY_DATA, TYPE_LEGACY_CODE):
            return None
        return walk_merkle_root(
            self.merkle_leaf_data(), self.tree_index(data_cnt),
            self.proof_nodes())

    def merkle_leaf_data(self) -> bytes:
        """The bytes the merkle leaf hash covers: everything after the
        signature up to the proof (chained roots are INSIDE the covered
        span; the retransmitter signature is not)."""
        return self.raw[SIGNATURE_SZ : self._proof_off()]


def walk_merkle_root(leaf_data: bytes, index: int,
                     proof: list[bytes]) -> bytes:
    """leaf bytes + tree index + sibling path -> 32-byte signed root."""
    import hashlib
    h = hashlib.sha256(bmtree.LEAF_PREFIX_LONG + leaf_data).digest()
    for p in proof:
        t = h[:MERKLE_NODE_SZ]
        pair = p + t if index & 1 else t + p
        h = hashlib.sha256(bmtree.NODE_PREFIX_LONG + pair).digest()
        index >>= 1
    return h


class ShredParseError(ValueError):
    pass


def parse(buf: bytes) -> Shred:
    """Parse + validate an untrusted shred (fd_shred_parse semantics)."""
    if len(buf) < CODE_HEADER_SZ:
        raise ShredParseError("too short")
    variant = buf[0x40]
    t = shred_type(variant)
    if t not in (
        TYPE_LEGACY_DATA, TYPE_LEGACY_CODE, TYPE_MERKLE_DATA, TYPE_MERKLE_CODE,
        TYPE_MERKLE_DATA_CHAINED, TYPE_MERKLE_CODE_CHAINED,
        TYPE_MERKLE_DATA_CHAINED_RESIGNED, TYPE_MERKLE_CODE_CHAINED_RESIGNED,
    ):
        raise ShredParseError(f"bad type {t:#x}")
    if t == TYPE_LEGACY_DATA and (variant & 0x0F) != 0x05:
        raise ShredParseError("bad legacy data variant")
    if t == TYPE_LEGACY_CODE and (variant & 0x0F) != 0x0A:
        raise ShredParseError("bad legacy code variant")

    s = Shred(
        raw=bytes(buf),
        signature=bytes(buf[:64]),
        variant=variant,
        slot=int.from_bytes(buf[0x41:0x49], "little"),
        idx=int.from_bytes(buf[0x49:0x4D], "little"),
        version=int.from_bytes(buf[0x4D:0x4F], "little"),
        fec_set_idx=int.from_bytes(buf[0x4F:0x53], "little"),
    )
    if s.idx >= MAX_PER_SLOT:
        raise ShredParseError("shred idx out of range")
    if s.is_data:
        s.parent_off = int.from_bytes(buf[0x53:0x55], "little")
        s.flags = buf[0x55]
        s.size = int.from_bytes(buf[0x56:0x58], "little")
        if not (DATA_HEADER_SZ <= s.size <= len(buf)):
            raise ShredParseError("bad data size field")
        if s.parent_off == 0 and s.slot != 0:
            raise ShredParseError("zero parent_off")
    else:
        s.data_cnt = int.from_bytes(buf[0x53:0x55], "little")
        s.code_cnt = int.from_bytes(buf[0x55:0x57], "little")
        s.code_idx = int.from_bytes(buf[0x57:0x59], "little")
        if s.data_cnt > MAX_PER_SLOT or s.code_cnt > MAX_PER_SLOT:
            raise ShredParseError("fec counts out of range")
        if s.code_idx >= max(s.code_cnt, 1):
            raise ShredParseError("code idx out of range")
    hdr_sz = DATA_HEADER_SZ if s.is_data else CODE_HEADER_SZ
    if len(buf) < hdr_sz + s._trailer_sz():
        raise ShredParseError("truncated merkle trailer")
    if s.is_data and s.type not in (TYPE_LEGACY_DATA,) \
            and s.idx < s.fec_set_idx:
        # merkle tree index is idx - fec_set_idx; a crafted inversion
        # would otherwise wrap the leaf position
        raise ShredParseError("data idx below fec_set_idx")
    return s


# ---------------------------------------------------------------------------
# shredder: entry batch -> signed FEC set(s)

def _proof_len_for(total_leaves: int) -> int:
    """Non-root proof node count = tree depth for `total_leaves` leaves."""
    n, d = 1, 0
    while n < total_leaves:
        n *= 2
        d += 1
    return d


@dataclass
class FecSet:
    data_shreds: list[bytes]
    code_shreds: list[bytes]
    merkle_root: bytes


def _le(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "little")


def make_fec_set(
    entry_batch: bytes,
    slot: int,
    parent_off: int,
    version: int,
    fec_set_idx: int,
    sign_fn,
    data_cnt: int = 32,
    code_cnt: int = 32,
    ref_tick: int = 0,
    slot_complete: bool = False,
    torch_device=None,
) -> FecSet:
    """Shred one entry batch into a single signed merkle FEC set
    (fd_shredder semantics, fixed 32:32 geometry by default).

    fec_set_idx is the first data shred's slot-level index (the merkle
    convention: set id == first member's idx).  sign_fn(root32) -> 64-byte
    leader signature over the merkle root — the keyguard hook
    (src/disco/keyguard): the private key never enters this module.

    Wire geometry (round-4 parity with fd_shred.h / fd_fec_resolver.c:339
    — validated byte-for-byte against the real capture in
    tests/golden/demo-shreds.pcap): every data shred is 1203 bytes and
    every parity shred 1228; the reedsol-protected span is
    1139 - 20*proof_len bytes from offset 0x40, parity blocks land after
    the 0x59-byte code header, and the trailer stores ONLY the proof.
    """
    proof_len = _proof_len_for(data_cnt + code_cnt)
    protected = 1139 - MERKLE_NODE_SZ * proof_len     # [0x40, ...) span
    payload_cap = protected - (DATA_HEADER_SZ - SIGNATURE_SZ)
    if len(entry_batch) > payload_cap * data_cnt:
        raise ValueError("entry batch exceeds FEC set capacity")

    chunk = (len(entry_batch) + data_cnt - 1) // data_cnt if entry_batch else 0

    # --- data shreds (unsigned, no merkle trailer yet)
    data_bodies = []
    for i in range(data_cnt):
        piece = entry_batch[i * chunk : (i + 1) * chunk]
        flags = ref_tick & REF_TICK_MASK
        if i == data_cnt - 1:
            flags |= FLAG_DATA_COMPLETE
            if slot_complete:
                flags |= FLAG_SLOT_COMPLETE
        hdr = (
            b"\0" * SIGNATURE_SZ
            + bytes([TYPE_MERKLE_DATA | proof_len])
            + _le(slot, 8)
            + _le(fec_set_idx + i, 4)
            + _le(version, 2)
            + _le(fec_set_idx, 4)
            + _le(parent_off, 2)
            + bytes([flags])
            + _le(DATA_HEADER_SZ + len(piece), 2)
        )
        assert len(hdr) == DATA_HEADER_SZ
        body = hdr + piece + b"\0" * (payload_cap - len(piece))
        data_bodies.append(bytearray(body))

    # --- parity over the data shreds' post-signature bytes
    # (the erasure code covers byte range [0x40, end-of-payload))
    protected = np.stack(
        [
            np.frombuffer(bytes(b[SIGNATURE_SZ:]), dtype=np.uint8)
            for b in data_bodies
        ]
    )
    parity = reedsol.encode(protected, code_cnt, torch_device=torch_device)

    code_bodies = []
    for j in range(code_cnt):
        hdr = (
            b"\0" * SIGNATURE_SZ
            + bytes([TYPE_MERKLE_CODE | proof_len])
            + _le(slot, 8)
            + _le(fec_set_idx + j, 4)  # code shreds get their own idx space
            + _le(version, 2)
            + _le(fec_set_idx, 4)
            + _le(data_cnt, 2)
            + _le(code_cnt, 2)
            + _le(j, 2)
        )
        assert len(hdr) == CODE_HEADER_SZ
        code_bodies.append(bytearray(hdr + parity[j].tobytes()))

    # --- merkle tree over all leaves (data then code): the 32-byte SIGNED
    # root comes from untruncated sha256 at the top; interior levels pass
    # 20-byte truncated children (fd_bmtree hash_sz contract)
    leaves = [bytes(b[SIGNATURE_SZ:]) for b in data_bodies] + [
        bytes(b[SIGNATURE_SZ:]) for b in code_bodies
    ]
    levels = bmtree.np_tree(
        leaves,
        node_sz=MERKLE_NODE_SZ,
        leaf_prefix=bmtree.LEAF_PREFIX_LONG,
        node_prefix=bmtree.NODE_PREFIX_LONG,
    )
    proof0 = bmtree.np_proof(levels, 0)
    root = walk_merkle_root(leaves[0], 0, proof0)
    sig = sign_fn(root)
    if len(sig) != SIGNATURE_SZ:
        raise ValueError("sign_fn must return 64 bytes")

    out_data, out_code = [], []
    for i, b in enumerate(data_bodies + code_bodies):
        proof = bmtree.np_proof(levels, i)
        full = bytes(sig) + bytes(b[SIGNATURE_SZ:]) + b"".join(proof)
        (out_data if i < data_cnt else out_code).append(full)
    return FecSet(out_data, out_code, root)


# ---------------------------------------------------------------------------
# FEC resolver: incoming side

class FecResolver:
    """Collect shreds of one FEC set; recover erasures once >= data_cnt
    arrive; verify merkle inclusion of every shred against the signed root
    (fd_fec_resolver.c contract, minus the signature check which the
    caller does once per set against the leader key)."""

    def __init__(self, root_check=None, torch_device=None):
        """root_check(root32, signature) -> bool: the leader-signature
        gate run on the FIRST member's computed root (fd_fec_resolver.c
        verifies the sig before admitting a set — without it a lone
        tampered shred is self-consistent, since the wire stores only the
        proof and ANY leaf walks to some root).  None = the caller
        signature-checks shreds before add() (the tile layer's shape).
        torch_device: where recover() runs the GF(2) kernel (None: the
        GPU)."""
        self.torch_device = torch_device
        self.data: dict[int, Shred] = {}
        self.code: dict[int, Shred] = {}
        self.data_cnt: Optional[int] = None
        self.code_cnt: Optional[int] = None
        self.root: Optional[bytes] = None
        self.root_check = root_check
        # data_cnt pinned by a DATA_COMPLETE/SLOT_COMPLETE-flagged data
        # shred (last data idx in the set + 1) — lets a set complete from
        # data shreds alone, e.g. over repair, which serves data only
        self._implied_data_cnt: Optional[int] = None

    def add(self, s: Shred) -> bool:
        """Returns True if the shred was accepted (consistent + verified).

        Acceptance = the shred's COMPUTED root (leaf + proof walk,
        fd_bmtree_commitp_insert_with_proof's contract) matches every
        other member's — no root rides the wire, so agreement IS the
        inclusion proof."""
        if not s.merkle_proof_len and s.type in (TYPE_LEGACY_DATA,
                                                 TYPE_LEGACY_CODE):
            return False
        # a code shred's tree index comes from its OWN header counts; the
        # resolver's counts are committed only AFTER acceptance (a spoofed
        # first shred must not poison data_cnt and wreck every honest
        # member's computed root — one-packet set DoS)
        root = s.merkle_root()
        if root is None:
            return False
        if self.root is None:
            if self.root_check is not None and not self.root_check(
                    root, s.signature):
                return False
            self.root = root
        elif root != self.root:
            return False
        if not s.is_data and self.data_cnt is None:
            self.data_cnt = s.data_cnt
            self.code_cnt = s.code_cnt
        if s.is_data:
            self.data[self._leaf_index(s)] = s
            if s.flags & (FLAG_DATA_COMPLETE | FLAG_SLOT_COMPLETE):
                self._implied_data_cnt = (s.idx - s.fec_set_idx) + 1
        else:
            self.code[s.code_idx] = s
        return True

    def _leaf_index(self, s: Shred) -> int:
        if s.is_data:
            return s.idx - s.fec_set_idx  # data idx within set
        return (self.data_cnt or s.data_cnt) + s.code_idx

    @property
    def resolved_data_cnt(self) -> Optional[int]:
        """data_cnt of the set: code-shred header if seen (authoritative),
        else the DATA_COMPLETE-flag-implied count."""
        return self.data_cnt if self.data_cnt is not None else self._implied_data_cnt

    def ready(self) -> bool:
        if self.data_cnt is not None:
            return len(self.data) + len(self.code) >= self.data_cnt
        # no code shred seen: only a flag-pinned count with EVERY data
        # shred present can complete (no parity -> no erasure recovery).
        # Index CONTIGUITY is required, not just count: a crafted set can
        # flag idx 3 while holding idx 5 — count alone would pass ready()
        # and then recover() would hit a hole
        k = self._implied_data_cnt
        return (k is not None
                and all(i in self.data for i in range(k)))

    def recover_args(self):
        """The (shreds, k, sz) triple for reedsol.recover/recover_batch,
        or None when the set completes from data shreds alone (repair
        path: nothing to recover).  Raises if not ready().  This is the
        batching seam (round 13): a multi-set caller gathers one triple
        per ready resolver and recovers them all in ONE device dispatch
        via reedsol.recover_batch, then feeds each outcome back through
        data_regions()."""
        if not self.ready():
            raise ValueError("not enough shreds")
        k = self.resolved_data_cnt
        if not self.code:
            return None
        c = self.code_cnt
        some_code = next(iter(self.code.values()))
        sz = len(some_code.raw) - CODE_HEADER_SZ - some_code._trailer_sz()
        shreds: list[Optional[np.ndarray]] = [None] * (k + c)
        for i, s in self.data.items():
            body = s.raw[SIGNATURE_SZ : SIGNATURE_SZ + sz]
            shreds[i] = np.frombuffer(body, dtype=np.uint8)
        for j, s in self.code.items():
            body = s.raw[CODE_HEADER_SZ : CODE_HEADER_SZ + sz]
            shreds[k + j] = np.frombuffer(body, dtype=np.uint8)
        return shreds, k, sz

    def data_regions(self, full=None) -> list[bytes]:
        """Data shreds' protected regions from a recover outcome.  `full`
        is the recovered codeword list (reedsol.recover/recover_batch
        output for this set's recover_args triple); None means the
        all-data completion path (regions read straight off the stored
        shreds)."""
        k = self.resolved_data_cnt
        if full is not None:
            return [np.asarray(f).tobytes() for f in full[:k]]
        out = []
        for i in range(k):
            s = self.data[i]
            sz = len(s.raw) - SIGNATURE_SZ - s._trailer_sz()
            out.append(s.raw[SIGNATURE_SZ : SIGNATURE_SZ + sz])
        return out

    def recover(self) -> list[bytes]:
        """Returns the data shreds' protected regions (post-signature bytes,
        padding included) for all data shreds, recovering erasures."""
        args = self.recover_args()
        if args is None:
            return self.data_regions()
        return self.data_regions(
            reedsol.recover(*args, torch_device=self.torch_device))

    @staticmethod
    def assemble_payload(regions: list[bytes]) -> bytes:
        """Reassembled entry-batch bytes from data-shred protected
        regions (each = variant..headers..payload..pad)."""
        out = b""
        for region in regions:
            size = int.from_bytes(region[0x56 - 0x40 : 0x58 - 0x40], "little")
            out += region[DATA_HEADER_SZ - SIGNATURE_SZ : size - SIGNATURE_SZ]
        return out

    def payloads(self) -> bytes:
        """Reassembled entry-batch bytes from recovered data shreds."""
        return self.assemble_payload(self.recover())
