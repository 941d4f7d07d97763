"""Blockstore: shred accumulation -> complete slots, with a disk archive
(ref: src/flamenco/runtime/fd_blockstore.c — hot slots in memory, the
long tail archived; theirs archives to RocksDB, ours to an append-only
indexed slot file, SlotArchive).

Shreds arrive out of order and possibly incomplete; each slot tracks its
FEC sets through ballet.shred.FecResolver, which erasure-recovers a set as
soon as any data_cnt of its data+code shreds are present.  When every FEC
set of a slot is complete and the slot-complete flag was seen, the slot's
entry batch bytes are assembled in shred-index order (and, when an archive
is attached, persisted so eviction never loses a completed block).

The port's own copy of firedancer_tpu/flamenco/blockstore.py; a FEC set
recovers on the GF(2) kernel (one launch a set, through FecResolver) on
torch_device (None: the GPU, "cpu" the kernel's plain version).
"""

import os
import struct
from dataclasses import dataclass, field

from ..ballet import shred as shred_lib
from ..ballet import entry as entry_lib
from ..ballet.reedsol import CorruptSetError


class SlotArchive:
    """Append-only indexed archive of completed slots (the fd_blockstore
    RocksDB role: fd_blockstore archives rooted blocks and serves
    historical reads).  File format:

        magic "FDAR" | u32 version
        record := u64 slot | u64 parent | u32 len | entry-batch bytes

    The in-memory index (slot -> file offset) rebuilds by a single scan at
    open; duplicate appends of a slot keep the FIRST record (a completed
    block is immutable — a differing duplicate indicates equivocation and
    is ignored here, the fork-choice layer's problem)."""

    _MAGIC = b"FDAR"
    _VERSION = 1
    _HDR = struct.Struct("<4sI")
    _REC = struct.Struct("<QQI")

    def __init__(self, path: str):
        self.path = path
        self._index: dict[int, tuple[int, int, int]] = {}  # slot->(off,len,parent)
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "a+b")
        if not exists:
            self._f.write(self._HDR.pack(self._MAGIC, self._VERSION))
            self._f.flush()
        else:
            self._scan()

    def _scan(self):
        size = os.fstat(self._f.fileno()).st_size
        self._f.seek(0)
        hdr = self._f.read(self._HDR.size)
        if len(hdr) < self._HDR.size:
            raise ValueError(f"{self.path}: not a slot archive (truncated)")
        magic, ver = self._HDR.unpack(hdr)
        if magic != self._MAGIC or ver != self._VERSION:
            raise ValueError(f"{self.path}: not a slot archive")
        pos = self._HDR.size
        while True:
            self._f.seek(pos)
            rec = self._f.read(self._REC.size)
            if len(rec) < self._REC.size:
                break
            slot, parent, ln = self._REC.unpack(rec)
            data_off = pos + self._REC.size
            if data_off + ln > size:
                break  # torn final record from a crashed writer: seeking
                # past EOF "succeeds", so truncation must be checked
                # against the real file size, never via tell()
            self._index.setdefault(slot, (data_off, ln, parent))
            pos = data_off + ln
        # append AFTER the last intact record: a torn tail is overwritten,
        # never left embedded inside a later record's claimed extent
        self._f.truncate(pos)
        self._f.seek(0, 2)

    def put(self, slot: int, parent: int, data: bytes):
        if slot in self._index:
            return
        self._f.seek(0, 2)
        pos = self._f.tell()
        self._f.write(self._REC.pack(slot, parent, len(data)))
        self._f.write(data)
        self._f.flush()
        self._index[slot] = (pos + self._REC.size, len(data), parent)

    def get(self, slot: int) -> bytes | None:
        ent = self._index.get(slot)
        if ent is None:
            return None
        off, ln, _ = ent
        self._f.seek(off)
        return self._f.read(ln)

    def parent(self, slot: int) -> int | None:
        ent = self._index.get(slot)
        return None if ent is None else ent[2]

    def slots(self) -> list[int]:
        return sorted(self._index)

    def __contains__(self, slot: int) -> bool:
        return slot in self._index

    def close(self):
        self._f.close()


@dataclass
class _SlotMeta:
    resolvers: dict[int, shred_lib.FecResolver] = field(default_factory=dict)
    complete_sets: dict[int, bytes] = field(default_factory=dict)
    set_data_cnt: dict[int, int] = field(default_factory=dict)
    last_set_idx: int | None = None  # fec_set_idx of the slot-complete set
    parent_off: int = 0
    assembled: bytes | None = None
    raw: dict[int, bytes] = field(default_factory=dict)  # data idx -> shred
    corrupt_sets: set[int] = field(default_factory=set)  # dropped fec ids


class Blockstore:
    def __init__(self, max_slots: int = 1024,
                 archive: SlotArchive | None = None,
                 root_check=None, torch_device=None):
        """root_check(slot, root32, signature) -> bool: leader-signature
        gate applied to EVERY shred at the door, before any bookkeeping
        (fd_fec_resolver.c verifies the sig before admitting a set).
        Without it a single self-consistent bogus shred reaching
        insert_shred pins its root as the set's first member and blocks
        every honest shred of that set (ADVICE r4) — and could store raw
        bytes, pin last_set_idx, or evict honest slots even when a later
        resolver-level check rejected it.  None = callers signature-check
        shreds before insert (the turbine tile's shape)."""
        self.max_slots = max_slots
        self.torch_device = torch_device
        self.archive = archive
        self.root_check = root_check
        self.slots: dict[int, _SlotMeta] = {}
        self.shred_cnt = 0
        self.recovered_cnt = 0
        self.sig_reject_cnt = 0
        self.corrupt_set_cnt = 0

    def insert_shred(self, raw: bytes, parsed=None,
                     pre_verified: bool = False) -> bool:
        """Insert one serialized shred; returns True if it completed a FEC
        set.  Invalid shreds raise ShredParseError.  A set whose
        survivors disagree is dropped (corrupt_set_cnt), not raised.  `parsed` skips the
        re-parse when the caller already holds the Shred (hot tile paths
        parse once for routing/verification).  pre_verified=True attests
        the caller already ran the leader-signature gate on THIS shred
        (turbine/repair ingress paths) — the door check below is skipped
        so validated hot paths don't pay a second ~100 ms synchronous
        device verify per shred."""
        s = parsed if parsed is not None else shred_lib.parse(raw)
        self.shred_cnt += 1
        if self.root_check is not None and not pre_verified:
            # gate at the DOOR: a rejected shred must not create slot
            # metadata, store servable raw bytes, pin last_set_idx, or
            # trigger eviction (code-review r5: the resolver-level check
            # ran after that bookkeeping had already committed)
            root = s.merkle_root()
            if root is None or not self.root_check(s.slot, root,
                                                   s.signature):
                self.sig_reject_cnt += 1
                return False
        sm = self.slots.get(s.slot)
        if sm is None:
            if (len(self.slots) >= self.max_slots
                    and s.slot < min(self.slots)):
                return False  # older than the retention window: drop, do
                # not evict a newer slot for it (and never evict the slot
                # we are mid-insert into)
            sm = self.slots[s.slot] = _SlotMeta()
            self._evict()
        if s.is_data:
            # record data-shred bookkeeping BEFORE the already-complete
            # dedup: the FLAG_SLOT_COMPLETE shred may arrive after its set
            # was erasure-recovered, and dropping the flag would leave the
            # slot permanently "incomplete" (and never archived)
            sm.parent_off = s.parent_off
            sm.raw[s.idx] = raw  # retained to serve repair requests
            if s.flags & shred_lib.FLAG_SLOT_COMPLETE:
                sm.last_set_idx = s.fec_set_idx
        if s.fec_set_idx in sm.complete_sets:
            if (self.archive is not None and s.slot not in self.archive
                    and self.slot_complete(s.slot)):
                self.slot_data(s.slot)  # late flag: persist now
            return False
        if s.fec_set_idx in sm.corrupt_sets:
            return False
        res = sm.resolvers.get(s.fec_set_idx)
        if res is None:
            # no resolver-level root_check: the door gate above already
            # leader-verified this shred, and the resolver's root-agreement
            # rule handles cross-member consistency
            res = sm.resolvers[s.fec_set_idx] = shred_lib.FecResolver(
                torch_device=self.torch_device)
        res.add(s)
        if res.ready():
            try:
                payload = res.payloads()
            except CorruptSetError:
                # a signed set whose survivors disagree (ERR_CORRUPT): drop
                # its resolver and ignore its later shreds; the slot stays
                # incomplete.  Counted in corrupt_set_cnt.
                del sm.resolvers[s.fec_set_idx]
                sm.corrupt_sets.add(s.fec_set_idx)
                self.corrupt_set_cnt += 1
                return False
            sm.complete_sets[s.fec_set_idx] = payload
            sm.set_data_cnt[s.fec_set_idx] = res.resolved_data_cnt
            del sm.resolvers[s.fec_set_idx]
            self.recovered_cnt += 1
            if self.archive is not None and self.slot_complete(s.slot):
                self.slot_data(s.slot)  # assemble + persist pre-eviction
            return True
        return False

    def slot_complete(self, slot: int) -> bool:
        sm = self.slots.get(slot)
        if sm is None or sm.last_set_idx is None:
            return False
        # every fec set from 0 to last_set_idx must be recovered WITH no
        # gap: set ids are cumulative data counts, so the next set's id
        # must be exactly want + data_cnt(want) — accepting any later
        # present id would silently assemble a block with a hole in it
        want = 0
        while want <= sm.last_set_idx:
            if want not in sm.complete_sets:
                return False
            if want == sm.last_set_idx:
                return True
            want = want + sm.set_data_cnt[want]
        return False  # inconsistent set geometry walked past the end

    def slot_data(self, slot: int) -> bytes | None:
        """Concatenated entry-batch bytes for a complete slot, else None.
        Evicted-but-archived slots are served from the SlotArchive (the
        RocksDB historical-read path, fd_blockstore archival reads)."""
        sm = self.slots.get(slot)
        if not self.slot_complete(slot):
            if self.archive is not None:
                return self.archive.get(slot)
            return None
        if sm.assembled is None:
            sm.assembled = b"".join(
                sm.complete_sets[i] for i in sorted(sm.complete_sets))
            if self.archive is not None:
                self.archive.put(slot, slot - sm.parent_off, sm.assembled)
        return sm.assembled

    def slot_entries(self, slot: int) -> list[entry_lib.Entry] | None:
        data = self.slot_data(slot)
        if data is None:
            return None
        try:
            return entry_lib.deserialize_batch(data)
        except ValueError:
            # signature-valid shreds carrying a corrupt entry stream: the
            # block is garbage but must not kill the replay tile
            return None

    # -- repair serving (fd_repair's read side) -------------------------
    def shred_raw(self, slot: int, idx: int) -> bytes | None:
        sm = self.slots.get(slot)
        return None if sm is None else sm.raw.get(idx)

    def parent_slot(self, slot: int) -> int | None:
        """slot's parent per its data shreds' parent_off (fd_blockstore
        tracks this in the slot meta); archived slots answer from the
        archive record."""
        sm = self.slots.get(slot)
        if sm is not None and sm.parent_off:
            return slot - sm.parent_off
        if self.archive is not None:
            return self.archive.parent(slot)
        return None

    def highest_shred(self, slot: int) -> tuple[int, bytes] | None:
        sm = self.slots.get(slot)
        if sm is None or not sm.raw:
            return None
        hi = max(sm.raw)
        return hi, sm.raw[hi]

    def missing_indices(self, slot: int, upto: int) -> list[int]:
        """Data shred indices not yet present in [0, upto] — what the
        repair client should request."""
        sm = self.slots.get(slot)
        have = sm.raw.keys() if sm else ()
        return [i for i in range(upto + 1) if i not in have]

    def _evict(self):
        while len(self.slots) > self.max_slots:
            del self.slots[min(self.slots)]
