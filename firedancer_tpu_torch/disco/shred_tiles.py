"""The shred lane's tiles: the shred tile's leader role (FEC sets cut from
poh entries, each root signed through the keyguard), batched
leader-signature admission and the retransmit role, FEC recovery and the
store (ref: src/app/fdctl/run/tiles/fd_shred.c, fd_fec_resolver.c
feeding fd_store.c); the port's own copy of firedancer_tpu/disco/
tiles.py's _ShredSigBatcher, ShredTile, StoreTile, ShredRecoverIngest and
ShredRecoverTile.  A leader's tail and a follower's data plane are

    poh_dev -> shred <-> sign ; shred -> store ; shred -> (net)
    net -> shred -> shred_recover -> (replay) ; shred -> store

The leader's shred tile computes each set's parity with one launch of
the GF(2) kernel (ops/gf2_recover.py, through reedsol.encode).  A
follower's shred tile admits a burst of shreds with one launch of the
merkle walk kernel (ops/bmtree_walk.py) and one strict ed25519 dispatch
of the roots (SigVerifier, the sha512 and verify_tail kernels);
shred_recover recovers a burst of FEC sets with one launch of the GF(2)
kernel through the rotating-buffer PackedDispatchEngine; the store's
Blockstore recovers each set with one launch of it.
"""

import time
from collections import OrderedDict, deque

import numpy as np
import torch

from .._device import resolve_device
from ..ballet import entry as entry_lib
from ..ballet import reedsol as rs
from ..ballet import shred as shred_lib
from ..models.verifier import (PackedDispatchEngine, SigVerifier, Verdict,
                               VerifierConfig, WorkloadDesc)
from ..ops import bmtree_walk as bw
from ..ops import gf2_recover as gf2
from ..ops import r_check as rck
from ..ops import sha512_kernel as sk
from ..ops import verify_tail as vt
from ..ops.ed25519 import verify_one_host
from .keyguard import ROLE_LEADER, KeyguardClient, KeyguardDown

# sig of a poh entry frag: slot | SLOT_DONE_BIT (leader_tiles.PohDevTile)
SLOT_DONE_BIT = 1 << 63


class _ShredSigBatcher:
    """Batched leader-signature admission for turbine ingress.

    Queued shreds clear as a burst: every merkle root of the burst walks
    in one launch of the merkle walk kernel, and the 64-byte root
    signatures verify through the same batched SigVerifier packed
    admission the txn lane uses (a blob of roots | sig | pub | len built
    on the card, so the roots never leave it).  Forwarding is deferred
    until the burst verdict; the caller re-checks dedup at verdict time
    before inserting, so the insert-only-after-signed discipline
    (forge-then-censor resistance) holds.

    backend="device" is the batched path, on `device` (None: the GPU;
    "cpu" runs the kernels' plain versions); "host" keeps per-shred
    python-int verification (control-plane rates, no device work)."""

    # padded batch geometry: leaf data spans at most the wire MTU minus
    # the signature; the proof-length nibble caps the walk depth at 15
    LEAF_MAXLEN = 1228 - 64
    PROOF_DEPTH = 15
    _PROOF_SZ = PROOF_DEPTH * bw.MERKLE_NODE_SZ
    # host row of a burst lane: leaf | proof nodes | signature | leader
    _ROW = LEAF_MAXLEN + _PROOF_SZ + 64 + 32

    def __init__(self, batch: int = 32, backend: str = "device",
                 flush_age_us: int = 2000, device=None):
        if backend not in ("device", "host"):
            raise ValueError(f"unknown sig backend {backend!r}")
        self.batch = max(1, int(batch))
        self.backend = backend
        self.flush_age_us = flush_age_us
        self._q: list = []            # (shred, raw, tag, leader)
        self._t0 = None               # monotonic_ns of oldest queued shred
        if backend == "device":
            self.device = resolve_device(device)
            self._sv = SigVerifier(VerifierConfig(batch=self.batch,
                                                  msg_maxlen=32),
                                   device=self.device)
            # the verify blob's length column: 32 (a root), u32 LE
            self._len4 = torch.tensor([[32, 0, 0, 0]], dtype=torch.uint8,
                                      device=self.device).expand(
                                          self.batch, 4)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.batch

    def due(self) -> bool:
        """Age deadline: a partial batch must not hold shreds hostage
        when the ingress rate drops (same flush-on-size-or-age shape as
        the verify tile's coalescer)."""
        return (self._t0 is not None
                and time.monotonic_ns() - self._t0
                >= self.flush_age_us * 1000)

    def add(self, s, raw: bytes, tag: int, leader) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic_ns()
        self._q.append((s, raw, tag, leader))

    def warm(self) -> None:
        """Pre-RUN build and first launch of the admission kernels (the
        first live burst must not stall the mux loop)."""
        if self.backend != "device":
            return
        b = self.batch
        z = np.zeros((b,), np.int32)
        np.asarray(self._dispatch(np.zeros((b, self._ROW), np.uint8), z, z,
                                  z))

    def _dispatch(self, rows: np.ndarray, lens, idxs, depths) -> Verdict:
        """One burst on the card: the merkle walk kernel over the rows'
        leaves and proofs, then the strict verify of the roots."""
        lm, pe = self.LEAF_MAXLEN, self.LEAF_MAXLEN + self._PROOF_SZ
        blob = torch.from_numpy(rows).to(self.device)
        roots = bw.bmtree_walk(
            blob[:, :lm], lens, idxs,
            blob[:, lm:pe].unflatten(1, (self.PROOF_DEPTH,
                                         bw.MERKLE_NODE_SZ)), depths)
        return self._sv.dispatch_blob(
            torch.cat([roots, blob[:, pe:], self._len4], 1))

    def flush(self) -> list:
        """Verify everything queued: [(shred, raw, tag, ok)], FIFO."""
        q, self._q, self._t0 = self._q, [], None
        if not q:
            return []
        if self.backend == "host":
            out = []
            for s, raw, tag, leader in q:
                root = s.merkle_root()
                ok = (root is not None and leader is not None
                      and verify_one_host(s.signature, root, leader))
                out.append((s, raw, tag, ok))
            return out
        out = []
        for i in range(0, len(q), self.batch):
            out.extend(self._verify_chunk(q[i:i + self.batch]))
        return out

    def _verify_chunk(self, chunk: list) -> list:
        b = self.batch
        lm, pe = self.LEAF_MAXLEN, self.LEAF_MAXLEN + self._PROOF_SZ
        rows = np.zeros((b, self._ROW), np.uint8)
        lens = np.zeros((b,), np.int32)
        idxs = np.zeros((b,), np.int32)
        depths = np.zeros((b,), np.int32)
        elig = np.zeros((b,), bool)
        for j, (s, _raw, _tag, leader) in enumerate(chunk):
            # legacy (non-merkle) shreds have no signable root; unknown
            # leaders are unverifiable: both fail on a zero lane
            if leader is None or s.type in (shred_lib.TYPE_LEGACY_DATA,
                                            shred_lib.TYPE_LEGACY_CODE):
                continue
            ld = s.merkle_leaf_data()
            rows[j, :len(ld)] = np.frombuffer(ld, np.uint8)
            lens[j] = len(ld)
            idxs[j] = s.tree_index()
            for d, node in enumerate(s.proof_nodes()):
                rows[j, lm + bw.MERKLE_NODE_SZ * d:
                     lm + bw.MERKLE_NODE_SZ * (d + 1)] = np.frombuffer(
                         node, np.uint8)
            depths[j] = s.merkle_proof_len
            rows[j, pe:pe + 64] = np.frombuffer(s.signature, np.uint8)
            rows[j, pe + 64:] = np.frombuffer(leader, np.uint8)
            elig[j] = True
        ok = np.asarray(self._dispatch(rows, lens, idxs, depths))
        ok = ok.astype(bool) & elig
        return [(s, raw, tag, bool(ok[j]))
                for j, (s, raw, tag, _leader) in enumerate(chunk)]


class ShredTile:
    """Shredder tile (ref: src/app/fdctl/run/tiles/fd_shred.c over
    src/disco/shred/fd_shredder.c + fd_shred_dest.c), in both roles.

    Leader: accumulates a slot's entries from its entry in-links (poh
    frames, sig = slot | SLOT_DONE_BIT on a slot's last entry) and cuts a
    merkle FEC set at the done bit, at a slot change (a missed done
    marker closes the slot) and at batch_max bytes, signing each root
    through the keyguard (the shred_sign request link to the sign tile,
    its reply on sign_shred); each set's parity is one launch of the
    GF(2) kernel.  The shreds fan out to every out link except
    shred_sign and, with turbine, each goes over UDP to its turbine tree
    root.  A drain cuts the open slot while the sign tile still serves
    (the drain order puts sign after shred); at a plain halt the sign
    tile may go down first, and the entries this tile then cannot shred
    are counted in unshred_entry_cnt, never raised.

    Retransmit: admits raw shreds from the net links named in cfg
    `net_ins` by batched leader-signature verification, fans each
    admitted shred out to every out link, and, with turbine, sends it
    over UDP to its children in the turbine tree (exactly once per
    shred); a drain admits the open burst.

    cfg: shred_version, fec_data_cnt (default 32: 32:32 sets), batch_max
    (default 16 KiB), net_ins, turbine: {identity: hexpub, fanout, port,
    slots_per_epoch, stakes: {hexpub: [stake, ip, port]}};
    batched-admission knobs sig_batch (default 32), sig_flush_age_us
    (default 2000), sig_backend ("device" | "host"); device (None: the
    GPU).  Without turbine, net shreds pass through unverified, as in the
    JAX tile.  Entry in-links without a shred_sign out-link raise
    ValueError at init."""

    # per-set timings kept for the drain manifest
    _TIMES_MAX = 4096

    def init(self, ctx):
        self.kgc = (KeyguardClient(ctx, "shred_sign", "sign_shred")
                    if "shred_sign" in ctx.tile.out_links else None)
        self.version = ctx.cfg.get("shred_version", 1)
        self.data_cnt = ctx.cfg.get("fec_data_cnt", 32)
        self._fanout = [i for i, ln in enumerate(ctx.tile.out_links)
                        if ln != "shred_sign"]
        self.batch_max = ctx.cfg.get("batch_max", 16 << 10)
        self.device = ctx.cfg.get("device") or None
        self.net_ins = set(ctx.cfg.get("net_ins", ()))
        # fail at wiring time, not on the first FEC cut: a topology that
        # feeds this tile entries (any non-net in-link) but gives it no
        # shred_sign out-link could never sign a merkle root
        entry_ins = [il.link for il in ctx.tile.in_links
                     if il.link not in self.net_ins]
        if entry_ins and self.kgc is None:
            raise ValueError(
                f"shred tile receives entries on {entry_ins} but has no "
                "'shred_sign' out link to the keyguard; wire one or make "
                "this a net-ins-only retransmit tile")
        self.slot = None
        self.entries = []
        self._size = 0
        self.fec_idx = 0
        self._launch0 = None
        self._gf2_0 = None
        self._sign_ns = deque(maxlen=self._TIMES_MAX)
        self._cut_ns = deque(maxlen=self._TIMES_MAX)
        if entry_ins:
            # the parity kernel builds and launches once BEFORE RUN, so
            # the first cut does not stall the mux loop
            shred_lib.make_fec_set(
                b"", 0, 0, self.version, 0, lambda root: bytes(64),
                data_cnt=self.data_cnt, code_cnt=self.data_cnt,
                torch_device=self.device)
            self._gf2_0 = gf2.gf2_recover.launches
        self._init_turbine(ctx)

    def _init_turbine(self, ctx):
        self.turbine = None
        tb = ctx.cfg.get("turbine")
        if not tb:
            return
        from ..flamenco.leaders import leader_schedule
        from ..tango.tcache import TCache
        from ..waltz.udpsock import UdpSock
        from . import shred_dest as sd_mod
        self.identity = bytes.fromhex(tb["identity"])
        self.tree_fanout = tb.get("fanout", 200)
        spe = tb.get("slots_per_epoch", 432_000)
        self._stake_map = {}
        ci = sd_mod.StakeCI(self.identity, spe)
        for pkhex, (stake, ip, port) in tb["stakes"].items():
            pk = bytes.fromhex(pkhex)
            self._stake_map[pk] = stake
            if ip:
                ci.set_contact(pk, ip, port)
        self.stake_ci = ci
        sched = {}

        def leaders(slot):
            ep = slot // spe
            if ep not in sched:
                sched[ep] = leader_schedule(
                    ep, {pk: st for pk, st in self._stake_map.items()
                         if st > 0}, spe)
            return sched[ep][slot % spe]

        self._leaders = leaders
        self.tsock = UdpSock(bind_port=tb.get("port", 0))
        self._retx_seen = TCache(1 << 14)
        self.turbine = tb
        # batched leader-signature admission; its kernels build and launch
        # once BEFORE RUN, so the first burst does not stall the mux loop
        self._sigb = _ShredSigBatcher(
            batch=ctx.cfg.get("sig_batch", 32),
            backend=ctx.cfg.get("sig_backend", "device"),
            flush_age_us=ctx.cfg.get("sig_flush_age_us", 2000),
            device=ctx.cfg.get("device") or None)
        self._sigb.warm()
        self._launch0 = _admission_launches()
        ctx.metrics.set("turbine_port", self.tsock.port)

    def _sdest(self, slot):
        ep = self.stake_ci.epoch_of(slot)
        if ep not in self.stake_ci.stakes:
            # static config stakes apply to every epoch until a stake
            # feed (replay epoch boundary) overrides them
            self.stake_ci.set_stakes(ep, self._stake_map)
        return self.stake_ci.sdest_for(slot, self._leaders)

    def _turbine_send(self, ctx, shreds, raws, first: bool):
        """Leader (first=True): each shred to its turbine tree root.
        Retransmitter: each shred to its children in the tree."""
        if self.turbine is None or not shreds:
            return
        from ..waltz.aio import Pkt
        sd = self._sdest(shreds[0].slot)
        if sd is None:
            return
        pkts = []
        if first:
            for s, raw in zip(shreds, raws):
                d = sd.idx_to_dest(sd.compute_first([s])[0])
                if d is not None and d.ip and d.pubkey != self.identity:
                    pkts.append(Pkt(raw, d.addr))
        else:
            for s, raw in zip(shreds, raws):
                for idx in sd.compute_children([s], self.tree_fanout)[0]:
                    d = sd.idx_to_dest(idx)
                    if d is not None and d.ip and d.pubkey != self.identity:
                        pkts.append(Pkt(raw, d.addr))
        if pkts:
            self.tsock.send_burst(pkts)
            ctx.metrics.add("turbine_tx_cnt", len(pkts))

    def _sign(self, root: bytes) -> bytes:
        t0 = time.monotonic_ns()
        sig = self.kgc.sign(ROLE_LEADER, root)
        self._sign_ns.append(time.monotonic_ns() - t0)
        return sig

    def _cut(self, ctx, slot_complete: bool):
        """One signed FEC set of the entries held (the slot's last when
        slot_complete).  The entries stay held until the set is made, so
        a failed signing leaves them to be counted."""
        if not self.entries and not slot_complete:
            return
        t0 = time.monotonic_ns()
        fs = shred_lib.make_fec_set(
            entry_lib.serialize_batch(self.entries), self.slot,
            parent_off=1 if self.slot else 0, version=self.version,
            fec_set_idx=self.fec_idx,
            sign_fn=self._sign,
            data_cnt=self.data_cnt, code_cnt=self.data_cnt,
            slot_complete=slot_complete, torch_device=self.device)
        self._cut_ns.append(time.monotonic_ns() - t0)
        self.entries = []
        self._size = 0
        self.fec_idx += self.data_cnt
        ctx.metrics.add("fec_set_cnt")
        raws = fs.data_shreds + fs.code_shreds
        for raw in raws:
            for out in self._fanout:
                ctx.publish(raw, sig=self.slot, out=out)
                ctx.metrics.add("shred_tx_cnt")
        if self.turbine is not None:
            self._turbine_send(ctx, [shred_lib.parse(r) for r in raws],
                               raws, first=True)

    def _on_entry(self, ctx, meta, payload):
        sig = int(meta["sig"])
        slot = sig & ~SLOT_DONE_BIT
        done = bool(sig & SLOT_DONE_BIT)
        if self.slot is None:
            self.slot = slot
        if slot != self.slot:  # missed the done marker: close anyway
            self._cut(ctx, True)
            self.slot, self.fec_idx = slot, 0
        e, _ = entry_lib.Entry.deserialize(payload)
        self.entries.append(e)
        self._size += len(payload)
        if done:
            self._cut(ctx, True)
            self.slot, self.fec_idx = slot + 1, 0
        elif self._size >= self.batch_max:
            self._cut(ctx, False)  # mid-slot set: bound FEC batch size

    def _on_net_shred(self, ctx, payload):
        """Turbine ingress (non-leader): verify the leader signature,
        dedup, store-forward and retransmit to my children exactly once
        per shred (fd_shred.c's retransmit path).  Admission is batched:
        the shred queues into _ShredSigBatcher and forwards only when the
        burst verdict lands (size or age triggered)."""
        try:
            s = shred_lib.parse(payload)
        except shred_lib.ShredParseError:
            ctx.metrics.add("shred_parse_fail_cnt")
            return
        if self.turbine is None:
            # no signature gate: publish the dcache view as-is
            for out in self._fanout:
                ctx.publish(payload, sig=s.slot, out=out)
            ctx.metrics.add("shred_rx_cnt")
            return
        tag = (s.slot << 17) | (s.idx << 1) | (1 if s.is_data else 0)
        # query-only dedup BEFORE the signature check; the tag is
        # inserted only after the shred proves leader-signed, so a forged
        # copy cannot poison the cache and censor the real one
        if self._retx_seen.query(tag):
            return                              # duplicate: drop entirely
        try:
            leader = self._leaders(s.slot)
        except Exception:
            leader = None
        # ONE copy per shred: payload is an in-ring dcache view the mux
        # will reuse, but the verdict is deferred
        self._sigb.add(s, bytes(payload), tag, leader)
        if self._sigb.full:
            self._admit(ctx, self._sigb.flush())

    def _admit(self, ctx, verdicts):
        """Apply a batched admission verdict (FIFO): re-check dedup (a
        duplicate may have queued in the SAME burst window), insert, fan
        out, retransmit."""
        if not verdicts:
            return
        ctx.metrics.add("sig_batch_cnt")
        for s, raw, tag, ok in verdicts:
            if not ok:
                ctx.metrics.add("shred_sig_fail_cnt")
                continue
            if self._retx_seen.query(tag):
                continue                # dup admitted earlier in the burst
            self._retx_seen.insert(tag)
            for out in self._fanout:
                ctx.publish(raw, sig=s.slot, out=out)
            ctx.metrics.add("shred_rx_cnt")
            if self._leaders(s.slot) != self.identity:
                self._turbine_send(ctx, [s], [raw], first=False)

    def after_credit(self, ctx):
        if self.turbine is not None and self._sigb.due():
            ctx.metrics.add("sig_deadline_flush_cnt")
            self._admit(ctx, self._sigb.flush())

    def on_frag(self, ctx, iidx, meta, payload):
        if ctx.tile.in_links[iidx].link in self.net_ins:
            self._on_net_shred(ctx, payload)
            return
        held = len(self.entries)
        try:
            self._on_entry(ctx, meta, payload)
        except KeyguardDown:
            if not self.kgc.halting():
                raise
            # a plain halt took the sign tile down first: the entries
            # held and this frame's (a slot change fails before taking
            # it) stay unshredded, counted; the loop exits
            lost = len(self.entries) + (len(self.entries) == held)
            ctx.metrics.add("unshred_entry_cnt", lost)
            self.entries = []
            ctx.halt()

    def drain(self, ctx) -> bool:
        """Drain-protocol hook: the leader role cuts the open slot (its
        last set flagged slot-complete, as fini would) while the sign tile
        still serves; the retransmit role admits its open burst."""
        if self.entries and self.slot is not None:
            self._cut(ctx, True)
            self.slot, self.fec_idx = self.slot + 1, 0
        if self.turbine is not None and len(self._sigb):
            self._admit(ctx, self._sigb.flush())
        return True

    def drain_manifest(self, ctx) -> dict:
        """The drain manifest's record of this tile: the admission
        kernels' launches since its warm-up (0 on the CPU, where the
        plain versions run) beside its burst count; for the leader role
        the GF(2) kernel's launches since its warm-up beside the FEC sets
        cut, and each set's keyguard round trip and cut (make_fec_set,
        the signing included) in ns."""
        now = _admission_launches()
        out = {"launches": {k: now[k] - self._launch0[k] for k in now}
               if self._launch0 is not None else {},
               "sig_batch_cnt": ctx.metrics.get("sig_batch_cnt")}
        if self._gf2_0 is not None:
            out["launches"]["gf2_recover"] = (gf2.gf2_recover.launches
                                              - self._gf2_0)
            out.update(fec_set_cnt=ctx.metrics.get("fec_set_cnt"),
                       sign_ns=list(self._sign_ns),
                       cut_ns=list(self._cut_ns))
        return out

    def fini(self, ctx):
        if self.entries and self.slot is not None:
            try:
                self._cut(ctx, True)
            except KeyguardDown:
                # a plain halt: the sign tile went down first
                ctx.metrics.add("unshred_entry_cnt", len(self.entries))
                self.entries = []
        if self.turbine is not None:
            try:
                self._admit(ctx, self._sigb.flush())  # drain the tail
            except Exception:
                pass  # downstream rings may already be gone
            self.tsock.close()


def _admission_launches() -> dict:
    return {"bmtree_walk": bw.bmtree_walk.launches,
            "sha512_ram": sk.sha512_ram.launches,
            "verify_tail": vt.verify_tail.launches,
            "r_check": rck.r_check.launches}


class StoreTile:
    """Shred sink into the blockstore (ref: src/app/fdctl/run/tiles/
    fd_store.c): inserts incoming shreds, tracks FEC recovery and complete
    slots.  cfg: max_slots, archive_path, device (where the Blockstore's
    FEC recovery runs the GF(2) kernel; None: the GPU); the
    `complete_slot` metrics slot exports the highest fully-assembled slot
    (how tests observe block completion).  A leader-signed set whose
    survivors disagree is dropped and counted (corrupt_set_cnt, in the
    drain manifest); the JAX StoreTile raises on it.  The metrics keep
    the JAX layout, so the count is not a metric."""

    def init(self, ctx):
        from ..flamenco.blockstore import Blockstore, SlotArchive
        # optional disk archive (fd_blockstore's RocksDB role): completed
        # slots persist past the in-memory retention window
        arch_path = ctx.cfg.get("archive_path")
        self.store = Blockstore(
            ctx.cfg.get("max_slots", 1024),
            archive=SlotArchive(arch_path) if arch_path else None,
            torch_device=ctx.cfg.get("device") or None)
        self.complete = 0

    def drain_manifest(self, ctx) -> dict:
        """The FEC sets dropped as corrupt, for the drain manifest."""
        return {"corrupt_set_cnt": self.store.corrupt_set_cnt}

    def on_frag(self, ctx, iidx, meta, payload):
        try:
            self.store.insert_shred(payload)
        except shred_lib.ShredParseError:
            ctx.metrics.add("parse_fail_cnt")
            return
        ctx.metrics.add("shred_store_cnt")
        slot = int(meta["sig"]) & ~SLOT_DONE_BIT
        if slot > self.complete and self.store.slot_complete(slot):
            self.complete = slot
            ctx.metrics.set("complete_slot", slot)


class ShredRecoverIngest:
    """Batched RS-recover workload over the packed rotation core: one FEC
    set per row in ballet.reedsol's recover_blob layout (surv | ref |
    have), the per-set GF(2^8) reconstruction matrices riding in a
    sibling array per rotating buffer, pinned like the buffer and paired
    with it by index (the kernel expands their bit-matrices on the card).
    The engine returns a buffer to its free ring only once that buffer's
    verdict is on the host, so a matrix is never rewritten while its
    upload or verdict is pending.  A dispatch is one
    launch of the GF(2) kernel on `device` (None: the GPU)."""

    def __init__(self, k_max: int = 32, n_max: int = 64, sz: int = 1019,
                 batch: int = 8, nbuf: int = 2, depth: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.k_max, self.n_max, self.sz = k_max, n_max, sz
        self.batch = batch
        pinned = self.device.type == "cuda"
        self._eng = PackedDispatchEngine(
            WorkloadDesc(rows=batch,
                         row_bytes=rs.recover_blob_row_bytes(k_max, n_max,
                                                             sz),
                         dispatch=self._dispatch, pinned=pinned),
            nbuf=nbuf, depth=depth)
        # sibling matrices per rotating buffer, paired by buffer id
        self._gfmats = [
            torch.zeros((batch, n_max, k_max), dtype=torch.uint8,
                        pin_memory=pinned)
            for _ in range(nbuf)]
        self._bidx = {id(b): i for i, b in enumerate(self._eng._bufs)}

    # engine passthroughs (observability + harvest surface)
    @property
    def dispatches(self):
        return self._eng.dispatches

    @property
    def inflight_depth(self):
        return self._eng.inflight_depth

    def poll(self):
        return self._eng.poll()

    def drain(self):
        return self._eng.drain()

    def _dispatch(self, buf):
        gm = self._gfmats[self._bidx[id(buf)]]
        return Verdict(rs.recover_blob(
            buf.to(self.device, non_blocking=True),
            gm.to(self.device, non_blocking=True),
            self.k_max, self.n_max, self.sz))

    def warm(self) -> None:
        """Pre-RUN build and launch: one zero-filled dispatch run to
        completion (padding rows are self-consistent, so the verdict is
        all-ok)."""
        self._eng.submit_packed(lambda buf: None, 0)
        self._eng.drain()

    def submit_sets(self, sets: list):
        """Stamp up to `batch` recover_args triples (every set at this
        engine's fixed sz and within (k_max, n_max)) into one rotating row
        blob + sibling matrix array and dispatch.  Returns verdicts retired
        by the inflight window this call (each a (batch, n_max*sz + 1) u8
        array; pair rows to sets FIFO)."""
        if len(sets) > self.batch:
            raise ValueError(f"{len(sets)} sets > engine batch {self.batch}")
        return self._eng.submit_packed(
            lambda buf: self._stamp(buf, sets), len(sets))

    def _stamp(self, buf, sets) -> None:
        k_max, n_max, sz = self.k_max, self.n_max, self.sz
        ks, ns = k_max * sz, n_max * sz
        blob = buf.numpy()
        blob[:] = 0
        gm = self._gfmats[self._bidx[id(buf)]].numpy()
        gm[:] = 0
        for r, (shreds, k, set_sz) in enumerate(sets):
            n = len(shreds)
            if set_sz != sz or k > k_max or n > n_max:
                raise ValueError(
                    f"set geometry (k={k}, n={n}, sz={set_sz}) outside "
                    f"engine ({k_max}, {n_max}, {sz})")
            have = [i for i, s in enumerate(shreds) if s is not None]
            if len(have) < k:
                raise ValueError(
                    f"unrecoverable: only {len(have)} of {k} needed shreds")
            use = tuple(have[:k])
            row = blob[r]
            for c, i in enumerate(use):
                row[c * sz:(c + 1) * sz] = np.frombuffer(
                    shreds[i], np.uint8, count=sz)
            for i in have:
                row[ks + i * sz:ks + (i + 1) * sz] = np.frombuffer(
                    shreds[i], np.uint8, count=sz)
                row[ks + ns + i] = 1
            gm[r, :n, :k] = rs._recover_gfmat(k, n, use)

    def split_verdict(self, v: np.ndarray):
        """(full (batch, n_max, sz) u8, ok (batch,) bool) off one verdict
        row blob."""
        ns = self.n_max * self.sz
        full = v[:, :ns].reshape(len(v), self.n_max, self.sz)
        return full, v[:, ns].astype(bool)


class ShredRecoverTile:
    """FEC recovery tile (ref: fd_fec_resolver.c feeding fd_store):
    accumulates verified shreds into per-(slot, fec_set_idx) resolvers
    and, when a set becomes recoverable, stamps its survivors into a
    packed recover row dispatched through the rotating-buffer engine: the
    reconstruction product runs once per BURST of sets.  All-data
    completions (repair serves data only) publish immediately with no
    device work.

    In: shred links (the shred tile's verified fan-out).  Out: one
    reassembled entry-batch payload per recovered FEC set (sig = slot).
    cfg: fec_data_cnt (k_max, default 32), fec_code_cnt (default =
    fec_data_cnt), shred_sz (default derived from the geometry's proof
    depth), batch_sets (rows per dispatch, default 8), nbuf, depth,
    flush_age_us (partial-batch deadline, default 5000), device (None:
    the GPU).  A set outside the engine's geometry recovers on the host
    table model, counted in fec_host_fallback_cnt."""

    def init(self, ctx):
        self.k_max = ctx.cfg.get("fec_data_cnt", 32)
        self.c_max = ctx.cfg.get("fec_code_cnt", self.k_max)
        self.n_max = self.k_max + self.c_max
        sz = ctx.cfg.get("shred_sz")
        if sz is None:
            # protected span = 1139 - 20 * proof_len for this geometry
            sz = 1139 - 20 * max(1, (self.n_max - 1).bit_length())
        self.sz = sz
        self.batch_sets = ctx.cfg.get("batch_sets", 8)
        self.flush_age_us = ctx.cfg.get("flush_age_us", 5000)
        self.ingest = ShredRecoverIngest(
            k_max=self.k_max, n_max=self.n_max, sz=sz,
            batch=self.batch_sets, nbuf=ctx.cfg.get("nbuf", 2),
            depth=ctx.cfg.get("depth"), device=ctx.cfg.get("device") or None)
        self.ingest.warm()       # build and launch BEFORE signaling RUN
        # bounded working state: open resolvers and the recovered-set
        # dedup both evict oldest-first
        self.max_open = ctx.cfg.get("max_open_sets", 1 << 12)
        self._sets = OrderedDict()        # (slot, fec_set_idx) -> resolver
        self._queue: list = []   # (key, resolver, recover_args triple)
        self._queued = OrderedDict()      # recovered-set dedup (as a set)
        self._q_t0 = None
        self._pending = deque()  # dispatch FIFO: [(key, resolver), ...]

    def _publish(self, ctx, key, regions):
        payload = shred_lib.FecResolver.assemble_payload(regions)
        ctx.publish(payload, sig=key[0])
        ctx.metrics.add("fec_complete_cnt")

    def _dispatch(self, ctx):
        sets, self._queue = self._queue, []
        self._q_t0 = None
        if not sets:
            return
        args = [a for (_k, _r, a) in sets]
        self._pending.append([(k, r) for (k, r, _a) in sets])
        ctx.metrics.add("fec_dispatch_cnt")
        for v in self.ingest.submit_sets(args):
            self._retire(ctx, v)

    def _retire(self, ctx, verdict):
        full, ok = self.ingest.split_verdict(verdict)
        metas = self._pending.popleft()
        for r, (key, resolver) in enumerate(metas):
            if not bool(ok[r]):
                # a surviving shred inconsistent with the re-derived
                # encoding: the set is corrupt, drop it (ERR_CORRUPT)
                ctx.metrics.add("fec_fail_cnt")
                continue
            ctx.metrics.add("fec_recovered_cnt")
            self._publish(ctx, key, resolver.data_regions(full[r]))

    def on_frag(self, ctx, iidx, meta, payload):
        try:
            s = shred_lib.parse(payload)
        except shred_lib.ShredParseError:
            ctx.metrics.add("shred_parse_fail_cnt")
            return
        ctx.metrics.add("shred_rx_cnt")
        key = (s.slot, s.fec_set_idx)
        if key in self._queued:
            return                       # set already recovering/complete
        fr = self._sets.get(key)
        if fr is None:
            fr = self._sets[key] = shred_lib.FecResolver()
            while len(self._sets) > self.max_open:
                self._sets.popitem(last=False)
        if not fr.add(s) or not fr.ready():
            return
        self._queued[key] = None
        while len(self._queued) > self.max_open:
            self._queued.popitem(last=False)
        self._sets.pop(key, None)
        args = fr.recover_args()
        if args is None:
            # all-data completion: regions read straight off the shreds
            self._publish(ctx, key, fr.data_regions())
            return
        shreds, k, set_sz = args
        if (set_sz != self.sz or k > self.k_max
                or len(shreds) > self.n_max):
            # geometry outside the engine: host per-set recovery (counted,
            # never silent: cfg should match the deployment)
            ctx.metrics.add("fec_host_fallback_cnt")
            try:
                full = rs.recover(shreds, k, set_sz, device=False)
            except ValueError:
                ctx.metrics.add("fec_fail_cnt")
                return
            self._publish(ctx, key, fr.data_regions(full))
            return
        self._queue.append((key, fr, args))
        if self._q_t0 is None:
            self._q_t0 = time.monotonic_ns()
        if len(self._queue) >= self.batch_sets:
            self._dispatch(ctx)

    def after_credit(self, ctx):
        for v in self.ingest.poll():     # non-blocking verdict harvest
            self._retire(ctx, v)
        if (self._q_t0 is not None
                and time.monotonic_ns() - self._q_t0
                >= self.flush_age_us * 1000):
            self._dispatch(ctx)
        ctx.metrics.set("recover_pending", len(self._pending))

    def drain_manifest(self, ctx) -> dict:
        """The drain manifest's record of this tile: the GF(2) kernel's
        launches in this process (the warm-up's included; 0 on the CPU,
        where the plain version runs) beside its dispatches."""
        return {"launches": {"gf2_recover": gf2.gf2_recover.launches},
                "fec_dispatch_cnt": ctx.metrics.get("fec_dispatch_cnt")}

    def fini(self, ctx):
        try:
            self._dispatch(ctx)
            for v in self.ingest.drain():
                self._retire(ctx, v)
        except Exception:
            pass  # downstream rings may already be gone


TILES = {"shred": ShredTile, "shred_recover": ShredRecoverTile,
         "store": StoreTile}
