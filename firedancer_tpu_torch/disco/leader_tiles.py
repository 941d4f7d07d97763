"""The leader lane's tiles: the pack scheduler, its shard merge and the
device PoH tile (ref: fd_pack.c between dedup and the banks,
fd_poh_tile.c's hashing core); the port's own copy of
firedancer_tpu/disco/tiles.py's LeaderPackTile, LeaderMergeTile and
PohDevTile.  The leader-bench data plane is

    source -> verify -> leader_pack -> poh_dev -> sink

or, with [leader] pack_shards = N > 1,

    source -> verify -> leader_pack:0..N-1 -> leader_merge -> poh_dev -> sink

PohDevTile runs the chain, the tick splices and the entry re-checks on
the PoH spans kernel and the microblock mixins on the mixin-tree kernel.
"""

import struct
import time
from collections import deque

import numpy as np

from ..ballet import entry as entry_lib
from ..ballet import pack as pack_lib
from ..ballet import txn as txn_lib
from ..ballet.poh_engine import PohEngine
from ..ops.mixin_tree import mixin_tree
from ..ops.poh_spans import poh_spans


class LeaderPackTile:
    """Leader-lane pack scheduler: consumes verify's verdict egress
    (per-txn frags, or packed arena frags), runs ballet.pack's
    fee-priority heap and account-conflict scheduling on the host, and
    emits each conflict-free microblock as ONE frag in
    entry.serialize_txn_batch wire (sig = monotonic microblock seq, bit 63
    clear so it never reads as a slot-done entry sig).

    Simple votes bypass the max_pending heap cap (the reserved vote lane),
    so a fee-paying flood cannot crowd consensus traffic out of the block.

    cfg: max_txn (per microblock, default 31), max_pending (heap cap, 0 =
    unbounded), block_us (end_block cadence, default 400_000),
    packed_egress (consume arena frags), native_pack (-1 or 1: the C
    scheduler, which raises when the host library does not build; 0: the
    Python scheduler), shard_cnt/shard_idx (fee-payer sharding;
    shard_cnt > 1 switches egress to the merge wire).

    Sharding: with shard_cnt > 1 every shard consumes ALL verify links and
    keeps only the txns whose fee payer hashes to it
    (acct_key(fee_payer) % shard_cnt — deterministic, so a respawned
    shard steers identically).  The fee payer is always writable, so a
    fee payer's whole conflict neighborhood lands on one shard;
    cross-shard write conflicts are serialized by microblock order at the
    merge.  Sharded microblocks egress in a merge wire (budget header +
    serialized batch) to LeaderMergeTile, which owns the GLOBAL block
    budgets."""

    # merge wire: n_acct u32 | cost u64 | vote_cost u64 | data u32 |
    # n_acct * (acct_key u64 | write_cost u64) | serialize_txn_batch
    MERGE_HDR = struct.Struct("<IQQI")
    MERGE_ITEM = struct.Struct("<QQ")

    # pack.Pack.metrics -> tile metric slots (synced by delta)
    _PACK_METRICS = (
        ("inserted", "txn_insert_cnt"),
        ("vote_inserted", "vote_insert_cnt"),
        ("scheduled", "sched_txn_cnt"),
        ("microblocks", "microblock_cnt"),
        ("dropped_oversize", "oversize_drop_cnt"),
        ("dropped_heap_full", "heap_full_drop_cnt"),
        ("delayed_conflict", "conflict_delay_cnt"),
    )

    def init(self, ctx):
        native_pack = int(ctx.cfg.get("native_pack", -1))
        if native_pack not in (-1, 0, 1):
            raise ValueError(f"native_pack {native_pack}: need -1, 0 or 1")
        self.pack = pack_lib.Pack(
            bank_tile_cnt=1,
            max_txn_per_microblock=ctx.cfg.get("max_txn", 31),
            max_pending=ctx.cfg.get("max_pending", 0),
            native=native_pack != 0)
        self.shard_cnt = int(ctx.cfg.get("shard_cnt", 1))
        self.shard_idx = int(ctx.cfg.get("shard_idx", 0))
        self.block_us = ctx.cfg.get("block_us", 400_000)
        self._block_t0 = time.monotonic_ns()
        self._mb_seq = 0
        self._last_pm = {k: 0 for k, _ in self._PACK_METRICS}
        self._drain_stall = 0
        if not ctx.cfg.get("packed_egress", 0):
            self.on_burst_view = None

    def _sync_pack(self, ctx):
        pm = self.pack.metrics
        for key, slot in self._PACK_METRICS:
            d = pm[key] - self._last_pm[key]
            if d:
                ctx.metrics.add(slot, d)
                self._last_pm[key] = pm[key]
        ctx.metrics.set("pending", self.pack.pending)

    def _insert(self, ctx, payload: bytes):
        if self.shard_cnt > 1:
            # deterministic fee-payer steering: a broken header steers to
            # shard 0, whose full parse rejects it with the real error
            fp = txn_lib.fee_payer(payload)
            shard = (pack_lib.acct_key(fp) % self.shard_cnt
                     if fp is not None else 0)
            if shard != self.shard_idx:
                return
            ctx.metrics.add("shard_steer_cnt")
        ctx.metrics.add("txn_in_cnt")
        try:
            parsed = txn_lib.parse(payload)
        except txn_lib.TxnParseError:
            ctx.metrics.add("parse_fail_cnt")
            return
        self.pack.insert(bytes(payload), parsed)

    def on_frag(self, ctx, iidx, meta, payload):
        self._insert(ctx, payload)
        self._emit(ctx)
        self._sync_pack(ctx)

    def on_burst_view(self, ctx, iidx, metas, dcache):
        """Packed verdict egress rx (the DedupTile unpack): copy the frag
        out of the shm view once, re-checking the mcache seq before the
        offsets table is trusted and again after the payload copy, so
        nothing derived from a producer-lapped frag is ever inserted."""
        mc = ctx.in_mcache(iidx)
        for meta in metas:
            k = int(meta["sz"])
            if k <= 0:
                continue
            chunk, seq = int(meta["chunk"]), int(meta["seq"])
            hdr = 4 * (k + 1)
            offs = dcache.view(chunk, hdr).view(np.uint32).astype(np.int64)
            rc, _ = mc.query(seq)
            if rc != 0:
                ctx.metrics.add("torn_drop_cnt")
                continue
            frag = dcache.view(chunk, hdr + int(offs[k]))[hdr:].copy()
            rc, _ = mc.query(seq)
            if rc != 0:
                ctx.metrics.add("torn_drop_cnt")
                continue
            for w in range(k):
                self._insert(ctx, bytes(frag[offs[w]:offs[w + 1]]))
        self._emit(ctx)
        self._sync_pack(ctx)

    def _emit(self, ctx) -> bool:
        """Schedule and publish until the heap cannot progress.  One bank
        lane whose locks release at once (the PoH tile is a synchronous
        consumer), so within a microblock conflicts are excluded and
        across microblocks the order serializes them."""
        progressed = False
        while True:
            mb = self.pack.schedule(0)
            if mb is None:
                break
            payload = entry_lib.serialize_txn_batch(mb.payloads)
            if self.shard_cnt > 1:
                payload = self._merge_wire(mb) + payload
            ctx.publish(payload, sig=self._mb_seq)
            self._mb_seq += 1
            ctx.metrics.add("cu_consumed",
                            sum(h.cost.total for h in mb.txns))
            self.pack.done(0)
            progressed = True
        return progressed

    def _merge_wire(self, mb) -> bytes:
        """Budget header for LeaderMergeTile's global accounting: total /
        vote cost, data bytes, and per-account write costs (u64 keys —
        the merge never re-parses).  Accounts are unique across the
        microblock's txns by construction (write-write conflicts are
        excluded within one microblock)."""
        total = vote = data = 0
        items: dict = {}
        for h in mb.txns:
            total += h.cost.total
            if h.cost.is_simple_vote:
                vote += h.cost.total
            data += len(h.payload)
            for k, c in pack_lib.writable_key_costs(h).items():
                items[k] = items.get(k, 0) + c
        return self.MERGE_HDR.pack(len(items), total, vote, data) + \
            b"".join(self.MERGE_ITEM.pack(k, c) for k, c in items.items())

    def after_credit(self, ctx):
        if self.pack.pending:
            self._emit(ctx)
            self._sync_pack(ctx)

    def house(self, ctx):
        if (time.monotonic_ns() - self._block_t0) // 1000 >= self.block_us:
            self.pack.end_block()
            self._block_t0 = time.monotonic_ns()
        self._sync_pack(ctx)

    def drain(self, ctx) -> bool:
        """Drain-protocol hook: flush the heap.  Block limits reset
        (end_block) so leftover txns are not stuck behind this block's
        budget; a heap that still cannot progress after two budget resets
        is dropped with a counter, never a silent hang."""
        progressed = self._emit(ctx)
        if not self.pack.pending:
            self._sync_pack(ctx)
            return True
        if progressed:
            self._drain_stall = 0
            return False
        self._drain_stall += 1
        self.pack.end_block()
        self._block_t0 = time.monotonic_ns()
        if self._drain_stall >= 3:
            ctx.metrics.add("drain_drop_cnt", self.pack.clear_pending())
            self._sync_pack(ctx)
            return True
        return False

    def fini(self, ctx):
        self._emit(ctx)
        self._sync_pack(ctx)


class LeaderMergeTile:
    """Shard-merge stage of the sharded leader lane: consumes the
    merge-wire microblock frags from every leader_pack shard and
    interleaves them round-robin into ONE tick-stream, enforcing the
    GLOBAL block/vote/data and per-account write budgets here — each
    shard's Pack only pre-filters against its local copy, so this tile is
    the consensus-critical accounting authority.

    Admission: one pass over the shards per round starting at a rotating
    cursor, admitting at most one head microblock per shard per pass (the
    round-robin interleave).  A head that would overflow a budget stays
    queued (merge_budget_defer_cnt) until the block rolls; a full pass
    with queued work but zero admissions counts merge_stall_cnt.
    Admitted frags re-publish the inner serialize_txn_batch payload
    (merge header stripped) with this tile's own monotonic microblock
    seq, so PohDevTile sees exactly the single-packer wire.

    Drain convergence: any single shard microblock fits a fresh budget
    (see pack.MergeBudget), so resetting the block always unblocks.
    cfg: block_us (end_block cadence, default 400_000)."""

    def init(self, ctx):
        self.budget = pack_lib.MergeBudget()
        self.block_us = ctx.cfg.get("block_us", 400_000)
        self._block_t0 = time.monotonic_ns()
        # iidx -> deque of (cost, vote, data, items, inner)
        self._qs: dict = {}
        self._rr = 0
        self._mb_seq = 0
        self._drain_stall = 0

    def on_frag(self, ctx, iidx, meta, payload):
        b = bytes(payload)
        hdr, item = LeaderPackTile.MERGE_HDR, LeaderPackTile.MERGE_ITEM
        try:
            n_items, cost, vote, data = hdr.unpack_from(b, 0)
            items = [item.unpack_from(b, hdr.size + item.size * i)
                     for i in range(n_items)]
            inner = b[hdr.size + item.size * n_items:]
        except struct.error:
            ctx.metrics.add("parse_fail_cnt")
            return
        self._qs.setdefault(iidx, deque()).append(
            (cost, vote, data, items, inner))
        ctx.metrics.add("mb_rx_cnt")
        self._admit(ctx)

    def _admit(self, ctx) -> bool:
        keys = sorted(self._qs)
        if not keys:
            return False
        admitted_any = False
        while True:
            progressed = False
            deferred = False
            for off in range(len(keys)):
                q = self._qs[keys[(self._rr + off) % len(keys)]]
                if not q:
                    continue
                cost, vote, data, items, inner = q[0]
                if not self.budget.try_admit(cost, vote, data, items):
                    ctx.metrics.add("merge_budget_defer_cnt")
                    deferred = True
                    continue
                q.popleft()
                ctx.publish(inner, sig=self._mb_seq)
                self._mb_seq += 1
                ctx.metrics.add("mb_merge_cnt")
                progressed = True
            self._rr = (self._rr + 1) % len(keys)
            if not progressed:
                if deferred:
                    ctx.metrics.add("merge_stall_cnt")
                break
            admitted_any = True
        ctx.metrics.set("merge_q", sum(len(q) for q in self._qs.values()))
        return admitted_any

    def house(self, ctx):
        if (time.monotonic_ns() - self._block_t0) // 1000 >= self.block_us:
            self.budget.end_block()
            self._block_t0 = time.monotonic_ns()
        self._admit(ctx)

    def after_credit(self, ctx):
        if any(self._qs.values()):
            self._admit(ctx)

    def drain(self, ctx) -> bool:
        """Drain-protocol hook: flush every queued microblock.  Budget
        resets force progress (any one microblock fits a fresh block);
        the drop path is an unreachable safety net, never silent."""
        self._admit(ctx)
        if not any(self._qs.values()):
            return True
        self.budget.end_block()
        self._block_t0 = time.monotonic_ns()
        if self._admit(ctx):
            self._drain_stall = 0
            return not any(self._qs.values())
        self._drain_stall += 1
        if self._drain_stall >= 3:
            n = sum(len(q) for q in self._qs.values())
            ctx.metrics.add("drain_drop_cnt", n)
            for q in self._qs.values():
                q.clear()
            return True
        return False

    def fini(self, ctx):
        self._admit(ctx)
        if any(self._qs.values()):
            self.budget.end_block()
            self._admit(ctx)


class PohDevTile:
    """Device PoH tile: extends the slot's hash chain through (lanes, 32)
    span dispatches on the PoH span engine.  Lane 0 is the chain; the
    other lanes re-check entries already emitted, in the same dispatch.

    Speculation, K ticks deep: mixins sit at the END of each tick — P =
    hashes_per_tick - mb_per_tick - 1 plain hashes, then up to mb_per_tick
    single-hash mixin entries, then a tail.  One window dispatch pre-hashes
    K whole ticks from the current head as 2K chained steps ((P, None),
    (tail, None) a tick), so every tick boundary and every mixin insertion
    point (the state at P) comes back as a step plane.  A tick that closes
    empty consumes one speculated tick (spec_hit) with no extra hashing; a
    tick that closes with j microblocks SPLICES: a second, one-lane engine
    re-hashes from the saved state at P — steps (1, m_1)..(1, m_j),
    inactive padding, (tail - j, None), caps (1,..,1,tail) — so the
    re-hash costs tail - j wasted hashes (rehash_cnt), and the later
    speculated ticks are invalidated.  The mixins of a tick's microblocks
    come from one launch of the mixin-tree kernel.

    In: microblock frags from leader_pack (entry.serialize_txn_batch
    wire).  Out: serialized entries, sig = slot | SLOT_DONE_BIT on a
    slot's last entry.

    cfg: seed_hash (hex), hashes_per_tick, ticks_per_slot, start_slot,
    spec_ticks (K), spec_spans (window lanes: 1 chain + N-1 re-check),
    mb_per_tick (mixin entries a tick; capped at hashes_per_tick - 1),
    mixin_txn_max (pad width of the mixin trees), nbuf, depth, device
    (None: the GPU; "cpu" runs the kernels' plain versions).  A device
    error propagates, from fini too."""

    SLOT_DONE_BIT = 1 << 63

    def init(self, ctx):
        cfg = ctx.cfg
        self.device = cfg.get("device") or None
        self.hash = bytes.fromhex(cfg["seed_hash"]) if "seed_hash" in cfg \
            else bytes(32)
        self.hashes_per_tick = cfg.get("hashes_per_tick", 16)
        self.ticks_per_slot = cfg.get("ticks_per_slot", 8)
        self.slot = cfg.get("start_slot", 1)
        self.tick = 0
        self.recheck_lanes = max(0, cfg.get("spec_spans", 3) - 1)
        self.mb_cap = min(cfg.get("mb_per_tick", 8),
                          self.hashes_per_tick - 1)
        if self.mb_cap < 1:
            raise ValueError("hashes_per_tick must be >= 2 for mixins")
        self.mixin_txn_max = cfg.get("mixin_txn_max", 32)
        self.K = max(1, cfg.get("spec_ticks", 4))
        # tick anatomy: P plain hashes, then the mixin region + tail
        self.P = self.hashes_per_tick - self.mb_cap - 1
        tail = self.mb_cap + 1
        # window engine: K ticks of (P, tail) step pairs.  Step 0's cap
        # is the full hashes_per_tick so re-check lanes (an entry of up
        # to a whole tick) fit in the shared first step.
        caps = [self.hashes_per_tick, tail] \
            + [max(self.P, 1), tail] * (self.K - 1)
        self.eng = PohEngine(
            lanes=1 + self.recheck_lanes, steps=2 * self.K,
            max_hashes=self.hashes_per_tick, step_caps=caps,
            nbuf=cfg.get("nbuf", 2), depth=cfg.get("depth"),
            device=self.device)
        # splice engine: re-hash from the saved mixin insertion point —
        # j mixin steps (1 hash each) + the plain tail, never a full tick
        self.seng = PohEngine(
            lanes=1, steps=tail, max_hashes=tail,
            step_caps=(1,) * self.mb_cap + (tail,), nbuf=2,
            device=self.device)
        # build and launch BEFORE signaling RUN: both span geometries and
        # the mixin-tree shape the hot path uses
        self.eng.warm()
        self.seng.warm()
        entry_lib.txn_mixins_device(
            [[b"\x00" * 65]], pad_batch=self.mb_cap,
            pad_width=self.mixin_txn_max, device=self.device)
        self._mb_q = deque()          # parsed microblocks awaiting a tick
        self._recheck_q = deque(maxlen=256)   # (start, n, mixin|None, end)
        self._pending_disp = deque()  # window-dispatch FIFO
        self._win = None              # current speculation window record
        self._win_pos = 0             # speculated ticks already consumed
        # the kernels' launch counts at the end of boot
        self._launch0 = (poh_spans.launches, mixin_tree.launches)

    # -------------------------------------------------------------- ingest
    def on_frag(self, ctx, iidx, meta, payload):
        try:
            txns, _ = entry_lib.deserialize_txn_batch(bytes(payload))
        except ValueError:
            ctx.metrics.add("parse_fail_cnt")
            return
        if not txns or len(txns) > self.mixin_txn_max:
            ctx.metrics.add("parse_fail_cnt")
            return
        self._mb_q.append(txns)
        ctx.metrics.add("mb_rx_cnt")

    # ------------------------------------------------------------- harvest
    def _emit(self, ctx, e, slot_done: bool, slot: int):
        ctx.publish(e.serialize(), sig=slot
                    | (self.SLOT_DONE_BIT if slot_done else 0))
        ctx.metrics.add("entry_cnt")

    def _process(self, ctx, verdicts):
        for v in verdicts:
            planes = self.eng.split_verdict(v)
            rec = self._pending_disp.popleft()
            for lane, exp in rec["rechecks"]:
                if bytes(planes[lane, 0]) == exp:
                    ctx.metrics.add("recheck_ok_cnt")
                else:
                    ctx.metrics.add("recheck_fail_cnt")
            # per speculated tick, the state at the mixin insertion point
            # (plane 2t) and the tick end (2t+1)
            rec["mid"] = [bytes(planes[0, 2 * t]) for t in range(self.K)]
            rec["end"] = [bytes(planes[0, 2 * t + 1]) for t in range(self.K)]
            rec["heads"] = [rec["head"]] + rec["end"][:-1]
            rec["ready"] = True

    # ---------------------------------------------------------- tick cycle
    def _open_window(self, ctx):
        rec = {"head": self.hash, "rechecks": [], "heads": None,
               "mid": None, "end": None, "ready": False}
        steps = []
        for _ in range(self.K):
            steps.append((self.P, None))
            steps.append((self.mb_cap + 1, None))
        lanes = [(self.hash, steps)]
        for lane in range(1, 1 + self.recheck_lanes):
            if not self._recheck_q:
                break
            start, n, mix, end = self._recheck_q.popleft()
            lanes.append((start, [(n, mix)]))
            rec["rechecks"].append((lane, end))
        self._pending_disp.append(rec)
        self._win = rec
        self._win_pos = 0
        ctx.metrics.add("dispatch_cnt")
        self._process(ctx, self.eng.submit_lanes(lanes))

    def _close_tick(self, ctx, final: bool = False):
        j = min(len(self._mb_q), self.mb_cap)
        mbs = [self._mb_q.popleft() for _ in range(j)]
        if self._mb_q:
            ctx.metrics.add("mb_deferred_cnt", len(self._mb_q))
        done = final or (self.tick + 1 >= self.ticks_per_slot)
        win = self._win
        if not win["ready"]:
            self._process(ctx, self.eng.drain())
        t = self._win_pos
        if j == 0:
            # speculation lands: the pre-hashed tick IS the tick, and the
            # window stays live for the next one
            ctx.metrics.add("spec_hit_cnt")
            end = win["end"][t]
            self._emit(ctx, entry_lib.Entry(self.hashes_per_tick, end, []),
                       done, self.slot)
            self._recheck_q.append(
                (win["heads"][t], self.hashes_per_tick, None, end))
            self.hash = end
            self._win_pos += 1
            if self._win_pos >= self.K:
                self._win = None
        else:
            # mixins landed: splice from the saved state at P — only the
            # mixin region re-hashes; the later speculated ticks assumed
            # a plain chain and are invalidated
            ctx.metrics.add("spec_miss_cnt")
            ctx.metrics.add("rehash_cnt", self.mb_cap + 1 - j)
            mix_arr = entry_lib.txn_mixins_device(
                mbs, pad_batch=self.mb_cap, pad_width=self.mixin_txn_max,
                device=self.device)
            mixins = [bytes(mix_arr[i]) for i in range(j)]
            steps = [(1, m) for m in mixins]
            steps += [(0, None)] * (self.mb_cap - j)
            steps.append((self.mb_cap + 1 - j, None))
            ctx.metrics.add("splice_dispatch_cnt")
            # entry order is consensus-critical: the splice retires
            # synchronously before the next tick opens on its end state
            verdicts = self.seng.submit_lanes([(win["mid"][t], steps)])
            verdicts += self.seng.drain()
            planes = self.seng.split_verdict(verdicts[-1])
            h = win["heads"][t]
            end = bytes(planes[0, 0])
            self._emit(ctx, entry_lib.Entry(self.P + 1, end, mbs[0]),
                       False, self.slot)
            self._recheck_q.append((h, self.P + 1, mixins[0], end))
            ctx.metrics.add("mixin_cnt")
            h = end
            for si in range(1, j):
                end = bytes(planes[0, si])
                self._emit(ctx, entry_lib.Entry(1, end, mbs[si]),
                           False, self.slot)
                self._recheck_q.append((h, 1, mixins[si], end))
                ctx.metrics.add("mixin_cnt")
                h = end
            n_rem = self.mb_cap + 1 - j
            end = bytes(planes[0, self.mb_cap])
            self._emit(ctx, entry_lib.Entry(n_rem, end, []), done, self.slot)
            self._recheck_q.append((h, n_rem, None, end))
            self.hash = end
            self._win = None
        ctx.metrics.add("hash_cnt", self.hashes_per_tick)
        ctx.metrics.add("tick_cnt")
        if done:
            self.tick = 0
            self.slot += 1
        else:
            self.tick += 1

    def house(self, ctx):
        if self._win is None:
            self._open_window(ctx)
        else:
            self._close_tick(ctx)
            if self._win is None:
                self._open_window(ctx)
        ctx.metrics.set("mb_queue", len(self._mb_q))
        ctx.metrics.set("spec_depth",
                        (self.K - self._win_pos) if self._win else 0)

    def after_credit(self, ctx):
        verdicts = self.eng.poll()
        if verdicts:
            self._process(ctx, verdicts)
        ctx.metrics.set("inflight_depth",
                        self.eng.inflight_depth + self.seng.inflight_depth)

    def drain(self, ctx) -> bool:
        """Drain-protocol hook: absorb every queued microblock into closed
        ticks, then run the engine dry."""
        if self._win is not None:
            self._close_tick(ctx)
            if self._mb_q:
                if self._win is None:
                    self._open_window(ctx)
                return False
        elif self._mb_q:
            self._open_window(ctx)
            return False
        self._process(ctx, self.eng.drain())
        self.seng.drain()
        return True

    def drain_manifest(self, ctx) -> dict:
        """The drain manifest's record of this tile, once it ran dry: the
        span and mixin-tree kernel launches since boot ended (0 on the
        CPU, where the plain versions run) beside the window and splice
        dispatches so far (fini, after the drain, dispatches again)."""
        return {"launches": {
                    "poh_spans": poh_spans.launches - self._launch0[0],
                    "mixin_tree": mixin_tree.launches - self._launch0[1]},
                "dispatch_cnt": ctx.metrics.get("dispatch_cnt"),
                "splice_dispatch_cnt": ctx.metrics.get("splice_dispatch_cnt")}

    def fini(self, ctx):
        """Close the slot so downstream sees a complete block."""
        if self._win is None:
            self._open_window(ctx)
        while self._mb_q:
            self._close_tick(ctx)
            if self._win is None and self._mb_q:
                self._open_window(ctx)
        if self._win is None:
            self._open_window(ctx)
        self._close_tick(ctx, final=True)
        self._process(ctx, self.eng.drain())
