"""The tile run loop (ref: src/disco/mux/fd_mux.c: credit-based flow
control fd_mux.c:233-310, housekeeping fd_mux.c:349-395, frag poll ->
before_frag/during_frag/after_frag dispatch, overrun detection); the
port's own copy of firedancer_tpu/disco/mux.py.

One Mux drives one tile process: it polls every in-link mcache by sequence
number, copies payloads out of dcaches with seqlock re-validation, invokes
the tile's callbacks, and publishes to the tile's out links gated on credits
from reliable downstream consumers.

Callbacks (a tile implements any subset — the fd_topo_run_tile_t vtable,
src/disco/tiles.h):
    init(ctx)                      after joining the topology, before the loop
    before_frag(ctx, iidx, seq, sig) -> bool   True = skip (filter w/o payload)
    on_frag(ctx, iidx, meta, payload)          process one frag
    after_credit(ctx)              once per loop when credits are available
    house(ctx)                     during housekeeping (low rate)
    fini(ctx)                      on halt

and the burst and zero-copy rx hooks (on_burst, on_burst_view with
credits_held), apply_knobs and the drain hook, described in run().

A fault plan (disco/faultinject.py: the tile cfg's `faults` or
FDTPU_FAULTS) arms a FaultInjector that the rx paths and housekeeping
call; with no plan each site costs one `is not None` compare.  A tile
respawned into a live workspace (restart_cnt > 0) resumes each in-link
from its fseq cursor.
"""

import os
import time
from dataclasses import dataclass

from ..tango import ring
from ..tango.ring import FSeq, Cnc
from ..utils.hist import Histf
from . import faultinject
from . import trace as trace_mod
from .topo import JoinedTopology, TileSpec

# fseq diag indices (mirrors FD_FSEQ_DIAG_*)
_D_PUB_CNT, _D_PUB_SZ = FSeq.DIAG_PUB_CNT, FSeq.DIAG_PUB_SZ
_D_FILT_CNT = FSeq.DIAG_FILT_CNT
_D_OVRNP_CNT = FSeq.DIAG_OVRNP_CNT
_D_SLOW_CNT = FSeq.DIAG_SLOW_CNT


@dataclass
class _InState:
    name: str
    mcache: object
    dcache: object
    fseq: FSeq
    seq: int = 0


@dataclass
class _OutState:
    name: str
    mcache: object
    dcache: object
    consumers: list          # reliable consumer fseqs
    depth: int = 0
    seq: int = 0
    chunk: int = 0
    cr_avail: int = 0
    mtu: int = 0
    # per-housekeeping-window attribution state (out{j}_* gauges):
    # credit low-watermark since the last housekeeping sample, plus the
    # publish seq/bytes marks the window rates are measured against
    cr_lwm: int = 0
    sz_total: int = 0
    seq_w0: int = 0
    sz_w0: int = 0


class TileCtx:
    """What a tile's callbacks see: its config, metrics block, and publish
    surface over the out links."""

    def __init__(self, topo: JoinedTopology, tile: TileSpec, mux: "Mux"):
        self.topo = topo
        self.tile = tile
        self.cfg = tile.cfg
        self.metrics = topo.metrics[tile.name]
        self.trace = topo.trace.get(tile.name)  # fdtrace span ring writer
        self._mux = mux
        self.halted = False

    def out_index(self, link_name: str) -> int:
        for i, o in enumerate(self._mux.outs):
            if o.name == link_name:
                return i
        raise KeyError(link_name)

    def publish(self, payload: bytes = b"", sig: int = 0, out: int = 0,
                ctl_: int | None = None) -> int:
        """Publish one frag on out link `out`, blocking on downstream credits
        (the reference instead polls credits in housekeeping and the tile
        yields; a bounded spin keeps the Python loop simple and still
        surfaces the stall in backp_cnt)."""
        return self._mux.publish(out, payload, sig, ctl_)

    def publish_burst(self, buf, starts, lens, sigs, out: int = 0) -> int:
        """Publish many frags in one native call (tango.cpp
        fd_ring_tx_burst): payload i = buf[starts[i]:starts[i]+lens[i]]
        with app sig sigs[i].  Same credit semantics as publish()."""
        return self._mux.publish_burst(out, buf, starts, lens, sigs)

    def out_reserve(self, nbytes: int, out: int = 0):
        """Reserve dcache space for one frag: blocks on a downstream
        credit, then returns (chunk, writable uint8 view of nbytes over
        the shm) for readinto-style stamping — no staging bytes object.
        Returns (None, None) on halt-while-backpressured.  Must be paired
        with out_commit()."""
        return self._mux.out_reserve(out, nbytes)

    def out_commit(self, chunk: int, nbytes: int, sig: int = 0,
                   sz: int | None = None, out: int = 0) -> int:
        """Publish the frag reserved at `chunk`.  `sz` is the value stored
        in the 16-bit meta.sz field (defaults to nbytes; packed-wire frags
        store the ROW COUNT there since byte sizes overflow u16)."""
        return self._mux.out_commit(out, chunk, nbytes, sig,
                                    nbytes if sz is None else sz)

    def in_mcache(self, iidx: int):
        """The in-link's mcache — zero-copy consumers (on_burst_view)
        re-check frag seqlocks against it after reading shm views."""
        return self._mux.ins[iidx].mcache

    def halt(self):
        """Ask the loop to exit after this callback returns."""
        self.halted = True

    def heartbeat(self):
        """Stamp this tile's cnc heartbeat and honor HALT — for callbacks
        that block longer than a housekeeping interval (a tile waiting on
        an in-flight device batch must not be declared stale, and must
        still come down when the supervisor raises HALT).  Rate-limited
        internally, so calling it from a tight wait loop is fine."""
        self._mux.heartbeat_poke()


class Mux:
    HOUSE_NS = 20_000_000   # ~20ms default housekeeping interval
    BURST = 64              # frags drained per mcache poll

    def __init__(self, topo: JoinedTopology, tile_name: str, vtable,
                 restart_cnt: int = 0):
        self.topo = topo
        self.tile = topo.tile_spec(tile_name)
        self.vt = vtable
        self.metrics = topo.metrics[tile_name]
        self.cnc: Cnc = topo.cnc[tile_name]
        # armed fault plan or None (the common case; every hot-path site
        # below guards on `is not None` so disabled injection costs one
        # identity compare per burst)
        self.fault = faultinject.for_tile(tile_name, self.tile.cfg,
                                          restart_cnt=restart_cnt)
        self.restart_cnt = restart_cnt
        self._next_poke = 0
        # fdtrace: this tile's span ring (disco/trace.py) + the span-chain
        # origin stamp of the frag currently being processed — publishes
        # during a callback carry it forward as tsorig so downstream hops
        # can measure whole-chain age (the reference's tsorig contract,
        # fd_tango_base.h:140-170)
        self.tracer = topo.trace.get(tile_name)
        self._cur_tsorig = 0
        # autotune knob mailbox: generation-checked once per housekeeping
        # (one int compare unarmed).  gen-seen starts at 0, so a tile
        # that joins late, or a respawned one, applies whatever knob set
        # is already posted.
        self._knob_pod = topo.knobs.get(tile_name)
        self._knob_gen = 0

        self.ins: list[_InState] = []
        for il in self.tile.in_links:
            jl = topo.links[il.link]
            fs = topo.fseq[(self.tile.name, il.link)]
            # start at the link's seq0, NOT the live producer cursor: a
            # producer that booted first may already have published, and a
            # reliable consumer must see every frag from the beginning (the
            # credit system guarantees none were overwritten: the producer
            # is gated on our fseq, which also starts at seq0).
            # EXCEPT on respawn: a tile restarted into a live workspace
            # resumes from its own persisted fseq cursor — every frag below
            # it was already acked (by the previous incarnation, or by the
            # supervisor's dead-consumer eviction while we were down), so
            # re-processing would emit duplicate verdicts downstream.
            seq = jl.mcache.seq0()
            if restart_cnt > 0:
                seq = max(seq, fs.query())
            self.ins.append(_InState(il.link, jl.mcache, jl.dcache, fs,
                                     seq=seq))
        self.outs: list[_OutState] = []
        for ln in self.tile.out_links:
            jl = topo.links[ln]
            self.outs.append(_OutState(
                ln, jl.mcache, jl.dcache, topo.reliable_consumers(ln),
                depth=jl.spec.depth, seq=jl.mcache.seq_query(),
                chunk=0))
            self.outs[-1].mtu = jl.spec.mtu
        self.ctx = TileCtx(topo, self.tile, self)

    # -- credits (fd_mux.c:233-310) ---------------------------------------
    def _refresh_credits(self):
        for o in self.outs:
            if not o.consumers:
                o.cr_avail = o.depth
                continue
            lo = min(fs.query() for fs in o.consumers)
            o.cr_avail = o.depth - (o.seq - lo)

    def _wait_credit(self, o: _OutState) -> bool:
        """Block (in slices) until one credit is available on `o`.  Returns
        False if the topology HALTed while backpressured (frag dropped)."""
        backp = False
        next_hb = 0
        t_enter = 0
        while o.cr_avail <= 0:
            if not backp:
                backp = True
                t_enter = time.monotonic_ns()
            self._refresh_credits()
            if o.cr_avail <= 0:
                # stay responsive while backpressured: heartbeat and honor
                # HALT so a dead downstream can't wedge shutdown or make the
                # supervisor flag us as stalled
                now = time.monotonic_ns()
                if now >= next_hb:
                    # charge the limiting consumer's slow diag (next_hb=0:
                    # the first pass charges immediately) — how the monitor
                    # attributes this producer's stall to a specific rx
                    # (fd_fctl.h receiver diag)
                    if o.consumers:
                        min(o.consumers,
                            key=lambda fs: fs.query()).diag_add(_D_SLOW_CNT)
                    next_hb = now + 10_000_000
                    self.cnc.heartbeat(now)
                    if self.cnc.signal_query() == Cnc.SIGNAL_HALT:
                        self.ctx.halted = True
                        self.metrics.add(
                            "backp_ns", time.monotonic_ns() - t_enter)
                        return False
                time.sleep(50e-6)
        if backp:
            self.metrics.add("backp_cnt")
            self.metrics.add("backp_ns", time.monotonic_ns() - t_enter)
        return True

    def heartbeat_poke(self):
        """Out-of-band heartbeat + HALT check for callbacks that block
        past a housekeeping interval (device verdict waits).  Rate-limited
        to the same 10ms cadence as the backpressure loop so hammering it
        from a poll loop stays cheap."""
        now = time.monotonic_ns()
        if now < self._next_poke:
            return
        self._next_poke = now + 10_000_000
        self.cnc.heartbeat(now)
        if self.cnc.signal_query() == Cnc.SIGNAL_HALT:
            self.ctx.halted = True

    # -- drain protocol (graceful quiesce) --------------------------------
    def _drain_park(self, ctx, vt, m, cb_held, t0):
        """SIGNAL_DRAIN terminal phase, entered from housekeeping once
        the catch-up phase has consumed every frag published before the
        DRAIN admission snapshot:

          1. stop admitting frags — the in-link fseqs freeze and live
             upstream producers park on withheld credits via the normal
             fctl math (a credit park, not a dead consumer: no eviction,
             no loss);
          2. run the tile dry: the vtable's optional `drain(ctx) -> bool`
             hook is polled until it reports True (the verify tile
             dispatches every open bucket + lat accumulator and harvests
             every in-flight device batch, publishing all verdicts);
             tiles without the hook are dry by definition;
          3. persist a cursor manifest (per-in-link fseq position, knob
             generation) — the zero-loss audit artifact;
          4. signal DRAINED and park, heartbeating, until HALT.

        The park keeps DRAINED visible for as long as the supervisor
        needs it (the loop-exit finally would otherwise overwrite it with
        the BOOT halted-ack immediately).  A tile that cannot run dry
        stays in DRAIN heartbeating — the supervisor's drain_timeout_s
        bounds that by falling back to crash-respawn semantics (HALT or
        terminate), so peers never hang on a wedged drain."""
        cb_drain = getattr(vt, "drain", None)
        while not ctx.halted:
            done = cb_drain(ctx) if cb_drain is not None else True
            now = time.monotonic_ns()
            self.cnc.heartbeat(now)
            # verdicts landing during the dry-run release pinned credits:
            # keep publishing fseq minus held so the manifest cursor (and
            # the producer's credit view) converges to fully-acked
            for hidx, i in enumerate(self.ins):
                held = cb_held(hidx) if cb_held is not None else 0
                i.fseq.update(i.seq - held)
            if self.cnc.signal_query() == Cnc.SIGNAL_HALT:
                return  # supervisor gave up (drain_timeout_s): plain halt
            if done:
                break
            time.sleep(200e-6)
        if ctx.halted:
            return
        m.set("drain_flush_ns", time.monotonic_ns() - t0)
        self._write_drain_manifest()
        self.cnc.signal(Cnc.SIGNAL_DRAINED)
        while self.cnc.signal_query() != Cnc.SIGNAL_HALT:
            self.cnc.heartbeat(time.monotonic_ns())
            time.sleep(1e-3)

    def _write_drain_manifest(self):
        """Cursor manifest for a completed drain.  The respawn itself
        resumes from the fseq lines in shm (restart_cnt > 0 path); the
        manifest is what an operator or a test inspects to prove zero
        loss — per-in-link fseq cursor, out-link publish cursor, the
        knob-pod generation this incarnation had applied, and under
        "tile_state" what the tile's optional
        drain_manifest(ctx) hook returns.  Written to
        [supervision] drain_manifest_dir (threaded into tile cfg) or
        $FDTPU_DRAIN_DIR; skipped when neither is set — a drain must
        never fail on a read-only filesystem."""
        sup = (self.tile.cfg.get("supervision") or {})
        d = (sup.get("drain_manifest_dir")
             or os.environ.get("FDTPU_DRAIN_DIR"))
        if not d:
            return
        try:
            import json
            os.makedirs(d, exist_ok=True)
            man = {
                "tile": self.tile.name,
                "kind": self.tile.kind,
                "restart_cnt": self.restart_cnt,
                "knob_gen": self._knob_gen,
                "cursors": {i.name: int(i.fseq.query()) for i in self.ins},
                "outs": {o.name: int(o.seq) for o in self.outs},
            }
            # the vtable's optional drain_manifest(ctx) -> dict: what the
            # tile itself records of its run (JSON values)
            cb_man = getattr(self.vt, "drain_manifest", None)
            if cb_man is not None:
                man["tile_state"] = cb_man(self.ctx)
            path = os.path.join(
                d, self.tile.name.replace(":", "_") + ".manifest.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(man, f, indent=1, sort_keys=True)
            os.replace(tmp, path)  # atomic: readers never see a torn file
        except OSError:
            pass

    def publish(self, out_idx: int, payload: bytes, sig: int,
                ctl_: int | None) -> int:
        o = self.outs[out_idx]
        if len(payload) > o.mtu:
            # covers metadata-only links too (mtu=0): publishing payload
            # bytes there would silently arrive as b"" downstream
            raise ValueError(
                f"payload {len(payload)}B exceeds link {o.name} mtu {o.mtu}")
        if not self._wait_credit(o):
            return -1  # frag dropped; topology is going down
        chunk, sz = 0, len(payload)
        if o.dcache is not None and sz:
            chunk = o.chunk
            o.chunk = o.dcache.write(chunk, payload)
        tspub = time.monotonic_ns() & 0xFFFFFFFF
        # span-chain origin: forward the consumed frag's tsorig; a frag
        # published outside frag processing (after_credit/house) STARTS a
        # chain, so its origin is its own publish time
        seq = o.mcache.publish(
            sig, chunk, sz,
            ring.ctl() if ctl_ is None else ctl_,
            self._cur_tsorig or tspub, tspub)
        o.seq = seq + 1
        o.cr_avail -= 1
        if o.cr_avail < o.cr_lwm:
            o.cr_lwm = o.cr_avail
        o.sz_total += sz
        self.metrics.add("out_frag_cnt")
        self.metrics.add("out_sz", sz)
        return seq

    def publish_burst(self, out_idx: int, buf, starts, lens, sigs) -> int:
        """Credit-gated burst publish: waits (in slices) until the whole
        burst's credits are available, then one fd_ring_tx_burst call.
        Returns the last seq published, or -1 on halt-while-backpressured."""
        import numpy as np
        o = self.outs[out_idx]
        n = len(starts)
        if n == 0:
            return o.seq - 1
        if int(np.max(lens)) > o.mtu:
            raise ValueError(
                f"payload exceeds link {o.name} mtu {o.mtu}")
        if o.dcache is None:
            raise ValueError(f"link {o.name} has no dcache (burst needs one)")
        done = 0
        while done < n:
            if not self._wait_credit(o):
                return -1
            take = min(n - done, o.cr_avail)
            tspub = time.monotonic_ns() & 0xFFFFFFFF
            seq, o.chunk = ring.tx_burst(
                o.mcache, o.dcache, o.chunk, buf,
                starts[done : done + take], lens[done : done + take],
                sigs[done : done + take],
                tsorig=self._cur_tsorig or tspub, tspub=tspub)
            o.seq = seq + 1
            o.cr_avail -= take
            if o.cr_avail < o.cr_lwm:
                o.cr_lwm = o.cr_avail
            done += take
        sz_total = int(np.sum(lens))
        o.sz_total += sz_total
        self.metrics.add("out_frag_cnt", n)
        self.metrics.add("out_sz", sz_total)
        return o.seq - 1

    # -- zero-copy producer surface (packed-wire path) ---------------------
    def out_reserve(self, out_idx: int, nbytes: int):
        """Reserve one frag's dcache space: wait for one credit, return
        (chunk, writable view).  The producer stamps the payload directly
        into shm (readinto-style) and then out_commit()s — the frag never
        exists as an intermediate bytes object."""
        o = self.outs[out_idx]
        if nbytes > o.mtu:
            raise ValueError(
                f"reserve {nbytes}B exceeds link {o.name} mtu {o.mtu}")
        if o.dcache is None:
            raise ValueError(f"link {o.name} has no dcache")
        if not self._wait_credit(o):
            return None, None
        return o.chunk, o.dcache.write_view(o.chunk, nbytes)

    def out_commit(self, out_idx: int, chunk: int, nbytes: int, sig: int,
                   sz: int) -> int:
        """Publish the frag reserved at `chunk` (nbytes written through the
        reserved view; `sz` goes into the u16 meta.sz field — for packed
        frags that is the row count, not the byte size)."""
        o = self.outs[out_idx]
        o.chunk = o.dcache.advance(chunk, nbytes)
        tspub = time.monotonic_ns() & 0xFFFFFFFF
        seq = o.mcache.publish(
            sig, chunk, sz, ring.ctl(),
            self._cur_tsorig or tspub, tspub)
        o.seq = seq + 1
        o.cr_avail -= 1
        if o.cr_avail < o.cr_lwm:
            o.cr_lwm = o.cr_avail
        o.sz_total += nbytes
        self.metrics.add("out_frag_cnt")
        self.metrics.add("out_sz", nbytes)
        return seq

    # -- main loop ---------------------------------------------------------
    def run(self):
        import numpy as np
        vt, ctx, m = self.vt, self.ctx, self.metrics
        # bind the vtable once: per-frag hasattr probes cost in the hot loop
        cb_before = getattr(vt, "before_frag", None)
        cb_frag = getattr(vt, "on_frag", None)
        cb_credit = getattr(vt, "after_credit", None)
        cb_house = getattr(vt, "house", None)
        cb_knobs = getattr(vt, "apply_knobs", None)
        if hasattr(vt, "init"):
            vt.init(ctx)
        # burst rx: a tile exposing on_burst(ctx, iidx, metas,
        # buf, offs, kept) gets frags drained via ONE native call per poll
        # (consume + seqlock payload copy + optional round-robin filter at
        # the ring, fd_ring_rx_burst) — the per-frag Python dispatch below
        # caps a tile near ~10^5 frags/s; the burst path doesn't.  The
        # tile's init may set .burst_rr = (cnt, idx) for ring-level RR
        # (ref fd_verify.c:36-47); before_frag is NOT called on this path.
        cb_burst = getattr(vt, "on_burst", None)
        # zero-copy burst rx: a tile exposing on_burst_view(ctx,
        # iidx, metas, dcache) consumes metas only — payloads stay in the
        # shm dcache and the tile builds views over them (dcache.rows).
        # Because the payload is NOT copied out under the seqlock, the tile
        # must re-check the mcache seq AFTER it is done reading (or after
        # the device upload completes) and drop torn frags itself.  A tile
        # may hold credits for frags whose views are still pinned by
        # exposing credits_held(iidx); fseq updates subtract it so the
        # producer cannot overwrite a pinned region.
        cb_view = getattr(vt, "on_burst_view", None)
        cb_held = getattr(vt, "credits_held", None)
        rr_cnt, rr_idx = getattr(vt, "burst_rr", (1, 0))
        if cb_burst is not None:
            BURST_RX = 1024
            rx_buf = [np.zeros(
                BURST_RX * max(self.topo.links[il.name].spec.mtu, 64),
                np.uint8) for il in self.ins]
            rx_metas = [np.zeros(BURST_RX, dtype=ring.FRAG_META_DTYPE)
                        for _ in self.ins]
            rx_offs = [np.zeros(BURST_RX + 1, np.int64) for _ in self.ins]
        self.cnc.signal(Cnc.SIGNAL_RUN)
        self._refresh_credits()
        for o in self.outs:
            o.cr_lwm = o.cr_avail
            o.seq_w0 = o.seq
        next_house = 0
        drain_stop = None  # per-in-link admission cursors once DRAINing
        drain_t0 = 0
        win_t0 = 0         # start of the current attribution window
        busy_acc = 0       # ns inside tile callbacks since last flush
        idle_acc = 0       # ns in the nothing-inbound yield sleep
        # per-in-link hop latency: consume time minus producer tspub (both
        # monotonic_ns low 32 bits, same machine clock) — the data the
        # reference monitor renders per link (monitor.c:49-160)
        hop_hists = [Histf(100, 10_000_000_000) for _ in self.ins[:4]]
        try:
            while not ctx.halted:
                now = time.monotonic_ns()
                m.add("loop_cnt")
                if now >= next_house:
                    next_house = now + self.HOUSE_NS
                    m.add("housekeep_cnt")
                    self.cnc.heartbeat(now)
                    sig = self.cnc.signal_query()
                    if sig == Cnc.SIGNAL_HALT:
                        break
                    if sig == Cnc.SIGNAL_DRAIN:
                        # graceful quiesce: rides the signal compare the
                        # loop already pays — zero cost until raised
                        if drain_stop is None:
                            m.add("drain_cnt")
                            drain_t0 = now
                            # admission snapshot: the catch-up phase
                            # consumes every frag published before this
                            # point and nothing after it (a dependency-
                            # ordered topology drain parks producers
                            # first, so the snapshot covers everything)
                            drain_stop = [x.mcache.seq_query()
                                          for x in self.ins]
                        if all(x.seq >= s for x, s
                               in zip(self.ins, drain_stop)):
                            self._drain_park(ctx, vt, m, cb_held,
                                             drain_t0)
                            break
                    for hidx, i in enumerate(self.ins):
                        held = cb_held(hidx) if cb_held is not None else 0
                        i.fseq.update(i.seq - held)
                    self._refresh_credits()
                    for hi, h in enumerate(hop_hists):
                        if h.count():
                            m.set(f"in{hi}_hop_p50_ns",
                                  int(h.percentile(0.50)))
                            m.set(f"in{hi}_hop_p99_ns",
                                  int(h.percentile(0.99)))
                            # fresh window per housekeeping interval: the
                            # gauges must track CURRENT latency, not a
                            # lifetime-cumulative distribution that hides
                            # a live stall behind old samples
                            hop_hists[hi] = Histf(100, 10_000_000_000)
                    # per-out-link attribution (out{j}_* gauges): seq lag
                    # behind the slowest reliable consumer, ring-occupancy
                    # high-watermark (depth - credit low-water), and the
                    # window's publish rates — the inputs to the monitor's
                    # bottleneck verdict (disco/attrib.py)
                    dt = now - win_t0 if win_t0 else 0
                    for oi, o in enumerate(self.outs[:4]):
                        lag = 0
                        if o.consumers:
                            lo = min(fs.query() for fs in o.consumers)
                            lag = max(o.seq - lo, 0)
                        m.set(f"out{oi}_lag", lag)
                        occ = o.depth - o.cr_lwm
                        m.set(f"out{oi}_occ_hwm",
                              max(0, min(occ, o.depth)))
                        m.set(f"out{oi}_cr_lwm", max(o.cr_lwm, 0))
                        if dt > 0:
                            m.set(f"out{oi}_frag_rate",
                                  (o.seq - o.seq_w0) * 1_000_000_000 // dt)
                            m.set(f"out{oi}_byte_rate",
                                  (o.sz_total - o.sz_w0)
                                  * 1_000_000_000 // dt)
                        o.cr_lwm = o.cr_avail
                        o.seq_w0 = o.seq
                        o.sz_w0 = o.sz_total
                    win_t0 = now
                    # regime flush: where the loop's wall time went since
                    # the last housekeeping (backp_ns lands straight from
                    # _wait_credit; housekeeping charges itself below)
                    if busy_acc:
                        m.add("busy_ns", busy_acc)
                        busy_acc = 0
                    if idle_acc:
                        m.add("idle_ns", idle_acc)
                        idle_acc = 0
                    if self.fault is not None:
                        self.fault.house()
                    if self._knob_pod is not None and cb_knobs is not None:
                        g = self._knob_pod.gen
                        if g != self._knob_gen:
                            self._knob_gen = g
                            vals = self._knob_pod.read_set()
                            if vals:
                                cb_knobs(ctx, vals)
                                m.add("knob_apply_cnt", 1)
                    if cb_house is not None:
                        cb_house(ctx)
                    m.add("house_ns", time.monotonic_ns() - now)

                did = 0
                for iidx, i in enumerate(self.ins):
                    if drain_stop is None:
                        room = 1 << 30   # effectively unbounded
                    else:
                        # drain catch-up: admit only frags published
                        # before the DRAIN snapshot; everything after it
                        # belongs to the successor's resume cursor
                        room = drain_stop[iidx] - i.seq
                        if room <= 0:
                            continue
                    if cb_view is not None and i.dcache is not None:
                        metas, rc = i.mcache.consume_burst(
                            i.seq, min(self.BURST, room))
                        cons = len(metas)
                        if cons:
                            # ring-level round-robin on the frag seq (the
                            # native rx_burst filter, in Python: packed
                            # frags are few and large)
                            mine = (metas[(metas["seq"] % rr_cnt) == rr_idx]
                                    if rr_cnt > 1 else metas)
                            if self.fault is not None and len(mine):
                                mine, _nd = self.fault.frags_view(
                                    mine, i.dcache)
                            filt = cons - len(mine)
                            m0 = metas[0]
                            hop = (int(now) - int(m0["tspub"])) & 0xFFFFFFFF
                            if hop >= 1 << 31:
                                hop = 0
                            elif iidx < 4:
                                hop_hists[iidx].sample(hop)
                                m.hist_sample("in_hop_ns", hop)
                            tsorig = int(m0["tsorig"])
                            age = ((int(now) - tsorig) & 0xFFFFFFFF
                                   if tsorig else hop)
                            self._cur_tsorig = tsorig or int(m0["tspub"])
                            t0 = time.monotonic_ns()
                            if len(mine):
                                cb_view(ctx, iidx, mine, i.dcache)
                            t1 = time.monotonic_ns()
                            busy_acc += t1 - t0
                            if self.tracer is not None:
                                self.tracer.record(
                                    trace_mod.KIND_BURST, t0,
                                    t1 - t0, iidx=iidx,
                                    hop_ns=hop,
                                    age_ns=age if age < 1 << 31 else 0,
                                    cnt=cons, seq=int(m0["seq"]))
                            self._cur_tsorig = 0
                            i.seq += cons
                            held = (cb_held(iidx)
                                    if cb_held is not None else 0)
                            i.fseq.update(i.seq - held)
                            i.fseq.diag_add(_D_PUB_CNT, len(mine))
                            if filt:
                                i.fseq.diag_add(_D_FILT_CNT, filt)
                                m.add("in_filt_cnt", filt)
                            m.add("in_frag_cnt", len(mine))
                            did += cons
                        elif cb_held is not None:
                            # release-driven credit return: harvests in
                            # after_credit may have retired pinned frags
                            # since the last poll even with nothing new
                            # inbound — one atomic store per poll
                            i.fseq.update(i.seq - cb_held(iidx))
                        if rc == 1:
                            cur = i.mcache.seq_query()
                            i.fseq.diag_add(_D_OVRNP_CNT, cur - i.seq)
                            m.add("in_ovrn_cnt", cur - i.seq)
                            i.seq = cur
                        if ctx.halted:
                            break
                        continue
                    if cb_burst is not None and i.dcache is not None:
                        rc, cons, kept, filt = ring.rx_burst(
                            i.mcache, i.dcache, i.seq,
                            min(BURST_RX, room),
                            rx_buf[iidx], rx_metas[iidx], rx_offs[iidx],
                            rr_cnt, rr_idx)
                        if kept and self.fault is not None:
                            # a kill threshold inside the burst trims it:
                            # the prefix is processed + span-recorded, the
                            # tail is acked-but-lost (outage semantics)
                            kept = self.fault.burst(kept, rx_buf[iidx],
                                                    rx_offs[iidx])
                        if kept:
                            m0 = rx_metas[iidx][0]
                            # one hop sample per burst keeps the
                            # monitor's in*_hop gauges alive on this
                            # path (per-frag sampling would be pure
                            # overhead at burst rates)
                            hop = (int(now) - int(m0["tspub"])) & 0xFFFFFFFF
                            if hop >= 1 << 31:
                                hop = 0  # stale/wrapped stamp
                            elif iidx < 4:
                                hop_hists[iidx].sample(hop)
                                m.hist_sample("in_hop_ns", hop)
                            tsorig = int(m0["tsorig"])
                            age = ((int(now) - tsorig) & 0xFFFFFFFF
                                   if tsorig else hop)
                            self._cur_tsorig = tsorig or int(m0["tspub"])
                            t0 = time.monotonic_ns()
                            cb_burst(ctx, iidx, rx_metas[iidx][:kept],
                                     rx_buf[iidx], rx_offs[iidx], kept)
                            t1 = time.monotonic_ns()
                            busy_acc += t1 - t0
                            if self.tracer is not None:
                                self.tracer.record(
                                    trace_mod.KIND_BURST, t0,
                                    t1 - t0, iidx=iidx,
                                    hop_ns=hop,
                                    age_ns=age if age < 1 << 31 else 0,
                                    cnt=kept, seq=int(m0["seq"]))
                            self._cur_tsorig = 0
                        if cons:
                            i.seq += cons
                            i.fseq.update(i.seq)
                            i.fseq.diag_add(_D_PUB_CNT, kept)
                            if filt:
                                i.fseq.diag_add(_D_FILT_CNT, filt)
                                m.add("in_filt_cnt", filt)
                            sz_total = int(rx_offs[iidx][kept])
                            i.fseq.diag_add(_D_PUB_SZ, sz_total)
                            m.add("in_frag_cnt", kept)
                            m.add("in_sz", sz_total)
                            did += cons
                        if rc == 1:
                            cur = i.mcache.seq_query()
                            i.fseq.diag_add(_D_OVRNP_CNT, cur - i.seq)
                            m.add("in_ovrn_cnt", cur - i.seq)
                            i.seq = cur
                        if ctx.halted:
                            break
                        continue
                    seq_before = i.seq
                    metas, rc = i.mcache.consume_burst(
                        i.seq, min(self.BURST, room))
                    if rc == 1 and len(metas) == 0:
                        # producer lapped us: resync and count the loss
                        cur = i.mcache.seq_query()
                        i.fseq.diag_add(_D_OVRNP_CNT, cur - i.seq)
                        m.add("in_ovrn_cnt", cur - i.seq)
                        i.seq = cur
                        continue
                    for meta in metas:
                        seq = int(meta["seq"])
                        if (cb_before is not None
                                and cb_before(ctx, iidx, seq,
                                              int(meta["sig"]))):
                            i.fseq.diag_add(_D_FILT_CNT)
                            m.add("in_filt_cnt")
                            i.seq = seq + 1
                            continue
                        payload = b""
                        sz = int(meta["sz"])
                        if i.dcache is not None and sz:
                            payload = i.dcache.read(int(meta["chunk"]), sz)
                            # seqlock re-validation: if the producer moved
                            # past this line while we copied, the payload may
                            # be torn (fd_mux.c overrun-during-frag check)
                            rc2, _ = i.mcache.query(seq)
                            if rc2 != 0:
                                i.fseq.diag_add(_D_OVRNP_CNT)
                                m.add("in_ovrn_cnt")
                                i.seq = i.mcache.seq_query()
                                break
                        if self.fault is not None:
                            payload, _drop = self.fault.frag(payload)
                            if _drop:
                                i.fseq.diag_add(_D_FILT_CNT)
                                m.add("in_filt_cnt")
                                i.seq = seq + 1
                                continue
                        hop = (int(now) - int(meta["tspub"])) & 0xFFFFFFFF
                        if hop >= 1 << 31:  # guard against stale stamps
                            hop = 0
                        elif iidx < 4:
                            hop_hists[iidx].sample(hop)
                            m.hist_sample("in_hop_ns", hop)
                        if cb_frag is not None:
                            tsorig = int(meta["tsorig"])
                            age = ((int(now) - tsorig) & 0xFFFFFFFF
                                   if tsorig else hop)
                            self._cur_tsorig = tsorig or int(meta["tspub"])
                            t0 = time.monotonic_ns()
                            cb_frag(ctx, iidx, meta, payload)
                            t1 = time.monotonic_ns()
                            busy_acc += t1 - t0
                            if self.tracer is not None:
                                self.tracer.record(
                                    trace_mod.KIND_FRAG, t0,
                                    t1 - t0, iidx=iidx,
                                    hop_ns=hop,
                                    age_ns=age if age < 1 << 31 else 0,
                                    seq=seq)
                            self._cur_tsorig = 0
                        i.fseq.diag_add(_D_PUB_CNT)
                        i.fseq.diag_add(_D_PUB_SZ, sz)
                        m.add("in_frag_cnt")
                        m.add("in_sz", sz)
                        i.seq = seq + 1
                        did += 1
                        if ctx.halted:
                            break
                    # eager credit return: publish our position as soon as we
                    # advance, not just in housekeeping — otherwise producer
                    # throughput caps at depth frags per HOUSE_NS (the
                    # reference's mux returns credits at a depth-scaled lazy
                    # rate for the same reason, fd_mux.c:233-310)
                    if i.seq != seq_before:
                        i.fseq.update(i.seq)
                    if ctx.halted:
                        break

                if cb_credit is not None:
                    t0 = time.monotonic_ns()
                    cb_credit(ctx)
                    busy_acc += time.monotonic_ns() - t0
                if not did:
                    # nothing inbound: brief yield keeps one spinning Python
                    # loop from starving siblings on shared cores (the
                    # reference spins with FD_SPIN_PAUSE on dedicated cores)
                    t0 = time.monotonic_ns()
                    time.sleep(20e-6)
                    idle_acc += time.monotonic_ns() - t0
        finally:
            if hasattr(vt, "fini"):
                vt.fini(ctx)
            for i in self.ins:
                i.fseq.update(i.seq)
            self.cnc.signal(Cnc.SIGNAL_BOOT)  # BOOT == halted-ack at exit
