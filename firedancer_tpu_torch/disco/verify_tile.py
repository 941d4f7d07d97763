"""The verify tile on the card (src/app/fdctl/run/tiles/fd_verify.c).

Counterpart of firedancer_tpu/disco/tiles.py VerifyTile, as the port's
own tile kind (TILES).  A tile is a class with the mux callbacks
(disco/mux.py); its ctx gives cfg, publish, publish_burst,
out_reserve/out_commit, in_mcache, metrics, heartbeat and trace.

One SigVerifier sized to the largest batch and message length serves
every bucket and latency-lane shape: its dispatch_blob takes any blob no
larger than that.  Boot builds the CUDA kernels and dispatches one zero
blob through every shape before the pipeline exists, so nothing is built
on the hot path (the JAX tile loads AOT executables or compiles
instead).  The tile does not wrap its verifier in a host fallback: a
device, build or launch failure surfaces as an exception.
"""

import os
import time

import numpy as np
import torch

from ..kernels import build
from ..models.verifier import SigVerifier, VerifierConfig
from ..ops.ed25519 import PACKED_EXTRA
from . import trace as trace_mod
from .pipeline import (DEFAULT_LAT_SHAPES, LAT_PRIO_BIT, PackedVerdicts,
                       VerifyPipeline)


class VerifyTile:
    """Round-robin data parallel: instance r of n keeps frags with
    seq % n == r (fd_verify.c:36-47).  Parse -> tcache pre-dedup ->
    fixed-shape device batch verify -> publish passing txns downstream
    with sig = low 64 bits of the first signature (the dedup tile's key).

    cfg: buckets ([[batch, msg_maxlen], ...], or batch and msg_maxlen),
    round_robin_cnt/idx, flush_age_ns, tcache_depth, max_inflight,
    n_buffers, burst, packed_wire, egress_packed, native_hostpath (the
    packed rows' one-pass C submit and finish, default 1; 0 runs them in
    NumPy), latency {enabled,
    shapes, deadline_us, max_inflight, spill_age_factor}, mode, and device
    (None is the GPU; "cpu" runs the kernels' plain versions).  Wire
    bursts go through the native burst parser either way.  dp_shards > 1,
    mode antipa, aot_dir, aot_require and jax_trace_dir are not ported and
    raise NotImplementedError.

    packed_wire: each in-link frag is meta.sz rows already in the device
    blob layout in the dcache, at the first bucket's shape.  The rows go
    to the verifier as a view of the shared memory, with no copy on the
    host; the frag's flow credit stays held (credits_held) until its
    verdict is harvested, and its mcache seq is re-checked after the
    dispatch, so a frag the producer overwrote mid-read is dropped whole
    (torn_drop_cnt).  dispatch_blob's upload reads the rows from pageable
    memory, a copy that has finished by the time dispatch_blob returns,
    so that re-check comes after the read."""

    def init(self, ctx):
        cfg = ctx.cfg
        self.rr_cnt = cfg.get("round_robin_cnt", 1)
        self.rr_idx = cfg.get("round_robin_idx", 0)
        batch = cfg.get("batch", 64)
        maxlen = cfg.get("msg_maxlen", 256)
        buckets = cfg.get("buckets") or [[batch, maxlen]]
        self.flush_age_ns = cfg.get("flush_age_ns", 2_000_000)
        if int(cfg.get("dp_shards", 1)) > 1:
            raise NotImplementedError(
                "dp_shards > 1: multi-GPU verify is not ported yet "
                "(firedancer_tpu_torch)")
        for key in ("aot_dir", "aot_require"):
            if cfg.get(key):
                raise NotImplementedError(
                    f"{key}: the port has no AOT store; its tile boots by "
                    "building the kernels and warming every shape")
        self.verify_mode = str(
            os.environ.get("FDTPU_VERIFY_MODE") or cfg.get("mode", "strict"))
        if self.verify_mode == "antipa":
            raise NotImplementedError(
                "[verify] mode = antipa is not ported yet "
                "(firedancer_tpu_torch)")
        if self.verify_mode != "strict":
            raise ValueError(f"[verify] mode must be strict|antipa, "
                             f"got {self.verify_mode!r}")
        if cfg.get("jax_trace_dir"):
            raise NotImplementedError(
                "jax_trace_dir: the port runs no XLA, so it has no XLA "
                "trace to write")
        latc = cfg.get("latency") or {}
        self._lat_enabled = bool(int(latc.get("enabled", 0)))
        lat_shapes = (tuple(int(s) for s in
                            (latc.get("shapes") or DEFAULT_LAT_SHAPES))
                      if self._lat_enabled else ())
        lat_ml = min(int(m) for _, m in buckets)
        lat_warm = [(s, lat_ml) for s in sorted(lat_shapes)]
        warm_shapes = [(int(b), int(ml)) for b, ml in buckets] + lat_warm
        fn = SigVerifier(VerifierConfig(max(b for b, _ in warm_shapes),
                                        max(ml for _, ml in warm_shapes)),
                         device=cfg.get("device"))
        self._init_pipeline(ctx, cfg, fn, buckets, warm_shapes, latc,
                            lat_warm)

    def _init_pipeline(self, ctx, cfg, fn, buckets, warm_shapes, latc,
                       lat_warm):
        # warm every ladder shape before the pipeline exists: the kernels
        # build once, and each shape's first dispatch runs here, not on
        # the hot path; a failure here is a boot failure
        hb = getattr(ctx, "heartbeat", None)
        if fn.device.type == "cuda":
            build.build_all()
        verdicts = []
        for b, ml in warm_shapes:
            if hb is not None:
                hb()
            verdicts.append(fn.dispatch_blob(
                np.zeros((b, ml + PACKED_EXTRA), np.uint8)))
        if fn.device.type == "cuda":
            torch.cuda.synchronize(fn.device)
        for (b, ml), v in zip(warm_shapes, verdicts):
            bits = np.asarray(v)
            if bits.shape != (b,) or bits.any():
                raise RuntimeError(f"warmup of ({b}, {ml}): zero rows must "
                                   f"all reject, got {bits.sum()} of "
                                   f"{bits.shape}")
        if hb is not None:
            hb()
        self.pipe = VerifyPipeline(
            fn, buckets=[tuple(b) for b in buckets],
            tcache_depth=cfg.get("tcache_depth", 1 << 16),
            # async data plane: filled buckets dispatch without blocking
            # the mux loop; after_credit harvests finished verdicts
            max_inflight=cfg.get("max_inflight", 8),
            n_buffers=cfg.get("n_buffers", 3),
            tracer=getattr(ctx, "trace", None),
            heartbeat_cb=hb,
            lat_shapes=[b for b, _ in lat_warm] or None,
            deadline_us=int(latc.get("deadline_us", 2000)),
            lat_max_inflight=int(latc.get("max_inflight", 2)),
            lat_spill_age_factor=float(latc.get("spill_age_factor", 4.0)),
            native_hostpath=bool(cfg.get("native_hostpath", 1)),
            egress_packed=bool(cfg.get("egress_packed", 0)))
        self.pipe.mark_warm(warm_shapes)
        self._last_submit_ns = 0
        self._synced_batches = -1
        self._burst = cfg.get("burst", True)
        self._held = {}            # iidx -> frags pinned awaiting verdict
        if cfg.get("packed_wire"):
            # zero-copy rx: the mux's on_burst_view path hands this tile
            # metas and the raw dcache; on_burst hides, so the mux does
            # not allocate its rx scratch (BURST_RX times a packed link's
            # mtu, hundreds of KB a frag)
            self.on_burst = None
            self.burst_rr = (self.rr_cnt, self.rr_idx)
            b0, ml0 = buckets[0]
            self._pw_batch = int(b0)
            self._pw_stride = int(ml0) + PACKED_EXTRA
        elif self._burst:
            self.on_burst_view = None
            self.burst_rr = (self.rr_cnt, self.rr_idx)
        else:
            # hide both hooks from the mux
            self.on_burst = None
            self.on_burst_view = None

    def before_frag(self, ctx, iidx, seq, sig) -> bool:
        return (seq % self.rr_cnt) != self.rr_idx

    def apply_knobs(self, ctx, vals):
        """Knob pod application (disco/autotune.py KNOBS['verify']).
        Every target is re-read on its hot path each call, so a new value
        is live from the next batch on, with no respawn."""
        if "flush_age_ns" in vals:
            self.flush_age_ns = max(1, int(vals["flush_age_ns"]))
        pipe = self.pipe
        if "max_inflight" in vals:
            pipe.max_inflight = max(1, int(vals["max_inflight"]))
        if "lat_max_inflight" in vals:
            pipe.lat_max_inflight = max(1, int(vals["lat_max_inflight"]))
        if "deadline_us" in vals:
            new = max(1, int(vals["deadline_us"]))
            old = max(1, int(pipe.deadline_us))
            # the spill age was set as factor * deadline at init; keep
            # the factor across deadline moves
            factor = pipe.lat_spill_age_ns / (old * 1000)
            pipe.deadline_us = new
            pipe.lat_spill_age_ns = int(factor * new * 1000)

    def _forward(self, ctx, passed):
        if self._burst:
            return self._forward_burst(ctx, passed)
        if not passed:
            return
        t0 = time.monotonic_ns()
        for payload, _ in passed:
            # first sig's low 64 bits: signature_off is 1 for every
            # wire-valid txn (1-byte sig count prefix)
            ctx.publish(payload, sig=int.from_bytes(payload[1:9], "little"))
        self._span_publish(ctx, t0, len(passed))

    @staticmethod
    def _span_publish(ctx, t0, cnt):
        if ctx.trace is not None:
            ctx.trace.record(trace_mod.KIND_PUBLISH, t0,
                             time.monotonic_ns() - t0, cnt=cnt)

    def _forward_burst(self, ctx, passed):
        """One burst publish for all passing txns; a PackedVerdicts entry
        ships as ONE arena frag instead of k per-txn frags."""
        if not passed:
            return
        for pv in passed:
            if isinstance(pv, PackedVerdicts):
                self._publish_packed_verdicts(ctx, pv)
        bufs = [p for p, _ in (q for q in passed
                               if not isinstance(q, PackedVerdicts))]
        if not bufs:
            return
        t0 = time.monotonic_ns()
        joined = b"".join(bufs)
        lens = np.array([len(b) for b in bufs], np.int32)
        starts = np.zeros(len(bufs), np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        sigs = np.array([int.from_bytes(b[1:9], "little") for b in bufs],
                        np.uint64)
        ctx.publish_burst(joined, starts, lens, sigs)
        self._span_publish(ctx, t0, len(bufs))

    def _publish_packed_verdicts(self, ctx, pv):
        """Stamp one harvest's passing wires downstream as one packed
        frag: a u32 offsets table (k+1 entries), then the wires back to
        back, written straight into the out dcache (out_reserve).
        meta.sz = survivor count k; meta.sig = first survivor's tag, bit
        63 masked so arena frags never alias latency-class admission."""
        t0 = time.monotonic_ns()
        hdr = 4 * (pv.k + 1)
        nb = hdr + int(pv.offs[pv.k])
        chunk, blk = ctx.out_reserve(nb)
        if blk is None:
            return  # halted while backpressured
        blk[:hdr].view(np.uint32)[:] = pv.offs
        blk[hdr:nb] = pv.arena
        sig0 = int(pv.tags[0]) & (LAT_PRIO_BIT - 1)
        ctx.out_commit(chunk, nb, sig=sig0, sz=pv.k)
        self._span_publish(ctx, t0, pv.k)

    def on_frag(self, ctx, iidx, meta, payload):
        # priority admission: the producer's latency-class bit rides the
        # frag meta sig
        lat = bool(self._lat_enabled and (int(meta["sig"]) & LAT_PRIO_BIT))
        passed = self.pipe.submit(payload, lat=lat)
        self._last_submit_ns = time.monotonic_ns()
        self._forward(ctx, passed)
        self._sync_metrics(ctx)

    def on_burst(self, ctx, iidx, metas, buf, offs, kept):
        if self._lat_enabled and kept:
            prio = (metas["sig"][:kept].astype(np.uint64)
                    & np.uint64(LAT_PRIO_BIT)) != 0
            if prio.any():
                passed = self._submit_burst_split(buf, offs, kept, prio)
                self._last_submit_ns = time.monotonic_ns()
                self._forward_burst(ctx, passed)
                self._sync_metrics(ctx)
                return
        passed = self.pipe.submit_burst(packed=(buf, offs[:kept + 1]))
        self._last_submit_ns = time.monotonic_ns()
        self._forward_burst(ctx, passed)
        self._sync_metrics(ctx)

    def _submit_burst_split(self, buf, offs, kept, prio):
        """Mixed-class burst: latency-class txns (LAT_PRIO_BIT in the
        frag meta sig) go into the low-latency lane; the bulk runs between
        them go through submit_burst."""
        passed = []
        i = 0
        while i < kept:
            if prio[i]:
                passed += self.pipe.submit(
                    bytes(buf[offs[i]:offs[i + 1]]), lat=True)
                i += 1
            else:
                j = i
                while j < kept and not prio[j]:
                    j += 1
                passed += self.pipe.submit_burst(
                    packed=(buf, offs[i:j + 1]))
                i = j
        return passed

    def credits_held(self, iidx: int) -> int:
        """Frags consumed but still pinned in the dcache (the pipeline
        rebuilds passing wires from the rows at harvest); the mux
        subtracts this from the fseq, so the producer cannot overwrite
        them before their verdict."""
        return self._held.get(iidx, 0)

    def on_burst_view(self, ctx, iidx, metas, dcache):
        """Packed-wire rx: each meta is one packed frag of meta.sz rows in
        the dcache.  The shm view goes to the pipeline with no payload
        copy; the frag's credit stays held until its verdict is
        harvested (release fires once, torn or not), and the mcache seq
        is re-checked after the dispatch, so a torn read never yields a
        verdict."""
        b, stride = self._pw_batch, self._pw_stride
        mc = ctx.in_mcache(iidx)
        held = self._held
        for meta in metas:
            rows = dcache.rows(int(meta["chunk"]), b, stride)
            # pin BEFORE submit: sync mode retires (and releases) inside
            held[iidx] = held.get(iidx, 0) + 1

            def _release(iidx=iidx):
                held[iidx] -= 1

            lat = bool(self._lat_enabled
                       and (int(meta["sig"]) & LAT_PRIO_BIT))
            passed = self.pipe.submit_packed_rows(
                rows, n=int(meta["sz"]), guard=(mc, int(meta["seq"])),
                release_cb=_release, lat=lat)
            if passed:
                self._forward_burst(ctx, passed)
        self._last_submit_ns = time.monotonic_ns()
        self._sync_metrics(ctx)

    def after_credit(self, ctx):
        # the low-latency lane's deadline close runs every loop
        if self._lat_enabled and self.pipe.lat_due():
            self._forward(ctx, self.pipe.dispatch_due())
        # harvest completed device batches first: never blocks
        passed = self.pipe.harvest()
        if passed:
            self._forward(ctx, passed)
        # sync on every completed batch, an all-fail one included
        if self.pipe.metrics.batches != self._synced_batches:
            self._synced_batches = self.pipe.metrics.batches
            self._sync_metrics(ctx)
        # age-based flush bounds batch latency when inflow stalls; async
        # mode only DISPATCHES the partial bucket (gate on has_open:
        # inflight batches need harvesting, not flushing)
        if (self.pipe.has_open
                and time.monotonic_ns() - self._last_submit_ns
                > self.flush_age_ns):
            if self.pipe.max_inflight:
                self._forward(ctx, self.pipe.dispatch_open())
            else:
                self._forward(ctx, self.pipe.flush())
            self._last_submit_ns = time.monotonic_ns()
            self._sync_metrics(ctx)

    def _sync_metrics(self, ctx):
        s = self.pipe.metrics
        ctx.metrics.set("txn_in_cnt", s.txns_in)
        ctx.metrics.set("parse_fail_cnt", s.parse_fail)
        ctx.metrics.set("dedup_drop_cnt", s.dedup_drop)
        ctx.metrics.set("too_long_cnt", s.too_long_drop)
        ctx.metrics.set("verify_fail_cnt", s.verify_fail)
        ctx.metrics.set("verify_pass_cnt", s.verify_pass)
        ctx.metrics.set("torn_drop_cnt", s.torn_drop)
        ctx.metrics.set("torn_txn_cnt", s.torn_txns)
        ctx.metrics.set("batch_cnt", s.batches)
        ctx.metrics.set("compile_cnt", s.compile_cnt)
        ctx.metrics.set("compile_ns", s.compile_ns)
        ctx.metrics.set("lanes_filled_cnt", s.lanes_filled)
        ctx.metrics.set("lanes_dispatched_cnt", s.lanes_dispatched)
        ctx.metrics.set("bucket_fill_pct", s.last_fill_pct)
        ctx.metrics.set("inflight_depth",
                        len(self.pipe.inflight) + len(self.pipe.lat_inflight))
        ctx.metrics.set("lat_txn_cnt", s.lat_txns)
        ctx.metrics.set("lat_spill_cnt", s.lat_spill)
        ctx.metrics.set("lat_batch_cnt", s.lat_batches)
        ctx.metrics.set("lat_deadline_close_cnt", s.lat_deadline_closes)
        # the whole distributions, not only derived percentiles
        ctx.metrics.hist_store("batch_ns", s.batch_ns)
        ctx.metrics.hist_store("coalesce_ns", s.coalesce_ns)
        ctx.metrics.hist_store("lat_e2e_ns", s.lat_e2e_ns)

    def drain(self, ctx) -> bool:
        """Drain-protocol hook (the mux polls it under SIGNAL_DRAIN): each
        poll dispatches every open bucket and the lat accumulator, and
        harvests finished device batches without blocking, publishing
        their verdicts.  True once nothing is open or in flight: every
        admitted txn has its verdict."""
        pipe = self.pipe
        if pipe.has_open:
            self._forward(ctx, pipe.dispatch_open())
        passed = pipe.harvest()
        if passed:
            self._forward(ctx, passed)
        if pipe.has_pending:
            return False
        self._sync_metrics(ctx)
        return True

    def fini(self, ctx):
        """At halt: dispatch what is open, wait for every verdict and
        publish the passing txns.  A device error propagates, so the tile
        does not exit cleanly over it."""
        self._forward(ctx, self.pipe.flush())
        self._sync_metrics(ctx)


TILES = {"verify": VerifyTile}
