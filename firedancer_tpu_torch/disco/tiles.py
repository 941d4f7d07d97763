"""The host tiles of the verify-bench topology and the port's tile
registry (ref: the fd_topo_run_tile_t vtables in src/app/fdctl/run/tiles/
and the TILES[] registry in src/app/fdctl/main.c:33-48); the port's own
copy of firedancer_tpu/disco/tiles.py's SourceTile, DedupTile and
SinkTile.

A tile is a class with any subset of the mux callbacks (disco/mux.py).
The registry maps kind -> class; a tile process looks its class up by
TileSpec.kind.  The verify-bench data plane is

    source -> verify -> dedup -> sink

with the port's VerifyTile (disco/verify_tile.py) dispatching to the card;
the leader-bench topology adds the leader_pack and poh_dev tiles
(disco/leader_tiles.py), and the follower's turbine shred lane the
shred, shred_recover and store tiles (disco/shred_tiles.py); the metric
tile serves /metrics and /healthz over every tile's block.  The net,
quic, bank and later tiles are not ported yet; neither are the source's executable transfers, stream
adoption and blockhash feedback, nor the dedup tile's sharded tcache and
restart preload: those options raise NotImplementedError.
"""

import time

import numpy as np

from ..ballet import txn as txn_lib
from ..tango.tcache import NativeTCache
from .leader_tiles import LeaderPackTile, PohDevTile
from .pipeline import LAT_PRIO_BIT
from .shred_tiles import ShredRecoverTile, ShredTile, StoreTile
from .verify_tile import VerifyTile


def source_txn_stream(seed: int, keys: int = 4, count: int = 0,
                      start: int = 0):
    """Regenerate the (tag, wire) stream a standalone non-burst SourceTile
    with cfg {seed, keys, count} publishes, without a topology: the same
    rng recipe (key pool, blockhash, program id all drawn from
    default_rng(seed) in init order), the same per-txn build.  The tag is
    the wire's sig[0:8] LE, the sig the verify tile stamps on the frag
    and the sink capture records."""
    from ..ops import ed25519 as ed
    rng = np.random.default_rng(int(seed))
    seeds = [rng.bytes(32) for _ in range(int(keys))]
    blockhash = rng.bytes(32)
    pool = [(s, ed.keypair_from_seed(s)[0]) for s in seeds]
    program = rng.bytes(32)
    i = int(start)
    while count == 0 or i < int(count):
        seed_i, pub = pool[i % len(pool)]
        msg = txn_lib.build_unsigned(
            [pub], blockhash, [(1, bytes([0]), i.to_bytes(8, "little"))],
            extra_accounts=[program])
        sig = ed.sign(seed_i, msg)
        yield (int.from_bytes(sig[:8], "little"),
               txn_lib.assemble([sig], msg))
        i += 1


class SourceTile:
    """Synthetic signed-txn generator (the fddev benchg analogue,
    src/app/fddev/tiles/fd_benchg.c): publishes `count` distinct valid
    txns, then idles (count=0: unbounded).  It signs with fresh keys
    against a random blockhash, enough for the verify path.

    cfg: seed, keys, count, rate_ns (min ns between txns), burst_n (a
    numpy burst firehose of stamped copies of one signed template),
    packed_rows / packed_ml / burst_splits (frags written in the device
    blob row layout straight into the out dcache), lat_every (every Nth
    txn tagged latency-class).  Stamped txns, burst and packed, all fail
    verify: the tag written over each signature invalidates it."""

    def init(self, ctx):
        from ..ops import ed25519 as ed
        cfg = ctx.cfg
        if cfg.get("executable"):
            raise NotImplementedError(
                "SourceTile(executable=True): executable transfers need "
                "flamenco's system program, not ported")
        if cfg.get("adopt_streams"):
            raise NotImplementedError(
                "SourceTile adopt_streams: the fleet layer "
                "(disco/fleet.py) is not ported")
        if any(il.link.endswith("blockhash") for il in ctx.tile.in_links):
            raise NotImplementedError(
                "SourceTile blockhash feedback links: the bank tile is not "
                "ported")
        self.count = cfg.get("count", 0)
        rng = np.random.default_rng(cfg.get("seed", 42))
        seeds = [rng.bytes(32) for _ in range(cfg.get("keys", 4))]
        self.blockhash = rng.bytes(32)
        self.pool = [(seed, ed.keypair_from_seed(seed)[0]) for seed in seeds]
        self.program = rng.bytes(32)
        self.sent = 0
        self._ed = ed
        self._rng = rng
        # optional pacing (benchg's tps knob): min ns between txns
        self.rate_ns = cfg.get("rate_ns", 0)
        self._last_gen_ns = 0
        # burst firehose: burst_n > 0 stamps out `burst_n` copies of one
        # signed template a loop in numpy (unique signature tag, unique
        # instr data), one burst publish.  Host signing would cap a
        # source near 1 K txns/s; the verify device cost of a stamped
        # copy equals a real one's (fixed shapes, data-independent), so
        # this is the firehose for throughput work.
        self._burst_n = int(cfg.get("burst_n", 0))
        # latency-class tagging: every `lat_every`-th txn carries
        # LAT_PRIO_BIT on its frag meta sig (the META only; the payload
        # sig bytes, the dedup tag, stay clean).  Packed-wire mode stays
        # bulk-only: one frag is one whole device blob.
        self._lat_every = max(0, int(cfg.get("lat_every", 0)))
        if self._burst_n:
            tpl = np.frombuffer(self._make_txn(0), np.uint8).copy()
            self._tpl = tpl
            self._tpl_len = len(tpl)
        # packed-wire firehose: frags written ALREADY in device-blob row
        # layout (msg | sig64 | pub32 | len-le32, the row stride
        # chunk-aligned by packed_row_ml) straight into the dcache through
        # ctx.out_reserve; one frag = one packed burst of `packed_rows`
        # rows, meta.sz the row count
        self._packed_rows = int(cfg.get("packed_rows", 0))
        if self._packed_rows:
            from ..tango.ring import PACKED_ROW_EXTRA, packed_row_ml
            ml = int(cfg.get("packed_ml") or packed_row_ml(256))
            stride = ml + PACKED_ROW_EXTRA
            wire = self._make_txn(0)
            msg, sig = wire[65:], wire[1:65]
            if len(msg) > ml:
                raise ValueError(
                    f"template msg {len(msg)}B exceeds packed ml {ml}")
            row = np.zeros(stride, np.uint8)
            row[:len(msg)] = np.frombuffer(msg, np.uint8)
            row[ml:ml + 64] = np.frombuffer(sig, np.uint8)
            row[ml + 64:ml + 96] = np.frombuffer(self.pool[0][1], np.uint8)
            row[ml + 96:ml + 100] = np.frombuffer(
                len(msg).to_bytes(4, "little"), np.uint8)
            self._row_tpl = row
            self._packed_ml = ml
            self._row_stride = stride
            # round-robin burst splitter: `burst_splits` frags a loop, so
            # consecutive seqs deal rows across round-robin verify tiles
            self._splits = max(1, int(cfg.get("burst_splits", 1)))

    def apply_knobs(self, ctx, vals):
        """Knob pod application (disco/autotune.py KNOBS['source'])."""
        if "burst_splits" in vals and self._packed_rows:
            self._splits = max(1, int(vals["burst_splits"]))

    def _make_txn(self, i: int) -> bytes:
        seed, pub = self.pool[i % len(self.pool)]
        data = i.to_bytes(8, "little")  # distinct payload per i
        msg = txn_lib.build_unsigned(
            [pub], self.blockhash,
            [(1, bytes([0]), data)], extra_accounts=[self.program])
        sig = self._ed.sign(seed, msg)
        return txn_lib.assemble([sig], msg)

    def after_credit(self, ctx):
        if self.count and self.sent >= self.count:
            return
        if self.rate_ns:
            now = time.monotonic_ns()
            if now - self._last_gen_ns < self.rate_ns:
                return
            self._last_gen_ns = now
        if self._packed_rows:
            self._gen_packed(ctx)
            return
        if self._burst_n:
            n = self._burst_n
            if self.count:
                n = min(n, self.count - self.sent)
            L = self._tpl_len
            arr = np.tile(self._tpl, (n, 1))
            # unique tag (first 8 sig bytes) + unique instr data (last 8
            # payload bytes) per txn; the tag doubles as the app sig
            tags = self._rng.integers(1, 1 << 63, size=n, dtype=np.uint64)
            arr[:, 1:9] = tags.view(np.uint8).reshape(n, 8)
            arr[:, L - 8:] = np.arange(
                self.sent, self.sent + n, dtype=np.uint64
            ).view(np.uint8).reshape(n, 8)
            starts = np.arange(n, dtype=np.int64) * L
            lens = np.full(n, L, dtype=np.int32)
            mtags = tags
            if self._lat_every:
                mtags = tags.copy()
                mtags[::self._lat_every] |= np.uint64(LAT_PRIO_BIT)
            ctx.publish_burst(arr, starts, lens, mtags)
            self.sent += n
            ctx.metrics.add("txn_gen_cnt", n)
            return
        payload = self._make_txn(self.sent)
        # mask bit 63: raw signature bytes are uniform, and a random high
        # bit must never read as a latency-class tag downstream
        sig64 = (int.from_bytes(payload[1:9], "little")
                 & (LAT_PRIO_BIT - 1))
        if self._lat_every and self.sent % self._lat_every == 0:
            sig64 |= LAT_PRIO_BIT
        ctx.publish(payload, sig=sig64)
        self.sent += 1
        ctx.metrics.add("txn_gen_cnt")

    def _gen_packed(self, ctx):
        """Stamp packed-blob frags in place in the out dcache: reserve the
        region, tile the template row into the shm view, overwrite tag and
        instr-data lanes, zero-pad a short tail, commit.  No staging
        buffer: the dcache bytes ARE the device blob."""
        rows, ml, stride = self._packed_rows, self._packed_ml, \
            self._row_stride
        L = stride
        for _ in range(self._splits):
            n = rows
            if self.count:
                n = min(n, self.count - self.sent)
            if n <= 0:
                return
            chunk, blk = ctx.out_reserve(rows * stride)
            if blk is None:        # halted mid-backpressure
                return
            blk = blk.reshape(rows, stride)
            np.copyto(blk[:n], self._row_tpl)
            tags = self._rng.integers(1, 1 << 63, size=n, dtype=np.uint64)
            blk[:n, ml:ml + 8] = tags.view(np.uint8).reshape(n, 8)
            blk[:n, L - 8:] = np.arange(
                self.sent, self.sent + n, dtype=np.uint64
            ).view(np.uint8).reshape(n, 8)
            if n < rows:
                blk[n:] = 0        # zero sig -> tag 0 -> dead lane
            ctx.out_commit(chunk, rows * stride, sig=int(tags[0]), sz=n)
            self.sent += n
            ctx.metrics.add("txn_gen_cnt", n)


class DedupTile:
    """Cross-verify-tile dedup on the signature tag
    (ref: src/app/fdctl/run/tiles/fd_dedup.c, tango tcache), over the
    port's NativeTCache.

    cfg: tcache_depth, packed_egress (the upstream verify tiles ship one
    packed arena frag per harvest).  shard_bits > 0 (the fleet's sharded
    tcache) and preload_tags_path (the fleet's restart preload) are not
    ported and raise NotImplementedError."""

    def init(self, ctx):
        if int(ctx.cfg.get("shard_bits", 0)):
            raise NotImplementedError(
                "DedupTile shard_bits > 0: the sharded tcache "
                "(tango/tcache.py ShardedTCache) is not ported")
        if ctx.cfg.get("preload_tags_path"):
            raise NotImplementedError(
                "DedupTile preload_tags_path: the fleet's restart preload "
                "is not ported")
        self.tcache = NativeTCache(ctx.cfg.get("tcache_depth", 1 << 20))
        # packed verdict egress consumer: on_burst_view unpacks the one
        # arena frag a harvest ships.  Hidden unless configured, so
        # per-txn links keep the rx-scratch burst path; when configured,
        # on_burst hides instead, so the mux skips its BURST_RX * mtu
        # scratch (a packed link's mtu is a whole arena).
        if ctx.cfg.get("packed_egress", 0):
            self.on_burst = None
        else:
            self.on_burst_view = None

    def on_frag(self, ctx, iidx, meta, payload):
        tag = int(meta["sig"])
        if self.tcache.insert(tag):
            ctx.metrics.add("dup_drop_cnt")
            return
        ctx.metrics.add("uniq_cnt")
        ctx.publish(payload, sig=tag)

    def on_burst(self, ctx, iidx, metas, buf, offs, kept):
        """Burst path: one pass over the tcache decides all verdicts,
        survivors forward in one burst publish."""
        tags = metas["sig"].astype(np.uint64)
        dup = self.tcache.insert_batch_dedup(tags)
        ndup = int(dup.sum())
        if ndup:
            ctx.metrics.add("dup_drop_cnt", ndup)
        keep = np.nonzero(~dup)[0]
        if not len(keep):
            return
        ctx.metrics.add("uniq_cnt", len(keep))
        starts = offs[:kept][keep]
        lens = (offs[1 : kept + 1] - offs[:kept])[keep].astype(np.int32)
        ctx.publish_burst(buf, starts, lens, tags[keep])

    def on_burst_view(self, ctx, iidx, metas, dcache):
        """Packed verdict egress rx: each frag is meta.sz wires behind a
        u32 offsets table (VerifyTile._publish_packed_verdicts).  The
        frag is copied out of the shm view ONCE, then the mcache seq is
        re-checked: a producer lap mid-copy drops the frag whole
        (torn_drop_cnt) before anything derived from it is published.
        Tags re-derive from each wire's sig bytes (wire[1:9] LE)."""
        mc = ctx.in_mcache(iidx)
        for meta in metas:
            k = int(meta["sz"])
            if k <= 0:
                continue
            chunk, seq = int(meta["chunk"]), int(meta["seq"])
            hdr = 4 * (k + 1)
            # re-check the seq BEFORE trusting the offsets table to size
            # the payload copy, and again after the copy
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
            starts = offs[:k]
            lens = (offs[1:] - offs[:k]).astype(np.int32)
            idx = starts[:, None] + np.arange(1, 9)
            tags = np.ascontiguousarray(frag[idx]).view(np.uint64).ravel()
            dup = self.tcache.insert_batch_dedup(tags)
            ndup = int(dup.sum())
            if ndup:
                ctx.metrics.add("dup_drop_cnt", ndup)
            keep = np.nonzero(~dup)[0]
            if not len(keep):
                continue
            ctx.metrics.add("uniq_cnt", len(keep))
            ctx.publish_burst(frag, starts[keep], lens[keep], tags[keep])


class SinkTile:
    """Counts and drops (the fd_blackhole tile).

    cfg capture_path (optional): append every frag to that file as
    `u64 sig | u32 len | payload`, the offline re-verification surface.
    Capture forces the per-frag path (burst delivery is disabled), so the
    file order is exactly publish order."""

    def init(self, ctx):
        self._cap = None
        path = ctx.cfg.get("capture_path") or ""
        if path:
            self._cap = open(path, "ab", buffering=0)
            self.on_burst = None       # per-frag so sigs ride along

    def on_frag(self, ctx, iidx, meta, payload):
        ctx.metrics.add("frag_cnt")
        if self._cap is not None:
            b = bytes(payload)
            self._cap.write(int(meta["sig"]).to_bytes(8, "little")
                            + len(b).to_bytes(4, "little") + b)

    def on_burst(self, ctx, iidx, metas, buf, offs, kept):
        ctx.metrics.add("frag_cnt", kept)

    def fini(self, ctx):
        if self._cap is not None:
            self._cap.close()


def read_capture(path: str) -> list[tuple[int, bytes]]:
    """The (sig, payload) records a SinkTile capture file holds, in
    publish order."""
    with open(path, "rb") as f:
        raw = f.read()
    out, at = [], 0
    while at < len(raw):
        sig = int.from_bytes(raw[at:at + 8], "little")
        n = int.from_bytes(raw[at + 8:at + 12], "little")
        out.append((sig, raw[at + 12:at + 12 + n]))
        at += 12 + n
    return out


class MetricTile:
    """Prometheus exporter over HTTP (ref: run/tiles/fd_metric.c:135-263),
    snapshotting every tile's shared-memory metrics block: the same
    /metrics and /healthz handler the supervisor's
    TopoRun(metrics_port=...) endpoint serves.  cfg: port."""

    def init(self, ctx):
        from .run import MetricsHttpServer
        self.server = MetricsHttpServer(
            ctx.topo, port=ctx.cfg.get("port", 7999))

    def fini(self, ctx):
        self.server.close()


TILES: dict[str, type] = {
    "source": SourceTile,
    "verify": VerifyTile,
    "dedup": DedupTile,
    "sink": SinkTile,
    "leader_pack": LeaderPackTile,
    "poh_dev": PohDevTile,
    "shred": ShredTile,
    "shred_recover": ShredRecoverTile,
    "store": StoreTile,
    "metric": MetricTile,
}
