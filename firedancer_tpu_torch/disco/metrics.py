"""Shared-memory metrics regions (ref: src/disco/metrics/fd_metrics.h:16-60,
declarative schema metrics.xml + gen_metrics.py codegen); the port's own
copy of firedancer_tpu/disco/metrics.py's schema and block.

Each tile owns a fixed block of 64-bit slots in the workspace laid out by
static offset from a declarative schema.  Writers are single-threaded per
block (one tile = one writer, the reference's contract) and use aligned
8-byte stores (atomic on every platform we run on); the metric tile, the
supervisor's /metrics endpoint and the monitor snapshot blocks without
coordination (prometheus_render renders them as Prometheus text).

The schema is a plain dict (kind -> slot defs).  A slot def is either a
bare name (COUNTER) or a (name, kind) tuple.  The schema, the footprint
and the histogram layout are the JAX package's exactly, so a block either
package writes reads the same through the other's MetricsBlock, and a
workspace laid out by one is joined at the same offsets by the other.

Histograms: each block also carries up to MAX_HISTS fixed 32-bucket
geomspace histograms (HIST defs below, the shm mirror of utils.hist.Histf).
"""

import numpy as np

COUNTER = "counter"
GAUGE = "gauge"

# Slots common to every tile, written by the mux run loop itself
# (the reference's FD_METRICS_ALL* in generated/fd_metrics_all.h).
MUX_SLOTS = [
    "in_frag_cnt",       # frags consumed over all in links
    "in_sz",             # payload bytes consumed
    "in_filt_cnt",       # frags dropped by before_frag filter
    "in_ovrn_cnt",       # overruns detected (producer lapped us)
    "out_frag_cnt",      # frags published
    "out_sz",            # payload bytes published
    "backp_cnt",         # backpressure events (no downstream credit)
    "housekeep_cnt",     # housekeeping iterations
    "loop_cnt",          # run-loop iterations
    # run-loop regime accounting (ns counters): where this tile's wall
    # time goes — callback work, credit-stall waits, housekeeping, idle
    # sleeps.  The monitor (`fdtpuctl top`) renders the deltas as
    # busy%/backpressure%/housekeep% per tile (ref monitor.c's tile
    # in_backp/in_housekeeping regime columns).
    "busy_ns",           # time inside tile callbacks (frag/burst/credit)
    "backp_ns",          # time stalled in _wait_credit (no downstream credit)
    "house_ns",          # time inside the housekeeping block
    "idle_ns",           # time in the nothing-inbound yield sleep
    "knob_apply_cnt",    # autotune knob-pod generations applied via
                         # apply_knobs (disco/autotune.py)
    # drain protocol (graceful quiesce): every tile kind can be drained,
    # so the slots live in the mux section.  drain_flush_ns is the last
    # drain's DRAIN->dry wall time (the BENCH drain_flush_ms source).
    "drain_cnt",
    ("drain_flush_ns", GAUGE),
    # per-in-link hop latency gauges (ns), consume-time minus the
    # producer's tspub stamp — the monitor's per-hop latency source
    # (ref monitor.c renders the same from tsorig/tspub frag metas).
    # Up to 4 in links; set by the mux during housekeeping over a
    # fresh window each interval (CURRENT latency, hence gauges).
    ("in0_hop_p50_ns", GAUGE), ("in0_hop_p99_ns", GAUGE),
    ("in1_hop_p50_ns", GAUGE), ("in1_hop_p99_ns", GAUGE),
    ("in2_hop_p50_ns", GAUGE), ("in2_hop_p99_ns", GAUGE),
    ("in3_hop_p50_ns", GAUGE), ("in3_hop_p99_ns", GAUGE),
]

# per-out-link attribution gauges (up to 4 out links, mirroring the
# in*_hop pattern): sampled by the mux housekeeping loop over a fresh
# window each interval.  lag = producer seq minus the slowest reliable
# consumer's fseq (how far downstream has fallen behind); occ_hwm = ring
# occupancy high-watermark over the window (depth - cr_avail low-water);
# cr_lwm = the credit low-watermark itself; frag/byte rates are the
# window's publish throughput.  disco/attrib.py re-exports these with
# producer->consumer link labels (fdtpu_link_*).
for _j in range(4):
    MUX_SLOTS += [
        (f"out{_j}_lag", GAUGE), (f"out{_j}_occ_hwm", GAUGE),
        (f"out{_j}_cr_lwm", GAUGE), (f"out{_j}_frag_rate", GAUGE),
        (f"out{_j}_byte_rate", GAUGE),
    ]
del _j

# Per-kind app slots, appended after MUX_SLOTS (metrics.xml tile sections).
TILE_SLOTS: dict[str, list] = {
    "source": ["txn_gen_cnt", "blockhash_refresh_cnt",
               "adopt_pub_cnt"],          # fleet failover: txns re-published
                                          # from an adopted (dead) host's
                                          # stream
    "net": ["rx_pkt_cnt", "rx_drop_cnt", "tx_pkt_cnt",
            ("bound_port", GAUGE),
            "rate_drop_cnt",              # per-source pps token-bucket sheds
            ("shedding", GAUGE)],         # 1 = shed within the last ~5 s
    "quic": [("conn_cnt", GAUGE), "reasm_pub_cnt", "reasm_drop_cnt",
             "reasm_evict_cnt"],          # reasm slots lost to FIFO/budget
    "quic_server": [
        ("bound_port", GAUGE), "reasm_pub_cnt", "pkt_rx_cnt", "pkt_tx_cnt",
        "conn_created_cnt", "conn_closed_cnt", "streams_rx_cnt",
        "retrans_cnt", "pkt_undecryptable_cnt",
        # DoS front-door shed counters (every shed is counted somewhere):
        "pkt_malformed_cnt",              # unparseable datagrams
        "conn_reject_cnt",                # conn/peer caps refused admission
        "retry_sent_cnt",                 # stateless Retries (flood defense)
        "rate_drop_cnt",                  # per-conn txn token-bucket sheds
        "reasm_evict_cnt",                # partial streams evicted (budgets)
        "reasm_drop_cnt",                 # completed txns dropped pre-publish
        ("conn_cnt", GAUGE),              # live conn table size
        ("half_open_cnt", GAUGE),         # conns mid-handshake
        ("shedding", GAUGE),              # 1 = shed within the last ~5 s
        # burst packet-protection backend attribution + key-cache bound
        "crypto_native_cnt",              # packets through the C engine
        "crypto_fallback_cnt",            # packets through Python/NumPy
        "initial_keys_evict_cnt",         # Initial key-schedule LRU evictions
    ],
    "verify": [
        "txn_in_cnt", "parse_fail_cnt", "dedup_drop_cnt", "too_long_cnt",
        "verify_fail_cnt", "verify_pass_cnt", "batch_cnt",
        # TPU hooks (fdtrace): XLA compile storms, bucket occupancy, and
        # device-queue depth — the decomposition the bench optimizes by
        "compile_cnt",                    # (batch, maxlen) first-dispatches
        "compile_ns",                     # wall ns spent in those dispatches
        "lanes_filled_cnt",               # sig lanes occupied at dispatch
        "lanes_dispatched_cnt",           # sig lanes shipped (filled + pad)
        ("bucket_fill_pct", GAUGE),       # last dispatch's occupancy %
        ("inflight_depth", GAUGE),        # device batches in flight
        "torn_drop_cnt",                  # packed-wire frags dropped on a
                                          # post-dispatch seq re-check miss
        "torn_txn_cnt",                   # rows riding those frags (kept out
                                          # of txn_in_cnt so pass/fail rates
                                          # only count harvested rows)
        # self-healing (GuardedVerifier): device dispatch health + the
        # CPU ed25519 fallback that keeps verdicts flowing when the
        # device path is sick.  The fallback serves device "cpu" only: on
        # the card the first failure ends the tile (DeviceFault), so the
        # last four stay 0 there.  The two lane counts take every lane of
        # a fallen-back batch, padding lanes included (the JAX package's
        # count), so they read above the live lanes verdicted
        "device_fail_cnt",                # device dispatches failed/timed out
        "fallback_lane_cnt",              # sig lanes verdicted on the CPU path
        "reprobe_cnt",                    # degraded-mode device probes
        ("degraded_mode", GAUGE),         # 1 = serving off the CPU fallback
        ("fallback_vps", GAUGE),          # CPU-fallback verify rate (lanes/s)
        # dual-lane dispatch: low-latency lane accounting
        "lat_txn_cnt",                    # txns admitted to the lat lane
        "lat_spill_cnt",                  # lat txns shed to the bulk lane
        "lat_batch_cnt",                  # lat-lane device batches
        "lat_deadline_close_cnt",         # batches closed by deadline_us
    ],
    "dedup": ["dup_drop_cnt", "uniq_cnt",
              "torn_drop_cnt",             # packed-egress frags dropped on a
                                           # seq re-check miss mid-unpack
              "preload_cnt",               # tags preloaded at boot from the
                                           # fleet digest/ledger reject set
              ("shard_foreign_cnt", GAUGE)],  # mis-steered tags (fleet
                                              # sharded tcache)
    "pack": ["txn_insert_cnt", "microblock_cnt", "cu_consumed"],
    "leader_pack": [
        "txn_in_cnt", "parse_fail_cnt", "txn_insert_cnt", "vote_insert_cnt",
        "sched_txn_cnt", "microblock_cnt", "cu_consumed",
        "oversize_drop_cnt",               # txn cost > block budget at insert
        "heap_full_drop_cnt",              # max_pending shed (votes bypass)
        "conflict_delay_cnt",              # account conflict deferrals
        "torn_drop_cnt",                   # packed-egress seq re-check miss
        "drain_drop_cnt",                  # unschedulable heap remainder
                                           # shed by the drain protocol
        "shard_steer_cnt",                 # txns owned by this fee-payer
                                           # shard (sharded topology)
        ("pending", GAUGE),                # heap occupancy
    ],
    "leader_merge": [
        "mb_rx_cnt",                       # shard microblocks received
        "mb_merge_cnt",                    # microblocks admitted downstream
        "parse_fail_cnt",                  # malformed merge-wire frags
        "merge_budget_defer_cnt",          # admissions deferred by the
                                           # GLOBAL block/vote/data/account
                                           # budgets
        "merge_stall_cnt",                 # full passes with queued work
                                           # but zero admissions
        "drain_drop_cnt",                  # queued microblocks shed by the
                                           # drain protocol after repeated
                                           # stalls
        ("merge_q", GAUGE),                # queued microblocks across shards
    ],
    "bank": ["txn_exec_cnt", "txn_fail_cnt", "slot_cnt",
             ("rpc_port", GAUGE)],
    "poh": ["hash_cnt", "mixin_cnt"],
    "poh_dev": [
        "hash_cnt", "mixin_cnt", "entry_cnt", "tick_cnt",
        "mb_rx_cnt", "parse_fail_cnt",
        "spec_hit_cnt",                    # speculative span became the tick
        "spec_miss_cnt",                   # mixins landed: span re-dispatched
        "rehash_cnt",                      # hashes re-run on spec misses
        "recheck_ok_cnt", "recheck_fail_cnt",  # emitted-entry re-verify lanes
        "mb_deferred_cnt",                 # microblocks pushed past a full tick
        "dispatch_cnt",                    # window (K-tick) span dispatches
        "splice_dispatch_cnt",             # mixin-splice dispatches (re-hash
                                           # from the saved insertion point)
        ("spec_depth", GAUGE),             # speculated ticks still unconsumed
        ("inflight_depth", GAUGE),
        ("mb_queue", GAUGE),
    ],
    "shred": ["fec_set_cnt", "shred_tx_cnt", "shred_rx_cnt",
              "shred_parse_fail_cnt", "shred_sig_fail_cnt",
              "turbine_tx_cnt", ("turbine_port", GAUGE),
              # batched leader-sig admission
              "sig_batch_cnt", "sig_deadline_flush_cnt"],
    "shred_recover": ["shred_rx_cnt", "shred_parse_fail_cnt",
                      "fec_complete_cnt", "fec_recovered_cnt",
                      "fec_dispatch_cnt", "fec_fail_cnt",
                      "fec_host_fallback_cnt",
                      ("recover_pending", GAUGE)],
    "store": ["shred_store_cnt", "parse_fail_cnt",
              ("complete_slot", GAUGE)],
    "sign": ["sign_cnt", "refuse_cnt"],
    "gossip": ["rx_pkt_cnt", ("peer_cnt", GAUGE), ("bound_port", GAUGE)],
    "repair": ["req_cnt", "served_cnt", ("bound_port", GAUGE), "req_tx_cnt",
               "repaired_cnt", "resp_sig_fail_cnt"],
    "replay": [("replay_slot", GAUGE), "txn_replay_cnt", "dead_slot_cnt",
               ("ghost_head", GAUGE), ("root_slot", GAUGE), "vote_cnt"],
    "metric": [],
    "sink": ["frag_cnt"],
}

BLOCK_SLOTS = 128  # fixed slot area per tile, room to grow every kind

# -- shm histograms ---------------------------------------------------------
# (name, min_val, max_val) per def; layout per hist: 32 u64 bucket counts
# (bucket 31 = overflow, matching utils.hist.Histf) + 1 u64 running sum.
HIST_BUCKETS = 32
MAX_HISTS = 4

# one hop-latency histogram every tile feeds (cumulative; the windowed
# in*_hop gauges stay the liveness view, this is the scrape-friendly
# full-distribution view)
MUX_HISTS = [("in_hop_ns", 100.0, 10e9)]

# ranges MUST match the Histf the writer samples into (pipeline.py's
# VerifyMetrics); hist_store() asserts the edges agree.
TILE_HISTS: dict[str, list] = {
    "verify": [("batch_ns", 1_000.0, 60e9), ("coalesce_ns", 1_000.0, 60e9),
               # lat lane arrival->verdict e2e: the deadline
               # SLO distribution the dual-lane bench gates on
               ("lat_e2e_ns", 1_000.0, 60e9)],
}


def slot_defs(kind: str) -> list[tuple[str, str]]:
    out = []
    for s in MUX_SLOTS + TILE_SLOTS.get(kind, []):
        out.append((s, COUNTER) if isinstance(s, str) else tuple(s))
    return out


def slot_names(kind: str) -> list[str]:
    return [n for n, _ in slot_defs(kind)]


def hist_defs(kind: str) -> list[tuple[str, float, float]]:
    return MUX_HISTS + TILE_HISTS.get(kind, [])


def footprint() -> int:
    # slots then hist area; uniform across kinds so the layout replay in
    # every process stays identical regardless of tile kind
    return (BLOCK_SLOTS + MAX_HISTS * (HIST_BUCKETS + 1)) * 8


def lint_schema() -> None:
    """CI gate over the declarative schema (the reference validates
    metrics.xml at codegen time): slot names unique post-prefixing, the
    block fits BLOCK_SLOTS, kinds valid, hist defs fit MAX_HISTS with
    sane ranges."""
    kinds = set(TILE_SLOTS) | set(TILE_HISTS)
    for kind in kinds:
        defs = slot_defs(kind)
        names = [n for n, _ in defs]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"{kind}: duplicate slot names {dupes}")
        if len(defs) > BLOCK_SLOTS:
            raise ValueError(
                f"{kind}: {len(defs)} slots exceed BLOCK_SLOTS={BLOCK_SLOTS}")
        for n, k in defs:
            if k not in (COUNTER, GAUGE):
                raise ValueError(f"{kind}.{n}: invalid metric kind {k!r}")
            if not n.isidentifier():
                raise ValueError(f"{kind}.{n}: not a valid metric name")
        hds = hist_defs(kind)
        if len(hds) > MAX_HISTS:
            raise ValueError(
                f"{kind}: {len(hds)} hists exceed MAX_HISTS={MAX_HISTS}")
        hnames = [h[0] for h in hds]
        if len(set(hnames)) != len(hnames):
            raise ValueError(f"{kind}: duplicate hist names")
        for n, lo, hi in hds:
            if not (0 < lo < hi):
                raise ValueError(f"{kind}.{n}: bad hist range [{lo}, {hi}]")
            if n in names:
                raise ValueError(f"{kind}.{n}: hist name collides with slot")


class MetricsBlock:
    """Writer/reader view of one tile's metrics block."""

    def __init__(self, buf: memoryview, off: int, kind: str):
        self._arr = np.frombuffer(buf, dtype=np.uint64, count=BLOCK_SLOTS,
                                  offset=off)
        self._idx = {n: i for i, n in enumerate(slot_names(kind))}
        self._kinds = dict(slot_defs(kind))
        self.kind = kind
        # hist views: per def, (edges, counts view, sum view)
        self._hists = {}
        hoff = off + BLOCK_SLOTS * 8
        for hi, (name, lo, hi_v) in enumerate(hist_defs(kind)):
            base = hoff + hi * (HIST_BUCKETS + 1) * 8
            counts = np.frombuffer(buf, dtype=np.uint64,
                                   count=HIST_BUCKETS, offset=base)
            hsum = np.frombuffer(buf, dtype=np.uint64, count=1,
                                 offset=base + HIST_BUCKETS * 8)
            edges = np.geomspace(lo, hi_v, HIST_BUCKETS - 1)
            self._hists[name] = (edges, counts, hsum)

    def add(self, name: str, delta: int = 1):
        i = self._idx[name]
        # single writer per block: read-modify-write is safe; the 8B store
        # is what readers observe atomically
        self._arr[i] += np.uint64(delta)

    def set(self, name: str, val: int):
        self._arr[self._idx[name]] = np.uint64(val)

    def get(self, name: str) -> int:
        return int(self._arr[self._idx[name]])

    def has(self, name: str) -> bool:
        """Schema probe — health checks ask kinds they don't own (e.g.
        "does this tile export degraded_mode?") without try/except."""
        return name in self._idx

    def snapshot(self) -> dict[str, int]:
        return {n: int(self._arr[i]) for n, i in self._idx.items()}

    # -- histograms --------------------------------------------------------
    def hist_sample(self, name: str, v: float):
        edges, counts, hsum = self._hists[name]
        counts[np.searchsorted(edges, v)] += 1
        hsum[0] += np.uint64(max(int(v), 0))

    def hist_store(self, name: str, histf):
        """Bulk-mirror a utils.hist.Histf into the shm hist (the verify
        tile syncs its pipeline Histf this way).  The writer's edges must
        match the schema's — drift would mislabel every exported bucket."""
        edges, counts, hsum = self._hists[name]
        if len(histf.counts) != HIST_BUCKETS or not np.allclose(
                histf.edges, edges):
            raise ValueError(f"hist {name}: writer edges do not match schema")
        counts[:] = histf.counts
        hsum[0] = np.uint64(max(int(histf.sum), 0))

    def hist_snapshot(self, name: str):
        edges, counts, hsum = self._hists[name]
        return edges, counts.copy(), int(hsum[0])

    def hist_names(self) -> list[str]:
        return list(self._hists)


def _esc(v: str) -> str:
    """Escape a label VALUE per the Prometheus text exposition format
    (backslash, double-quote, newline — in that order)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(d: dict) -> str:
    return ",".join(f'{k}="{_esc(v)}"' for k, v in d.items())


def prometheus_render(tiles: dict[str, "MetricsBlock"], extra=None) -> str:
    """Render all tile blocks as Prometheus text exposition
    (ref: src/app/fdctl/run/tiles/fd_metric.c:232-263 prometheus_print):
    counters and gauges per the schema kind, shm histograms as native
    `le`-bucket histograms with _sum/_count.

    Conformant grouping: ALL samples of a family are emitted contiguously
    under exactly one `# HELP`/`# TYPE` pair (strict parsers reject a
    family split across the page), and label values are escaped.

    `extra` is an optional iterable of (name, kind, help, labels_dict,
    value) samples — disco/attrib.py feeds the producer->consumer link
    families through it so the HTTP server stays one render call.
    """
    # family name -> (kind, help, [sample lines])
    fams: dict[str, tuple[str, str, list[str]]] = {}

    def fam(metric, kind, help_txt):
        if metric in fams:
            return fams[metric][2]
        lines: list[str] = []
        fams[metric] = (kind, help_txt, lines)
        return lines

    for tname, blk in tiles.items():
        kind = blk.kind
        base = {"tile": tname, "kind": kind}
        for slot, val in blk.snapshot().items():
            metric = f"fdtpu_{slot}"
            fam(metric, blk._kinds[slot], f"{slot} per tile").append(
                f"{metric}{{{_labels(base)}}} {val}")
        for hname in blk.hist_names():
            metric = f"fdtpu_{hname}"
            lines = fam(metric, "histogram", f"{hname} distribution per tile")
            edges, counts, hsum = blk.hist_snapshot(hname)
            labels = _labels(base)
            cum = 0
            for i, e in enumerate(edges):
                cum += int(counts[i])
                lines.append(
                    f'{metric}_bucket{{{labels},le="{e:.6g}"}} {cum}')
            cum += int(counts[-1])  # overflow bucket
            lines.append(f'{metric}_bucket{{{labels},le="+Inf"}} {cum}')
            lines.append(f"{metric}_sum{{{labels}}} {hsum}")
            lines.append(f"{metric}_count{{{labels}}} {cum}")
    for name, kind, help_txt, labels, value in (extra or ()):
        fam(name, kind, help_txt).append(
            f"{name}{{{_labels(labels)}}} {value}")

    out = []
    for metric, (kind, help_txt, lines) in fams.items():
        out.append(f"# HELP {metric} {help_txt}")
        out.append(f"# TYPE {metric} {kind}")
        out.extend(lines)
    return "\n".join(out) + "\n"
