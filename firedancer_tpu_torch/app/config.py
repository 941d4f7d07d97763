"""Layered TOML config -> topology (ref: src/app/fdctl/config.c:818-870
config_parse: compiled-in defaults <- --config file <- env overrides;
topology selection topos.c:6-12); the port's own copy of
firedancer_tpu/app/config.py for the sections the verify-bench topology
reads.

The compiled-in defaults are DEFAULT_TOML below, with the JAX package's
values; a user file overlays it key by key; FDTPU_* environment variables
overlay scalars last (FDTPU_LAYOUT_VERIFY_TILE_COUNT=4 sets [layout]
verify_tile_count).  build_topology materializes `verify-bench` and
`leader-bench` (with one pack tile: `[leader] pack_shards > 1` needs the
leader_merge tile and raises NotImplementedError), each with the metric
tile when `[tiles.metric] prometheus_port` is set; the `fdtpu` topology
needs tiles the port does not have yet, and `[autotune] enabled` the
autotuner, and both raise NotImplementedError.
"""

import os
import tomllib

from ..disco.topo import TopoBuilder, TopoSpec, assign_affinity

DEFAULT_TOML = """
name = "fdtpu"
topology = "verify-bench"   # verify-bench | leader-bench (fdtpu: not ported)

[layout]
verify_tile_count = 1
affinity = ""               # "" = no pinning | "auto" | "0,2,3" cpu list
                            # (tiles take cpus in topology order, wrapping)

[verify]
mode = "strict"             # strict | antipa (the halved-scalar chain:
                            # strict's bits on honest and corrupted
                            # signatures, torsion-lax on forgeries).
                            # Env: FDTPU_VERIFY_MODE

[ingest]
native_hostpath = 1         # 1: one-pass C submit/harvest (hostpath.cpp) on
                            # packed dcache row views; 0 = NumPy finish,
                            # bit-identical verdicts.
                            # Env: FDTPU_INGEST_NATIVE_HOSTPATH
egress_packed = 0           # 1: verify tiles publish ONE packed arena frag
                            # per harvest (u32 offs[k+1] | wires) instead of
                            # k per-txn frags; the dedup tile unpacks it.
                            # Requires [development] packed_wire.

[tiles.verify]
batch = 64
msg_maxlen = 256
flush_age_ns = 2000000
tcache_depth = 65536
dp_shards = 1               # >1: not ported (multi-GPU verify)
device = ""                 # "" = the GPU; "cpu" runs the plain versions

[latency]
enabled = 0                 # 1: dual-lane dispatch in verify tiles (frags
                            # with the sig priority bit take the small lane)
deadline_us = 2000          # close the low-latency batch when its oldest
                            # txn reaches this age, regardless of fill
shapes = [16, 64, 256]      # small-lane batch ladder, pre-warmed at boot
max_inflight = 2            # lat-lane inflight budget before spilling
spill_age_factor = 4.0      # spill when open-queue age > factor * deadline

[tiles.dedup]
tcache_depth = 1048576

[leader]                    # leader lane: pack -> device PoH (the
                            # leader-bench topology)
hashes_per_tick = 16
ticks_per_slot = 8
spec_spans = 3              # concurrent engine span lanes: 1 chain lane +
                            # (spec_spans - 1) emitted-entry re-check lanes
poh_spec_ticks = 4          # PoH speculation depth: ticks pre-hashed per
                            # window dispatch (a mixin splices from the
                            # saved insertion point and invalidates the
                            # rest of the window)
mb_per_tick = 8             # mixin steps per tick (capped at
                            # hashes_per_tick - 1; excess microblocks defer)
pack_shards = 1             # leader_pack tiles (> 1: the sharded pack and
                            # its leader_merge tile, not ported)
native_pack = -1            # pack schedule hot loop: -1 or 1 = the C
                            # scheduler (raises when the host library does
                            # not build), 0 = the Python scheduler
mixin_txn_max = 32          # mixin merkle-tree pad width (txns/microblock)
max_txn_per_microblock = 31
max_pending = 4096          # pack heap cap (0 = unbounded; simple votes
                            # bypass — the reserved vote lane)
block_us = 400000           # end_block cadence (block budget reset)
capture_path = ""           # sink capture file (sig|len|payload per frag)
                            # for offline chain re-verification; "" = off
device = ""                 # the poh_dev tile's: "" = the GPU; "cpu" runs
                            # the plain versions

[tiles.metric]
prometheus_port = 0         # 0 = disabled; >0: a metric tile serving
                            # /metrics and /healthz on this port

[observability]
http_port = 0               # 0 = no supervisor /metrics + /healthz endpoint
flight_dir = ""             # "" = flight recorder off; else postmortem
                            # bundle dir (crash/degrade/respawn/SIGUSR2)
flight_max_bundles = 16     # oldest-bundle rotation bound on flight_dir
                            # (a crash loop can't fill the disk); evictions
                            # counted in fdtpu_flightrec_evict_cnt
slo_target_ms = 2.0         # e2e p99 latency target the stage budgets
                            # and /healthz slo field grade against

[autotune]
enabled = 0                 # 1: the closed-loop tuner, not ported

[supervision]
restart_policy = "fail_fast"  # fail_fast (ref run.c:279) | respawn
max_restarts = 5              # per-tile respawn budget
backoff_initial_s = 0.25      # exponential backoff: initial delay,
backoff_max_s = 8.0           # cap, and +/- jitter fraction (jitter is
backoff_jitter = 0.2          # deterministic per (tile, attempt))
boot_grace_s = 300.0          # no staleness checks while a tile boots
heartbeat_stale_s = 60.0      # default heartbeat staleness -> tile failed
device_fail_threshold = 3     # consecutive dispatch failures -> CPU
                              # fallback (device "cpu"; on the card the
                              # first failure ends the tile)
device_retry = 1              # bounded retries per device dispatch
device_deadline_s = 30.0      # verdict materialization deadline
device_reprobe_s = 5.0        # degraded-mode device re-probe interval
                              # (device "cpu")
drain_timeout_s = 0.0         # >0: graceful drain budget a tile (rolling
                              # restarts, SIGTERM/SIGINT topology drain).
                              # A tile not DRAINED within it falls back to
                              # crash-respawn semantics + a flight bundle.
                              # 0 (default): drain never engages
drain_manifest_dir = ""       # where draining tiles persist their cursor
                              # manifests ("" = skip; $FDTPU_DRAIN_DIR also
                              # works per-process)

[supervision.heartbeat_stale] # per tile KIND overrides (seconds)
verify = 120.0                # device dispatches stall longer

[development]
source_count = 0            # txns the synthetic source publishes
source_burst_n = 0          # >0: numpy burst firehose (txns/loop; SourceTile)
packed_wire = 0             # 1: dcache frags ARE device-blob rows (zero-copy
                            # wire->device path)
burst_splits = 2            # packed frags emitted per source loop (round-robin
                            # deal across verify tiles)
lat_every = 0               # >0: tag every Nth synthetic txn latency-class
bench_seed = 42
"""


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _env_overlay(cfg: dict, environ=os.environ) -> dict:
    """FDTPU_SECTION_KEY=value overrides; ints parsed when they look like
    ints (the reference parses env as the final layer, config.c)."""
    for name, val in environ.items():
        if not name.startswith("FDTPU_"):
            continue
        path = name[6:].lower().split("_", 1)
        cur = cfg
        # walk into the deepest section that matches; remaining underscore
        # words form the key (sections never contain underscores)
        if len(path) == 1:
            key = path[0]
        else:
            sect, key = path
            if sect in cur and isinstance(cur[sect], dict):
                cur = cur[sect]
                # tiles.verify style: one more level
                head = key.split("_", 1)
                if (len(head) == 2 and head[0] in cur
                        and isinstance(cur[head[0]], dict)):
                    cur = cur[head[0]]
                    key = head[1]
            else:
                key = name[6:].lower()
        try:
            cur[key] = int(val)
        except ValueError:
            cur[key] = val
    return cfg


# Sections where an unknown key is an ERROR, not a silent no-op: they
# carry tuning knobs, and a typo'd knob (deadline_uss) that no-ops is the
# worst failure mode.  The valid key set IS the DEFAULT_TOML schema.
_STRICT_SECTIONS = ("latency", "verify", "supervision", "observability")
_STRICT_SUBTABLES = {"supervision": ("heartbeat_stale",)}


# Keys of the JAX package's config whose code the port does not have: a
# value other than 0 would change nothing, so it is refused, naming the
# missing part.
_NOT_PORTED = {
    "leader": {"unroll": "the XLA scan unroll of the PoH step (the CUDA "
                         "kernel unrolls its rounds in full)"},
}


def _validate_strict(cfg: dict):
    import difflib
    for sect, keys in _NOT_PORTED.items():
        for key, what in keys.items():
            if (cfg.get(sect) or {}).get(key):
                raise NotImplementedError(
                    f"[{sect}] {key}: {what} is not ported")
    schema = tomllib.loads(DEFAULT_TOML)
    for sect in _STRICT_SECTIONS:
        got = cfg.get(sect)
        if not isinstance(got, dict):
            continue
        valid = (set(schema[sect]) | set(_STRICT_SUBTABLES.get(sect, ()))
                 | set(_NOT_PORTED.get(sect, ())))
        for key in got:
            if key in valid:
                continue
            near = difflib.get_close_matches(key, sorted(valid), n=1)
            hint = f" (did you mean {near[0]!r}?)" if near else ""
            raise ValueError(
                f"unknown key {key!r} in [{sect}]{hint}; valid keys: "
                + ", ".join(sorted(valid)))


def load(path: str | None = None, environ=os.environ) -> dict:
    cfg = tomllib.loads(DEFAULT_TOML)
    if path:
        with open(path, "rb") as f:
            cfg = _deep_merge(cfg, tomllib.load(f))
    cfg = _env_overlay(cfg, environ)
    _validate_strict(cfg)
    return cfg


# the tiles each topology the port does not build yet is missing
_MISSING = {
    "fdtpu": "net, quic, pack, bank, poh, sign",
}


def build_topology(cfg: dict) -> TopoSpec:
    """Materialize the configured topology (the fd_topo_* analogues,
    src/app/fdctl/run/topos/)."""
    name = cfg.get("topology", "verify-bench")
    if name in _MISSING:
        raise NotImplementedError(
            f"topology {name!r} needs tiles the port does not have yet: "
            f"{_MISSING[name]}")
    if name not in _TOPOS:
        raise ValueError(f"unknown topology {name!r}")
    if int((cfg.get("autotune") or {}).get("enabled", 0) or 0):
        raise NotImplementedError(
            "[autotune] enabled: the Autotuner (disco/autotune.py) is not "
            "ported")
    return assign_affinity(_TOPOS[name](cfg),
                           str(cfg["layout"].get("affinity", "")))


def _source_and_verify(cfg: dict, name: str, out_link: str):
    """The builder with the source and the verify tiles both topologies
    share: source -> verify[v], verify v publishing on `out_link`:v.
    Returns (builder, nverify, egress_packed)."""
    nverify = int(cfg["layout"]["verify_tile_count"])
    dev = cfg["development"]
    vcfg = dict(cfg["tiles"]["verify"])
    vcfg["device"] = vcfg.get("device") or None
    vcfg["mode"] = str(cfg.get("verify", {}).get("mode", "strict"))
    packed = int(dev.get("packed_wire", 0))
    ing = dict(cfg.get("ingest") or {})
    vcfg["native_hostpath"] = int(ing.get("native_hostpath", 1))
    egress_packed = bool(int(ing.get("egress_packed", 0))) and bool(packed)
    if egress_packed:
        vcfg["egress_packed"] = 1
    b = TopoBuilder(cfg.get("name", "fdtpu") + name,
                    wksp_mb=128 if packed else 64)
    if packed:
        # zero-copy wire->device: the src_verify dcache chunk layout IS
        # the device-blob layout.  One frag = one packed burst of `batch`
        # rows at a chunk-aligned stride; meta.sz carries the row count
        # (u16 can't hold the byte size).  Small depth: frags are few and
        # huge, and the reader pins them until verdicts land (the mux's
        # credits_held).
        from ..tango.ring import PACKED_ROW_EXTRA, packed_row_ml
        batch = int(vcfg.get("batch", 64))
        ml = packed_row_ml(int(vcfg.get("msg_maxlen", 256)))
        stride = ml + PACKED_ROW_EXTRA
        vcfg["packed_wire"] = 1
        vcfg["buckets"] = [[batch, ml]]
        b.link("src_verify", depth=16, mtu=batch * stride)
        b.tile("source", "source", outs=["src_verify"],
               count=int(dev["source_count"]),
               seed=int(dev["bench_seed"]),
               packed_rows=batch, packed_ml=ml,
               burst_splits=int(dev.get("burst_splits", 2)))
    else:
        b.link("src_verify", depth=4096, mtu=1280)
        b.tile("source", "source", outs=["src_verify"],
               count=int(dev["source_count"]),
               seed=int(dev["bench_seed"]),
               burst_n=int(dev.get("source_burst_n", 0)),
               lat_every=int(dev.get("lat_every", 0)))
    vcfg.setdefault("supervision", dict(cfg.get("supervision") or {}))
    vcfg.setdefault("latency", dict(cfg.get("latency") or {}))
    if egress_packed:
        vd_depth = 16
        vd_mtu = int(vcfg["buckets"][0][0]) * (65 + int(vcfg["buckets"][0][1])) \
            + 4 * (int(vcfg["buckets"][0][0]) + 1)
    else:
        vd_depth, vd_mtu = 256, 1280
    for v in range(nverify):
        b.link(f"{out_link}:{v}", depth=vd_depth, mtu=vd_mtu)
        b.tile(f"verify:{v}", "verify", ins=["src_verify"],
               outs=[f"{out_link}:{v}"],
               round_robin_cnt=nverify, round_robin_idx=v, **vcfg)
    return b, nverify, egress_packed


def _metric_tile(b, cfg: dict):
    """[tiles.metric] prometheus_port > 0: the metric tile, serving
    /metrics and /healthz over every tile's block on that port."""
    port = int(cfg["tiles"]["metric"]["prometheus_port"])
    if port:
        b.tile("metric", "metric", ins=(), port=port)


def _topo_verify_bench(cfg: dict) -> TopoSpec:
    """source -> verify[v] -> dedup -> sink: the synthetic sigverify load
    harness (the verify_synth_load.c / `fddev bench` analogue)."""
    b, nverify, egress_packed = _source_and_verify(cfg, "-bench",
                                                   "verify_dedup")
    t = cfg["tiles"]
    b.link("dedup_sink", depth=256, mtu=1280)
    b.tile("dedup", "dedup",
           ins=[f"verify_dedup:{v}" for v in range(nverify)],
           outs=["dedup_sink"], packed_egress=int(egress_packed),
           **t["dedup"])
    b.tile("sink", "sink", ins=["dedup_sink"],
           **dict(t.get("sink") or {}))
    _metric_tile(b, cfg)
    return b.build()


def _topo_leader_bench(cfg: dict) -> TopoSpec:
    """source -> verify[v] -> leader_pack -> poh_dev -> sink: the leader
    write-side harness.  Verified txns feed the fee-priority pack
    scheduler, whose microblocks mix into the device PoH chain; the sink
    collects serialized entries (capture_path, for re-verification)."""
    ld = dict(cfg.get("leader") or {})
    if int(ld.get("pack_shards", 1)) > 1:
        raise NotImplementedError(
            "[leader] pack_shards > 1: the sharded pack and its "
            "leader_merge tile are not ported")
    b, nverify, egress_packed = _source_and_verify(cfg, "-leader",
                                                   "verify_pack")
    mtxn = int(ld.get("max_txn_per_microblock", 31))
    mb_mtu = 4 + mtxn * (4 + 1280)          # serialize_txn_batch wire
    b.link("pack_poh", depth=256, mtu=mb_mtu)
    b.tile("leader_pack", "leader_pack",
           ins=[f"verify_pack:{v}" for v in range(nverify)],
           outs=["pack_poh"], packed_egress=int(egress_packed),
           max_txn=mtxn, max_pending=int(ld.get("max_pending", 4096)),
           block_us=int(ld.get("block_us", 400_000)),
           native_pack=int(ld.get("native_pack", -1)))
    mixin_max = int(ld.get("mixin_txn_max", 32))
    entry_mtu = 48 + mixin_max * (4 + 1280)  # Entry.serialize wire
    b.link("poh_sink", depth=512, mtu=entry_mtu)
    b.tile("poh_dev", "poh_dev", ins=["pack_poh"], outs=["poh_sink"],
           hashes_per_tick=int(ld.get("hashes_per_tick", 16)),
           ticks_per_slot=int(ld.get("ticks_per_slot", 8)),
           spec_spans=int(ld.get("spec_spans", 3)),
           spec_ticks=int(ld.get("poh_spec_ticks", 4)),
           mb_per_tick=int(ld.get("mb_per_tick", 8)),
           mixin_txn_max=mixin_max,
           device=ld.get("device") or None)
    b.tile("sink", "sink", ins=["poh_sink"],
           capture_path=str(ld.get("capture_path", "")))
    _metric_tile(b, cfg)
    return b.build()


_TOPOS = {"verify-bench": _topo_verify_bench,
          "leader-bench": _topo_leader_bench}
