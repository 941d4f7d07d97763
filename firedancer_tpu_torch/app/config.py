"""Layered TOML config -> topology (ref: src/app/fdctl/config.c:818-870
config_parse: compiled-in defaults <- --config file <- env overrides;
topology selection topos.c:6-12); the port's own copy of
firedancer_tpu/app/config.py for the sections the verify-bench topology
reads.

The compiled-in defaults are DEFAULT_TOML below, with the JAX package's
values; a user file overlays it key by key; FDTPU_* environment variables
overlay scalars last (FDTPU_LAYOUT_VERIFY_TILE_COUNT=4 sets [layout]
verify_tile_count).  build_topology materializes `verify-bench`; the
`fdtpu` and `leader-bench` topologies need tiles the port does not have
yet and raise NotImplementedError.
"""

import os
import tomllib

from ..disco.topo import TopoBuilder, TopoSpec, assign_affinity

DEFAULT_TOML = """
name = "fdtpu"
topology = "verify-bench"   # verify-bench (fdtpu, leader-bench: not ported)

[layout]
verify_tile_count = 1
affinity = ""               # "" = no pinning | "auto" | "0,2,3" cpu list
                            # (tiles take cpus in topology order, wrapping)

[verify]
mode = "strict"             # strict (antipa: not ported).
                            # Env: FDTPU_VERIFY_MODE

[ingest]
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

[tiles.metric]
prometheus_port = 0         # >0: the metric tile, not ported

[autotune]
enabled = 0                 # 1: the closed-loop tuner, not ported

[supervision]
restart_policy = "fail_fast"  # fail_fast (respawn: not ported)
boot_grace_s = 300.0          # no staleness checks while a tile boots
heartbeat_stale_s = 60.0      # default heartbeat staleness -> tile failed
drain_timeout_s = 0.0         # >0: graceful drain budget a tile.  0
                              # (default): drain never engages
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
_STRICT_SECTIONS = ("latency", "verify", "supervision")
_STRICT_SUBTABLES = {"supervision": ("heartbeat_stale",)}


# Keys of the JAX package's config whose code the port does not have: a
# value other than 0 would change nothing, so it is refused, naming the
# missing part.
_RESPAWN = "respawn (TopoRun.supervise)"
_GUARD = "the verify tile's GuardedVerifier (host fallback)"
_NOT_PORTED = {
    "supervision": {"max_restarts": _RESPAWN, "backoff_initial_s": _RESPAWN,
                    "backoff_max_s": _RESPAWN, "backoff_jitter": _RESPAWN,
                    "device_fail_threshold": _GUARD, "device_retry": _GUARD,
                    "device_deadline_s": _GUARD, "device_reprobe_s": _GUARD},
    "ingest": {"native_hostpath": "the native host path (hostpath.cpp)"},
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
    "fdtpu": "net, quic, pack, bank, poh, shred, store, sign",
    "leader-bench": "leader_pack, leader_merge, poh_dev, shred",
}


def build_topology(cfg: dict) -> TopoSpec:
    """Materialize the configured topology (the fd_topo_* analogues,
    src/app/fdctl/run/topos/)."""
    name = cfg.get("topology", "verify-bench")
    if name in _MISSING:
        raise NotImplementedError(
            f"topology {name!r} needs tiles the port does not have yet: "
            f"{_MISSING[name]}")
    if name != "verify-bench":
        raise ValueError(f"unknown topology {name!r}")
    if int(cfg["tiles"]["metric"]["prometheus_port"]):
        raise NotImplementedError(
            "[tiles.metric] prometheus_port: the metric tile is not ported")
    if int((cfg.get("autotune") or {}).get("enabled", 0) or 0):
        raise NotImplementedError(
            "[autotune] enabled: the Autotuner (disco/autotune.py) is not "
            "ported")
    return assign_affinity(_topo_verify_bench(cfg),
                           str(cfg["layout"].get("affinity", "")))


def _topo_verify_bench(cfg: dict) -> TopoSpec:
    """source -> verify[v] -> dedup -> sink: the synthetic sigverify load
    harness (the verify_synth_load.c / `fddev bench` analogue)."""
    nverify = int(cfg["layout"]["verify_tile_count"])
    t = cfg["tiles"]
    dev = cfg["development"]
    vcfg = dict(t["verify"])
    vcfg["device"] = vcfg.get("device") or None
    vcfg["mode"] = str(cfg.get("verify", {}).get("mode", "strict"))
    packed = int(dev.get("packed_wire", 0))
    ing = dict(cfg.get("ingest") or {})
    egress_packed = bool(int(ing.get("egress_packed", 0))) and bool(packed)
    if egress_packed:
        vcfg["egress_packed"] = 1
    b = TopoBuilder(cfg.get("name", "fdtpu") + "-bench",
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
        b.link(f"verify_dedup:{v}", depth=vd_depth, mtu=vd_mtu)
        b.tile(f"verify:{v}", "verify", ins=["src_verify"],
               outs=[f"verify_dedup:{v}"],
               round_robin_cnt=nverify, round_robin_idx=v, **vcfg)
    b.link("dedup_sink", depth=256, mtu=1280)
    b.tile("dedup", "dedup",
           ins=[f"verify_dedup:{v}" for v in range(nverify)],
           outs=["dedup_sink"], packed_egress=int(egress_packed),
           **t["dedup"])
    b.tile("sink", "sink", ins=["dedup_sink"],
           **dict(t.get("sink") or {}))
    return b.build()
