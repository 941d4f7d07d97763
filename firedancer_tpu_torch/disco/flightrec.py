"""Flight recorder: crash postmortem bundles (the port's own copy of
firedancer_tpu/disco/flightrec.py; ref: the reference leaves
its tango workspaces behind after a tile crash so fd_monitor can inspect
the corpse; our supervisor respawns tiles into the SAME workspace, which
heals the topology but overwrites the evidence — so the supervisor
snapshots it first).

A bundle is one directory under `[observability] flight_dir`:

    manifest.json   app, reason, dead tile, creation time, per-tile kind
                    + restart count + cnc state, span counts
    spans.npz       last-N trace spans per tile (TRACE_REC_DTYPE)
    metrics.json    per-tile metrics slots + shm histograms
    links.json      per-link fctl/fseq state (seq, lag, diag) + the
                    producer-side out{j}_* gauges (disco/attrib.py)
    config.json     the resolved config the topology ran with
    events.log      the supervisor's event log (spawn/respawn/degrade...)

`fdtpuctl postmortem <bundle>` renders it: hop table + stage budgets +
bottleneck verdict at time of death + the dead tile's final spans.
"""

import json
import os
import time

import numpy as np

from ..tango.ring import Cnc
from . import attrib
from . import slo
from . import trace as trace_mod

SPANS_PER_TILE = 2048   # last-N spans kept per tile in a bundle

_SIG_NAMES = {Cnc.SIGNAL_RUN: "run", Cnc.SIGNAL_BOOT: "boot",
              Cnc.SIGNAL_FAIL: "FAIL", Cnc.SIGNAL_HALT: "halt",
              Cnc.SIGNAL_DRAIN: "drain", Cnc.SIGNAL_DRAINED: "drained"}


def write_bundle(flight_dir: str, jt, *, reason: str, tile: str = "",
                 restarts: dict | None = None, config: dict | None = None,
                 events: list | None = None) -> str:
    """Snapshot the joined topology into a new bundle directory; returns
    its path.  Read-only over the workspace — safe to call while tiles
    run (the snapshot contract every reader in this repo follows)."""
    spec = jt.spec
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    name = f"{spec.app}-{reason}-{stamp}-{os.getpid()}"
    path = os.path.join(flight_dir, name)
    n = 0
    while os.path.exists(path):  # same second, same pid: disambiguate
        n += 1
        path = os.path.join(flight_dir, f"{name}.{n}")
    os.makedirs(path)

    spans = {}
    span_cnt = {}
    for tname, ring in jt.trace.items():
        _, recs = ring.snapshot(0)
        spans[tname] = recs[-SPANS_PER_TILE:]
        span_cnt[tname] = int(len(spans[tname]))
    np.savez(os.path.join(path, "spans.npz"), **spans)

    metrics = {}
    for tname, blk in jt.metrics.items():
        hists = {}
        for hname in blk.hist_names():
            edges, counts, hsum = blk.hist_snapshot(hname)
            hists[hname] = {"edges": [float(e) for e in edges],
                            "counts": [int(c) for c in counts],
                            "sum": hsum}
        metrics[tname] = {"slots": blk.snapshot(), "hists": hists}
    with open(os.path.join(path, "metrics.json"), "w") as f:
        json.dump(metrics, f)

    sample = attrib.link_sample(jt)
    links = {"t": sample["t"],
             "links": {f"{ln}|{cons}": lv
                       for (ln, cons), lv in sample["links"].items()},
             "tiles": sample["tiles"]}
    with open(os.path.join(path, "links.json"), "w") as f:
        json.dump(links, f)

    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config or {}, f, default=str)

    with open(os.path.join(path, "events.log"), "w") as f:
        f.write("\n".join(events or []) + ("\n" if events else ""))

    manifest = {
        "app": spec.app, "reason": reason, "tile": tile,
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "tiles": {t.name: {
            "kind": t.kind,
            "restarts": int((restarts or {}).get(t.name, 0)),
            "cnc": _SIG_NAMES.get(jt.cnc[t.name].signal_query(), "?"),
            "spans": span_cnt.get(t.name, 0),
        } for t in spec.tiles},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


def rotate(flight_dir: str, max_bundles: int) -> int:
    """Oldest-bundle rotation ([observability] flight_max_bundles): keep
    the newest `max_bundles` bundle dirs, delete the rest.  Returns the
    number evicted (fdtpu_flightrec_evict_cnt) — a crash loop must
    never fill the disk."""
    if max_bundles <= 0:
        return 0
    try:
        entries = [os.path.join(flight_dir, d)
                   for d in os.listdir(flight_dir)]
    except OSError:
        return 0
    bundles = [p for p in entries
               if os.path.isdir(p)
               and os.path.exists(os.path.join(p, "manifest.json"))]
    if len(bundles) <= max_bundles:
        return 0
    import shutil
    bundles.sort(key=os.path.getmtime)
    evicted = 0
    for p in bundles[:len(bundles) - max_bundles]:
        try:
            shutil.rmtree(p)
            evicted += 1
        except OSError:
            pass
    return evicted


def load_bundle(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "spans.npz")) as z:
        spans = {k: np.asarray(z[k], dtype=trace_mod.TRACE_REC_DTYPE)
                 for k in z.files}
    with open(os.path.join(path, "metrics.json")) as f:
        metrics = json.load(f)
    with open(os.path.join(path, "links.json")) as f:
        links = json.load(f)
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    events = []
    ev_path = os.path.join(path, "events.log")
    if os.path.exists(ev_path):
        with open(ev_path) as f:
            events = [ln for ln in f.read().splitlines() if ln]
    return {"path": path, "manifest": manifest, "spans": spans,
            "metrics": metrics, "links": links, "config": config,
            "events": events}


def render_bundle(path: str, target_ms: float | None = None) -> str:
    """Terminal postmortem: what the topology looked like when it died
    (`fdtpuctl postmortem <bundle>`)."""
    b = load_bundle(path)
    man = b["manifest"]
    if target_ms is None:
        target_ms = float(
            b["config"].get("observability", {}).get(
                "slo_target_ms", slo.DEFAULT_TARGET_MS))
    lines = [f"flight recorder bundle: {b['path']}",
             f"app {man['app']}  reason {man['reason']}"
             + (f"  tile {man['tile']}" if man.get("tile") else "")
             + f"  created {man['created']}", ""]
    lines.append(f"{'TILE':<14}{'KIND':<12}{'CNC':<6}{'RESTARTS':>9}"
                 f"{'SPANS':>7}")
    for tname, tv in man["tiles"].items():
        lines.append(f"{tname:<14}{tv['kind']:<12}{tv['cnc']:<6}"
                     f"{tv['restarts']:>9}{tv['spans']:>7}")

    kind_of = {t: tv["kind"] for t, tv in man["tiles"].items()}
    lines += ["", trace_mod.hop_table(b["spans"]), ""]
    stats = slo.stage_stats(b["spans"], kind_of, target_ms)
    burn = slo.burn(b["spans"], kind_of, target_ms)
    lines += [slo.render_table(stats, burn, target_ms), ""]

    # bottleneck at time of death, from the bundled link snapshot
    sample = {"t": b["links"]["t"],
              "links": {tuple(k.split("|", 1)): v
                        for k, v in b["links"]["links"].items()},
              "tiles": b["links"]["tiles"]}
    link, why = attrib.snapshot_verdict(sample)
    lines.append(f"bottleneck at death: {link} ({why})")

    dead = man.get("tile")
    if dead and dead in b["spans"] and len(b["spans"][dead]):
        lines += ["", f"final spans of {dead}:"]
        for r in b["spans"][dead][-10:]:
            kname = trace_mod.KIND_NAMES.get(int(r["kind"]),
                                             str(int(r["kind"])))
            lines.append(
                f"  ts={int(r['ts'])} {kname:<9} dur={int(r['dur'])}ns"
                f" cnt={int(r['cnt'])} seq={int(r['seq'])}")
    if b["events"]:
        lines += ["", "supervisor events (tail):"]
        lines += [f"  {ln}" for ln in b["events"][-15:]]
    return "\n".join(lines)
