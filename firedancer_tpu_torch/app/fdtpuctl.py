"""fdtpuctl — the port's operator CLI (ref: src/app/fdctl — main1.c:10-17
action table); the port's own copy of firedancer_tpu/app/fdtpuctl.py's
topology commands.

    python -m firedancer_tpu_torch.app.fdtpuctl [--config file.toml] CMD

    run          boot + supervise the topology (the verify tiles on the
                 GPU unless [tiles.verify] device = "cpu")
    topo         print the materialized graph
    monitor      periodic metrics snapshot
    trace        span rings -> Chrome trace JSON + hop table
    top          live bottleneck attribution
    slo          stage-budget table vs the e2e latency target
    postmortem   render a flight-recorder bundle
    drain        graceful quiesce + shutdown
    ready        block until every tile is RUN
    keys         new PATH: write an identity keypair (the sign tile's
                 key_path), print its public key; pubkey PATH: print it

The JAX package's other commands (autotune, fleet, configure, mem,
version, ledger) are not offered.
"""

import argparse
import json
import os
import sys
import time


def _supervisor_pidfile(app: str) -> str:
    """Where `fdtpuctl run` records its pid so `fdtpuctl drain` can ask
    THE SUPERVISOR to quiesce (the process that owns the children and
    the respawn machinery) instead of driving the cnc lines blind."""
    import tempfile
    return os.path.join(tempfile.gettempdir(), f"fdtpu_{app}.pid")


# pidfile older than this with no way to cross-check process identity is
# presumed stale (a supervisor that ran for a week would have refreshed
# nothing — but a recycled pid that LOOKS alive is the real hazard)
_PIDFILE_STALE_AGE_S = 7 * 24 * 3600.0


def _proc_start_time(pid: int) -> float | None:
    """Wall-clock start time of `pid`, from /proc/<pid>/stat field 22
    (starttime, clock ticks since boot) + /proc/stat btime.  None when
    /proc isn't available (non-Linux) or unparseable."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        # comm may contain spaces/parens — fields count from after ')'
        fields = stat[stat.rindex(")") + 2:].split()
        start_ticks = int(fields[19])        # field 22, 0-indexed past comm
        with open("/proc/stat", "rb") as f:
            for line in f.read().decode().splitlines():
                if line.startswith("btime "):
                    btime = float(line.split()[1])
                    break
            else:
                return None
        hz = os.sysconf(os.sysconf_names["SC_CLK_TCK"])
        return btime + start_ticks / float(hz)
    except (OSError, ValueError, IndexError, KeyError):
        return None


def _pid_running(pid: int) -> bool:
    """Whether `pid` is a process that has not exited: an exited one that
    its parent has not reaped yet (a zombie, /proc state Z) still answers
    kill(pid, 0), and counts as exited here."""
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("ascii", "replace")
        return stat[stat.rindex(")") + 2:].split()[0] != "Z"
    except (OSError, ValueError, IndexError):
        return True


def _live_supervisor_pid(pidfile: str) -> int:
    """Read a supervisor pidfile and return the pid ONLY if the process
    is alive AND demonstrably the one that wrote the file.  A pid
    recycled by an unrelated process must never be signaled: the
    process's start time (from /proc) has to predate the pidfile's
    mtime (+slack for clock granularity).  Where /proc can't answer,
    an old pidfile is presumed stale.  Returns 0 for no/stale/dead —
    callers fall through to driving the cnc lines directly."""
    try:
        st = os.stat(pidfile)
        with open(pidfile) as f:
            pid = int(f.read().strip())
        os.kill(pid, 0)
    except (OSError, ValueError):
        return 0
    started = _proc_start_time(pid)
    if started is not None:
        if started > st.st_mtime + 2.0:
            return 0                      # pid recycled after the file
    elif time.time() - st.st_mtime > _PIDFILE_STALE_AGE_S:
        return 0                          # no /proc; too old to trust
    return pid


def _join(spec):
    """Join a running topology's workspace from this command's process.
    Python's SharedMemory registers every mapping it opens with the
    process's resource tracker, which unlinks what is still registered
    when the process exits: a command run from a shell has a tracker of
    its own, so without this it would unlink the live workspace's name at
    its exit, and a tile respawned later could no longer join it.  The
    supervisor that created the workspace owns its unlink."""
    from multiprocessing import resource_tracker

    from ..disco import topo as topo_mod
    jt = topo_mod.join(spec)
    resource_tracker.unregister(jt.ws.shm._name, "shared_memory")
    return jt


def cmd_run(cfg, args):
    """Boot the topology, wait for every tile's RUN and supervise it
    until a tile fails past the policy (exit 1), or a drain (SIGTERM /
    SIGINT with [supervision] drain_timeout_s set, `fdtpuctl drain`) or
    an interrupt ends it (exit 0).  The supervisor's pid goes to the
    pidfile `fdtpuctl drain` reads."""
    from ..disco.run import SupervisionPolicy, TopoRun
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    print(f"booting topology {spec.app!r}: "
          f"{len(spec.tiles)} tiles, {len(spec.links)} links", flush=True)
    # [observability] http_port: 0 disables the supervisor-side scrape
    # endpoint (a metric-kind tile can still serve one), N binds it fixed
    obs = cfg.get("observability", {})
    http_port = obs.get("http_port", 0)
    policy = SupervisionPolicy.from_cfg(cfg)
    pidfile = _supervisor_pidfile(spec.app)
    try:
        with open(pidfile, "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pidfile = ""
    bad = None
    try:
        with TopoRun(spec,
                     metrics_port=http_port if http_port else None,
                     policy=policy,
                     flight_dir=str(obs.get("flight_dir", "") or ""),
                     slo_target_ms=float(obs.get("slo_target_ms", 2.0)),
                     config=cfg) as run:
            if run.metrics_port:
                print("metrics: "
                      f"http://127.0.0.1:{run.metrics_port}/metrics",
                      flush=True)
            run.wait_ready(timeout=args.boot_timeout)
            print("all tiles RUN", flush=True)
            try:
                bad = run.supervise()
            except KeyboardInterrupt:
                # with [supervision] drain_timeout_s set, SIGINT never
                # lands here (the drain handler absorbs the first one)
                print("halting", flush=True)
    finally:
        if pidfile:
            try:
                os.unlink(pidfile)
            except OSError:
                pass
    if bad is not None:
        # a tile failed under fail_fast, or spent its respawn budget
        print(f"tile {bad} failed; topology torn down", file=sys.stderr)
        return 1
    return 0


def cmd_drain(cfg, args):
    """Gracefully quiesce a running topology (drain protocol, ref: the
    cnc lifecycle PAPER.md describes — here BOOT→RUN→DRAIN→DRAINED→HALT):
    every tile drains in dependency order (source→net→quic→verify→dedup),
    so the topology exits with every accepted txn verdicted.

    Preferred path: SIGTERM to the `fdtpuctl run` supervisor (pidfile) —
    it owns the children, drains in order bounded by drain_timeout_s,
    and degrades to the plain halt on a wedged tile.  Without a live
    supervisor (e.g. a TopoRun embedded in a test), the cnc lines are
    driven directly."""
    import signal as signal_mod
    from ..disco.run import dependency_order
    from ..tango.ring import Cnc
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    sup = cfg.get("supervision") or {}
    timeout = args.timeout or float(sup.get("drain_timeout_s", 0) or 10.0)

    pidfile = _supervisor_pidfile(spec.app)
    pid = _live_supervisor_pid(pidfile)
    if pid:
        os.kill(pid, signal_mod.SIGTERM)
        print(f"drain requested from supervisor (pid {pid})", flush=True)
        budget = timeout * (len(spec.tiles) + 1) + 10.0
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if not _pid_running(pid):
                print("topology drained and halted")
                return 0
            time.sleep(0.1)
        print(f"supervisor still up after {budget:.0f}s", file=sys.stderr)
        return 1

    jt = _join(spec)
    try:
        ok = True
        for name in dependency_order(spec):
            cnc = jt.cnc[name]
            if cnc.signal_query() != Cnc.SIGNAL_RUN:
                print(f"  {name}: not running, skipped")
                continue
            cnc.signal(Cnc.SIGNAL_DRAIN)
            deadline = time.monotonic() + timeout
            while (time.monotonic() < deadline
                   and cnc.signal_query() != Cnc.SIGNAL_DRAINED):
                time.sleep(0.005)
            drained = cnc.signal_query() == Cnc.SIGNAL_DRAINED
            print(f"  {name}: {'drained' if drained else 'DRAIN TIMEOUT'}",
                  flush=True)
            if not drained:
                ok = False
                break
        for cnc in jt.cnc.values():
            cnc.signal(Cnc.SIGNAL_HALT)
        print("topology halted" + ("" if ok else " (degraded: timeout)"))
        return 0 if ok else 1
    finally:
        jt.close()


def cmd_topo(cfg, args):
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    print(f"app: {spec.app}  workspace: {spec.wksp_mb} MiB")
    print("links:")
    for l in spec.links:
        print(f"  {l.name:24s} depth={l.depth:<6d} mtu={l.mtu}")
    print("tiles:")
    for t in spec.tiles:
        ins = ",".join(i.link for i in t.in_links) or "-"
        outs = ",".join(t.out_links) or "-"
        print(f"  {t.name:12s} kind={t.kind:8s} in=[{ins}] out=[{outs}]")
    return 0


def cmd_monitor(cfg, args):
    """Read-only metrics snapshots of a running topology (ref:
    src/app/fdctl/monitor/monitor.c — joins workspaces read-only).

    Default mode prints one JSON object per sample; --follow renders the
    live in-place dashboard (monitor.c:49-160's terminal table): per tile
    the cnc status + heartbeat age, per in-link the consumer's catch-up
    rate vs the producer plus backlog and the overrun/slow diag rates,
    and each tile's busiest counters as per-second rates."""
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    jt = _join(spec)
    try:
        if getattr(args, "follow", False):
            return _monitor_follow(spec, jt, args)
        for _ in range(args.count) if args.count else iter(int, 1):
            out = {}
            for name, blk in jt.metrics.items():
                snap = blk.snapshot()
                out[name] = {k: v for k, v in snap.items() if v}
            print(json.dumps(out), flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        jt.close()
    return 0


def _monitor_follow(spec, jt, args):
    """In-place refreshing dashboard over the shared-memory topology."""
    from ..tango.ring import Cnc, FSeq
    sig_name = {Cnc.SIGNAL_RUN: "run", Cnc.SIGNAL_BOOT: "boot",
                Cnc.SIGNAL_FAIL: "FAIL", Cnc.SIGNAL_HALT: "halt",
                Cnc.SIGNAL_DRAIN: "drain", Cnc.SIGNAL_DRAINED: "drained"}

    def sample():
        now = time.monotonic_ns()
        s = {"t": now, "tiles": {}, "links": {}}
        for t in spec.tiles:
            cnc = jt.cnc[t.name]
            hb = cnc.heartbeat_query()
            s["tiles"][t.name] = {
                "sig": sig_name.get(cnc.signal_query(), "?"),
                "hb_ms": (now - hb) / 1e6 if hb else -1.0,
                "m": {k: v for k, v in jt.metrics[t.name].snapshot().items()
                      if isinstance(v, (int, float)) and v},
            }
            for il in t.in_links:
                fs = jt.fseq[(t.name, il.link)]
                s["links"][(t.name, il.link)] = {
                    "seq": fs.query(),
                    "prod": jt.links[il.link].mcache.seq_query(),
                    "ovrnp": fs.diag(FSeq.DIAG_OVRNP_CNT),
                    "ovrnr": fs.diag(FSeq.DIAG_OVRNR_CNT),
                    "slow": fs.diag(FSeq.DIAG_SLOW_CNT),
                    "filt": fs.diag(FSeq.DIAG_FILT_CNT),
                }
        return s

    def render(prev, cur):
        dt = max((cur["t"] - prev["t"]) / 1e9, 1e-9)
        lines = [f"fdtpu monitor — {spec.app}  "
                 f"(interval {dt:.2f}s, ctrl-c to exit)", ""]
        lines.append(f"{'TILE':<14}{'STAT':<6}{'HB(ms)':>8}  busiest rates")
        for name, tv in cur["tiles"].items():
            pm = prev["tiles"][name]["m"]
            rates = sorted(
                ((k, (v - pm.get(k, 0)) / dt) for k, v in tv["m"].items()
                 if isinstance(v, int)),
                key=lambda kv: -abs(kv[1]))[:3]
            rstr = "  ".join(f"{k}={r:,.0f}/s" for k, r in rates if r)
            hb = f"{tv['hb_ms']:.0f}" if tv["hb_ms"] >= 0 else "-"
            lines.append(f"{name:<14}{tv['sig']:<6}{hb:>8}  {rstr}")
        lines.append("")
        lines.append(f"{'LINK (consumer)':<30}{'rate/s':>12}{'backlog':>9}"
                     f"{'ovrnp/s':>9}{'ovrnr/s':>9}{'slow/s':>9}")
        for key, lv in cur["links"].items():
            pv = prev["links"][key]
            tile, link = key
            lines.append(
                f"{link + ' -> ' + tile:<30}"
                f"{(lv['seq'] - pv['seq']) / dt:>12,.0f}"
                f"{max(0, lv['prod'] - lv['seq']):>9,}"
                f"{(lv['ovrnp'] - pv['ovrnp']) / dt:>9,.0f}"
                f"{(lv['ovrnr'] - pv['ovrnr']) / dt:>9,.0f}"
                f"{(lv['slow'] - pv['slow']) / dt:>9,.0f}")
        return lines

    import sys
    prev = sample()
    print("\x1b[2J", end="")                       # clear once
    n = 0
    try:
        while not args.count or n < args.count:
            time.sleep(args.interval)
            cur = sample()
            out = render(prev, cur)
            sys.stdout.write("\x1b[H")             # home, repaint in place
            for ln in out:
                sys.stdout.write(ln + "\x1b[K\n")  # clear line tails
            sys.stdout.write("\x1b[J")             # clear below
            sys.stdout.flush()
            prev = cur
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        jt.close()
    return 0


def cmd_trace(cfg, args):
    """Drain every tile's shm span ring of a running topology for
    --duration seconds, write Chrome trace_event JSON (load the file in
    Perfetto or chrome://tracing) and print the p50/p99-per-hop table
    (ref: fd_monitor's tsorig/tspub rendering, as a span timeline)."""
    import numpy as np
    from ..disco import trace as trace_mod
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    jt = _join(spec)
    chunks = {name: [] for name in jt.trace}
    cursors = dict.fromkeys(jt.trace, 0)
    try:
        deadline = time.monotonic() + args.duration
        while True:
            for name, ring in jt.trace.items():
                cursors[name], recs = ring.snapshot(since=cursors[name])
                if len(recs):
                    chunks[name].append(recs)
            if time.monotonic() >= deadline:
                break
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
    except KeyboardInterrupt:
        pass
    finally:
        jt.close()
    spans = {
        name: (np.concatenate(c) if c
               else np.empty(0, dtype=trace_mod.TRACE_REC_DTYPE))
        for name, c in chunks.items()}
    if getattr(args, "lane", ""):
        # verify-tile spans carry the lane tag in iidx's high bit
        # (trace.LANE_LAT); --lane lat keeps only low-latency-lane spans,
        # --lane bulk keeps everything else (stage spans are lane-less
        # and count as bulk)
        want = args.lane == "lat"
        spans = {
            name: recs[(recs["iidx"] & trace_mod.LANE_LAT != 0) == want]
            for name, recs in spans.items()}
    total = sum(len(v) for v in spans.values())
    if args.out:
        trace_mod.write_chrome_trace(args.out, spans)
        print(f"wrote {total} spans -> {args.out}", flush=True)
    print(trace_mod.hop_table(spans), flush=True)
    return 0


def cmd_top(cfg, args):
    """Live bottleneck attribution: per-tile regime split (busy/backp/
    house/idle from the mux's loop accounting), per-link lag + slow-
    consumer stall rates, and one "bottleneck: <link> (<reason>)"
    verdict line (ref: fd_monitor's fctl diag columns + the human
    squinting at them, monitor.c:49-160 — the squint is now code)."""
    import sys
    from ..disco import attrib
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    jt = _join(spec)
    try:
        prev = attrib.link_sample(jt)
        print("\x1b[2J", end="")                    # clear once
        n = 0
        while not args.count or n < args.count:
            time.sleep(args.interval)
            cur = attrib.link_sample(jt)
            sys.stdout.write("\x1b[H")              # home, repaint
            for ln in attrib.render_top(spec, prev, cur):
                sys.stdout.write(ln + "\x1b[K\n")   # clear line tails
            sys.stdout.write("\x1b[J")              # clear below
            sys.stdout.flush()
            prev = cur
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        jt.close()
    return 0


def cmd_slo(cfg, args):
    """Stage-budget SLO table: drain the span rings for --duration
    seconds, fold them into the named stage pipeline and grade each
    stage's p99 against its share of the e2e latency target, plus the
    window burn rate + trend (disco/slo.py)."""
    import numpy as np
    from ..disco import slo as slo_mod
    from ..disco import trace as trace_mod
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    target = args.target if args.target else float(
        cfg.get("observability", {}).get("slo_target_ms",
                                         slo_mod.DEFAULT_TARGET_MS))
    jt = _join(spec)
    chunks = {name: [] for name in jt.trace}
    cursors = dict.fromkeys(jt.trace, 0)
    kind_of = {t.name: t.kind for t in spec.tiles}
    try:
        deadline = time.monotonic() + args.duration
        while True:
            for name, ring in jt.trace.items():
                cursors[name], recs = ring.snapshot(since=cursors[name])
                if len(recs):
                    chunks[name].append(recs)
            if time.monotonic() >= deadline:
                break
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
    except KeyboardInterrupt:
        pass
    finally:
        jt.close()
    spans = {
        name: (np.concatenate(c) if c
               else np.empty(0, dtype=trace_mod.TRACE_REC_DTYPE))
        for name, c in chunks.items()}
    stats = slo_mod.stage_stats(spans, kind_of, target)
    burn = slo_mod.burn(spans, kind_of, target)
    print(slo_mod.render_table(stats, burn, target), flush=True)
    return 0 if all(r["ok"] for r in stats) else 1


def cmd_postmortem(cfg, args):
    """Render a flight-recorder bundle written by the supervisor on tile
    crash/degrade/respawn/SIGUSR2 (disco/flightrec.py): tile table, hop
    table, stage budgets, and the bottleneck verdict at time of death."""
    from ..disco import flightrec
    print(flightrec.render_bundle(args.bundle), flush=True)
    return 0


def cmd_ready(cfg, args):
    """Block until every tile of the running topology signals RUN (ref:
    `fdctl ready` — polls each tile's cnc, main1.c action table).  A
    workspace the supervisor has not created yet counts as not ready, so
    `ready` may be started together with `run`."""
    from ..tango.ring import Cnc
    from . import config as config_mod
    spec = config_mod.build_topology(cfg)
    deadline = time.monotonic() + args.timeout
    while True:
        try:
            jt = _join(spec)
            break
        except FileNotFoundError:
            if time.monotonic() > deadline:
                print(f"NOT READY: no workspace fdtpu_{spec.app}")
                return 1
            time.sleep(0.05)
    try:
        for name, cnc in jt.cnc.items():
            while cnc.signal_query() != Cnc.SIGNAL_RUN:
                if time.monotonic() > deadline:
                    print(f"NOT READY: {name}")
                    return 1
                time.sleep(0.05)
        print("ready")
        return 0
    finally:
        jt.close()


def cmd_keys(cfg, args):
    """`keys new PATH` writes a fresh identity keypair in the JSON format
    the sign tile reads (disco/keyguard.py) and prints its public key in
    hex; `keys pubkey PATH` prints the public key of one."""
    from ..disco import keyguard
    from ..ops import ed25519 as ed
    if args.action == "new":
        seed = os.urandom(32)
        pub, _, _ = ed.keypair_from_seed(seed)
        keyguard.keypair_write(args.path, seed, pub)
        print(pub.hex())
        return 0
    _, pub = keyguard.keypair_read(args.path)
    print(pub.hex())
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="fdtpuctl", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", help="TOML config overlaying the defaults")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("run")
    sp.add_argument("--boot-timeout", type=float, default=600.0)
    sub.add_parser("topo")
    sp = sub.add_parser("monitor")
    sp.add_argument("--interval", type=float, default=1.0)
    sp.add_argument("--count", type=int, default=0, help="0 = forever")
    sp.add_argument("--follow", action="store_true",
                    help="live in-place dashboard (fdctl monitor style)")
    sp = sub.add_parser(
        "trace", help="drain span rings -> Chrome trace JSON + hop table")
    sp.add_argument("--duration", type=float, default=2.0,
                    help="seconds to collect spans for")
    sp.add_argument("--out", default="",
                    help="write Chrome trace_event JSON here")
    sp.add_argument("--lane", default="", choices=["", "bulk", "lat"],
                    help="keep only one dispatch lane's spans (verify "
                         "tiles tag device/coalesce spans per lane)")
    sp = sub.add_parser(
        "top", help="live bottleneck attribution (per-tile regimes, "
                    "per-link lag/stalls, verdict line)")
    sp.add_argument("--interval", type=float, default=1.0)
    sp.add_argument("--count", type=int, default=0, help="0 = forever")
    sp = sub.add_parser(
        "slo", help="stage-budget table vs the e2e latency target")
    sp.add_argument("--duration", type=float, default=2.0,
                    help="seconds to collect spans for")
    sp.add_argument("--target", type=float, default=0.0,
                    help="e2e p99 target in ms (0 = config "
                         "[observability] slo_target_ms)")
    sp = sub.add_parser(
        "postmortem", help="render a flight-recorder crash bundle")
    sp.add_argument("bundle", help="bundle directory under flight_dir")
    sp = sub.add_parser(
        "drain", help="graceful quiesce: drain every tile in dependency "
                      "order, exit with all accepted txns verdicted")
    sp.add_argument("--timeout", type=float, default=0.0,
                    help="per-tile drain budget in seconds (0 = config "
                         "[supervision] drain_timeout_s, else 10)")
    sp = sub.add_parser("ready")
    sp.add_argument("--timeout", type=float, default=60.0)
    sp = sub.add_parser("keys", help="write or read an identity keypair")
    sp.add_argument("action", choices=["new", "pubkey"])
    sp.add_argument("path")
    args = p.parse_args(argv)

    from . import config as config_mod
    cfg = config_mod.load(args.config)
    return {
        "run": cmd_run, "topo": cmd_topo, "monitor": cmd_monitor,
        "trace": cmd_trace, "top": cmd_top, "slo": cmd_slo,
        "postmortem": cmd_postmortem, "drain": cmd_drain,
        "ready": cmd_ready, "keys": cmd_keys,
    }[args.cmd](cfg, args)


if __name__ == "__main__":
    sys.exit(main())
