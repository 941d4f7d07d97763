"""Supervised topology boot (ref: src/app/fdctl/run/run.c, clone per tile;
src/disco/topo/fd_topo_run.c:50-130, join wksps -> init -> run loop; the
pidns parent waits on children and tears the whole validator down if any
tile dies, run.c:279); the port's own copy of firedancer_tpu/disco/run.py.

One OS process per tile, started with multiprocessing 'spawn', never fork:
a tile process makes its own CUDA context, and the parent may hold one
already.  The shared-memory topology is joined by replaying the
deterministic layout; supervision reads child exit and cnc heartbeat
staleness (poll).  The response is policy-driven (SupervisionPolicy, the
[supervision] config section): `fail_fast` keeps the reference's
tear-everything-down behavior; `respawn` restarts the failed tile into
the SAME workspace with exponential backoff and jitter under a per-tile
restart budget, evicting the corpse's fseq credits while it is down so
producers don't stall.  A respawned verify tile makes a new CUDA context
and loads the kernels from the build cache.  Halt is cooperative: the
supervisor raises HALT on every cnc and joins, and a tile alive at the
halt that does not then exit 0 (its fini raised) makes the halt raise.
Drain quiesces the topology in dependency order so every admitted txn
gets its verdict before the halt.

Around the loop: the /metrics and /healthz endpoint (MetricsHttpServer),
the flight recorder (flight_dir: a bundle on crash, degrade, respawn and
SIGUSR2), rolling restarts, and the SIGTERM/SIGINT drain.  The JAX
package's autotuner is not ported: [autotune] enabled raises
NotImplementedError.
"""

import faulthandler
import json
import multiprocessing as mp
import os
import signal
import threading
import time
import zlib
from dataclasses import dataclass, field

from ..tango.fctl import Fctl
from ..tango.ring import Cnc
from ..utils import log
from . import topo as topo_mod
from .mux import Mux
from .topo import TopoSpec


@dataclass
class SupervisionPolicy:
    """Per-topology supervision knobs ([supervision] in config.py).

    Pickles into tile children (it rides in TopoRun's spawn args closure
    only on the supervisor side), so keep it plain data."""

    restart_policy: str = "fail_fast"   # fail_fast (ref run.c:279) | respawn
    max_restarts: int = 5               # per-tile budget under respawn
    backoff_initial_s: float = 0.25     # exponential: initial, cap, jitter
    backoff_max_s: float = 8.0
    backoff_jitter: float = 0.2         # +/- fraction of the delay
    boot_grace_s: float = 300.0         # no staleness checks while booting
    heartbeat_stale_s: float = 60.0     # default staleness -> failed
    heartbeat_stale_by_kind: dict = field(default_factory=dict)
    # graceful degradation (consumed by the verify tile's GuardedVerifier)
    device_fail_threshold: int = 3
    device_retry: int = 1
    device_deadline_s: float = 30.0
    device_reprobe_s: float = 5.0
    # drain protocol: per-tile graceful-quiesce budget for rolling
    # restarts and SIGTERM/SIGINT topology drains.  0 (the default)
    # keeps drain disarmed: crash-respawn and the plain halt only.
    drain_timeout_s: float = 0.0
    drain_manifest_dir: str = ""

    @classmethod
    def from_cfg(cls, cfg: dict) -> "SupervisionPolicy":
        sup = dict(cfg.get("supervision") or {})
        by_kind = {k: float(v)
                   for k, v in (sup.get("heartbeat_stale") or {}).items()}
        return cls(
            restart_policy=str(sup.get("restart_policy", "fail_fast")),
            max_restarts=int(sup.get("max_restarts", 5)),
            backoff_initial_s=float(sup.get("backoff_initial_s", 0.25)),
            backoff_max_s=float(sup.get("backoff_max_s", 8.0)),
            backoff_jitter=float(sup.get("backoff_jitter", 0.2)),
            boot_grace_s=float(sup.get("boot_grace_s", 300.0)),
            heartbeat_stale_s=float(sup.get("heartbeat_stale_s", 60.0)),
            heartbeat_stale_by_kind=by_kind,
            device_fail_threshold=int(sup.get("device_fail_threshold", 3)),
            device_retry=int(sup.get("device_retry", 1)),
            device_deadline_s=float(sup.get("device_deadline_s", 30.0)),
            device_reprobe_s=float(sup.get("device_reprobe_s", 5.0)),
            drain_timeout_s=float(sup.get("drain_timeout_s", 0.0)),
            drain_manifest_dir=str(sup.get("drain_manifest_dir", "")))

    def stale_ns(self, kind: str | None = None) -> int:
        """Heartbeat staleness threshold for a tile kind (verify tiles
        doing uncached device dispatches legitimately stall longer than
        net/sink tiles, so [supervision.heartbeat_stale] overrides the
        default per kind)."""
        s = self.heartbeat_stale_by_kind.get(kind, self.heartbeat_stale_s)
        return int(s * 1e9)

    def backoff_s(self, attempt: int, tile_name: str = "") -> float:
        """Exponential backoff with deterministic per-(tile, attempt)
        jitter — reproducible chaos runs need a reproducible supervisor,
        so the jitter is a hash, not an rng draw."""
        base = min(self.backoff_initial_s * (2 ** max(0, attempt - 1)),
                   self.backoff_max_s)
        if not self.backoff_jitter:
            return base
        h = zlib.crc32(f"{tile_name}#{attempt}".encode()) / 0xFFFFFFFF
        return base * (1.0 + self.backoff_jitter * (2.0 * h - 1.0))


def dependency_order(spec: TopoSpec) -> list[str]:
    """Tiles in producer->consumer topological order (source first):
    draining in this order parks each tile's upstream before the tile
    itself, so its DRAIN admission snapshot covers everything ever
    published to it and the quiesce runs genuinely dry."""
    prod = {}
    for t in spec.tiles:
        for ln in t.out_links:
            prod[ln] = t.name
    deps = {t.name: {prod[il.link] for il in t.in_links
                     if il.link in prod and prod[il.link] != t.name}
            for t in spec.tiles}
    order: list[str] = []
    done: set[str] = set()
    while len(order) < len(deps):
        ready = [t.name for t in spec.tiles
                 if t.name not in done and deps[t.name] <= done]
        if not ready:  # cycle: fall back to spec order
            ready = [t.name for t in spec.tiles if t.name not in done]
        order += ready
        done.update(ready)
    return order


def _tile_main(spec: TopoSpec, tile_name: str, restart_cnt: int = 0):
    """Child entry: join the workspace, build the vtable, run the mux loop
    (restart_cnt > 0: a respawn, which resumes its in-links from the fseq
    cursors).  The tile's cfg goes to it unchanged: a verify tile's
    `device` None is the GPU, and with no GPU its boot raises, so
    wait_ready reports the tile as died during boot."""
    from .tiles import TILES
    # log attribution: every record from this process carries tile name +
    # restart generation, so a respawned child's lines are separable from
    # its corpse's in an interleaved supervisor log
    log.set_context(tile_name, restart_cnt)
    # SIGUSR1 dumps every thread's stack to stderr without stopping the
    # tile, to inspect a live or wedged topology
    faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    jt = topo_mod.join(spec)
    vt = None
    try:
        ts = jt.tile_spec(tile_name)
        # per-tile CPU pin (the [layout] affinity knob, threaded in by
        # topo.assign_affinity); modulo cpu_count so a layout written for a
        # bigger host still boots on a smaller one
        cpu = ts.cfg.get("cpu_idx")
        if cpu is not None and hasattr(os, "sched_setaffinity"):
            try:
                os.sched_setaffinity(0, {int(cpu) % os.cpu_count()})
            except OSError:
                log.warning("tile %s: cpu pin %s failed", tile_name, cpu)
        vt = TILES[ts.kind]()
        Mux(jt, tile_name, vt, restart_cnt=restart_cnt).run()
    finally:
        # drop tile-held dcache views (packed-wire tiles pin row views)
        # before the workspace unmaps
        vt = None
        jt.close()


class MetricsHttpServer:
    """In-process Prometheus scrape target over a joined topology.

    GET /metrics — text exposition of every tile's shm metrics block
    (counters, gauges, and le-bucketed histograms) plus the per-link
    attribution families.  GET /healthz — the states of health() (ref:
    fd_metric.c's http listener plus the fdctl status probe, folded into
    one endpoint):

        503 "unhealthy\\n<tiles>"  a tile is not in RUN or its heartbeat
                                  is stale (per-kind threshold when a
                                  SupervisionPolicy is supplied)
        200 "degraded\\n<tiles>"  every tile is live but a verify tile is
                                  serving verdicts off the CPU fallback
                                  (degraded_mode gauge set) — the load
                                  balancer should keep routing, the
                                  operator should look
        200 "shedding\\n<tiles>"  every tile is live and verifying, but a
                                  front-door tile is actively shedding
                                  load — capacity alarm, not an outage
        200 "draining\\n<tiles>"  a tile is mid drain and heartbeating
        200 "ok\\n"               fully healthy

    Each body ends with the SLO one-liner (disco/slo.py healthz_field).
    clock_ns is the clock heartbeats are stamped with (tests pass a fake
    one).  Runs on a daemon thread: readers only touch shm, never the
    tile loops.
    """

    def __init__(self, jt, host: str = "127.0.0.1", port: int = 0,
                 stale_ns: int = 60_000_000_000,
                 policy: "SupervisionPolicy | None" = None,
                 slo_target_ms: float = 2.0, clock_ns=time.monotonic_ns):
        import http.server
        from . import attrib
        from . import metrics as metrics_mod

        self.jt = jt
        self.policy = policy
        self.stale_ns = stale_ns
        self.slo_target_ms = slo_target_ms
        self.clock_ns = clock_ns
        self._kinds = {t.name: t.kind for t in jt.spec.tiles}
        # supervisor-side extra metric families (flightrec evictions,
        # torn drain manifests): installed after construction via
        # `self.extra_fn = callable -> iterable of prometheus_render
        # extra tuples`
        self.extra_fn = None
        srv = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                ctype = "text/plain"
                if path == "/healthz":
                    code, body = srv.health()
                elif path in ("/", "/metrics"):
                    code = 200
                    try:
                        extra = list(attrib.link_families(jt))
                        if srv.extra_fn is not None:
                            extra += list(srv.extra_fn())
                    except Exception:
                        extra = None
                    body = metrics_mod.prometheus_render(
                        jt.metrics, extra=extra).encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    code, body = 404, b"not found\n"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes arrive every few seconds
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port), H)
        self.port = self.httpd.server_address[1]  # resolved when port=0
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, name="fdtpu:metrics-http",
            daemon=True)
        self.thread.start()

    def _stale(self, name: str) -> int:
        if self.policy is not None:
            return self.policy.stale_ns(self._kinds.get(name))
        return self.stale_ns

    def _slo_line(self) -> bytes:
        # degraded latency visible without a trace dump; guarded — a
        # scrape must never take the health endpoint down
        from . import slo as slo_mod
        try:
            return (slo_mod.healthz_field(self.jt, self.slo_target_ms)
                    + "\n").encode()
        except Exception:
            return b"slo unavailable\n"

    def health(self) -> tuple[int, bytes]:
        """(HTTP status, body) of /healthz, from the cnc lines and the
        metrics blocks as they stand."""
        jt = self.jt
        bad, degraded, shedding, draining = [], [], [], []
        for name, cnc in jt.cnc.items():
            sig = cnc.signal_query()
            if sig in (Cnc.SIGNAL_DRAIN, Cnc.SIGNAL_DRAINED):
                # mid-drain (rolling restart / graceful shutdown): live
                # by construction while heartbeating — an operational
                # event, not an outage
                hb = cnc.heartbeat_query()
                if hb and self.clock_ns() - hb > self._stale(name):
                    bad.append(f"{name}: stale heartbeat (draining)")
                else:
                    draining.append(name)
                continue
            if sig != Cnc.SIGNAL_RUN:
                bad.append(f"{name}: signal={sig}")
                continue
            hb = cnc.heartbeat_query()
            if hb and self.clock_ns() - hb > self._stale(name):
                bad.append(f"{name}: stale heartbeat")
                continue
            blk = jt.metrics.get(name)
            if blk is None:
                continue
            if blk.has("degraded_mode") and blk.get("degraded_mode"):
                degraded.append(name)
            if blk.has("shedding") and blk.get("shedding"):
                shedding.append(name)
        if bad:
            return 503, ("unhealthy\n" + "\n".join(bad)
                         + "\n").encode() + self._slo_line()
        if degraded:
            return 200, ("degraded\n" + "\n".join(degraded)
                         + "\n").encode() + self._slo_line()
        if shedding:
            # front-door overload shed: still serving — capacity signal
            return 200, ("shedding\n" + "\n".join(shedding)
                         + "\n").encode() + self._slo_line()
        if draining:
            return 200, ("draining\n" + "\n".join(draining)
                         + "\n").encode() + self._slo_line()
        return 200, b"ok\n" + self._slo_line()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class TopoRun:
    """Handle to a running topology (the supervisor side).  clock_ns is
    the clock poll() and /healthz compare cnc heartbeats against (the
    tiles stamp time.monotonic_ns; tests pass a fake one)."""

    HEARTBEAT_STALE_NS = 60_000_000_000  # 60s (uncached device dispatches
    # can stall a Python tile loop for seconds; kernel builds run pre-RUN)

    def __init__(self, spec: TopoSpec, start: bool = True,
                 metrics_port: int | None = None,
                 policy: SupervisionPolicy | None = None,
                 flight_dir: str = "", slo_target_ms: float = 2.0,
                 config: dict | None = None, clock_ns=time.monotonic_ns):
        if int(((config or {}).get("autotune") or {}).get("enabled", 0)
               or 0):
            raise NotImplementedError(
                "[autotune] enabled: the Autotuner (disco/autotune.py) is "
                "not ported")
        self.spec = spec.validate()
        self.jt = topo_mod.create(spec)
        self.procs: dict[str, mp.process.BaseProcess] = {}
        self._mpctx = mp.get_context("spawn")
        self.policy = policy or SupervisionPolicy(
            heartbeat_stale_s=self.HEARTBEAT_STALE_NS / 1e9)
        self._clock_ns = clock_ns
        self._kind = {t.name: t.kind for t in self.spec.tiles}
        self.restarts: dict[str, int] = {}      # respawns done per tile
        self._boot_deadline: dict[str, float] = {}
        self._evicting: set[str] = set()        # respawned, not yet RUN
        self._draining: set[str] = set()        # mid drain
        self._drain_req = False                 # SIGTERM/SIGINT -> drain
        self._halting = False
        self.exitcodes: dict[str, int | None] = {}   # set by halt()
        # flight recorder ([observability] flight_dir): postmortem
        # bundles on crash/degrade/respawn/SIGUSR2; "" disables
        self.flight_dir = flight_dir
        self.slo_target_ms = slo_target_ms
        self.config = config
        self.events: list[str] = []             # supervisor event log
        self._dump_req = False                  # SIGUSR2 -> dump next scan
        self._degraded: set[str] = set()        # tiles seen in degraded
        obs = (config or {}).get("observability") or {}
        self.flight_max_bundles = int(obs.get("flight_max_bundles", 16))
        self._flight_evicts = 0                 # bundles rotated away
        self.manifest_corrupt_cnt = 0           # torn drain receipts seen
        self._saved_signals: dict = {}          # restored by close()
        if flight_dir:
            self._install_dump_signal()
        if self.policy.drain_timeout_s > 0:
            self._install_term_signals()
        # metrics_port: None = no http endpoint, 0 = ephemeral (resolved
        # port on self.metrics_port), N = fixed
        self.http: MetricsHttpServer | None = None
        if metrics_port is not None:
            self.http = MetricsHttpServer(
                self.jt, port=metrics_port,
                stale_ns=self.HEARTBEAT_STALE_NS, policy=self.policy,
                slo_target_ms=slo_target_ms, clock_ns=clock_ns)
            self.http.extra_fn = self._extra_families
        if start:
            self.start()

    def _extra_families(self):
        """Supervisor-side metric families for the /metrics endpoint."""
        return [("fdtpu_flightrec_evict_cnt", "counter",
                 "flight bundles rotated away (flight_max_bundles)", {},
                 self._flight_evicts),
                ("fdtpu_manifest_corrupt_cnt", "counter",
                 "drain manifests rejected as torn/corrupt (crash-eviction "
                 "fallback taken)", {}, self.manifest_corrupt_cnt)]

    def _load_drain_manifest(self, name: str):
        """Load + validate `name`'s drain-cursor manifest (written by the
        mux at DRAINED — disco/mux.py _write_drain_manifest).

        Returns the manifest dict, None if no manifest dir is configured
        or the file simply doesn't exist, or raises ValueError if the
        file is present but torn/corrupt — truncated JSON, wrong tile,
        non-integer cursors.  The caller treats corrupt as a failed
        drain receipt: bounded-loss crash-eviction respawn instead of
        trusting cursors that may describe a different (or partial)
        quiesce point; duplicates stay impossible because the crash path
        never rewinds consumer fseqs."""
        d = self.policy.drain_manifest_dir or os.environ.get(
            "FDTPU_DRAIN_DIR", "")
        if not d:
            return None
        path = os.path.join(d, name.replace(":", "_") + ".manifest.json")
        try:
            with open(path) as f:
                raw = f.read()
        except OSError:
            return None
        try:
            m = json.loads(raw)
        except ValueError as e:
            raise ValueError(f"torn JSON: {e}") from None
        if not isinstance(m, dict) or m.get("tile") != name:
            raise ValueError("manifest tile mismatch")
        for sect in ("cursors", "outs"):
            c = m.get(sect)
            if not isinstance(c, dict) or not all(
                    isinstance(v, int) and v >= 0 for v in c.values()):
                raise ValueError(f"bad {sect} table")
        return m

    def _bind(self, signum, handler):
        self._saved_signals.setdefault(signum, signal.getsignal(signum))
        signal.signal(signum, handler)

    def _install_dump_signal(self):
        """SIGUSR2 -> write a bundle at the next supervision scan (an
        operator snapshot of a LIVE topology; signals only bind in the
        main thread, and a test-thread supervisor just won't have the
        hook)."""
        if threading.current_thread() is not threading.main_thread():
            return
        self._bind(signal.SIGUSR2,
                   lambda *_: setattr(self, "_dump_req", True))

    def _install_term_signals(self):
        """SIGTERM/SIGINT -> graceful topology drain at the next
        supervision scan, instead of the abrupt child kill the default
        handlers produce.  Only armed when [supervision] drain_timeout_s
        is set (drain configured), and only in the main thread — same
        constraint as the SIGUSR2 hook.  SIGUSR2 keeps working mid-drain:
        the dump request is checked every scan, including the drain
        pass."""
        if threading.current_thread() is not threading.main_thread():
            return

        def _req(signum, _frame):
            # second signal = operator insisting: restore the default
            # and let it through (abrupt teardown escape hatch)
            self._drain_req = True
            signal.signal(signum, signal.SIG_DFL)

        self._bind(signal.SIGTERM, _req)
        self._bind(signal.SIGINT, _req)

    def _restore_signals(self):
        if threading.current_thread() is not threading.main_thread():
            return
        for signum, old in self._saved_signals.items():
            signal.signal(signum, old)
        self._saved_signals = {}

    def _log_event(self, msg: str):
        self.events.append(
            f"{time.strftime('%H:%M:%S', time.gmtime())} {msg}")
        del self.events[:-500]  # bounded: the bundle tails it anyway

    def flight_dump(self, reason: str, tile: str = "") -> str | None:
        """Write a postmortem bundle (no-op without flight_dir); never
        raises — the flight recorder must not take the supervisor down
        with it."""
        if not self.flight_dir:
            return None
        try:
            from . import flightrec
            path = flightrec.write_bundle(
                self.flight_dir, self.jt, reason=reason, tile=tile,
                restarts=self.restarts, config=self.config,
                events=self.events)
            self._flight_evicts += flightrec.rotate(
                self.flight_dir, self.flight_max_bundles)
            self._log_event(f"flight bundle {reason} -> {path}")
            log.warning("flight recorder: %s bundle -> %s", reason, path)
            return path
        except Exception as e:  # pragma: no cover - defensive
            log.warning("flight recorder failed (%s): %s", reason, e)
            return None

    @property
    def metrics_port(self) -> int | None:
        return self.http.port if self.http is not None else None

    def start(self):
        for t in self.spec.tiles:
            self._spawn(t.name)

    def _spawn(self, name: str, restart_cnt: int = 0):
        cnc = self.jt.cnc[name]
        if restart_cnt:
            # the corpse may have died in RUN with a stale heartbeat; a
            # respawn must present as BOOTING (health checks and poll()
            # apply boot-grace, not staleness, until it signals RUN)
            cnc.signal(Cnc.SIGNAL_BOOT)
            cnc.heartbeat(self._clock_ns())
        p = self._mpctx.Process(
            target=_tile_main, args=(self.spec, name, restart_cnt),
            name=f"fdtpu:{name}", daemon=True)
        p.start()
        self.procs[name] = p
        self._log_event(f"spawn {name} gen={restart_cnt} pid={p.pid}")
        self._boot_deadline[name] = time.monotonic() + self.policy.boot_grace_s

    # -- supervision ------------------------------------------------------
    def wait_ready(self, timeout: float = 120.0):
        """Block until every tile signals RUN (ref fd_cnc wait in topo boot)."""
        if not self.procs:
            raise RuntimeError(
                "topology not started (constructed with start=False; "
                "call start() first)")
        deadline = time.monotonic() + timeout
        for name, cnc in self.jt.cnc.items():
            while cnc.signal_query() != Cnc.SIGNAL_RUN:
                if not self.procs[name].is_alive():
                    raise RuntimeError(f"tile {name} died during boot")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"tile {name} failed to boot")
                time.sleep(0.01)

    def poll(self) -> str | None:
        """One supervision scan; returns the name of a failed tile or None.

        Failure = dead process, heartbeat older than the per-kind
        staleness threshold (policy.stale_ns), or a tile wedged in BOOT
        past its boot-grace window.  A booting tile is exempt from
        heartbeat staleness — kernel builds happen pre-RUN."""
        now_ns = self._clock_ns()
        now = time.monotonic()
        for name, p in list(self.procs.items()):
            if name in self._draining:
                # mid drain or rolling restart: the tile is intentionally
                # parked (or reaped, between HALT and respawn) — the
                # drain path owns its lifecycle and bounds it with
                # drain_timeout_s
                continue
            if not p.is_alive():
                return name
            cnc = self.jt.cnc[name]
            sig = cnc.signal_query()
            if sig in (Cnc.SIGNAL_DRAIN, Cnc.SIGNAL_DRAINED):
                # draining outside the supervisor's own bookkeeping
                # (operator signal): live while heartbeating
                hb = cnc.heartbeat_query()
                if hb and now_ns - hb > self.policy.stale_ns(
                        self._kind.get(name)):
                    return name
                continue
            if sig != Cnc.SIGNAL_RUN:
                bd = self._boot_deadline.get(name)
                if bd is not None and now > bd:
                    return name
                continue
            hb = cnc.heartbeat_query()
            if hb and now_ns - hb > self.policy.stale_ns(self._kind.get(name)):
                return name
        return None

    def supervise(self, poll_s: float = 0.1):
        """Run the supervision loop.

        fail_fast (default, ref run.c:279): return the first failed tile
        and tear everything down.  respawn: restart the failed tile with
        exponential backoff + jitter until its restart budget is spent,
        evicting its consumer fseqs while it is down so producers don't
        stall on the corpse's frozen credits; over-budget failures fall
        back to fail_fast.  Returns the tile that exhausted the policy,
        or None if halted or drained (SIGTERM/SIGINT with drain
        configured, or a _drain_req set by the caller)."""
        try:
            while True:
                if self._halting:
                    return None
                if self._dump_req:
                    self._dump_req = False
                    self.flight_dump("sigusr2")
                if self._drain_req:
                    # SIGTERM/SIGINT with drain configured: quiesce the
                    # whole topology in dependency order, then halt
                    self._drain_req = False
                    self._log_event("signal-initiated topology drain")
                    self.drain()
                    return None
                self._scan_degraded()
                # a freshly respawned tile consumes nothing until it is
                # RUN: keep acking its in-links on its behalf (its mux
                # resumes from the fseq cursor we advance, so nothing is
                # double-processed)
                for name in list(self._evicting):
                    if self.jt.cnc[name].signal_query() == Cnc.SIGNAL_RUN:
                        self._evicting.discard(name)
                    else:
                        self.evict_consumer(name)
                bad = self.poll()
                if bad is None:
                    time.sleep(poll_s)
                    continue
                n = self.restarts.get(bad, 0)
                if (self.policy.restart_policy != "respawn"
                        or n >= self.policy.max_restarts):
                    log.warning("tile %s failed (restarts=%d); tearing "
                                "down topology", bad, n)
                    self._log_event(f"tile {bad} failed (restarts={n}); "
                                    "fail-fast teardown")
                    # evidence BEFORE teardown: halt() wipes the cnc
                    # states and the respawned world never comes
                    self.flight_dump("crash", bad)
                    return bad
                self.respawn(bad)
        finally:
            self.halt()

    def _scan_degraded(self):
        """Dump a bundle once per 0->1 degraded_mode transition (a verify
        tile fell back to CPU serving: the device-loss evidence is the
        trace/metrics state at the moment it happened)."""
        for name, blk in self.jt.metrics.items():
            if not blk.has("degraded_mode"):
                continue
            if blk.get("degraded_mode"):
                if name not in self._degraded:
                    self._degraded.add(name)
                    self._log_event(f"tile {name} degraded (CPU fallback)")
                    self.flight_dump("degrade", name)
            else:
                self._degraded.discard(name)

    def respawn(self, name: str):
        """Kill + restart one tile into the live workspace: reap the
        corpse, wait out the backoff window (evicting the dead consumer's
        fseqs the whole time), then respawn.  The child re-joins by
        deterministic layout replay and resumes its in-links from the
        persisted fseq cursors — frags published during the outage were
        acked by eviction and are lost to this tile (the reference's
        unreliable-consumer overrun semantics for the outage window); no
        frag is ever processed twice."""
        n = self.restarts.get(name, 0) + 1
        self.restarts[name] = n
        # snapshot BEFORE the respawn: the child re-joins the same trace
        # ring and will overwrite the corpse's final spans
        self._log_event(f"tile {name} died; respawn {n}"
                        f"/{self.policy.max_restarts}")
        self.flight_dump("respawn", name)
        p = self.procs.get(name)
        if p is not None and p.is_alive():
            # stale-heartbeat (wedged) failure: the process is live but
            # catatonic — take it down hard before replacing it
            p.terminate()
            p.join(2.0)
            if p.is_alive():
                p.kill()
                p.join(1.0)
        delay = self.policy.backoff_s(n, name)
        log.warning("tile %s died; respawn %d/%d in %.2fs", name, n,
                    self.policy.max_restarts, delay)
        deadline = time.monotonic() + delay
        self.evict_consumer(name)
        while time.monotonic() < deadline and not self._halting:
            time.sleep(0.02)
            self.evict_consumer(name)
        if self._halting:
            return
        self._spawn(name, restart_cnt=n)
        self._evicting.add(name)

    def evict_consumer(self, name: str):
        """Fast-forward a dead consumer's reliable fseqs to the producer
        cursors so upstream credits refill (tango-layer eviction)."""
        for il, fseq, mcache in self.jt.consumer_edges(name):
            if il.reliable:
                Fctl.evict_dead_consumer(fseq, mcache)

    # -- drain protocol (graceful quiesce + rolling restart) --------------
    def drain_tile(self, name: str, timeout_s: float) -> bool:
        """Raise SIGNAL_DRAIN on one tile and wait (bounded) for its
        DRAINED ack.  Returns False on timeout or if the tile died
        mid-drain — the caller decides the fallback (crash-respawn
        semantics); this never hangs."""
        cnc = self.jt.cnc[name]
        cnc.signal(Cnc.SIGNAL_DRAIN)
        self._log_event(f"drain {name} (budget {timeout_s:.1f}s)")
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            sig = cnc.signal_query()
            if sig == Cnc.SIGNAL_DRAINED:
                return True
            if sig == Cnc.SIGNAL_RUN:
                # a tile that was mid-boot when we raised DRAIN stamps
                # RUN over it on loop entry; only boot writes RUN, so
                # seeing it here means the request was lost — re-assert
                cnc.signal(Cnc.SIGNAL_DRAIN)
            p = self.procs.get(name)
            if p is not None and not p.is_alive():
                return False
            if self._dump_req:   # SIGUSR2 still works mid-drain
                self._dump_req = False
                self.flight_dump("sigusr2")
            time.sleep(0.005)
        return cnc.signal_query() == Cnc.SIGNAL_DRAINED

    def _retile(self, name: str, new_cfg: dict):
        """Swap restart-required cfg keys into a tile's spec.  The
        workspace layout derives only from links and tile/in-link counts
        — never tile cfg — so a successor spawned from the new spec
        re-joins identical shm offsets with different private objects
        (n_buffers, max_inflight, cpu_idx, latency shapes, buckets)."""
        tiles = []
        for t in self.spec.tiles:
            if t.name == name:
                cfg = dict(t.cfg)
                cfg.update(new_cfg)
                t = topo_mod.TileSpec(t.name, t.kind, t.in_links,
                                      t.out_links, cfg)
            tiles.append(t)
        self.spec = TopoSpec(self.spec.app, self.spec.links, tuple(tiles),
                             self.spec.wksp_mb).validate()
        # supervisor-side lookups (tile_spec, consumer_edges) follow the
        # new spec; the joined rings themselves are untouched
        self.jt.spec = self.spec

    def rolling_restart(self, name: str, new_cfg: dict | None = None,
                        drain_timeout_s: float | None = None) -> bool:
        """Zero-loss tile restart: drain, reap, re-layout the tile's
        private objects with changed immutable knobs, respawn from the
        cursor manifest.

        The tile is drained (bounded by drain_timeout_s, default the
        policy's), HALTed out of its DRAINED park and joined; restart-
        required cfg keys are swapped via _retile; the successor then
        resumes every in-link from the drained fseq cursor — no frag is
        lost or re-verdicted, and upstream credits were parked (never
        evicted), so producers stall at most drain + respawn-boot.

        On drain timeout (or death mid-drain) the tile gets a flight
        bundle and falls back to crash-respawn semantics — terminate,
        evict-while-down, backoff respawn; frags published during the
        outage are acked on its behalf and lost to it, exactly as a
        crash.  Returns True on the graceful path."""
        t = (self.policy.drain_timeout_s if drain_timeout_s is None
             else float(drain_timeout_s))
        self._draining.add(name)
        try:
            ok = self.drain_tile(name, t)
            if ok:
                # validate the drain receipt: a torn/corrupt cursor
                # manifest means the quiesce point on disk can't be
                # trusted — fall back to the crash-eviction respawn path
                # (bounded loss; never duplicate verdicts) instead of
                # raising in the supervisor
                try:
                    self._load_drain_manifest(name)
                except ValueError as e:
                    self.manifest_corrupt_cnt += 1
                    self._log_event(
                        f"tile {name} drain manifest corrupt ({e}); "
                        f"crash-eviction fallback")
                    log.warning("tile %s drain manifest corrupt (%s); "
                                "falling back to crash respawn", name, e)
                    ok = False
            if new_cfg:
                self._retile(name, new_cfg)
            if not ok:
                self._log_event(f"tile {name} drain timeout "
                                f"({t:.1f}s); falling back to respawn")
                log.warning("tile %s drain timed out after %.1fs; "
                            "crash-respawn fallback", name, t)
                self.flight_dump("drain-timeout", name)
                self.respawn(name)
                return False
            n = self.restarts.get(name, 0) + 1
            self.restarts[name] = n
            self._log_event(f"tile {name} drained; rolling restart "
                            f"gen={n}")
            cnc = self.jt.cnc[name]
            cnc.signal(Cnc.SIGNAL_HALT)
            p = self.procs.get(name)
            if p is not None:
                p.join(5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(2.0)
                    if p.is_alive():
                        p.kill()
                        p.join(1.0)
            self._spawn(name, restart_cnt=n)
            return True
        finally:
            self._draining.discard(name)

    def drain(self, timeout_s: float | None = None) -> bool:
        """Graceful whole-topology shutdown: quiesce source -> verify ->
        dedup -> sink in dependency order so every accepted txn is
        verdicted before exit, then halt.  Per-tile budget timeout_s
        (default the policy's drain_timeout_s; 0 skips the drain); a tile
        that cannot run dry inside its budget gets a flight bundle and
        the rest of the topology degrades to the plain cooperative halt:
        bounded, never a hang.  Returns True iff every tile drained;
        raises as halt() does when a tile does not exit cleanly."""
        t = (self.policy.drain_timeout_s if timeout_s is None
             else float(timeout_s))
        ok = True
        if t > 0:
            for name in dependency_order(self.spec):
                p = self.procs.get(name)
                if p is None or not p.is_alive():
                    continue
                self._draining.add(name)
                if self.drain_tile(name, t):
                    self._log_event(f"tile {name} drained")
                else:
                    log.warning("tile %s did not drain in %.1f s; "
                                "cooperative halt", name, t)
                    self._log_event(f"drain timeout: {name}; degrading "
                                    "to cooperative halt")
                    self.flight_dump("drain-timeout", name)
                    ok = False
                    break
        try:
            self.halt()
        finally:
            self._draining.clear()
        return ok

    def metrics(self, tile: str) -> dict:
        return self.jt.metrics[tile].snapshot()

    # -- shutdown ---------------------------------------------------------
    def halt(self, timeout: float = 10.0) -> dict:
        """Raise HALT on every cnc and join every tile (terminate, then
        kill, a tile that does not come down in `timeout`).  Records each
        tile's exit code in self.exitcodes and returns it: a tile that a
        respawn replaced is judged by its last incarnation.  A tile that
        was alive at the halt and did not exit 0 raises RuntimeError: its
        fini failed (a device error at the last flush, say), or it had to
        be killed.  A tile that had died before the halt is poll()'s to
        report, and does not raise here."""
        self._halting = True
        alive = {n for n, p in self.procs.items() if p.is_alive()}
        for cnc in self.jt.cnc.values():
            cnc.signal(Cnc.SIGNAL_HALT)
        deadline = time.monotonic() + timeout
        for name, p in self.procs.items():
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(1.0)
                if p.is_alive():
                    p.kill()
                    p.join(1.0)
        self.exitcodes = {n: p.exitcode for n, p in self.procs.items()}
        bad = {n: c for n, c in self.exitcodes.items()
               if n in alive and c != 0}
        if bad:
            raise RuntimeError(f"tiles did not exit cleanly at halt "
                               f"(name: exit code): {bad}")
        return self.exitcodes

    def close(self) -> dict:
        """halt(), then stop the /metrics endpoint, put back the signal
        handlers this run bound, and unmap and unlink the workspace (also
        when the halt raises)."""
        try:
            return self.halt()
        finally:
            if self.http is not None:
                self.http.close()
                self.http = None
            self._restore_signals()
            self.jt.close()
            self.jt.unlink()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
