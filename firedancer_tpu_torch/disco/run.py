"""Supervised topology boot (ref: src/app/fdctl/run/run.c, clone per tile;
src/disco/topo/fd_topo_run.c:50-130, join wksps -> init -> run loop); the
port's own copy of firedancer_tpu/disco/run.py's boot, poll, drain and
halt.

One OS process per tile, started with multiprocessing 'spawn', never fork:
a tile process makes its own CUDA context, and the parent may hold one
already.  The shared-memory topology is joined by replaying the
deterministic layout; supervision reads child exit and cnc heartbeat
staleness (poll), and halt is cooperative: the supervisor raises HALT on
every cnc and joins, and a tile that does not then exit 0 (its fini
raised) makes the halt raise.  Drain quiesces the topology in dependency order so
every admitted txn gets its verdict before the halt.

Not ported yet (they raise NotImplementedError where an option asks for
them): the supervise loop with respawn and rolling restart, the signal
handlers, the /metrics endpoint, the flight recorder and the autotuner.
"""

import faulthandler
import json
import multiprocessing as mp
import os
import signal
import time
from dataclasses import dataclass, field

from ..tango.ring import Cnc
from ..utils import log
from . import topo as topo_mod
from .mux import Mux
from .topo import TopoSpec


@dataclass
class SupervisionPolicy:
    """Per-topology supervision knobs ([supervision] in config.py), the
    ones the port reads: the JAX package's respawn budget and backoff and
    its GuardedVerifier knobs belong to code the port does not have, and
    config.load refuses them.

    Pickles into tile children (it rides in TopoRun's spawn args closure
    only on the supervisor side), so keep it plain data."""

    restart_policy: str = "fail_fast"   # fail_fast (ref run.c:279); respawn
                                        # is not ported and is refused
    boot_grace_s: float = 300.0         # no staleness checks while booting
    heartbeat_stale_s: float = 60.0     # default staleness -> failed
    heartbeat_stale_by_kind: dict = field(default_factory=dict)
    # drain protocol: per-tile graceful-quiesce budget of drain().  0 (the
    # default) keeps drain disarmed: drain() is then a plain halt.
    drain_timeout_s: float = 0.0
    drain_manifest_dir: str = ""

    @classmethod
    def from_cfg(cls, cfg: dict) -> "SupervisionPolicy":
        sup = dict(cfg.get("supervision") or {})
        by_kind = {k: float(v)
                   for k, v in (sup.get("heartbeat_stale") or {}).items()}
        return cls(
            restart_policy=str(sup.get("restart_policy", "fail_fast")),
            boot_grace_s=float(sup.get("boot_grace_s", 300.0)),
            heartbeat_stale_s=float(sup.get("heartbeat_stale_s", 60.0)),
            heartbeat_stale_by_kind=by_kind,
            drain_timeout_s=float(sup.get("drain_timeout_s", 0.0)),
            drain_manifest_dir=str(sup.get("drain_manifest_dir", "")))

    def stale_ns(self, kind: str | None = None) -> int:
        """Heartbeat staleness threshold for a tile kind (verify tiles
        doing uncached device dispatches legitimately stall longer than
        net/sink tiles, so [supervision.heartbeat_stale] overrides the
        default per kind)."""
        s = self.heartbeat_stale_by_kind.get(kind, self.heartbeat_stale_s)
        return int(s * 1e9)


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


def _tile_main(spec: TopoSpec, tile_name: str):
    """Child entry: join the workspace, build the vtable, run the mux loop.
    The tile's cfg goes to it unchanged: a verify tile's `device` None is
    the GPU, and with no GPU its boot raises, so wait_ready reports the
    tile as died during boot."""
    from .tiles import TILES
    log.set_context(tile_name, 0)
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
        Mux(jt, tile_name, vt).run()
    finally:
        # drop tile-held dcache views (packed-wire tiles pin row views)
        # before the workspace unmaps
        vt = None
        jt.close()


class TopoRun:
    """Handle to a running topology (the supervisor side)."""

    HEARTBEAT_STALE_NS = 60_000_000_000  # 60s (uncached device dispatches
    # can stall a Python tile loop for seconds; compiles happen pre-RUN)

    def __init__(self, spec: TopoSpec, start: bool = True,
                 metrics_port: int | None = None,
                 policy: SupervisionPolicy | None = None,
                 flight_dir: str = "", config: dict | None = None):
        if metrics_port is not None:
            raise NotImplementedError(
                "metrics_port: the supervisor's /metrics endpoint "
                "(MetricsHttpServer, prometheus_render) is not ported")
        if flight_dir:
            raise NotImplementedError(
                "flight_dir: the flight recorder (disco/flightrec.py) is "
                "not ported")
        if int(((config or {}).get("autotune") or {}).get("enabled", 0)
               or 0):
            raise NotImplementedError(
                "[autotune] enabled: the Autotuner (disco/autotune.py) is "
                "not ported")
        if policy is not None and policy.restart_policy == "respawn":
            raise NotImplementedError(
                'restart_policy = "respawn": TopoRun.supervise and respawn '
                "are not ported; the port's supervisor reports a failed "
                "tile through poll()")
        self.spec = spec.validate()
        self.jt = topo_mod.create(spec)
        self.procs: dict[str, mp.process.BaseProcess] = {}
        self._mpctx = mp.get_context("spawn")
        self.policy = policy or SupervisionPolicy(
            heartbeat_stale_s=self.HEARTBEAT_STALE_NS / 1e9)
        self._kind = {t.name: t.kind for t in self.spec.tiles}
        self._boot_deadline: dict[str, float] = {}
        self._draining: set[str] = set()        # mid drain
        self.exitcodes: dict[str, int | None] = {}   # set by halt()
        if start:
            self.start()

    def _load_drain_manifest(self, name: str):
        """Load + validate `name`'s drain-cursor manifest (written by the
        mux at DRAINED — disco/mux.py _write_drain_manifest).

        Returns the manifest dict, None if no manifest dir is configured
        or the file simply doesn't exist, or raises ValueError if the
        file is present but torn/corrupt: truncated JSON, wrong tile,
        non-integer cursors.  A corrupt manifest is a failed drain
        receipt, whose cursors must not be trusted."""
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

    def start(self):
        for t in self.spec.tiles:
            self._spawn(t.name)

    def _spawn(self, name: str):
        p = self._mpctx.Process(
            target=_tile_main, args=(self.spec, name),
            name=f"fdtpu:{name}", daemon=True)
        p.start()
        self.procs[name] = p
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
        The caller decides what a failure means (the JAX package's
        supervise() and respawn are not ported).

        Failure = dead process, heartbeat older than the per-kind
        staleness threshold (policy.stale_ns), or a tile wedged in BOOT
        past its boot-grace window.  A booting tile is exempt from
        heartbeat staleness — compiles happen pre-RUN."""
        now_ns = time.monotonic_ns()
        now = time.monotonic()
        for name, p in list(self.procs.items()):
            if name in self._draining:
                # mid drain: the tile is intentionally parked; the drain
                # path owns its lifecycle and bounds it with
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

    # -- drain protocol (graceful quiesce) ---------------------------------
    def drain_tile(self, name: str, timeout_s: float) -> bool:
        """Raise SIGNAL_DRAIN on one tile and wait (bounded) for its
        DRAINED ack.  Returns False on timeout or if the tile died
        mid-drain; this never hangs."""
        cnc = self.jt.cnc[name]
        cnc.signal(Cnc.SIGNAL_DRAIN)
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
            time.sleep(0.005)
        return cnc.signal_query() == Cnc.SIGNAL_DRAINED

    def drain(self, timeout_s: float | None = None) -> bool:
        """Graceful whole-topology shutdown: quiesce source -> verify ->
        dedup -> sink in dependency order so every accepted txn is
        verdicted before exit, then halt.  Per-tile budget timeout_s
        (default the policy's drain_timeout_s; 0 skips the drain); a tile
        that cannot run dry inside its budget degrades the rest of the
        topology to the plain cooperative halt: bounded, never a hang.
        Returns True iff every tile drained; raises as halt() does when a
        tile does not exit cleanly."""
        t = (self.policy.drain_timeout_s if timeout_s is None
             else float(timeout_s))
        ok = True
        if t > 0:
            for name in dependency_order(self.spec):
                p = self.procs.get(name)
                if p is None or not p.is_alive():
                    continue
                self._draining.add(name)
                if not self.drain_tile(name, t):
                    log.warning("tile %s did not drain in %.1f s; "
                                "cooperative halt", name, t)
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
        tile's exit code in self.exitcodes and returns it.  A tile that
        was alive at the halt and did not exit 0 raises RuntimeError: its
        fini failed (a device error at the last flush, say), or it had to
        be killed.  A tile that had died before the halt is poll()'s to
        report, and does not raise here."""
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
        """halt(), then unmap and unlink the workspace (also when the
        halt raises)."""
        try:
            return self.halt()
        finally:
            self.jt.close()
            self.jt.unlink()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
