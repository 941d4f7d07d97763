"""Deterministic fault injection for chaos testing (disco layer); the
port's own copy of firedancer_tpu/disco/faultinject.py's tile plans
(the fleet plan and the QUIC wire generator belong to tiles the port
does not have).

The reference hardens tiles with fuzz targets and out-of-band chaos runs;
the in-tree equivalent here is a seeded fault plan threaded through the
mux rx paths, the tile housekeeping, and the verifier dispatch.  Faults
are OFF unless the FDTPU_FAULTS env var (or a tile cfg `faults` entry)
names the tile, in which case `for_tile()` returns a FaultInjector; every
hot-path call site guards with `if fault is not None`, so the disabled
cost is a single identity compare per burst.

Plan grammar (env FDTPU_FAULTS, or a tile cfg `faults` string; a cfg
`faults` dict applies to that one tile directly):

    tile=knob:value,knob:value[;tile2=...]

    FDTPU_FAULTS="verify:0=kill_after_frags:128,boot:0;source=delay_frag_us:50"

A tile term matches by exact instance name ("verify:0") or by kind prefix
("verify" matches every verify:* instance).  When both match, the exact
entry wins knob-by-knob.

Knobs (all deterministic given `seed` — identical plans replay identical
failure sequences):

    kill_after_frags:N   hard-exit (os._exit, no unwinding — SIGKILL-grade)
                         the tile process right BEFORE it processes its Nth
                         received frag: the doomed frag is neither processed
                         nor fseq-acked, so a respawn resumes at it cleanly
    delay_frag_us:U      sleep U microseconds per received frag
    drop_frag_p:P        silently drop each received frag with probability P
                         (frag-granular on the scalar and zero-copy view
                         paths; the native rx_burst path does not support it)
    corrupt_payload_p:P  flip one payload bit per frag with probability P
                         (on the zero-copy view path the flip lands in the
                         first 64 payload bytes — inside the packed row 0
                         message region)
    fail_dispatch_p:P    device dispatch raises InjectedDispatchError with
                         probability P (consumed by pipeline.GuardedVerifier;
                         raised before the dispatch, so nothing launches)
    fail_dispatch_n:N    fail the first N device dispatches, then heal —
                         scripts the "device sick, then recovers" arc
    stall_heartbeat_s:S  one-shot: housekeeping sleeps S seconds without
                         heartbeating (stale-detection drill)
    seed:K               rng seed for the probabilistic knobs (default 0;
                         folded with the tile name so instances diverge)
    boot:G               plan applies only to boot generation G (0 = first
                         spawn; a tile respawned by the supervisor runs
                         generation 1, 2, ...) — lets a chaos script kill
                         the first incarnation and let the respawn live
"""

import os
import time
import zlib

import numpy as np

KILL_EXIT_CODE = 86  # distinguishes an injected kill from a real crash


class InjectedDispatchError(RuntimeError):
    """Raised by FaultInjector.dispatch() in place of a real device error."""


def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_plan(text: str) -> dict:
    """'tile=k:v,k:v;tile2=...' -> {tile: {k: v}} with numeric coercion."""
    plans = {}
    for term in text.split(";"):
        term = term.strip()
        if not term:
            continue
        tile, _, body = term.partition("=")
        knobs = {}
        for kv in body.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition(":")
            knobs[k.strip()] = _coerce(v.strip())
        plans[tile.strip()] = knobs
    return plans


def plan_for(tile_name: str, plans: dict) -> dict | None:
    """Kind-prefix entry overlaid by an exact-name entry (exact wins)."""
    kind = tile_name.split(":", 1)[0]
    knobs = {}
    if kind in plans and kind != tile_name:
        knobs.update(plans[kind])
    if tile_name in plans:
        knobs.update(plans[tile_name])
    return knobs or None


def for_tile(tile_name: str, cfg: dict | None = None, restart_cnt: int = 0,
             environ=os.environ) -> "FaultInjector | None":
    """The single entry point: None (the common case — zero overhead
    downstream) unless a fault plan names this tile AND its boot-generation
    gate matches."""
    knobs = {}
    env_text = environ.get("FDTPU_FAULTS", "")
    if env_text:
        knobs.update(plan_for(tile_name, parse_plan(env_text)) or {})
    f = (cfg or {}).get("faults")
    if isinstance(f, str) and f:
        knobs.update(plan_for(tile_name, parse_plan(f)) or {})
    elif isinstance(f, dict):
        knobs.update(f)
    if not knobs:
        return None
    gen = knobs.get("boot")
    if gen is not None and int(gen) != int(restart_cnt):
        return None
    return FaultInjector(tile_name, knobs)


class FaultInjector:
    """One tile's armed fault plan.  Mux calls frag()/frags_view()/burst()
    on the rx paths and house() in housekeeping; GuardedVerifier calls
    dispatch().  All decisions are driven by one seeded Generator, so a
    fixed (plan, traffic) pair replays the exact same failure sequence."""

    def __init__(self, tile_name: str, knobs: dict):
        self.tile = tile_name
        self.knobs = dict(knobs)
        seed = int(knobs.get("seed", 0))
        # fold the tile name in so verify:0 and verify:1 diverge under the
        # same plan seed
        self._rng = np.random.default_rng(
            (seed << 16) ^ zlib.crc32(tile_name.encode()))
        self.frag_cnt = 0
        self.dispatch_cnt = 0
        self._kill_after = int(knobs.get("kill_after_frags", 0))
        self._delay_s = float(knobs.get("delay_frag_us", 0)) * 1e-6
        self._drop_p = float(knobs.get("drop_frag_p", 0.0))
        self._corrupt_p = float(knobs.get("corrupt_payload_p", 0.0))
        self._fail_p = float(knobs.get("fail_dispatch_p", 0.0))
        self._fail_n = int(knobs.get("fail_dispatch_n", 0))
        self._stall_s = float(knobs.get("stall_heartbeat_s", 0.0))
        self._stalled = False
        self._kill_pending = False

    # -- shared per-frag machinery ----------------------------------------
    def _maybe_kill(self):
        if self._kill_pending:
            os._exit(KILL_EXIT_CODE)

    def _tick(self):
        """Count one received frag; kill/delay per plan.  The kill fires
        BEFORE the frag is processed or acked (at-least-once handoff to
        the respawned incarnation, never a duplicate verdict)."""
        self._maybe_kill()
        self.frag_cnt += 1
        if self._kill_after and self.frag_cnt >= self._kill_after:
            os._exit(KILL_EXIT_CODE)
        if self._delay_s:
            time.sleep(self._delay_s)

    def _tick_batch(self, n: int) -> int:
        """Count n received frags at once; returns how many leading frags
        may still be processed.  When the kill threshold lands inside the
        batch, the kill is DEFERRED to the next fault-point entry (the
        frag boundary) rather than fired mid-batch: the allowed prefix is
        processed, span-recorded and acked exactly like the scalar path,
        where every frag before the threshold completes.  The trailing
        frags of the killing batch are acked-but-unprocessed — the same
        outage-loss semantics dead-consumer eviction applies for the rest
        of the downtime."""
        self._maybe_kill()
        take = n
        if self._kill_after:
            allowed = self._kill_after - 1 - self.frag_cnt
            if allowed < n:
                take = max(0, allowed)
                self._kill_pending = True
        self.frag_cnt += n
        if self._delay_s and take:
            time.sleep(self._delay_s * take)
        return take

    def _flip(self, buf, lo: int, hi: int):
        """Deterministically flip one bit of buf[lo:hi] (uint8 view)."""
        if hi <= lo:
            return
        i = lo + int(self._rng.integers(hi - lo))
        buf[i] ^= np.uint8(1 << int(self._rng.integers(8)))

    # -- mux rx fault points ----------------------------------------------
    def frag(self, payload):
        """Scalar rx path: returns (payload, drop)."""
        self._tick()
        if self._drop_p and self._rng.random() < self._drop_p:
            return payload, True
        if self._corrupt_p and payload and self._rng.random() < self._corrupt_p:
            b = bytearray(payload)
            arr = np.frombuffer(b, np.uint8)
            self._flip(arr, 0, len(arr))
            payload = bytes(b)
        return payload, False

    def frags_view(self, metas, dcache):
        """Zero-copy view rx path: metas stay in place, payload bytes live
        in the shm dcache.  Returns (metas', n_dropped); corruption mutates
        the dcache in place (the consumer reads the flipped bytes, exactly
        like wire corruption that beat the producer's checksum)."""
        take = self._tick_batch(len(metas))
        if take < len(metas):
            metas = metas[:take]
        keep = None
        for j in range(len(metas)):
            if self._drop_p and self._rng.random() < self._drop_p:
                if keep is None:
                    keep = np.ones(len(metas), bool)
                keep[j] = False
                continue
            if self._corrupt_p and self._rng.random() < self._corrupt_p:
                view = dcache.view(int(metas[j]["chunk"]), 64)
                self._flip(view, 0, 64)
        if keep is None:
            return metas, 0
        return metas[keep], int((~keep).sum())

    def burst(self, kept: int, buf, offs) -> int:
        """Native rx_burst path: frags were already copied out; supports
        kill/delay/corrupt (no drop — the burst is committed at the ring).
        Returns the number of leading frags the mux may hand to the tile
        (kept, unless the kill threshold lands inside this burst)."""
        take = self._tick_batch(kept)
        for j in range(take):
            if self._corrupt_p and self._rng.random() < self._corrupt_p:
                self._flip(buf, int(offs[j]), int(offs[j + 1]))
        return take

    # -- verifier dispatch fault point ------------------------------------
    def dispatch(self):
        self.dispatch_cnt += 1
        if self._fail_n and self.dispatch_cnt <= self._fail_n:
            raise InjectedDispatchError(
                f"{self.tile}: injected dispatch failure "
                f"#{self.dispatch_cnt}/{self._fail_n}")
        if self._fail_p and self._rng.random() < self._fail_p:
            raise InjectedDispatchError(
                f"{self.tile}: injected dispatch failure (p={self._fail_p})")

    # -- housekeeping fault point -----------------------------------------
    def house(self):
        # a batch-deferred kill must fire even with nothing inbound: the
        # housekeeping cadence (~20ms) bounds how long the corpse lingers
        self._maybe_kill()
        if self._stall_s and not self._stalled:
            self._stalled = True
            time.sleep(self._stall_s)
