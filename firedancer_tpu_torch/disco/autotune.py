"""Knob pods: the live-tuning mailbox of every tile; the port's own copy of
firedancer_tpu/disco/autotune.py's pod layout.

Every tile gets a small shm region next to its metrics block (allocated by
the same deterministic layout replay in disco/topo.py): one u64 generation
counter + one f64 slot per live-tunable knob of that tile kind (KNOBS
below).  A supervisor writes values then bumps the generation; the tile's
mux housekeeping compares the generation once per interval (~20 ms) and,
on change, hands the non-zero slots to the tile's `apply_knobs(ctx, vals)`
callback.  Unarmed cost is one integer compare per housekeeping.  Pods
outlive tile processes, so a respawned tile re-applies the current knob
set at its first housekeeping.

The JAX package's closed-loop Autotuner, the pods' writer, is not ported
yet: `[autotune] enabled` raises NotImplementedError in TopoRun.  The pod
layout is the JAX package's, so a workspace either package lays out has
its pods at the same offsets.
"""

import numpy as np

# -- knob schema ------------------------------------------------------------
# Per tile kind, the ordered live-tunable knobs (the order IS the pod
# slot layout — append only).  Every knob here is read each call on its
# tile's hot path, so a pod write takes effect within one housekeeping
# interval without a respawn:
#   verify   deadline_us / lat_max_inflight (pipeline lat lane),
#            max_inflight (dispatch-ahead window), flush_age_ns
#            (partial-batch age flush)
#   source   burst_splits (packed-frag fan-out per loop)
#   net      pps_per_source / pps_burst (per-source token bucket)
#   quic_server  conn_txn_rate / conn_txn_burst (per-conn token bucket)
KNOBS: dict[str, tuple[str, ...]] = {
    "verify": ("deadline_us", "lat_max_inflight", "max_inflight",
               "flush_age_ns"),
    "source": ("burst_splits",),
    "net": ("pps_per_source", "pps_burst"),
    "quic_server": ("conn_txn_rate", "conn_txn_burst"),
}

POD_SLOTS = 8       # f64 value slots per pod (max knobs per kind, room)


def pod_footprint() -> int:
    """Uniform per-tile pod size (gen u64 + POD_SLOTS f64), padded so the
    deterministic layout replay never depends on tile kind."""
    return 128


class KnobPod:
    """One tile's knob mailbox in the workspace.  Writer = supervisor,
    reader = the tile's mux housekeeping; the u64 generation store is the
    publish barrier (aligned 8-byte stores are atomic on our platforms,
    and f64 is exact for every integer knob value we carry)."""

    def __init__(self, buf, off: int, kind: str):
        self._gen = np.frombuffer(buf, dtype=np.uint64, count=1, offset=off)
        self._vals = np.frombuffer(buf, dtype=np.float64, count=POD_SLOTS,
                                   offset=off + 8)
        self.names = KNOBS.get(kind, ())

    @property
    def gen(self) -> int:
        return int(self._gen[0])

    def write(self, name: str, value: float):
        """Stage one knob value (visible to the tile after commit())."""
        self._vals[self.names.index(name)] = float(value)

    def commit(self):
        self._gen[0] += np.uint64(1)

    def read_set(self) -> dict[str, float]:
        """The armed knobs: every slot a supervisor ever wrote (zero =
        never touched; no real knob value here is zero)."""
        return {n: float(self._vals[i]) for i, n in enumerate(self.names)
                if self._vals[i] != 0.0}
