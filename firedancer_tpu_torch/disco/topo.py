"""Topology model + builder (ref: src/disco/topo/fd_topo.h:8-140,
fd_topob.c); the port's own copy of firedancer_tpu/disco/topo.py.

A topology is a static graph of one workspace (named shared memory), links
(mcache + optional dcache, single-producer / multi-consumer), and tiles (one
process each).  The layout inside the workspace is computed by replaying the
same deterministic allocation sequence in every process — the reference's
trick of materializing the identical fd_topo_t in each tile process
(src/disco/topo/fd_topo.c) so nothing needs serializing beyond the spec.

Specs are plain picklable dataclasses; the materialized view (join) holds
live ring objects from firedancer_tpu_torch.tango.ring.  The allocation
replay is the JAX package's, step for step, so the port joins a workspace
the JAX package created from the same spec (and the reverse) and finds
every link, cnc, fseq, metrics block, trace ring and knob pod at the same
offset.
"""

from dataclasses import dataclass, field

from ..tango.ring import Workspace, MCache, Dcache, FSeq, Cnc
from . import autotune as autotune_mod
from . import metrics as metrics_mod
from . import trace as trace_mod


@dataclass(frozen=True)
class LinkSpec:
    """One frag stream (fd_topo_link_t, fd_topo.h:46-77)."""
    name: str
    depth: int          # mcache depth, power of two
    mtu: int = 0        # max payload bytes; 0 = metadata-only link (no dcache)
    burst: int = 1      # frags producible beyond depth before wrap


@dataclass(frozen=True)
class InLink:
    """A tile's subscription to a link (fd_topo.h:93-103)."""
    link: str
    reliable: bool = True   # reliable consumers backpressure the producer
    polled: bool = True


@dataclass(frozen=True)
class TileSpec:
    """One tile process (fd_topo_tile_t, fd_topo.h:79-140)."""
    name: str                       # unique instance name, e.g. "verify:0"
    kind: str                       # registry key into disco.tiles.TILES
    in_links: tuple[InLink, ...] = ()
    out_links: tuple[str, ...] = ()  # links this tile produces (it owns them)
    cfg: dict = field(default_factory=dict)

    def __post_init__(self):
        # freeze cfg content hazards early: it must pickle to children
        if not isinstance(self.cfg, dict):
            raise TypeError("tile cfg must be a dict")


@dataclass(frozen=True)
class TopoSpec:
    """The whole static graph; picklable, hashable by app name."""
    app: str
    links: tuple[LinkSpec, ...]
    tiles: tuple[TileSpec, ...]
    wksp_mb: int = 64

    def validate(self) -> "TopoSpec":
        lnames = [l.name for l in self.links]
        if len(set(lnames)) != len(lnames):
            raise ValueError("duplicate link names")
        tnames = [t.name for t in self.tiles]
        if len(set(tnames)) != len(tnames):
            raise ValueError("duplicate tile names")
        producers: dict[str, str] = {}
        for t in self.tiles:
            for ln in t.out_links:
                if ln not in lnames:
                    raise ValueError(f"tile {t.name} produces unknown link {ln}")
                if ln in producers:
                    raise ValueError(
                        f"link {ln} has two producers: {producers[ln]}, {t.name}")
                producers[ln] = t.name
            for il in t.in_links:
                if il.link not in lnames:
                    raise ValueError(f"tile {t.name} consumes unknown link {il.link}")
        for ln in lnames:
            if ln not in producers:
                raise ValueError(f"link {ln} has no producer")
        # bank tiles each own a private Runtime/Funk built from genesis;
        # until an accountsdb shared across processes exists, >1 bank lane
        # would execute against divergent chains (the reference's N bank
        # tiles share one Agave bank via FFI — tiles.h:36-64)
        if sum(1 for t in self.tiles if t.kind == "bank") > 1:
            raise ValueError("at most one bank tile per topology for now "
                             "(bank tiles do not yet share an accounts db)")
        return self


class TopoBuilder:
    """Programmatic topology construction (fd_topob_* builders,
    src/disco/topo/fd_topob.c)."""

    def __init__(self, app: str, wksp_mb: int = 64):
        self.app = app
        self.wksp_mb = wksp_mb
        self._links: list[LinkSpec] = []
        self._tiles: list[TileSpec] = []

    def link(self, name: str, depth: int, mtu: int = 0, burst: int = 1):
        self._links.append(LinkSpec(name, depth, mtu, burst))
        return self

    def tile(self, name: str, kind: str, ins=(), outs=(), **cfg):
        in_links = tuple(
            i if isinstance(i, InLink) else InLink(i) for i in ins)
        self._tiles.append(
            TileSpec(name, kind, in_links, tuple(outs), cfg))
        return self

    def build(self) -> TopoSpec:
        return TopoSpec(self.app, tuple(self._links),
                        tuple(self._tiles), self.wksp_mb).validate()


class JoinedLink:
    def __init__(self, spec: LinkSpec, mcache: MCache, dcache: Dcache | None):
        self.spec = spec
        self.mcache = mcache
        self.dcache = dcache


class JoinedTopology:
    """Live view after mapping the workspace.  Offsets are identical in every
    process because the allocation replay below is deterministic."""

    def __init__(self, spec: TopoSpec, create: bool):
        self.spec = spec
        self.created = create
        self.ws = Workspace(f"fdtpu_{spec.app}", spec.wksp_mb << 20,
                            create=create)
        try:
            self._layout(create)
        except BaseException:
            self.ws.close()
            if create:
                self.ws.unlink()
            raise

    def _layout(self, create: bool):
        ws = self.ws
        self.links: dict[str, JoinedLink] = {}
        for ls in self.spec.links:
            if create:
                mc = MCache.new(ws, ls.depth)
                dc = Dcache.new(ws, ls.mtu, ls.depth, ls.burst) if ls.mtu else None
            else:
                mc = MCache.join(ws, ws.alloc(MCache.footprint(ls.depth)))
                dc = (Dcache.join(
                        ws, ws.alloc(Dcache.footprint(ls.mtu, ls.depth, ls.burst)))
                      if ls.mtu else None)
            self.links[ls.name] = JoinedLink(ls, mc, dc)

        self.cnc: dict[str, Cnc] = {}
        self.metrics: dict[str, metrics_mod.MetricsBlock] = {}
        self.trace: dict[str, trace_mod.TraceRing] = {}
        # per-tile autotune knob mailbox (supervisor-writer, mux-reader)
        self.knobs: dict[str, autotune_mod.KnobPod] = {}
        # (tile_name, link_name) -> consumer fseq
        self.fseq: dict[tuple[str, str], FSeq] = {}
        for t in self.spec.tiles:
            if create:
                self.cnc[t.name] = Cnc.new(ws)
            else:
                from .. import native
                self.cnc[t.name] = Cnc.join(
                    ws, ws.alloc(native.lib().fd_cnc_footprint()))
            moff = ws.alloc(metrics_mod.footprint())
            if create:
                import numpy as np
                np.frombuffer(ws.buf, dtype=np.uint64,
                              count=metrics_mod.footprint() // 8,
                              offset=moff)[:] = 0
            self.metrics[t.name] = metrics_mod.MetricsBlock(ws.buf, moff, t.kind)
            # per-tile fdtrace span ring, laid out next to the metrics
            # block (same single-writer shm contract)
            toff = ws.alloc(trace_mod.footprint())
            self.trace[t.name] = trace_mod.TraceRing(ws.buf, toff,
                                                     create=create)
            koff = ws.alloc(autotune_mod.pod_footprint())
            if create:
                import numpy as np
                np.frombuffer(ws.buf, dtype=np.uint64,
                              count=autotune_mod.pod_footprint() // 8,
                              offset=koff)[:] = 0
            self.knobs[t.name] = autotune_mod.KnobPod(ws.buf, koff, t.kind)
            for il in t.in_links:
                if create:
                    self.fseq[(t.name, il.link)] = FSeq.new(ws)
                else:
                    from .. import native
                    self.fseq[(t.name, il.link)] = FSeq.join(
                        ws, ws.alloc(native.lib().fd_fseq_footprint()))

    def reliable_consumers(self, link_name: str) -> list[FSeq]:
        """FSeqs of every reliable consumer of a link — the producer's credit
        sources (fd_mux.c:233-310)."""
        out = []
        for t in self.spec.tiles:
            for il in t.in_links:
                if il.link == link_name and il.reliable:
                    out.append(self.fseq[(t.name, il.link)])
        return out

    def tile_spec(self, name: str) -> TileSpec:
        for t in self.spec.tiles:
            if t.name == name:
                return t
        raise KeyError(name)

    def consumer_edges(self, tile_name: str) -> list:
        """(in_link, fseq, producer mcache) per in-link of `tile_name` —
        the supervisor's eviction surface for a dead consumer: while the
        tile is down, its reliable fseqs get fast-forwarded to the
        producer cursors (fctl.Fctl.evict_dead_consumer) so upstream
        credits don't freeze on the corpse."""
        t = self.tile_spec(tile_name)
        return [(il, self.fseq[(tile_name, il.link)],
                 self.links[il.link].mcache) for il in t.in_links]

    def close(self):
        # numpy views (dcache/metrics) export pointers into the shm buffer;
        # drop them before closing or SharedMemory.close raises BufferError
        self.links = {}
        self.metrics = {}
        self.trace = {}
        self.knobs = {}
        self.fseq = {}
        self.cnc = {}
        import gc
        gc.collect()
        try:
            self.ws.close()
        except BufferError:
            pass  # a stray view outlived us; the mapping dies with the process

    def unlink(self):
        self.ws.unlink()


def assign_affinity(spec: TopoSpec, affinity: str | None) -> TopoSpec:
    """Thread per-tile CPU pins through tile cfgs (ref: the [layout]
    affinity string in fdctl's config, src/app/fdctl/config.c — there a
    cpu list consumed tile-by-tile in topology order).

    affinity: "" / None = no pinning; "auto" = tiles round-robin over all
    CPUs in topology order; "3,1,5" = explicit cpu per tile in topology
    order (shorter lists wrap).  Tiles with an explicit cfg cpu_idx keep
    it.  Returns a NEW spec (specs are frozen)."""
    if not affinity:
        return spec
    import os as _os
    if affinity == "auto":
        cpus = list(range(_os.cpu_count() or 1))
    else:
        cpus = [int(c) for c in affinity.split(",") if c.strip() != ""]
    if not cpus:
        return spec
    tiles = []
    for idx, t in enumerate(spec.tiles):
        cfg = dict(t.cfg)
        cfg.setdefault("cpu_idx", cpus[idx % len(cpus)])
        tiles.append(TileSpec(t.name, t.kind, t.in_links, t.out_links, cfg))
    return TopoSpec(spec.app, spec.links, tuple(tiles), spec.wksp_mb)


def create(spec: TopoSpec) -> JoinedTopology:
    return JoinedTopology(spec, create=True)


def join(spec: TopoSpec) -> JoinedTopology:
    return JoinedTopology(spec, create=False)
