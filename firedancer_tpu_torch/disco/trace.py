"""Per-frag pipeline span rings (ref: the reference's tsorig/tspub frag-meta
stamps, src/tango/fd_tango_base.h:140-170); the port's own copy of
firedancer_tpu/disco/trace.py's record layout and ring.

Each tile owns a fixed-size SINGLE-WRITER span ring in the workspace,
allocated by the topology layout next to the tile's metrics block.  The
mux run loop records one span per frag (scalar path) or per burst (native
path); the verify pipeline adds coalesce, compile, dispatch, device and
harvest spans through the same writer.  The record layout and footprint
are the JAX package's, so either package's readers drain the other's
rings.  `fdtpuctl trace` drains every ring read-only and exports Chrome
`trace_event` JSON (chrome_trace, loadable in Perfetto or
chrome://tracing) plus a terminal p50/p99-per-hop table (hop_table).

Concurrency contract (same as disco/metrics.py): one writer per ring,
aligned 8-byte stores, readers snapshot without coordination and drop
records the cursor may have overwritten mid-copy.

This module stays import-light (numpy only): the topology layout and
every tile process import it.
"""

import json

import numpy as np

# -- span record ------------------------------------------------------------

TRACE_REC_DTYPE = np.dtype([
    ("ts", "<u8"),       # span start, monotonic ns (full width)
    ("dur", "<u8"),      # span duration ns
    ("seq", "<u8"),      # first frag seq covered (0 if not frag-bound)
    ("hop_ns", "<u4"),   # producer tspub -> our consume (one hop)
    ("age_ns", "<u4"),   # chain origin tsorig -> our consume (whole chain)
    ("iidx", "<u2"),     # in-link index (or bucket index for device spans)
    ("kind", "<u2"),     # KIND_* below
    ("cnt", "<u4"),      # frags / txns covered by the span
])
assert TRACE_REC_DTYPE.itemsize == 40  # 8-byte aligned, no padding

# span kinds (the pipeline stages ingest -> dedup -> coalesce -> dispatch
# -> device -> readback -> pack all reduce to these)
KIND_FRAG = 1       # scalar on_frag callback (one frag)
KIND_BURST = 2      # native on_burst callback (cnt frags)
KIND_COALESCE = 3   # verify bucket: first txn in -> dispatch
KIND_DEVICE = 4     # verify bucket: dispatch -> verdict harvested
KIND_COMPILE = 5    # first dispatch of a (batch, maxlen) shape not warmed
KIND_STAGE = 6      # named offline stage
KIND_DISPATCH = 7   # verify bucket: dispatch call + over-budget queue drain
KIND_PUBLISH = 8    # verify: verdicted txns -> downstream publish
KIND_HARVEST = 9    # verify: verdict materialize -> passing txns rebuilt

KIND_NAMES = {
    KIND_FRAG: "frag", KIND_BURST: "burst", KIND_COALESCE: "coalesce",
    KIND_DEVICE: "device", KIND_COMPILE: "compile", KIND_STAGE: "stage",
    KIND_DISPATCH: "dispatch", KIND_PUBLISH: "publish",
    KIND_HARVEST: "harvest",
}

# lane tag: the iidx field's top bit marks spans from the verify
# pipeline's low-latency lane, so a reader separates the deadline-driven
# lane from the throughput lane on the same tile row.  In-link and bucket
# indexes stay far below 2^15, so the split is lossless.
LANE_LAT = 1 << 15


def _lane_split(iidx: int) -> tuple[int, bool]:
    """(index, is_low_latency_lane) from a raw span iidx."""
    return iidx & (LANE_LAT - 1), bool(iidx & LANE_LAT)

DEPTH = 4096        # spans retained per tile (~160 KiB: DEPTH * 40B + header)
_HDR = 64           # [magic, depth, cursor, reserved...] as u64
_MAGIC = 0xFD7ACE0000000001


def footprint(depth: int = DEPTH) -> int:
    return _HDR + depth * TRACE_REC_DTYPE.itemsize


class TraceRing:
    """Single-writer span ring over a workspace byte range (the same
    static-offset contract as MetricsBlock: every process computes the
    identical offset by allocation replay)."""

    def __init__(self, buf: memoryview, off: int, create: bool = False,
                 depth: int = DEPTH):
        self._hdr = np.frombuffer(buf, dtype=np.uint64, count=_HDR // 8,
                                  offset=off)
        if create:
            self._hdr[1] = depth
            self._hdr[2] = 0
            self._hdr[0] = _MAGIC  # magic last: joiners see a full header
        if int(self._hdr[0]) != _MAGIC:
            raise ValueError("no trace ring at offset")
        self.depth = int(self._hdr[1])
        self._recs = np.frombuffer(buf, dtype=TRACE_REC_DTYPE,
                                   count=self.depth, offset=off + _HDR)
        if create:
            self._recs[:] = 0
        self._cursor = int(self._hdr[2])  # writer-side cache

    # -- writer (one per tile) ---------------------------------------------
    def record(self, kind: int, ts: int, dur: int, *, iidx: int = 0,
               hop_ns: int = 0, age_ns: int = 0, cnt: int = 1, seq: int = 0):
        c = self._cursor
        self._recs[c % self.depth] = (
            ts, dur, seq, min(hop_ns, 0xFFFFFFFF), min(age_ns, 0xFFFFFFFF),
            iidx & 0xFFFF, kind & 0xFFFF, min(cnt, 0xFFFFFFFF))
        self._cursor = c + 1
        self._hdr[2] = c + 1  # cursor store AFTER the record (readers gate)

    # -- reader (monitor / fdtpuctl trace) ---------------------------------
    def snapshot(self, since: int = 0):
        """Records published in [since, cursor), oldest first; returns
        (cursor, records).  Records the writer may have overwritten while
        we copied are dropped (re-read the cursor, discard anything below
        the new lapped floor)."""
        cur = int(self._hdr[2])
        lo = max(since, cur - self.depth)
        if lo >= cur:
            return cur, self._recs[:0].copy()
        idx = np.arange(lo, cur, dtype=np.int64) % self.depth
        out = self._recs[idx].copy()
        lapped = int(self._hdr[2]) - self.depth
        if lapped > lo:
            out = out[lapped - lo:]
        return cur, out


# -- chrome trace_event export ---------------------------------------------

def chrome_trace(spans_by_tile: dict[str, np.ndarray]) -> dict:
    """Build a Chrome trace_event JSON object (Perfetto-loadable): one
    pid per app, one tid per tile, "X" complete events with microsecond
    timestamps.  Span args carry hop/age/cnt for drill-down."""
    events = []
    for tid, (tile, recs) in enumerate(sorted(spans_by_tile.items())):
        events.append({"ph": "M", "name": "thread_name", "pid": 1,
                       "tid": tid, "args": {"name": tile}})
        for r in recs:
            kind = KIND_NAMES.get(int(r["kind"]), str(int(r["kind"])))
            idx, is_lat = _lane_split(int(r["iidx"]))
            events.append({
                "ph": "X",
                "name": f"{kind}:in{idx}" + (":lat" if is_lat else ""),
                "cat": kind,
                "pid": 1,
                "tid": tid,
                "ts": int(r["ts"]) / 1e3,
                "dur": max(int(r["dur"]), 1) / 1e3,
                "args": {"hop_ns": int(r["hop_ns"]),
                         "age_ns": int(r["age_ns"]),
                         "cnt": int(r["cnt"]),
                         "seq": int(r["seq"]),
                         "lane": "lat" if is_lat else "bulk"},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans_by_tile: dict) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans_by_tile), f)


# -- terminal per-hop table ------------------------------------------------

def hop_table(spans_by_tile: dict[str, np.ndarray]) -> str:
    """p50/p99 per (tile, kind, in-link) over hop latency and span
    duration — the terminal companion of the mux's in*_hop gauges,
    computed from the SAME samples through the same Histf percentile."""
    from ..utils.hist import Histf
    rows = []
    for tile, recs in sorted(spans_by_tile.items()):
        for kind in np.unique(recs["kind"]) if len(recs) else []:
            km = recs[recs["kind"] == kind]
            for iidx in np.unique(km["iidx"]):
                sel = km[km["iidx"] == iidx]
                hh, dh = Histf(100, 10e9), Histf(100, 10e9)
                frags = 0
                for r in sel:
                    if int(r["hop_ns"]):
                        hh.sample(int(r["hop_ns"]))
                    dh.sample(max(int(r["dur"]), 1))
                    frags += int(r["cnt"])
                idx, is_lat = _lane_split(int(iidx))
                kname = KIND_NAMES.get(int(kind), str(int(kind)))
                rows.append((
                    tile, kname + (":lat" if is_lat else ""),
                    idx, len(sel), frags,
                    hh.percentile(0.50) if hh.count() else 0.0,
                    hh.percentile(0.99) if hh.count() else 0.0,
                    dh.percentile(0.50), dh.percentile(0.99)))
    lines = [f"{'TILE':<14}{'SPAN':<10}{'IN':>3}{'SPANS':>8}{'FRAGS':>9}"
             f"{'HOP p50':>10}{'HOP p99':>10}{'DUR p50':>10}{'DUR p99':>10}"]
    for t, k, i, n, fr, h50, h99, d50, d99 in rows:
        def _us(v):
            return f"{v / 1e3:,.0f}us" if v else "-"
        lines.append(f"{t:<14}{k:<10}{i:>3}{n:>8}{fr:>9}"
                     f"{_us(h50):>10}{_us(h99):>10}"
                     f"{_us(d50):>10}{_us(d99):>10}")
    return "\n".join(lines)


# -- in-process recorder (offline stage timings) --------------------------

class SpanRecorder:
    """Offline span sink with the same record shape as TraceRing but
    string stage names: tools use it so their stage timings export
    through the SAME chrome_trace/hop_table renderers (one
    instrumentation source, no drift vs the live pipeline)."""

    def __init__(self, tile: str = "offline"):
        self.tile = tile
        self._names: list[str] = []
        self._recs: list[tuple] = []

    def _stage_idx(self, name: str) -> int:
        try:
            return self._names.index(name)
        except ValueError:
            self._names.append(name)
            return len(self._names) - 1

    def record(self, name: str, ts: int, dur: int, cnt: int = 1):
        self._recs.append((ts, dur, 0, 0, 0, self._stage_idx(name),
                           KIND_STAGE, cnt))

    def span(self, name: str, cnt: int = 1):
        """Context manager timing one stage into the recorder."""
        import time

        class _Span:
            def __enter__(s):
                s.t0 = time.perf_counter_ns()
                return s

            def __exit__(s, *exc):
                self.record(name, s.t0, time.perf_counter_ns() - s.t0, cnt)

        return _Span()

    def records(self) -> np.ndarray:
        return np.array(self._recs, dtype=TRACE_REC_DTYPE)

    def stage_name(self, iidx: int) -> str:
        return self._names[iidx] if iidx < len(self._names) else str(iidx)

    def chrome(self) -> dict:
        """chrome_trace with stage names substituted for in-link labels."""
        out = chrome_trace({self.tile: self.records()})
        for ev in out["traceEvents"]:
            if ev["ph"] == "X":
                ev["name"] = self.stage_name(
                    int(ev["name"].rsplit(":in", 1)[1]))
        return out

    def table(self) -> str:
        """Per-stage p50/p99/mean, through the same Histf percentile the
        mux hop gauges use."""
        from ..utils.hist import Histf
        recs = self.records()
        lines = [f"{'STAGE':<28}{'SPANS':>7}{'p50':>12}{'p99':>12}"
                 f"{'mean':>12}"]
        for i, name in enumerate(self._names):
            sel = recs[recs["iidx"] == i] if len(recs) else recs
            if not len(sel):
                continue
            h = Histf(100, 60e9)
            for r in sel:
                h.sample(max(int(r["dur"]), 1))
            mean = float(sel["dur"].mean())
            lines.append(
                f"{name:<28}{len(sel):>7}"
                f"{h.percentile(0.50) / 1e6:>10.2f}ms"
                f"{h.percentile(0.99) / 1e6:>10.2f}ms"
                f"{mean / 1e6:>10.2f}ms")
        return "\n".join(lines)
