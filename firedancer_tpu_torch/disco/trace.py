"""Per-frag pipeline span rings (ref: the reference's tsorig/tspub frag-meta
stamps, src/tango/fd_tango_base.h:140-170); the port's own copy of
firedancer_tpu/disco/trace.py's record layout and ring.

Each tile owns a fixed-size SINGLE-WRITER span ring in the workspace,
allocated by the topology layout next to the tile's metrics block.  The
mux run loop records one span per frag (scalar path) or per burst (native
path); the verify pipeline adds coalesce, compile, dispatch, device and
harvest spans through the same writer.  The record layout and footprint
are the JAX package's, so either package's readers drain the other's
rings.

Concurrency contract (same as disco/metrics.py): one writer per ring,
aligned 8-byte stores, readers snapshot without coordination and drop
records the cursor may have overwritten mid-copy.

This module stays import-light (numpy only): the topology layout and
every tile process import it.
"""

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

# lane tag: the iidx field's top bit marks spans from the verify
# pipeline's low-latency lane, so a reader separates the deadline-driven
# lane from the throughput lane on the same tile row.  In-link and bucket
# indexes stay far below 2^15, so the split is lossless.
LANE_LAT = 1 << 15

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
