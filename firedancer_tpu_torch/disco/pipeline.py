"""The verify slice: txn bytes in, per-txn verdicts out, on the card.

Counterpart of firedancer_tpu/disco/pipeline.py (VerifyPipeline and its
records), with the verify tile's processing contract
(src/app/fdctl/run/tiles/fd_verify.c after_frag -> fd_txn_verify,
fd_verify.h:43-88): parse -> tcache pre-dedup on the first 64 sig bits
-> batched ed25519 verify -> per-txn accept iff every signature passes.

Signatures from many txns are coalesced into fixed-shape device batches
(wiredancer's async-offload insertion point): a ladder of (batch,
msg_maxlen) buckets, each txn routed to the smallest bucket that fits
its message, so full-MTU txns (1232 B, src/ballet/txn/fd_txn.h:92-103)
go to a narrow full-width bucket instead of being dropped.

The host path is native, as the JAX package's default is: the dedup
window is a NativeTCache, submit_burst parses, dedups and fills a bucket
in one C call a fill (native/txnparse.cpp), and packed-row frags go
through one C call a frag at submit and one at harvest
(native/hostpath.cpp).  native_hostpath=False moves the packed-row
submit and finish onto NumPy over the same tcache, with bit-identical
output; nothing falls back to a Python tcache or parser when the host
library fails to build, and nothing falls back from the device to the
host (the JAX package's GuardedVerifier comes in a later slice).
"""

import ctypes
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..ballet import txn as txn_lib
from ..ballet import txn_native as tn
from ..ops.ed25519 import PACKED_EXTRA
from ..tango.tcache import NativeTCache
from ..utils.hist import Histf
from . import trace as trace_mod


def _is_ready(dev) -> bool:
    """Non-blocking completion poll on a verdict future (the port's
    Verdict queries a CUDA event); host arrays are trivially ready."""
    fn = getattr(dev, "is_ready", None)
    return True if fn is None else bool(fn())


# default bucket ladder: (lanes, msg_maxlen); covers through the wire MTU
DEFAULT_BUCKETS = ((2048, 256), (256, 768), (64, 1232))

# priority admission: ingest links carry a per-frag latency-class bit in
# the tango frag meta `sig` field.  Producers that tag keep their app sigs
# below bit 63; untagged wire ingest masks the bit off so random signature
# bytes never alias a txn into the low-latency lane.
LAT_PRIO_BIT = 1 << 63

# default low-latency lane shape ladder (lanes per pre-warmed shape)
DEFAULT_LAT_SHAPES = (16, 64, 256)


@dataclass
class VerifyMetrics:
    """Counter block, the shape of the reference's per-tile metrics region
    (src/disco/metrics/metrics.xml verify tile)."""

    txns_in: int = 0
    parse_fail: int = 0
    dedup_drop: int = 0
    too_long_drop: int = 0
    sig_overflow_drop: int = 0
    verify_fail: int = 0
    verify_pass: int = 0
    batches: int = 0
    # packed rows whose seqlock re-check failed after the dispatch (the
    # producer lapped the dcache mid-upload): the frag is dropped whole,
    # and its rows counted apart from txns_in
    torn_drop: int = 0
    torn_txns: int = 0
    # first dispatch of a (batch, maxlen) shape not warmed at boot: the
    # no-hot-path-compile signal (0 in steady state)
    compile_cnt: int = 0
    compile_ns: int = 0
    lanes_filled: int = 0
    lanes_dispatched: int = 0
    last_fill_pct: int = 0
    # low-latency lane: lat_spill counts lat-class txns shed to the
    # throughput lane (still verified, never dropped)
    lat_txns: int = 0
    lat_spill: int = 0
    lat_batches: int = 0
    lat_deadline_closes: int = 0
    # dispatch -> verdict harvested
    batch_ns: Histf = field(
        default_factory=lambda: Histf(1_000, 60_000_000_000))
    # first submit -> dispatch (the batching window's cost)
    coalesce_ns: Histf = field(
        default_factory=lambda: Histf(1_000, 60_000_000_000))
    # arrival -> verdict of each batch's oldest txn, per lane
    e2e_ns: Histf = field(
        default_factory=lambda: Histf(1_000, 60_000_000_000))
    lat_e2e_ns: Histf = field(
        default_factory=lambda: Histf(1_000, 60_000_000_000))

    def snapshot(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "txns_in", "parse_fail", "dedup_drop", "too_long_drop",
            "sig_overflow_drop", "verify_fail", "verify_pass", "batches",
            "torn_drop", "torn_txns", "compile_cnt", "compile_ns",
            "lanes_filled",
            "lanes_dispatched", "last_fill_pct", "lat_txns", "lat_spill",
            "lat_batches", "lat_deadline_closes")}
        d["batch_ns_p50"] = self.batch_ns.percentile(0.50)
        d["batch_ns_p99"] = self.batch_ns.percentile(0.99)
        d["coalesce_ns_p50"] = self.coalesce_ns.percentile(0.50)
        d["coalesce_ns_p99"] = self.coalesce_ns.percentile(0.99)
        d["e2e_ns_p50"] = self.e2e_ns.percentile(0.50)
        d["e2e_ns_p99"] = self.e2e_ns.percentile(0.99)
        d["lat_e2e_ns_p50"] = self.lat_e2e_ns.percentile(0.50)
        d["lat_e2e_ns_p99"] = self.lat_e2e_ns.percentile(0.99)
        return d


@dataclass
class _Pending:
    payload: bytes
    parsed: txn_lib.Txn
    lanes: list[int]  # indices into the bucket's open batch
    tag: int  # dedup tag (low 64 bits of first sig), computed once in submit()


@dataclass
class _BurstPending:
    """A burst's accepted txns as one pending record (submit_burst), kept
    in NumPy so the harvest is vectorized too.  The native parser gives a
    burst's txns CONTIGUOUS lanes.  The payload bytes are ONE copied
    region (the rx scratch is reused by the next poll) with each txn's
    (start, len) into it; bytes objects are made only for passing txns at
    harvest."""

    buf: bytes              # copy of this round's payload region
    start: object           # (k,) int64 payload start per accepted txn
    plen: object            # (k,) int32 payload length per accepted txn
    lane0: object           # (k,) int32 first lane per txn
    nsig: object            # (k,) int32 sig lanes per txn
    tag: object             # (k,) uint64 dedup tags


@dataclass
class _RowsPending:
    """A packed-wire frag verified without a copy (submit_packed_rows):
    the caller keeps `rows` unchanged until the verdict materializes, so
    passing payloads are rebuilt from it at harvest.  release_cb fires
    once the frag retires."""

    rows: object            # (batch, ml+100) uint8 rows
    tag: object             # (n,) uint64 dedup tags (row[ml:ml+8])
    dup: object             # (n,) bool pre-dedup verdicts (query-only)
    n: int                  # true row count; rows beyond are zero padding
    ml: int
    release_cb: object = None


@dataclass
class PackedVerdicts:
    """One harvested frag's passing txns as a packed wire arena: wire j =
    arena[offs[j]:offs[j+1]] = 0x01 | sig[64] | msg, back to back.  The
    arena is owned, so it outlives the pipeline's next finish; the verify
    tile stamps it downstream as ONE frag instead of k."""

    arena: object           # (nbytes,) uint8, owned
    offs: object            # (k+1,) int64 wire boundaries, offs[0] = 0
    tags: object            # (k,) uint64 dedup tags of the survivors
    k: int                  # survivor count

    def wires(self) -> list[bytes]:
        """Per-txn wire bytes (one tobytes, then bytes slices)."""
        buf = self.arena.tobytes()
        ol = np.asarray(self.offs).tolist()
        return [buf[a:b] for a, b in zip(ol, ol[1:])]


@dataclass
class _Inflight:
    """A dispatched, not yet harvested device batch (wiredancer's
    in-flight request set, src/wiredancer/c/wd_f1.h:85-113)."""

    ok_dev: object            # verdict future of per-lane pass bits
    pending: list             # the _Pending / _RowsPending of that batch
    t0: int                   # dispatch timestamp (ns)
    buf: object = None        # packed blob pinned under this dispatch
    owner: object = None      # the _Bucket whose pool gets buf back
    lane: int = 0             # 0 = throughput lane, 1 = low-latency lane
    t_first: int = 0          # arrival ns of the batch's oldest txn


class _Bucket:
    """One (batch, msg_maxlen) shape with its open batch, laid out as ONE
    row-interleaved uint8 blob (msgs | sigs | pubs | lens-le32 per row),
    a torch tensor uploaded in one copy by the verifier's dispatch_blob;
    arr, msgs, sigs and pubs are NumPy views of it that submit() and the
    native burst fill write in place.  lens is the host-side (batch,)
    int32 copy of the length column, which the burst fill writes too.
    pinned=True puts the blobs in page-locked host memory, so the upload
    is an asynchronous copy.

    A bucket rotates over a pool of `n_buffers` blobs: a flushed blob
    stays pinned under its _Inflight dispatch and returns to the pool
    only after its verdict materializes in _finish(), never repacked
    while the device may still read it, while reset() swaps in a free,
    zeroed blob for the next batch."""

    def __init__(self, batch: int, maxlen: int, n_buffers: int = 2,
                 bidx: int = 0, lane: int = 0, pinned: bool = False):
        self.batch = batch
        self.maxlen = maxlen
        self.pinned = pinned
        self.n_buffers = max(1, n_buffers)
        self.bidx = bidx            # position in the pipeline's ladder
        self.lane = lane            # 0 = throughput, 1 = low-latency
        self._pool: deque = deque()
        self.lens = np.zeros(batch, np.int32)
        self.reset()

    def release(self, blob) -> None:
        """Return a no-longer-inflight blob to the rotation."""
        if len(self._pool) < self.n_buffers:
            self._pool.append(blob)

    def reset(self):
        ml = self.maxlen
        if self._pool:
            self.blob = self._pool.popleft()
            # zero the reused blob: partial (age-flush) fills must not
            # see the previous batch's bytes
            self.blob.zero_()
        else:
            self.blob = torch.zeros((self.batch, ml + PACKED_EXTRA),
                                    dtype=torch.uint8, pin_memory=self.pinned)
        self.arr = self.blob.numpy()
        self.lens.fill(0)
        self.msgs = self.arr[:, :ml]
        self.sigs = self.arr[:, ml:ml + 64]
        self.pubs = self.arr[:, ml + 64:ml + 96]
        self.used = 0
        self.t_first = 0  # ns stamp of the first txn in the open batch
        self.pending: list[_Pending] = []

    def set_len(self, lane: int, n: int):
        self.lens[lane] = n
        self.arr[lane, self.maxlen + 96:self.maxlen + 100] = (
            self.lens[lane:lane + 1].view(np.uint8))


class VerifyPipeline:
    """Fixed-shape batching verify pipeline.

    Single-bucket form:  VerifyPipeline(fn, batch=B, msg_maxlen=L)
    Multi-bucket form:   VerifyPipeline(fn, buckets=DEFAULT_BUCKETS)

    verify_fn is a strict verifier with dispatch_blob (the port's
    SigVerifier, covering the largest bucket): each bucket is a packed
    blob dispatched in one upload, pinned when verify_fn.device is a CUDA
    device, and the verdict is a future with is_ready /
    copy_to_host_async / np.asarray.  tcache_depth: the dedup window in
    distinct signatures, held in a NativeTCache.  native_hostpath runs the
    packed-row submit and finish as one C call a frag; False runs them in
    NumPy, bit-identical.  max_inflight > 0 runs the async data plane
    (filled batches dispatch without waiting; harvest() retires them); 0
    returns each batch's verdicts from the submit that fills it.  lat_shapes
    adds the low-latency lane.  egress_packed makes packed-row harvests
    return one PackedVerdicts per frag.  tracer (a TraceRing, the tile's
    ctx.trace) records the coalesce, compile, dispatch, device and harvest
    spans of every batch.
    """

    def __init__(self, verify_fn, batch: int | None = None,
                 msg_maxlen: int | None = None, tcache_depth: int = 1 << 16,
                 buckets=None, max_inflight: int = 0, tracer=None,
                 n_buffers: int = 2, heartbeat_cb=None, lat_shapes=None,
                 deadline_us: int = 2000, lat_max_inflight: int = 2,
                 lat_spill_age_factor: float = 4.0,
                 native_hostpath: bool = True,
                 egress_packed: bool = False):
        if buckets is None:
            if batch is None or msg_maxlen is None:
                raise ValueError("need either (batch, msg_maxlen) or buckets")
            buckets = ((batch, msg_maxlen),)
        if (not hasattr(verify_fn, "dispatch_blob")
                or getattr(verify_fn, "mode", "strict") != "strict"):
            raise ValueError("the pipeline dispatches packed blobs: it "
                             "needs a strict verifier with dispatch_blob")
        self.verify_fn = verify_fn
        dev = getattr(verify_fn, "device", None)
        pinned = isinstance(dev, torch.device) and dev.type == "cuda"
        self.buckets = [
            _Bucket(b, m, n_buffers=n_buffers, bidx=i, pinned=pinned)
            for i, (b, m) in enumerate(sorted(buckets, key=lambda t: t[1]))
        ]
        # the burst parser queries the window inline from C; a host
        # library that fails to build raises here
        self.tcache = NativeTCache(tcache_depth)
        self._hp = native.lib() if native_hostpath else None
        # the native finish's scratch, grown to the worst case n*(65+ml)
        # once a shape and reused after
        self._hp_arena = np.empty(0, np.uint8)
        self._hp_offs = np.empty(1, np.int64)
        self._hp_tags = np.empty(0, np.uint64)
        self._hp_cnt = np.zeros(3, np.int64)
        self.egress_packed = bool(egress_packed)
        self.metrics = VerifyMetrics()
        self.max_inflight = max_inflight
        self.tracer = tracer
        # bulk batches retired per NON-blocking harvest poll: a bulk
        # finish is host work, and an unbounded drain would hold the
        # deadline lane behind it (the lat lane is never quota'd)
        self.harvest_quota = 2
        self.inflight: deque[_Inflight] = deque()
        self._seen_shapes: set[tuple[int, int]] = set()
        # called while blocked on a device verdict (the tile's heartbeat):
        # a long device wait must not read as a dead tile
        self.heartbeat_cb = heartbeat_cb
        # ---- low-latency lane ----------------------------------------
        # Admitted txns accumulate in ONE bucket shaped as the LARGEST lat
        # shape; at close (fill, or deadline_us on the oldest txn) the
        # batch ships as the SMALLEST ladder shape that holds it.  lat
        # batches retire through their own inflight queue, never behind
        # a throughput batch.
        self.lat_shapes = tuple(sorted(int(s) for s in (lat_shapes or ())))
        self.deadline_us = int(deadline_us)
        self.lat_max_inflight = max(1, int(lat_max_inflight))
        self.lat_spill_age_ns = int(
            float(lat_spill_age_factor) * self.deadline_us * 1_000)
        self.lat_inflight: deque[_Inflight] = deque()
        if self.lat_shapes:
            self.lat_bucket = _Bucket(
                self.lat_shapes[-1], min(m for _, m in buckets),
                n_buffers=n_buffers, bidx=len(self.buckets), lane=1,
                pinned=pinned)
        else:
            self.lat_bucket = None

    @property
    def has_pending(self) -> bool:
        """True iff some admitted txn has no verdict yet: open in a bucket
        or in flight on the device."""
        return (self.has_open or bool(self.inflight)
                or bool(self.lat_inflight))

    @property
    def has_open(self) -> bool:
        """True iff some bucket holds UNDISPATCHED txns: the age-flush
        predicate (in-flight batches need harvesting, not flushing)."""
        return (any(bk.pending for bk in self.buckets)
                or bool(self.lat_bucket and self.lat_bucket.pending))

    def _bucket_for(self, msg_len: int) -> _Bucket | None:
        for bk in self.buckets:  # sorted by maxlen: smallest fitting bucket
            if msg_len <= bk.maxlen:
                return bk
        return None

    # ---- low-latency lane ----------------------------------------------
    def mark_warm(self, shapes) -> None:
        """Record (batch, maxlen) shapes as warmed at boot: their first
        dispatch here does not count in compile_cnt, so a nonzero
        compile_cnt means a shape nobody warmed reached the hot path."""
        for b, ml in shapes:
            self._seen_shapes.add((int(b), int(ml)))

    def _lat_overloaded(self) -> bool:
        """The lane's dispatch-ahead depth is at budget, or its open
        queue has aged far past the deadline: new admissions spill to the
        throughput lane."""
        if len(self.lat_inflight) >= self.lat_max_inflight:
            return True
        bk = self.lat_bucket
        return bool(
            bk.t_first and self.lat_spill_age_ns
            and time.perf_counter_ns() - bk.t_first > self.lat_spill_age_ns)

    def _fit_rows(self, used: int) -> int:
        """The smallest lat shape holding `used` filled lanes."""
        for s in self.lat_shapes:
            if s >= used:
                return s
        return self.lat_shapes[-1]

    def _flush_lat(self, deadline: bool = False) -> list:
        bk = self.lat_bucket
        if bk is None or not bk.pending:
            return []
        if deadline:
            self.metrics.lat_deadline_closes += 1
        return self._flush_bucket(bk, rows=self._fit_rows(bk.used))

    def lat_due(self, now_ns: int | None = None) -> bool:
        """True iff the open low-latency batch's OLDEST txn has aged past
        deadline_us."""
        bk = self.lat_bucket
        if bk is None or not bk.pending or self.deadline_us <= 0:
            return False
        now = time.perf_counter_ns() if now_ns is None else now_ns
        return now - bk.t_first >= self.deadline_us * 1_000

    def dispatch_due(self) -> list:
        """Close the open lat batch once its oldest txn hits deadline_us,
        at any fill; returns completed batches of either lane."""
        out = self._flush_lat(deadline=True) if self.lat_due() else []
        if self.max_inflight > 0:
            out += self.harvest()
        return out

    def submit(self, payload: bytes,
               lat: bool = False) -> list[tuple[bytes, txn_lib.Txn]]:
        """Feed one serialized txn.  Returns verified txns flushed by this
        submit (empty unless an open batch filled and was dispatched).

        lat=True admits the txn to the low-latency lane; when the lane is
        overloaded, or the txn does not fit its shape, it SPILLS to the
        throughput lane (lat_spill)."""
        self.metrics.txns_in += 1
        try:
            parsed = txn_lib.parse(payload)
        except txn_lib.TxnParseError:
            self.metrics.parse_fail += 1
            return []

        msg = parsed.message(payload)
        sigs = parsed.signatures(payload)
        bk = None
        if lat and self.lat_bucket is not None:
            lb = self.lat_bucket
            if (len(msg) <= lb.maxlen and len(sigs) <= lb.batch
                    and not self._lat_overloaded()):
                bk = lb
            else:
                self.metrics.lat_spill += 1
        if bk is None:
            bk = self._bucket_for(len(msg))
            if bk is None:
                self.metrics.too_long_drop += 1
                return []

        if len(sigs) > bk.batch:
            # a txn's sig lanes must fit one device batch
            self.metrics.sig_overflow_drop += 1
            return []
        # pre-dedup on the low 64 bits of the first signature
        # (fd_verify.h:64-71), query only: the tag is inserted once the
        # txn PASSES, so a mangled copy cannot block the valid one
        tag = int.from_bytes(sigs[0][:8], "little")
        if self.tcache.query(tag):
            self.metrics.dedup_drop += 1
            return []

        out = []
        if bk.used + len(sigs) > bk.batch:
            out = (self._flush_lat() if bk.lane
                   else self._flush_bucket(bk))
        pubs = parsed.signer_pubkeys(payload)
        lanes = []
        for s, p in zip(sigs, pubs):
            lane = bk.used
            bk.msgs[lane, : len(msg)] = np.frombuffer(msg, dtype=np.uint8)
            bk.set_len(lane, len(msg))
            bk.sigs[lane] = np.frombuffer(s, dtype=np.uint8)
            bk.pubs[lane] = np.frombuffer(p, dtype=np.uint8)
            lanes.append(lane)
            bk.used += 1
        if not bk.t_first:
            bk.t_first = time.perf_counter_ns()
        bk.pending.append(_Pending(payload, parsed, lanes, tag))
        if bk.lane:
            self.metrics.lat_txns += 1
        if bk.used == bk.batch:
            out += self._flush_lat() if bk.lane else self._flush_bucket(bk)
        return out

    def submit_burst(self, payloads=None, packed=None) -> list:
        """Feed many serialized txns with ONE native parse, dedup query and
        bucket fill a fill of the first bucket (native/txnparse.cpp).

        Input: payloads (list[bytes]), or packed=(buf, offs), a flat
        buffer with int64 offsets (n+1) such as a ring's rx scratch, read
        in place.  Returns the verified txns flushed by this call as
        (payload, None): the burst path builds no Txn descriptor.

        Bursts fill the PRIMARY bucket (the first of the ladder); a txn
        whose message is longer reroutes through submit() and the ladder.
        A txn whose lanes do not fit what is left flushes the bucket and
        is parsed again into the empty one."""
        if packed is None:
            packed = tn.pack_payloads(payloads)
        buf, offs = packed
        handle = self.tcache.handle

        out = []
        bk = self.buckets[0]
        idx = 0
        n = len(offs) - 1
        while idx < n:
            r = tn.parse_packed_bucket(buf, offs[idx:], bk.arr, bk.maxlen,
                                       bk.lens, bk.used, handle)
            errs = r.err
            too_long = np.nonzero(errs == tn.ERR_TOO_LONG)[0]
            reroute = len(self.buckets) > 1
            self.metrics.txns_in += r.consumed - (
                len(too_long) if reroute else 0)
            self.metrics.parse_fail += int((errs == tn.ERR_PARSE).sum())
            self.metrics.dedup_drop += int((errs == tn.ERR_DUP).sum())
            self.metrics.sig_overflow_drop += int(
                (errs == tn.ERR_SIG_CAP).sum())
            if reroute:
                for i in too_long:
                    j = idx + int(i)
                    out += self.submit(bytes(buf[offs[j]:offs[j + 1]]))
            else:
                self.metrics.too_long_drop += len(too_long)
            acc = np.nonzero(errs == tn.OK)[0]
            if len(acc):
                # one copy of this round's region; accepted txns address
                # into it by (start, len), made bytes only if they pass
                base = int(offs[idx])
                region = bytes(
                    memoryview(buf)[base:int(offs[idx + r.consumed])])
                starts = (offs[idx:][acc] - base).astype(np.int64)
                plens = (offs[idx:][acc + 1] - offs[idx:][acc]).astype(
                    np.int32)
                if not bk.t_first:
                    bk.t_first = time.perf_counter_ns()
                bk.pending.append(_BurstPending(
                    region, starts, plens,
                    r.lane0[acc], r.nsig[acc], r.tag[acc]))
                bk.used += r.lanes_used
            pre_used = bk.used
            idx += r.consumed
            if idx >= n:
                break
            # the parser stopped early: the next txn needs more lanes than
            # are left, so flush and parse it again into the empty bucket
            out += self._flush_bucket(bk)
            if r.consumed == 0 and pre_used == 0:
                # not even an empty bucket holds it (ERR_SIG_CAP already
                # drops a txn wider than the bucket)
                self.metrics.txns_in += 1
                self.metrics.sig_overflow_drop += 1
                idx += 1
        if bk.used == bk.batch:
            out += self._flush_bucket(bk)
        return out

    def submit_packed_rows(self, rows, n: int | None = None, guard=None,
                           release_cb=None, lat: bool = False) -> list:
        """Packed-wire submit: `rows` is a (batch, ml+100) uint8 array
        already in the device-blob row layout (msg | sig | pub |
        len-le32); it goes straight to verify_fn.dispatch_blob, with no
        payload copy on the host.

        n: true row count (rows beyond are zero padding: tag 0, excluded
        from dedup and counts).  guard=(mcache, seq): the frag's seqlock
        is re-checked AFTER the dispatch call; a torn frag is dropped
        whole (torn_drop), never verified.  release_cb fires exactly once
        when the frag retires.  lat=True routes the frag through the
        low-latency lane: the dispatch takes the closest-fit ladder shape
        >= n, and an overloaded lane spills the frag to the throughput
        path (lat_spill += n)."""
        nrows = rows.shape[0]
        ml = rows.shape[1] - PACKED_EXTRA
        n = nrows if n is None else min(int(n), nrows)
        # dedup tags = low 64 bits of the signature (row[ml:ml+8]), query
        # only here: tags insert at harvest iff verify passes
        if self._hp is not None:
            # strided gather and batched query in one C call, straight off
            # the row view
            if not (isinstance(rows, np.ndarray) and rows.dtype == np.uint8
                    and rows.strides[1] == 1):
                raise ValueError("the native host path takes uint8 NumPy "
                                 "rows with unit column stride")
            tag = np.empty(n, np.uint64)
            dup8 = np.empty(n, np.uint8)
            ndup = int(self._hp.fd_hostpath_submit_rows(
                ctypes.c_void_p(rows.ctypes.data), int(rows.strides[0]), n,
                ml, ctypes.c_void_p(self.tcache.handle),
                ctypes.c_void_p(tag.ctypes.data),
                ctypes.c_void_p(dup8.ctypes.data)))
            dup = dup8.view(bool)
        else:
            tag = np.ascontiguousarray(rows[:n, ml:ml + 8]).view(
                np.uint64).ravel()
            dup = self.tcache.query_batch(tag)
            ndup = int(dup.sum())

        lane = 0
        nd = nrows                       # dispatched row count
        if lat and self.lat_shapes:
            if self._lat_overloaded():
                self.metrics.lat_spill += n
            else:
                lane = 1
                self.metrics.lat_txns += n
                fit = next((s for s in self.lat_shapes if s >= n), None)
                if fit is not None and fit < nrows:
                    nd = fit
        t0 = time.perf_counter_ns()
        shape = (nd, ml)
        first_dispatch = shape not in self._seen_shapes
        blob = rows if nd == nrows else rows[:nd]
        ok_dev = self.verify_fn.dispatch_blob(blob, maxlen=ml)
        if first_dispatch:
            self._seen_shapes.add(shape)
            dt = time.perf_counter_ns() - t0
            self.metrics.compile_cnt += 1
            self.metrics.compile_ns += dt
            if self.tracer is not None:
                self.tracer.record(
                    trace_mod.KIND_COMPILE, t0, dt,
                    iidx=trace_mod.LANE_LAT if lane else 0)
        if guard is not None:
            # the payload was never copied under the seqlock, so the
            # overrun check comes AFTER the device got its read underway
            mcache, seq = guard
            rc, _ = mcache.query(seq)
            if rc != 0:
                self.metrics.torn_drop += 1
                self.metrics.torn_txns += n
                if release_cb is not None:
                    release_cb()
                return []
        self.metrics.txns_in += n
        self.metrics.dedup_drop += ndup
        start_async = getattr(ok_dev, "copy_to_host_async", None)
        if start_async is not None:
            start_async()
        self.metrics.lanes_filled += n
        self.metrics.lanes_dispatched += nd
        self.metrics.last_fill_pct = 100 * n // nd
        fl = _Inflight(ok_dev,
                       [_RowsPending(rows, tag, dup, n, ml, release_cb)],
                       t0, lane=lane, t_first=t0)
        if self.max_inflight <= 0:
            return self._finish(fl)
        q = self.lat_inflight if lane else self.inflight
        q.append(fl)
        out = []
        while len(q) > self.max_inflight:
            out += self._finish(q.popleft())
        return out + self.harvest()

    def flush(self) -> list[tuple[bytes, txn_lib.Txn]]:
        """Dispatch every bucket with pending txns and harvest EVERYTHING
        (blocking); returns passing txns."""
        out = self._flush_lat()
        for bk in self.buckets:
            out += self._flush_bucket(bk)
        out += self.harvest(block=True)
        return out

    def dispatch_open(self) -> list[tuple[bytes, txn_lib.Txn]]:
        """Age-flush for the async tile: dispatch partially filled buckets
        WITHOUT waiting for their results (they surface via harvest())."""
        out = self._flush_lat()
        for bk in self.buckets:
            out += self._flush_bucket(bk)
        return out

    def harvest(self, block: bool = False) -> list[tuple[bytes, txn_lib.Txn]]:
        """Collect verdicts of completed in-flight batches, in dispatch
        order per lane.  block=False stops at the first still-running
        batch; block=True drains both queues.  The low-latency queue
        drains FIRST, and between bulk finishes; a non-blocking call
        retires at most harvest_quota bulk batches (the rest retire on
        later polls)."""
        out = self._drain_lat(block)
        n_bulk = 0
        while self.inflight:
            if not block:
                if n_bulk >= self.harvest_quota:
                    break
                if not _is_ready(self.inflight[0].ok_dev):
                    break
            out += self._finish(self.inflight.popleft())
            n_bulk += 1
            if self.lat_due():
                out += self._flush_lat(deadline=True)
            out += self._drain_lat(block=False)
        return out

    def _drain_lat(self, block: bool = False) -> list:
        out = []
        while self.lat_inflight:
            if not block and not _is_ready(self.lat_inflight[0].ok_dev):
                break
            out += self._finish(self.lat_inflight.popleft())
        return out

    def _flush_bucket(self, bk: _Bucket,
                      rows: int | None = None) -> list:
        """Dispatch a bucket's open batch.  rows (low-latency lane only)
        dispatches just the first `rows` lanes, the closest-fit ladder
        shape; a leading row slice is contiguous, so it is exactly the
        smaller shape's layout."""
        if not bk.pending:
            return []
        t0 = time.perf_counter_ns()
        tr_idx = bk.bidx | (trace_mod.LANE_LAT if bk.lane else 0)
        if bk.t_first:
            self.metrics.coalesce_ns.sample(t0 - bk.t_first)
            if self.tracer is not None:
                self.tracer.record(trace_mod.KIND_COALESCE, bk.t_first,
                                   t0 - bk.t_first, iidx=tr_idx,
                                   cnt=len(bk.pending))
        nrows = bk.batch if rows is None else min(int(rows), bk.batch)
        self.metrics.lanes_filled += bk.used
        self.metrics.lanes_dispatched += nrows
        self.metrics.last_fill_pct = 100 * bk.used // nrows
        shape = (nrows, bk.maxlen)
        first_dispatch = shape not in self._seen_shapes
        blob = bk.blob if nrows == bk.batch else bk.blob[:nrows]
        ok_dev = self.verify_fn.dispatch_blob(blob, maxlen=bk.maxlen)
        if first_dispatch:
            self._seen_shapes.add(shape)
            dt = time.perf_counter_ns() - t0
            self.metrics.compile_cnt += 1
            self.metrics.compile_ns += dt
            if self.tracer is not None:
                self.tracer.record(trace_mod.KIND_COMPILE, t0, dt,
                                   iidx=tr_idx)
        start_async = getattr(ok_dev, "copy_to_host_async", None)
        if start_async is not None:
            start_async()
        # the blob stays pinned under this dispatch; reset() below rotates
        # a FREE pool blob in, so the next batch packs while this one
        # uploads and verifies
        fl = _Inflight(ok_dev, bk.pending, t0, buf=bk.blob, owner=bk,
                       lane=bk.lane, t_first=bk.t_first)
        bk.reset()
        if self.max_inflight <= 0:
            if self.tracer is not None:
                self.tracer.record(trace_mod.KIND_DISPATCH, t0,
                                   time.perf_counter_ns() - t0,
                                   iidx=tr_idx, cnt=len(fl.pending))
            return self._finish(fl)          # synchronous mode
        q = self.lat_inflight if bk.lane else self.inflight
        q.append(fl)
        out = []
        while len(q) > self.max_inflight:
            # bounded queue: retire the oldest before accepting more
            out += self._finish(q.popleft())
        if self.tracer is not None:
            # the dispatch call and the over-budget drain above: a full
            # inflight queue blocks there, so this span is the
            # dispatch-queue pressure
            self.tracer.record(trace_mod.KIND_DISPATCH, t0,
                               time.perf_counter_ns() - t0, iidx=tr_idx,
                               cnt=len(fl.pending))
        return out + self.harvest()

    def _finish(self, fl: _Inflight) -> list[tuple[bytes, txn_lib.Txn]]:
        if self.heartbeat_cb is not None:
            # heartbeat through the device wait instead of blocking cold;
            # start at 50 us and back off toward 500 us
            wait = 50e-6
            while not _is_ready(fl.ok_dev):
                self.heartbeat_cb()
                time.sleep(wait)
                wait = min(wait * 2, 500e-6)
        ok = np.asarray(fl.ok_dev)           # blocks only if still running
        if fl.buf is not None:
            # verdict materialized => the stream finished both the blob's
            # upload and the verify that read it; only now may the blob
            # re-enter the pack rotation
            fl.owner.release(fl.buf)
            fl.buf = None
        now = time.perf_counter_ns()
        self.metrics.batches += 1
        self.metrics.batch_ns.sample(now - fl.t0)
        if fl.lane:
            self.metrics.lat_batches += 1
            if fl.t_first:
                self.metrics.lat_e2e_ns.sample(now - fl.t_first)
        elif fl.t_first:
            self.metrics.e2e_ns.sample(now - fl.t_first)
        tr_idx = ((fl.owner.bidx if fl.owner is not None else 0)
                  | (trace_mod.LANE_LAT if fl.lane else 0))
        if self.tracer is not None:
            self.tracer.record(trace_mod.KIND_DEVICE, fl.t0, now - fl.t0,
                               iidx=tr_idx, cnt=len(fl.pending))
        out = []
        for p in fl.pending:
            if isinstance(p, _RowsPending):
                out += self._finish_rows(p, ok)
            elif isinstance(p, _BurstPending):
                out += self._finish_burst(p, ok)
            elif all(ok[lane] for lane in p.lanes):
                if self.tcache.insert(p.tag):
                    # same tag verified twice inside one open batch window
                    self.metrics.dedup_drop += 1
                    continue
                self.metrics.verify_pass += 1
                out.append((p.payload, p.parsed))
            else:
                self.metrics.verify_fail += 1
        if self.tracer is not None:
            # harvest: verdict materialized -> passing txns rebuilt
            self.tracer.record(trace_mod.KIND_HARVEST, now,
                               time.perf_counter_ns() - now, iidx=tr_idx,
                               cnt=len(out))
        return out

    def _finish_rows(self, rp: _RowsPending, ok) -> list:
        """Harvest one packed-wire frag: verdicts are per row (one sig a
        row on this path); passing payloads are rebuilt in the single-sig
        wire form (0x01 | sig | msg) from the rows, then release_cb
        fires.  The native host path does it in one C call
        (fd_hostpath_finish_rows), the NumPy finish is its plain version.
        Egress is a [(bytes, None)] list, or with egress_packed one
        PackedVerdicts."""
        try:
            okv = np.asarray(ok[:rp.n])
            pv = (self._hp_finish(rp, okv) if self._hp is not None
                  else self._np_finish(rp, okv))
            if pv is None:
                return []
            if self.egress_packed:
                return [pv]
            return [(w, None) for w in pv.wires()]
        finally:
            if rp.release_cb is not None:
                rp.release_cb()

    def _hp_finish(self, rp: _RowsPending, okv) -> "PackedVerdicts | None":
        """One-pass C finish: masks, inserts, and builds the wires of one
        frag into the grow-only scratch arena (worst case n*(65+ml)
        bytes, allocated once a shape)."""
        n, ml = rp.n, rp.ml
        ok8 = np.ascontiguousarray(okv, dtype=np.uint8)
        dup8 = rp.dup.view(np.uint8)
        cap = n * (65 + ml)
        if self._hp_arena.nbytes < cap:
            self._hp_arena = np.empty(cap, np.uint8)
        if len(self._hp_offs) < n + 1:
            self._hp_offs = np.empty(n + 1, np.int64)
            self._hp_tags = np.empty(n, np.uint64)
        while True:
            rc = self._hp.fd_hostpath_finish_rows(
                ctypes.c_void_p(rp.rows.ctypes.data),
                int(rp.rows.strides[0]), n, ml,
                ctypes.c_void_p(ok8.ctypes.data),
                ctypes.c_void_p(rp.tag.ctypes.data),
                ctypes.c_void_p(dup8.ctypes.data),
                ctypes.c_void_p(self.tcache.handle),
                ctypes.c_void_p(self._hp_arena.ctypes.data),
                int(self._hp_arena.nbytes),
                ctypes.c_void_p(self._hp_offs.ctypes.data),
                ctypes.c_void_p(self._hp_tags.ctypes.data),
                ctypes.c_void_p(self._hp_cnt.ctypes.data))
            if rc >= 0:
                break
            # arena too small (the worst-case sizing above rules it out
            # unless the scratch was swapped): the call touched NOTHING,
            # so grow and retry for the same result
            self._hp_arena = np.empty(-int(rc), np.uint8)
        k = int(rc)
        self.metrics.verify_fail += int(self._hp_cnt[0])
        self.metrics.dedup_drop += int(self._hp_cnt[1])
        self.metrics.verify_pass += k
        if k == 0:
            return None
        nb = int(self._hp_offs[k])
        # copied out of the scratch: a PackedVerdicts outlives the next
        # frag's finish (a harvest retires several)
        return PackedVerdicts(self._hp_arena[:nb].copy(),
                              self._hp_offs[:k + 1].copy(),
                              self._hp_tags[:k].copy(), k)

    # the ragged wire build stages at most this many payload bytes (plus
    # the same-shape bool mask) at once, so one long row does not inflate
    # the harvest footprint to k * Lmax
    _NP_PAD_CAP = 1 << 18

    def _np_finish(self, rp: _RowsPending, okv) -> "PackedVerdicts | None":
        """The plain version of _hp_finish: the same verdict masking,
        tcache inserts with exact FD_TCACHE_INSERT semantics, and wire
        arena, by vectorized column copies."""
        ml = rp.ml
        okv = okv.astype(bool)
        live = rp.tag != 0
        passing = okv & ~rp.dup & live
        self.metrics.verify_fail += int((live & ~rp.dup & ~okv).sum())
        pass_idx = np.nonzero(passing)[0]
        if len(pass_idx) == 0:
            return None
        # insert tags only now (verify passed), across frags and within
        # this one
        dup2 = self.tcache.insert_batch_dedup(rp.tag[pass_idx])
        self.metrics.dedup_drop += int(dup2.sum())
        self.metrics.verify_pass += int((~dup2).sum())
        rows = rp.rows
        lens = np.ascontiguousarray(
            rows[:rp.n, ml + 96:ml + 100]).view(np.int32).ravel()
        keep = pass_idx[~dup2]
        if len(keep) == 0:
            return None
        klens = np.clip(lens[keep], 0, ml)
        k = len(keep)
        offs = np.empty(k + 1, np.int64)
        offs[0] = 0
        np.cumsum(65 + klens, out=offs[1:])
        arena = np.empty(int(offs[k]), np.uint8)
        if int(klens.min()) == int(klens.max()):
            # equal-length rows: the arena IS a (k, 65+L) matrix
            L = int(klens[0])
            wires = arena.reshape(k, 65 + L)
            wires[:, 0] = 1
            wires[:, 1:65] = rows[keep, ml:ml + 64]
            wires[:, 65:] = rows[keep, :L]
        else:
            # ragged lengths: a padded (c, 65+Lmax) staging block, chunked
            # under _NP_PAD_CAP, then per-row copies into the arena
            Lmax = int(klens.max())
            step = max(1, self._NP_PAD_CAP // (65 + Lmax))
            for c0 in range(0, k, step):
                c1 = min(c0 + step, k)
                kc, lc = keep[c0:c1], klens[c0:c1]
                Lm = int(lc.max())
                wires = np.empty((c1 - c0, 65 + Lm), np.uint8)
                wires[:, 0] = 1
                wires[:, 1:65] = rows[kc, ml:ml + 64]
                body = wires[:, 65:]
                msk = np.arange(Lm)[None, :] < lc[:, None]
                body[msk] = rows[kc, :Lm][msk]
                for j in range(c1 - c0):
                    o = int(offs[c0 + j])
                    arena[o:o + 65 + int(lc[j])] = wires[j, :65 + int(lc[j])]
        return PackedVerdicts(arena, offs, rp.tag[keep].copy(), k)

    def _finish_burst(self, bp: _BurstPending, ok) -> list:
        """Vectorized harvest of one burst record: a txn's verdict is the
        minimum over its (contiguous) lanes, then one batched tcache
        insert with exact FD_TCACHE_INSERT dup semantics."""
        k = len(bp.lane0)
        if k == 0:
            return []
        start = int(bp.lane0[0])
        end = int(bp.lane0[-1] + bp.nsig[-1])
        seg = np.asarray(ok[start:end], dtype=np.uint8)
        acc = np.minimum.reduceat(seg, bp.lane0 - start).astype(bool)
        pass_idx = np.nonzero(acc)[0]
        self.metrics.verify_fail += k - len(pass_idx)
        if len(pass_idx) == 0:
            return []
        dup = self.tcache.insert_batch_dedup(bp.tag[pass_idx])
        self.metrics.dedup_drop += int(dup.sum())
        self.metrics.verify_pass += int((~dup).sum())
        buf = bp.buf
        return [(buf[int(bp.start[i]):int(bp.start[i]) + int(bp.plen[i])],
                 None)
                for i, d in zip(pass_idx, dup) if not d]
