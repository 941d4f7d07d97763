"""Python face of the port's tango fabric (firedancer_tpu_torch/native/
tango.cpp); the port's own copy of firedancer_tpu/tango/ring.py.

Workspace = named shared memory (the reference's hugepage wksp,
src/util/wksp/) with a deterministic bump allocator: every process that
builds the same topology computes the same offsets, so no directory needs
serializing (the reference materializes the topology identically in each
tile process, src/disco/topo/fd_topo.c).  The layouts are the JAX
package's byte for byte: a workspace either package created reads the same
through the other's rings.

MCache / Dcache / FSeq / Cnc wrap caller-owned byte ranges; all the
concurrency-sensitive code is in C++ (see tango.cpp for the seqlock
contract).  Hot consumers drain bursts through one ctypes call into a
numpy structured array.
"""

from multiprocessing import shared_memory
import ctypes

import numpy as np

from .. import native

FRAG_META_DTYPE = np.dtype(
    [
        ("seq", "<u8"),
        ("sig", "<u8"),
        ("chunk", "<u4"),
        ("sz", "<u2"),
        ("ctl", "<u2"),
        ("tsorig", "<u4"),
        ("tspub", "<u4"),
    ]
)
assert FRAG_META_DTYPE.itemsize == 32

# ctl bits (fd_tango_base.h:76-99): ctl = origin<<3 | SOM<<2 | EOM<<1 | ERR
CTL_SOM = 1 << 2
CTL_EOM = 1 << 1
CTL_ERR = 1 << 0


def ctl(origin: int = 0, som: bool = True, eom: bool = True, err: bool = False) -> int:
    return (origin << 3) | (CTL_SOM if som else 0) | (CTL_EOM if eom else 0) | (
        CTL_ERR if err else 0
    )


PACKED_ROW_EXTRA = 100  # sig 64 + pub 32 + len-le32 4 (ops/ed25519.py blob row)


def packed_row_ml(maxlen: int, chunk_sz: int = 64) -> int:
    """Message width `ml` such that the packed-blob row stride (ml +
    PACKED_ROW_EXTRA) is a multiple of the dcache chunk size.  With this
    ml, a dcache region written row-by-row IS a valid (n, ml+100) device
    blob: rows start on chunk boundaries, stride == row width exactly, so
    `dispatch_blob` can infer maxlen and AOT executables see stable shapes.
    """
    if maxlen <= 0:
        raise ValueError("maxlen must be positive")
    stride = -(-(maxlen + PACKED_ROW_EXTRA) // chunk_sz) * chunk_sz
    return stride - PACKED_ROW_EXTRA


class Workspace:
    """Named shared-memory region with a deterministic bump allocator."""

    ALIGN = 64

    def __init__(self, name: str, size: int, create: bool = False):
        self.name = name
        self.shm = shared_memory.SharedMemory(
            name=name, create=create, size=size if create else 0
        )
        self.created = create
        self._top = 0

    @property
    def buf(self) -> memoryview:
        return self.shm.buf

    def alloc(self, footprint: int, align: int = ALIGN) -> int:
        """Bump-allocate; returns byte offset.  Deterministic: identical
        alloc sequences in different processes yield identical offsets."""
        off = (self._top + align - 1) & ~(align - 1)
        if off + footprint > len(self.shm.buf):
            raise MemoryError(
                f"workspace {self.name}: alloc {footprint} @ {off} exceeds "
                f"{len(self.shm.buf)}"
            )
        self._top = off + footprint
        return off

    def ptr(self, off: int = 0) -> ctypes.c_void_p:
        base = ctypes.addressof(ctypes.c_char.from_buffer(self.shm.buf))
        return ctypes.c_void_p(base + off)

    def close(self):
        self.shm.close()

    def unlink(self):
        try:
            self.shm.unlink()
        except FileNotFoundError:
            pass


class MCache:
    """Single-producer broadcast metadata ring (fd_mcache equivalent)."""

    def __init__(self, ws: Workspace, off: int, depth: int):
        self.ws = ws
        self.off = off
        self.depth = depth
        self._p = ws.ptr(off)
        self._L = native.lib()

    @classmethod
    def footprint(cls, depth: int) -> int:
        fp = native.lib().fd_mcache_footprint(depth)
        if not fp:
            raise ValueError(f"bad mcache depth {depth}")
        return fp

    @classmethod
    def new(cls, ws: Workspace, depth: int, seq0: int = 0) -> "MCache":
        off = ws.alloc(cls.footprint(depth))
        rc = native.lib().fd_mcache_new(ws.ptr(off), depth, seq0)
        if rc:
            raise ValueError("fd_mcache_new failed")
        return cls(ws, off, depth)

    @classmethod
    def join(cls, ws: Workspace, off: int) -> "MCache":
        depth = native.lib().fd_mcache_depth(ws.ptr(off))
        if not depth:
            raise ValueError("no mcache at offset")
        return cls(ws, off, depth)

    def seq0(self) -> int:
        return self._L.fd_mcache_seq0(self._p)

    def seq_query(self) -> int:
        return self._L.fd_mcache_seq_query(self._p)

    def publish(
        self,
        sig: int,
        chunk: int = 0,
        sz: int = 0,
        ctl_: int = CTL_SOM | CTL_EOM,
        tsorig: int = 0,
        tspub: int = 0,
    ) -> int:
        return self._L.fd_mcache_publish(
            self._p, sig, chunk, sz, ctl_, tsorig, tspub
        )

    def query(self, want: int):
        """Returns (rc, meta): rc 0 ok / -1 not yet / 1 overrun."""
        out = np.zeros(1, dtype=FRAG_META_DTYPE)
        rc = self._L.fd_mcache_query(
            self._p, want, out.ctypes.data_as(ctypes.c_void_p)
        )
        return rc, out[0]

    def consume_burst(self, want: int, max_frags: int):
        """Returns (metas, rc_after): metas is a structured array of the
        frags consumed starting at `want`; rc_after is the status of the
        first unconsumed slot (0 = burst full, -1 = caught up, 1 = overrun)."""
        out = np.zeros(max_frags, dtype=FRAG_META_DTYPE)
        n = ctypes.c_uint64(0)
        rc = self._L.fd_mcache_consume_burst(
            self._p,
            want,
            max_frags,
            out.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(n),
        )
        return out[: n.value], rc


class Dcache:
    """Chunk-addressed payload region with compact-ring allocation.

    Layout: [ 64B header (magic, mtu, data_sz, wmark) | data ].  The header
    makes join() self-describing so every process rebuilds the same view.
    Chunk indices are relative to the data area.
    """

    _HDR = 64
    _MAGIC = 0xFD7A6FDCAC4E0001

    def __init__(self, ws: Workspace, off: int):
        self.ws = ws
        self.off = off
        self.chunk_sz = native.lib().fd_dcache_chunk_sz()
        hdr = np.frombuffer(ws.buf, dtype=np.uint64, count=4, offset=off)
        if int(hdr[0]) != self._MAGIC:
            raise ValueError("no dcache at offset")
        self.mtu = int(hdr[1])
        self.data_sz = int(hdr[2])
        self.wmark = int(hdr[3])
        self.chunk0 = 0
        self._arr = np.frombuffer(
            ws.buf, dtype=np.uint8, count=self.data_sz, offset=off + self._HDR
        )

    @classmethod
    def footprint(cls, mtu: int, depth: int, burst: int = 1) -> int:
        return cls._HDR + native.lib().fd_dcache_req_data_sz(mtu, depth, burst)

    @classmethod
    def new(cls, ws: Workspace, mtu: int, depth: int, burst: int = 1) -> "Dcache":
        data_sz = native.lib().fd_dcache_req_data_sz(mtu, depth, burst)
        off = ws.alloc(cls._HDR + data_sz)
        chunk_sz = native.lib().fd_dcache_chunk_sz()
        hdr = np.frombuffer(ws.buf, dtype=np.uint64, count=4, offset=off)
        hdr[1] = mtu
        hdr[2] = data_sz
        hdr[3] = (data_sz - mtu) // chunk_sz  # last chunk an mtu write fits at
        hdr[0] = cls._MAGIC  # magic last: joiners see a complete header
        return cls(ws, off)

    @classmethod
    def join(cls, ws: Workspace, off: int) -> "Dcache":
        return cls(ws, off)

    def write(self, chunk: int, data: bytes) -> int:
        """Write payload at chunk; returns the next chunk (compact ring)."""
        start = chunk * self.chunk_sz
        self._arr[start : start + len(data)] = np.frombuffer(data, dtype=np.uint8)
        return native.lib().fd_dcache_compact_next(
            chunk, len(data), self.chunk0, self.wmark
        )

    def read(self, chunk: int, sz: int) -> bytes:
        start = chunk * self.chunk_sz
        return bytes(self._arr[start : start + sz])

    def view(self, chunk: int, sz: int) -> np.ndarray:
        """Zero-copy uint8 view of [chunk, chunk + sz bytes) over the shm.
        The view stays valid only until the producer laps the ring — pair
        any read through it with an mcache seq re-check afterwards."""
        start = chunk * self.chunk_sz
        if start + sz > self.data_sz:
            raise ValueError(
                f"dcache view [{start}, {start + sz}) exceeds data_sz "
                f"{self.data_sz}")
        return self._arr[start : start + sz]

    def rows(self, chunk: int, n: int, stride: int) -> np.ndarray:
        """Zero-copy (n, stride) row view starting at chunk: the packed-blob
        shape `dispatch_blob`/`parse_packed_bucket` consume directly.  The
        frag must not wrap the compact ring (guaranteed when the dcache mtu
        covers the whole frag, as fd_dcache_compact_next never splits an
        <= mtu write)."""
        return self.view(chunk, n * stride).reshape(n, stride)

    def write_view(self, chunk: int, sz: int) -> np.ndarray:
        """Writable zero-copy view for readinto-style producer fills.  The
        caller stamps payload bytes directly into shm, then advances with
        `advance(chunk, sz)` and publishes the frag meta — no staging bytes
        object ever materializes."""
        return self.view(chunk, sz)

    def advance(self, chunk: int, sz: int) -> int:
        """Next chunk after an sz-byte write at chunk (compact ring)."""
        return native.lib().fd_dcache_compact_next(
            chunk, sz, self.chunk0, self.wmark)

    def data_ptr(self) -> ctypes.c_void_p:
        """Base pointer of the data area (native burst rx/tx)."""
        return self.ws.ptr(self.off + self._HDR)


def rx_burst(mcache: "MCache", dcache: "Dcache", want: int, max_frags: int,
             buf: np.ndarray, metas: np.ndarray, offs: np.ndarray,
             rr_cnt: int = 1, rr_idx: int = 0):
    """Native burst consume (tango.cpp fd_ring_rx_burst): drain up to
    `max_frags` frags from `want`, seqlock-validated payload copy into
    `buf`, optional round-robin filter at the ring.  Caller provides the
    scratch arrays (reused across polls): buf uint8 (cap,), metas
    FRAG_META_DTYPE (max_frags,), offs int64 (max_frags+1,).

    Returns (rc, consumed, kept, filtered): rc is the status of the first
    unconsumed slot (0 = burst/buf full, -1 = caught up, 1 = overrun).
    Payload of kept frag i = buf[offs[i]:offs[i+1]]."""
    L = native.lib()
    vp = ctypes.c_void_p
    c_cons = ctypes.c_uint64(0)
    c_kept = ctypes.c_uint64(0)
    c_filt = ctypes.c_uint64(0)
    rc = L.fd_ring_rx_burst(
        mcache._p, dcache.data_ptr(), dcache.chunk_sz, want, max_frags,
        rr_cnt, rr_idx, metas.ctypes.data_as(vp),
        buf.ctypes.data_as(vp), buf.nbytes, offs.ctypes.data_as(vp),
        ctypes.byref(c_cons), ctypes.byref(c_kept), ctypes.byref(c_filt))
    return rc, c_cons.value, c_kept.value, c_filt.value


def tx_burst(mcache: "MCache", dcache: "Dcache", chunk: int,
             buf, starts: np.ndarray, lens: np.ndarray,
             sigs: np.ndarray, tsorig: int = 0,
             tspub: int = 0) -> tuple[int, int]:
    """Native burst publish (tango.cpp fd_ring_tx_burst): payload i =
    buf[starts[i]:starts[i]+lens[i]] with app sig sigs[i].  NO flow
    control — the caller must hold len(starts) credits.  tsorig is the
    span-chain origin stamp carried through from the consumed frag (0 =
    this burst originates the chain).  Returns (last_seq, next_chunk)."""
    L = native.lib()
    vp = ctypes.c_void_p
    n = len(starts)
    chunk_io = np.array([chunk], dtype=np.uint64)
    if isinstance(buf, (bytes, bytearray, memoryview)):
        # np.frombuffer is a zero-copy view (works for readonly buffers
        # too): no copy of the burst on a tx
        buf = np.frombuffer(buf, dtype=np.uint8)
    bp = buf.ctypes.data_as(vp)
    seq = L.fd_ring_tx_burst(
        mcache._p, dcache.data_ptr(), dcache.chunk_sz, dcache.chunk0,
        dcache.wmark, bp,
        np.ascontiguousarray(starts, np.int64).ctypes.data_as(vp),
        np.ascontiguousarray(lens, np.int32).ctypes.data_as(vp),
        np.ascontiguousarray(sigs, np.uint64).ctypes.data_as(vp),
        n, tsorig & 0xFFFFFFFF, tspub & 0xFFFFFFFF,
        chunk_io.ctypes.data_as(vp))
    return int(seq), int(chunk_io[0])


class FSeq:
    """Consumer->producer flow-control line (fd_fseq equivalent)."""

    # diag indices (see tango.cpp)
    DIAG_PUB_CNT, DIAG_PUB_SZ, DIAG_FILT_CNT, DIAG_FILT_SZ = 0, 1, 2, 3
    DIAG_OVRNP_CNT, DIAG_OVRNR_CNT, DIAG_SLOW_CNT = 4, 5, 6

    def __init__(self, ws: Workspace, off: int):
        self.ws = ws
        self.off = off
        self._p = ws.ptr(off)
        self._L = native.lib()

    @classmethod
    def new(cls, ws: Workspace, seq0: int = 0) -> "FSeq":
        off = ws.alloc(native.lib().fd_fseq_footprint())
        native.lib().fd_fseq_new(ws.ptr(off), seq0)
        return cls(ws, off)

    @classmethod
    def join(cls, ws: Workspace, off: int) -> "FSeq":
        return cls(ws, off)

    def update(self, seq: int):
        self._L.fd_fseq_update(self._p, seq)

    def reset(self, seq: int):
        """Supervisor-side eviction write: force the line to `seq`.

        Same store as update(), but named for the ONE legitimate writer
        besides the owning consumer — a supervisor fast-forwarding a dead
        consumer's line to the producer cursor so upstream credits unfreeze
        (fctl.Fctl.evict_dead_consumer).  A live consumer must never call
        this; a respawned one resumes FROM the value it finds here."""
        self._L.fd_fseq_update(self._p, seq)

    def query(self) -> int:
        return self._L.fd_fseq_query(self._p)

    def diag_add(self, idx: int, delta: int = 1):
        self._L.fd_fseq_diag_add(self._p, idx, delta)

    def diag(self, idx: int) -> int:
        return self._L.fd_fseq_diag_query(self._p, idx)


class Cnc:
    """Command-and-control line: signal + heartbeat (fd_cnc equivalent)."""

    SIGNAL_RUN, SIGNAL_BOOT, SIGNAL_FAIL, SIGNAL_HALT = 0, 1, 2, 3
    # drain protocol (graceful quiesce, supervisor-raised): DRAIN asks a
    # tile to stop admitting frags, run its in-flight work dry and park;
    # DRAINED is the tile's ack (it keeps heartbeating, parked, until the
    # supervisor raises HALT).  Values extend the fd_cnc signal space the
    # same way the reference reserves >FD_CNC_SIGNAL_FAIL for app signals
    # (fd_cnc.h: "user signals").
    SIGNAL_DRAIN, SIGNAL_DRAINED = 4, 5

    def __init__(self, ws: Workspace, off: int):
        self.ws = ws
        self.off = off
        self._p = ws.ptr(off)
        self._L = native.lib()

    @classmethod
    def new(cls, ws: Workspace) -> "Cnc":
        off = ws.alloc(native.lib().fd_cnc_footprint())
        native.lib().fd_cnc_new(ws.ptr(off))
        return cls(ws, off)

    @classmethod
    def join(cls, ws: Workspace, off: int) -> "Cnc":
        return cls(ws, off)

    def signal(self, sig: int):
        self._L.fd_cnc_signal(self._p, sig)

    def signal_query(self) -> int:
        return self._L.fd_cnc_signal_query(self._p)

    def heartbeat(self, now: int):
        self._L.fd_cnc_heartbeat(self._p, now)

    def heartbeat_query(self) -> int:
        return self._L.fd_cnc_heartbeat_query(self._p)
