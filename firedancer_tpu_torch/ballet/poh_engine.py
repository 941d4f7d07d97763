"""The PoH span engine (ref: src/disco/poh/fd_poh_tile.c's hashing core);
the port's own copy of firedancer_tpu/ballet/poh_engine.py.

The leader extends an iterated-sha256 chain while mixing in one merkle
root a microblock, and always has independent spans in flight: the
speculated next ticks, a tick's microblock splice, and the re-check of
entries already emitted.  Those spans are the LANES of one dispatch of
the PoH spans kernel (ops/poh_spans.py) through the port's
PackedDispatchEngine, on pinned rotating blobs.

Row wire format (one lane a row):

    start[32] | steps * ( mixin[32] | n u32 LE | has_mixin u8 | active u8 )

Steps chain within a lane: step s starts from step s-1's end state, so a
tick with j microblocks is one dispatch.  The verdict is every step's end
state (lanes, steps * 32).  A step's plain appends stop at its cap
(step_caps, else max_hashes), where the JAX scan of that length ends.
"""

import struct

import numpy as np

from .._device import resolve_device
from ..kernels import build
from ..models.verifier import PackedDispatchEngine, Verdict, WorkloadDesc
from ..ops.poh_spans import LANE_HDR_SZ, STEP_SZ, poh_spans, row_bytes
from . import entry as entry_lib

__all__ = ["LANE_HDR_SZ", "STEP_SZ", "row_bytes", "poh_spans_blob",
           "stamp_lanes", "host_spans", "PohEngine"]


def poh_spans_blob(blob, steps: int, max_hashes: int, step_caps=None):
    """The span kernel over a (lanes, row_bytes(steps)) uint8 tensor.
    Returns uint8 (lanes, steps * 32): each step's end state (inactive
    steps pass the running state through).  step_caps: per-step hash
    ceilings (len == steps), else max_hashes for every step."""
    caps = tuple(step_caps) if step_caps is not None \
        else (max_hashes,) * steps
    return poh_spans(blob, steps, caps)


def stamp_lanes(buf: np.ndarray, specs) -> None:
    """Write lane specs, (start: bytes32, [(n, mixin_bytes_or_None),
    ...]), into the rows of a uint8 (lanes, row_bytes(steps)) array in
    the row wire format; rows and steps past the specs stay inactive."""
    buf[:, :] = 0
    for li, (start, sspec) in enumerate(specs):
        row = buf[li]
        row[:32] = np.frombuffer(bytes(start), dtype=np.uint8)
        for si, (n, mx) in enumerate(sspec):
            base = LANE_HDR_SZ + si * STEP_SZ
            if mx is not None:
                row[base : base + 32] = np.frombuffer(bytes(mx),
                                                      dtype=np.uint8)
                row[base + 36] = 1
            row[base + 32 : base + 36] = np.frombuffer(
                struct.pack("<I", n), dtype=np.uint8)
            row[base + 37] = 1


def host_spans(specs, steps: int) -> np.ndarray:
    """Host golden twin of poh_spans_blob over the same lane specs
    (hashlib chain via entry.next_hash).  specs: list of
    (start: bytes32, [(n, mixin_bytes_or_None), ...]); returns uint8
    (len(specs), steps, 32)."""
    out = np.zeros((len(specs), steps, 32), dtype=np.uint8)
    for li, (start, sspec) in enumerate(specs):
        h = bytes(start)
        for si in range(steps):
            if si < len(sspec):
                n, mx = sspec[si]
                if n > 0:
                    h = entry_lib.next_hash(h, n, mx)
                elif mx is not None:
                    raise ValueError("mixin requires n >= 1")
            out[li, si] = np.frombuffer(h, dtype=np.uint8)
    return out


class PohEngine:
    """PoH span workload over the shared rotation core.

    The lanes x steps geometry is fixed at construction; submit_lanes()
    stamps however many lanes a call has into the rotating blob (unused
    lanes and steps stay inactive and pass through).  Verdicts retire in
    dispatch order.  device=None is the GPU; "cpu" runs the kernel's
    plain version."""

    def __init__(self, lanes: int, steps: int, max_hashes: int, *,
                 nbuf: int = 2, depth: int | None = None, step_caps=None,
                 device=None):
        if lanes < 1 or steps < 1 or max_hashes < 1:
            raise ValueError("bad poh engine geometry")
        if step_caps is not None:
            step_caps = tuple(int(c) for c in step_caps)
            if len(step_caps) != steps:
                raise ValueError("step_caps length != steps")
            if any(not (1 <= c <= max_hashes) for c in step_caps):
                raise ValueError("step cap outside [1, max_hashes]")
        self.lanes = lanes
        self.steps = steps
        self.max_hashes = max_hashes
        self.step_caps = step_caps  # None = uniform max_hashes per step
        self.device = resolve_device(device)
        self._caps = step_caps if step_caps is not None \
            else (max_hashes,) * steps
        desc = WorkloadDesc(rows=lanes, row_bytes=row_bytes(steps),
                            dispatch=self._dispatch,
                            pinned=self.device.type == "cuda")
        self._eng = PackedDispatchEngine(desc, nbuf=nbuf, depth=depth)

    # ------------------------------------------------------------ plumbing
    def _dispatch(self, blob):
        dev_blob = blob.to(self.device, non_blocking=True)
        return Verdict(poh_spans(dev_blob, self.steps, self._caps))

    def warm(self):
        """Build the kernel and launch it once with zero active lanes, so
        the first real dispatch builds nothing."""
        if self.device.type == "cuda":
            build.load("poh_spans")
        self._eng.submit_packed(lambda buf: buf.zero_(), 0)
        self._eng.drain()

    def _validate(self, specs):
        if len(specs) > self.lanes:
            raise ValueError(f"{len(specs)} lanes > engine {self.lanes}")
        total = 0
        for start, sspec in specs:
            if len(start) != 32:
                raise ValueError("start hash must be 32 bytes")
            if len(sspec) > self.steps:
                raise ValueError(f"{len(sspec)} steps > engine {self.steps}")
            for si, (n, mx) in enumerate(sspec):
                cap = self._caps[si]
                if not (0 <= n <= cap):
                    raise ValueError(f"step n={n} outside [0, {cap}]")
                if mx is not None and n < 1:
                    # the kernel passes n == 0 through but next_hash would
                    # absorb the mixin: reject the divergent stamp outright
                    raise ValueError("mixin requires n >= 1")
                if mx is not None and len(mx) != 32:
                    raise ValueError("mixin must be 32 bytes")
                total += 1
        return total

    def submit_lanes(self, specs) -> list[np.ndarray]:
        """Dispatch one batch of lane specs: list of
        (start: bytes32, [(n, mixin_bytes_or_None), ...]).  Returns any
        verdicts the inflight window retired this call (dispatch order);
        split with split_verdict."""
        total = self._validate(specs)
        return self._eng.submit_packed(
            lambda tbuf: stamp_lanes(tbuf.numpy(), specs), total)

    def split_verdict(self, verdict: np.ndarray) -> np.ndarray:
        """(lanes, steps*32) harvest blob -> (lanes, steps, 32)."""
        return verdict.reshape(self.lanes, self.steps, 32)

    # --------------------------------------------------- engine passthrough
    @property
    def dispatches(self) -> int:
        return self._eng.dispatches

    @property
    def inflight_depth(self) -> int:
        return self._eng.inflight_depth

    @property
    def backpressure_waits(self) -> int:
        return self._eng.backpressure_waits

    def poll(self) -> list[np.ndarray]:
        return self._eng.poll()

    def drain(self) -> list[np.ndarray]:
        return self._eng.drain()

    def stats(self) -> dict:
        return self._eng.stats()
