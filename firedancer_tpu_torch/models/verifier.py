"""The serving verifier: fixed-bucket batched ed25519 verification.

Counterpart of firedancer_tpu/models/verifier.py (single device, the
strict and rlc modes).  The host pipeline fills (batch, msg_maxlen)
buckets and gets pass bits back.  In strict mode a batch goes to the card
as one packed row blob (ed25519 PACKED_EXTRA layout); in rlc mode as the
four arrays, checked by one random-linear-combination batch equation.
Either way the verdict comes back as a future that meets the pipeline's
duck protocol (disco/pipeline.py): is_ready() polls a CUDA event,
copy_to_host_async() starts the device-to-host copy, and np.asarray()
waits for the bits.

The serving engine (make_ingest, PackedIngest on the workload-agnostic
PackedDispatchEngine) packs batches into rotating pinned host blobs, so
the host packs batch k+1 while the card uploads and verifies batch k.
"""

import functools
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops import ed25519 as ed
from ..ops.msm import SELECTS


@dataclass(frozen=True)
class VerifierConfig:
    batch: int = 4096        # BASELINE.md config #2: 4096 single-sig txns
    msg_maxlen: int = 128    # padded message bucket (wire txn MTU is 1232)


class Verdict:
    """The result of one dispatch, still on the device: pass bits, or
    another workload's tensor (the PoH engine's span planes)."""

    def __init__(self, bits: torch.Tensor):
        self._bits = bits
        self._host = None
        self._event = None
        if bits.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(bits.device))

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def copy_to_host_async(self):
        if self._host is None:
            if self._bits.is_cuda:
                self._host = torch.empty(self._bits.shape,
                                         dtype=self._bits.dtype,
                                         pin_memory=True)
                self._host.copy_(self._bits, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record(torch.cuda.current_stream(
                    self._bits.device))
            else:
                self._host = self._bits

    def __array__(self, dtype=None, copy=None):
        self.copy_to_host_async()
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype)


class SigVerifier:
    """Per-signature verifier on one device.  cfg bounds a dispatch: a
    blob may carry fewer rows and shorter messages than cfg, so one
    instance covers a whole bucket ladder.  device=None means the GPU, and raises when
    there is none; tests pass device="cpu", which runs the kernels' plain
    versions.

    mode="strict" verifies each signature, in the layout strict_tail
    ("fused", "split" or "unfused": ed.verify_batch's tail=, which the
    JAX package picks by FDTPU_NO_FUSED; all give the same bits).
    mode="rlc" first runs the random-linear-combination batch check
    (ed.verify_batch_rlc, msm_m signatures per MSM lane, rlc_select the
    MSM kernel's table select); when it fails, a binary-split descent
    settles the exact strict bits (_resolve), its leaves in strict_tail's
    layout.  z is drawn per call from rng, a numpy Generator seeded from
    OS entropy unless one is given.  mode="antipa" is not ported."""

    # slices this small go straight to strict bits
    _SPLIT_LEAF = 256

    def __init__(self, cfg: VerifierConfig = VerifierConfig(),
                 mode: str = "strict", msm_m: int = 8, device=None,
                 rng: np.random.Generator | None = None,
                 rlc_select: str = "legacy", strict_tail: str = "fused"):
        if mode == "antipa":
            raise NotImplementedError(
                "antipa mode is not ported yet (firedancer_tpu_torch)")
        if mode not in ("strict", "rlc"):
            raise ValueError(f"unknown verifier mode {mode!r}")
        if mode == "rlc" and cfg.batch % msm_m:
            raise ValueError(f"rlc mode needs batch ({cfg.batch}) divisible "
                             f"by msm_m ({msm_m})")
        if rlc_select not in SELECTS:
            raise ValueError(f"unknown rlc_select {rlc_select!r}; expected "
                             f"one of {SELECTS}")
        if strict_tail not in ed.TAILS:
            raise ValueError(f"unknown strict_tail {strict_tail!r}; expected "
                             f"one of {ed.TAILS}")
        self.cfg = cfg
        self.mode = mode
        self.msm_m = msm_m
        self.rlc_select = rlc_select
        self.strict_tail = strict_tail
        self.device = resolve_device(device)
        self._rng = np.random.default_rng() if rng is None else rng
        self._fn = functools.partial(ed.verify_batch, tail=strict_tail)

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True)

    def __call__(self, msgs, msg_len, sigs, pubkeys):
        if not isinstance(msg_len, torch.Tensor):
            msg_len = np.asarray(msg_len, dtype=np.int32)
        args = tuple(self._to_device(x)
                     for x in (msgs, msg_len, sigs, pubkeys))
        if self.mode == "strict":
            return Verdict(self._fn(*args))
        all_ok, _ = self._rlc(args)
        return _LazyRlcVerdict(self, args, all_ok)

    def packed_dispatch(self, msgs, lens, sigs, pubs):
        """Pack the four arrays into one blob and dispatch it: one
        host-to-device copy per batch.  rlc mode takes the four arrays
        (__call__)."""
        if self.mode == "rlc":
            return self(msgs, lens, sigs, pubs)
        return self.dispatch_blob(pack_blob(msgs, lens, sigs, pubs))

    def dispatch_blob(self, blob, maxlen: int | None = None) -> Verdict:
        """Dispatch an already packed (batch, ml + PACKED_EXTRA) blob; it
        is read in place on the device, with no unpacking copy.  Strict
        mode only: running it for an rlc verifier would bypass the
        configured mode."""
        if self.mode == "rlc":
            raise ValueError("dispatch_blob is strict-only (mode='rlc'); "
                             "dispatch the four arrays instead")
        ml = blob.shape[1] - ed.PACKED_EXTRA
        if maxlen is not None and maxlen != ml:
            raise ValueError(f"blob rows hold ml={ml} message bytes, "
                             f"maxlen={maxlen} given")
        if ml > self.cfg.msg_maxlen or blob.shape[0] > self.cfg.batch:
            raise ValueError(
                f"blob {tuple(blob.shape)} exceeds the bucket "
                f"({self.cfg.batch}, {self.cfg.msg_maxlen})")
        return Verdict(ed.verify_blob(self._to_device(blob),
                                      tail=self.strict_tail))

    def make_ingest(self, ml: int | None = None, nbuf: int = 2,
                    depth: int | None = None) -> "PackedIngest":
        """Rotating-buffer ingest engine over this verifier's packed
        dispatch (strict mode only, as dispatch_blob)."""
        if self.mode == "rlc":
            raise ValueError(
                f"make_ingest is per-sig-only (mode={self.mode!r})")
        return PackedIngest(self, ml=ml, nbuf=nbuf, depth=depth)

    def _rlc(self, args):
        """verify_batch_rlc over device arrays, with a fresh z."""
        z = self._rng.integers(0, 256, size=(args[2].shape[0], 16),
                               dtype=np.uint8)
        return ed.verify_batch_rlc(*args, self._to_device(z), m=self.msm_m,
                                   select=self.rlc_select)

    def _rlc_slice(self, arrs, lo: int, hi: int) -> bool:
        all_ok, _ = self._rlc(tuple(a[lo:hi] for a in arrs))
        return bool(all_ok)

    def _resolve(self, arrs, lo: int, hi: int, out: np.ndarray) -> None:
        """Exact bits for rows [lo, hi) of a batch whose RLC check
        failed: halves that pass their own RLC check are accepted
        wholesale, the others split again, down to strict leaves.  One
        forged signature costs two RLC checks per level and one strict
        leaf, not a strict pass over the batch."""
        n = hi - lo
        if n <= max(self._SPLIT_LEAF, 2 * self.msm_m) or n % (2 * self.msm_m):
            out[lo:hi] = self._fn(*(a[lo:hi] for a in arrs)).cpu().numpy()
            return
        mid = lo + n // 2
        for a, b in ((lo, mid), (mid, hi)):
            if self._rlc_slice(arrs, a, b):
                out[a:b] = True
            else:
                self._resolve(arrs, a, b, out)


class _LazyRlcVerdict:
    """Per-lane bits of an rlc dispatch, resolved when they are read.
    It meets the same duck protocol as Verdict (is_ready,
    copy_to_host_async, np.asarray) and the array-like reads the pipeline
    makes (len, indexing, iteration, all, any).  A batch whose check
    passed costs one flag copied to the host; a failed batch runs the
    verifier's descent on the arrays still on the device."""

    def __init__(self, sv: SigVerifier, args, all_ok: torch.Tensor):
        self._sv = sv
        self._args = args
        self._flag = Verdict(all_ok.reshape(1))
        self._batch = args[2].shape[0]
        self._result = None
        self.shape = (self._batch,)
        self.dtype = np.dtype(bool)

    def is_ready(self) -> bool:
        return self._result is not None or self._flag.is_ready()

    def copy_to_host_async(self):
        self._flag.copy_to_host_async()

    def _materialize(self) -> np.ndarray:
        if self._result is None:
            if np.asarray(self._flag)[0]:
                self._result = np.ones(self._batch, dtype=bool)
            else:
                out = np.zeros(self._batch, dtype=bool)
                self._sv._resolve(self._args, 0, self._batch, out)
                self._result = out
        return self._result

    def __array__(self, dtype=None, copy=None):
        r = self._materialize()
        return r if dtype is None else r.astype(dtype)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self):
        return self._batch

    def __bool__(self):
        # without this, bool() would fall back to __len__ and read True
        # for any non-empty batch, a failed one included
        raise ValueError("truth value of a per-lane verdict is ambiguous; "
                         "use .all(), .any() or np.asarray(verdict)")

    def all(self):
        return self._materialize().all()

    def any(self):
        return self._materialize().any()


@dataclass(frozen=True)
class WorkloadDesc:
    """What the rotation core needs to know about a packed workload:

      rows, row_bytes   rotating-blob geometry
      dispatch          host blob -> verdict future (upload + compute),
                        for rotating and caller-owned blobs alike
      pinned            the blobs live in page-locked host memory (a CUDA
                        workload), so the upload is an asynchronous copy
    """

    rows: int
    row_bytes: int
    dispatch: object
    pinned: bool = False


class PackedDispatchEngine:
    """Workload-agnostic upload/compute overlap (the wiredancer async
    push shape, src/wiredancer/c/wd_f1.h:85-113): `nbuf` rotating host
    blobs, so batch k+1 packs into a free blob while batch k uploads and
    computes on the card.  An inflight window (`depth`) applies
    backpressure: when it is full, a submit harvests (blocks on) the
    OLDEST verdict before dispatching more.

    No torn buffer: a blob returns to the free ring only when its batch's
    verdict has materialized on the host.  The upload is a non-blocking
    copy from pinned memory on the stream that then runs the verify, and
    the verdict's event follows the verify, so a materialized verdict
    proves the copy that read the blob is complete.

    Counterpart of firedancer_tpu/models/verifier.py PackedDispatchEngine,
    with the same counters (stats())."""

    def __init__(self, desc: WorkloadDesc, nbuf: int = 2,
                 depth: int | None = None):
        if nbuf < 2:
            raise ValueError(f"need >= 2 buffers to overlap, got {nbuf}")
        if depth is None:
            depth = nbuf - 1
        if depth < 1:
            raise ValueError(f"inflight depth must be >= 1, got {depth}")
        self.desc = desc
        self.depth = depth
        self.rows = desc.rows
        self._bufs = [torch.zeros((desc.rows, desc.row_bytes),
                                  dtype=torch.uint8, pin_memory=desc.pinned)
                      for _ in range(nbuf)]
        self._free = deque(range(nbuf))
        self._inflight: deque[tuple[object, int | None]] = deque()
        # dispatches, blocking harvests forced by a full window
        # (backpressure), the deepest window reached, host pack cost
        self.dispatches = 0
        self.backpressure_waits = 0
        self.max_depth_seen = 0
        self.pack_ns = 0
        self.pack_txns = 0

    @property
    def inflight_depth(self) -> int:
        return len(self._inflight)

    @property
    def pack_us_txn(self) -> float:
        """Mean host-side pack cost per lane (us) across all submits."""
        return self.pack_ns / max(self.pack_txns, 1) / 1e3

    def stats(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "backpressure_waits": self.backpressure_waits,
            "max_depth_seen": self.max_depth_seen,
            "inflight_depth": self.inflight_depth,
            "pack_us_txn": self.pack_us_txn,
        }

    def _harvest_oldest(self) -> np.ndarray:
        ok_dev, bidx = self._inflight.popleft()
        ok = np.asarray(ok_dev)          # blocks until upload+compute done
        if bidx is not None:             # caller-owned blobs never pool
            self._free.append(bidx)
        return ok

    def _enqueue(self, ok_dev, bidx, out: list) -> None:
        # start the device->host verdict copy now, behind the verify
        ok_dev.copy_to_host_async()
        self._inflight.append((ok_dev, bidx))
        self.dispatches += 1
        self.max_depth_seen = max(self.max_depth_seen, len(self._inflight))
        while len(self._inflight) > self.depth:
            out.append(self._harvest_oldest())

    def submit_packed(self, fill_fn, count: int) -> list[np.ndarray]:
        """Acquire a free blob (harvesting the oldest verdict first when
        every blob is pinned), fill it by fill_fn(blob), timed into the
        pack stats with `count` work items, and dispatch it.  Returns the
        verdicts the inflight window retired in this call, in dispatch
        order."""
        out = []
        if not self._free:
            self.backpressure_waits += 1
            out.append(self._harvest_oldest())
        bidx = self._free.popleft()
        buf = self._bufs[bidx]
        t_pack = time.perf_counter_ns()
        try:
            fill_fn(buf)
        except BaseException:
            # the blob was never dispatched: back on the free ring, so a
            # failed pack leaves the engine usable
            self._free.appendleft(bidx)
            raise
        self.pack_ns += time.perf_counter_ns() - t_pack
        self.pack_txns += count
        self._enqueue(self.desc.dispatch(buf), bidx, out)
        return out

    def submit_rows(self, rows) -> list[np.ndarray]:
        """Dispatch an already packed row blob as it is, with no host
        repack.  The caller owns `rows` and must not change it until this
        batch's verdict is harvested; it never enters the free ring."""
        out = []
        self._enqueue(self.desc.dispatch(rows), None, out)
        return out

    def poll(self) -> list[np.ndarray]:
        """Harvest every verdict that is already on the host, in dispatch
        order, without blocking (is_ready() is a CUDA event query)."""
        out = []
        while self._inflight and self._inflight[0][0].is_ready():
            out.append(self._harvest_oldest())
        return out

    def drain(self) -> list[np.ndarray]:
        """Harvest every outstanding verdict, in dispatch order."""
        out = []
        while self._inflight:
            out.append(self._harvest_oldest())
        return out


class PackedIngest(PackedDispatchEngine):
    """The sigverify workload on the rotation core: rows are the packed
    verify layout (msg[ml] | sig | pub | len), dispatch is the verifier's
    dispatch_blob, the verdict the per-lane bool vector.  On a CUDA
    verifier the blobs are pinned, and packing writes through their
    .numpy() views."""

    def __init__(self, verifier: SigVerifier, ml: int | None = None,
                 nbuf: int = 2, depth: int | None = None):
        self.verifier = verifier
        cfg = verifier.cfg
        self.batch = cfg.batch
        self.ml = cfg.msg_maxlen if ml is None else ml
        super().__init__(
            WorkloadDesc(rows=self.batch,
                         row_bytes=self.ml + ed.PACKED_EXTRA,
                         dispatch=verifier.dispatch_blob,
                         pinned=verifier.device.type == "cuda"),
            nbuf=nbuf, depth=depth)

    def _pack_into(self, buf: torch.Tensor, msgs, lens, sigs, pubs):
        ml = self.ml
        msgs = np.asarray(msgs)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        np.concatenate(
            [msgs[:, :ml], np.asarray(sigs), np.asarray(pubs),
             lens.view(np.uint8).reshape(len(lens), 4)],
            axis=1, out=buf.numpy()[:self.batch])

    def submit(self, msgs, lens, sigs, pubs) -> list[np.ndarray]:
        """Pack one batch into a rotating blob and dispatch it.  Returns
        the verdicts the inflight window retired in this call (in
        dispatch order); this batch's own verdict comes from a later
        submit(), poll() or drain()."""
        return self.submit_packed(
            lambda buf: self._pack_into(buf, msgs, lens, sigs, pubs),
            self.batch)


def make_example_batch(batch: int, maxlen: int, valid: bool = True,
                       seed: int = 1234, sign_pool: int | None = None,
                       lens=None):
    """`batch` (msg, sig, pub) triples as numpy arrays (msgs (batch,
    maxlen) u8, lens int32, sigs (batch, 64) u8, pubs (batch, 32) u8).

    Host Python-int signing; messages default to min(64, maxlen) bytes,
    or take the given per-lane `lens`.  With valid=False a quarter of the
    lanes get a flipped bit in R.  `sign_pool` bounds the number of
    distinct signings (lanes beyond it repeat pool entries: the device
    work is the same)."""
    rng = np.random.default_rng(seed)
    msgs = np.zeros((batch, maxlen), dtype=np.uint8)
    if lens is None:
        lens = np.full((batch,), min(64, maxlen), dtype=np.int32)
    lens = np.asarray(lens, dtype=np.int32).copy()
    sigs = np.zeros((batch, 64), dtype=np.uint8)
    pubs = np.zeros((batch, 32), dtype=np.uint8)
    if sign_pool is not None and sign_pool < 1:
        raise ValueError(f"sign_pool must be >= 1, got {sign_pool}")
    nsign = batch if sign_pool is None else min(batch, sign_pool)
    seeds = [rng.bytes(32) for _ in range(min(batch, 32, nsign))]
    keys = [(s, ed.keypair_from_seed(s)[0]) for s in seeds]
    signed = []
    for i in range(nsign):
        seed_b, pub = keys[i % len(keys)]
        m = rng.bytes(int(lens[i]))
        signed.append((m, ed.sign(seed_b, m), pub))
    for i in range(batch):
        m, sig, pub = signed[i % nsign]
        msgs[i, :len(m)] = np.frombuffer(m, dtype=np.uint8)
        lens[i] = len(m)
        sigs[i] = np.frombuffer(sig, dtype=np.uint8)
        pubs[i] = np.frombuffer(pub, dtype=np.uint8)
    if not valid:
        bad = rng.choice(batch, size=max(1, batch // 4), replace=False)
        sigs[bad, 0] ^= 1
    return msgs, lens, sigs, pubs


def pack_blob(msgs, lens, sigs, pubs) -> np.ndarray:
    """Four numpy arrays -> one packed (batch, maxlen + PACKED_EXTRA) blob."""
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    return np.concatenate([np.asarray(msgs), np.asarray(sigs),
                           np.asarray(pubs),
                           lens.view(np.uint8).reshape(len(lens), 4)], axis=1)


# The lane kinds of make_adversarial_batch, cycled over the batch.
ADVERSARIAL_KINDS = ("valid", "tampered_r", "tampered_msg", "s_plus_l",
                     "a_no_sqrt", "a_y0_sign", "a_identity", "a_order8",
                     "a_noncanonical_y", "r_noncanonical_y", "zero_pad")


def make_adversarial_batch(batch: int, maxlen: int, seed: int = 7):
    """make_example_batch with lane i turned into the case
    ADVERSARIAL_KINDS[i % 11]: a tampered R or message, S + L in place of
    S, a public key with no square root, y = 0 with the sign bit, the
    identity, an order-8 point, a non-canonical y (>= p) in A or in R, and
    an all-zero padding lane.  Returns (msgs, lens, sigs, pubs, kinds)."""
    msgs, lens, sigs, pubs = make_example_batch(
        batch, maxlen, True, seed, sign_pool=min(batch, 64))
    kinds = [ADVERSARIAL_KINDS[i % len(ADVERSARIAL_KINDS)]
             for i in range(batch)]
    for i, kind in enumerate(kinds):
        if kind == "tampered_r":
            sigs[i, 5] ^= 0xFF
        elif kind == "tampered_msg":
            msgs[i, 0] ^= 1
        elif kind == "s_plus_l":
            s = int.from_bytes(bytes(sigs[i, 32:]), "little") + ed.L
            sigs[i, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
        elif kind == "a_no_sqrt":
            pubs[i] = 0x07
        elif kind == "a_y0_sign":
            pubs[i] = 0
            pubs[i, 31] = 0x80
        elif kind == "a_identity":
            pubs[i] = 0
            pubs[i, 0] = 1
        elif kind == "a_order8":
            pubs[i] = np.frombuffer(ed.cv.ORDER8_Y0.to_bytes(32, "little"),
                                    np.uint8)
        elif kind == "a_noncanonical_y":
            pubs[i] = np.frombuffer((ed.P + 3).to_bytes(32, "little"),
                                    np.uint8)
        elif kind == "r_noncanonical_y":
            sigs[i, :32] = np.frombuffer((ed.P + 5).to_bytes(32, "little"),
                                         np.uint8)
        elif kind == "zero_pad":
            msgs[i], lens[i], sigs[i], pubs[i] = 0, 0, 0, 0
    return msgs, lens, sigs, pubs, kinds
