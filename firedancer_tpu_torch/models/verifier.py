"""The serving verifier: fixed-bucket batched strict ed25519 verification.

Counterpart of firedancer_tpu/models/verifier.py (strict, single device).
The host pipeline fills (batch, msg_maxlen) buckets and gets pass bits
back; here a batch goes to the card as one packed row blob (ed25519
PACKED_EXTRA layout) and the verdict comes back as a future that meets the
pipeline's duck protocol (firedancer_tpu/disco/pipeline.py): is_ready()
polls a CUDA event, copy_to_host_async() starts the device-to-host copy,
and np.asarray() waits for the bits.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device
from ..ops import ed25519 as ed


@dataclass(frozen=True)
class VerifierConfig:
    batch: int = 4096        # BASELINE.md config #2: 4096 single-sig txns
    msg_maxlen: int = 128    # padded message bucket (wire txn MTU is 1232)


class Verdict:
    """Pass bits of one dispatch, still on the device."""

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
                self._host = torch.empty(self._bits.shape, dtype=torch.bool,
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
    """Strict per-signature verifier on one device.  One instance per
    (batch, msg_maxlen) bucket, as in the JAX package; a dispatch may
    carry fewer rows than the bucket.  device=None means the GPU, and
    raises when there is none; tests pass device="cpu", which runs the
    kernels' plain versions."""

    def __init__(self, cfg: VerifierConfig = VerifierConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True)

    def __call__(self, msgs, msg_len, sigs, pubkeys) -> Verdict:
        if not isinstance(msg_len, torch.Tensor):
            msg_len = np.asarray(msg_len, dtype=np.int32)
        return Verdict(ed.verify_batch(self._to_device(msgs),
                                       self._to_device(msg_len),
                                       self._to_device(sigs),
                                       self._to_device(pubkeys)))

    def packed_dispatch(self, msgs, lens, sigs, pubs) -> Verdict:
        """Pack the four arrays into one blob and dispatch it: one
        host-to-device copy per batch."""
        return self.dispatch_blob(pack_blob(msgs, lens, sigs, pubs))

    def dispatch_blob(self, blob, maxlen: int | None = None) -> Verdict:
        """Dispatch an already packed (batch, ml + PACKED_EXTRA) blob; it
        is read in place on the device, with no unpacking copy."""
        ml = blob.shape[1] - ed.PACKED_EXTRA
        if maxlen is not None and maxlen != ml:
            raise ValueError(f"blob rows hold ml={ml} message bytes, "
                             f"maxlen={maxlen} given")
        if ml > self.cfg.msg_maxlen or blob.shape[0] > self.cfg.batch:
            raise ValueError(
                f"blob {tuple(blob.shape)} exceeds the bucket "
                f"({self.cfg.batch}, {self.cfg.msg_maxlen})")
        return Verdict(ed.verify_blob(self._to_device(blob)))


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
