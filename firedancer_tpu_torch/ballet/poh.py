"""Proof-of-History hash chain (ref: src/ballet/poh/ fd_poh_append: iterated
sha256; fd_poh_mixin: hash(state || mixin)); the port's own copy of
firedancer_tpu/ballet/poh.py.

Generation is serial; verification is parallel: each entry declares
(start_hash, num_hashes, mixin) and every segment is recomputed on its own
lane.  All of it runs on the PoH spans kernel (ops/poh_spans.py), one step
a lane: the JAX package's masked scan of max_hashes rounds becomes a bound
of the kernel's loop, min(n - 1, max_hashes) appends and then the last
hash.  Arrays go in as uint8 (batch, 32) states and mixins, int
num_hashes and bool has_mixin, tensors or numpy; numpy inputs go to
`device` (None: the GPU).  Results are tensors on that device.
"""

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import build
from ..ops import poh_spans as ps


def _dev_of(x, device):
    if isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _t(x, dtype, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)


def _one_step_blob(start, n, mix, has_mixin):
    """(batch,) lanes of one active step each, in the span row format."""
    n4 = n.to(torch.int32).reshape(-1, 1).view(torch.uint8)   # LE bytes
    flags = torch.stack([has_mixin.to(torch.uint8),
                         torch.ones_like(has_mixin, dtype=torch.uint8)], 1)
    return torch.cat([start, mix, n4, flags], 1).contiguous()


def append(state, n: int, device=None):
    """Advance PoH chains by n iterated sha256 hashes: uint8 (batch, 32)."""
    dev = _dev_of(state, device)
    st = _t(state, torch.uint8, dev)
    b = st.shape[0]
    blob = _one_step_blob(st, torch.full((b,), int(n), device=dev),
                          torch.zeros_like(st),
                          torch.zeros((b,), dtype=torch.bool, device=dev))
    return ps.poh_spans(blob, 1, (max(int(n) - 1, 0),))


def mixin(state, mix, device=None):
    """PoH mixin: state = sha256(state || mix).  Both uint8 (batch, 32)."""
    dev = _dev_of(state, device)
    st = _t(state, torch.uint8, dev)
    b = st.shape[0]
    blob = _one_step_blob(st, torch.ones((b,), device=dev),
                          _t(mix, torch.uint8, dev),
                          torch.ones((b,), dtype=torch.bool, device=dev))
    return ps.poh_spans(blob, 1, (0,))


def verify_entries(start_hashes, num_hashes, mixins, has_mixin,
                   max_hashes: int, device=None):
    """Recompute a batch of PoH entry segments in parallel.

    Entry i: from start_hashes[i], num_hashes[i] - 1 appends (at most
    max_hashes, where the JAX scan ends), then the last hash, a mixin of
    mixins[i] if has_mixin[i]; num_hashes <= 0 passes the start through.
    Returns the end hash per entry, uint8 (batch, 32)."""
    dev = _dev_of(start_hashes, device)
    blob = _one_step_blob(_t(start_hashes, torch.uint8, dev),
                          _t(num_hashes, torch.int64, dev),
                          _t(mixins, torch.uint8, dev),
                          _t(has_mixin, torch.bool, dev))
    return ps.poh_spans(blob, 1, (int(max_hashes),))


def entry_verify(start_hashes, num_hashes, mixins, has_mixin, end_hashes,
                 max_hashes: int, device=None):
    """Full slot check: recompute every segment in parallel and compare with
    the declared end hashes.  Returns bool (batch,)."""
    got = verify_entries(start_hashes, num_hashes, mixins, has_mixin,
                         max_hashes, device)
    return (got == _t(end_hashes, torch.uint8, got.device)).all(1)


# -- the trip-count ladder --------------------------------------------------
# The JAX package compiles one scan length a rung and picks the smallest
# rung that covers a batch.  Here a rung is the kernel's loop bound, so
# every rung gives the same hashes; the names and the ladder stay.

DEFAULT_HASH_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def fit_max_hashes(needed: int, max_hashes: int,
                   ladder=DEFAULT_HASH_LADDER) -> int:
    """Closest-fit trip count: the smallest ladder rung covering `needed`
    hashes, capped at max_hashes."""
    needed = max(1, min(int(needed), int(max_hashes)))
    for s in ladder:
        if s > int(max_hashes):
            break
        if s >= needed:
            return int(s)
    return int(max_hashes)


def verify_entries_fit(start_hashes, num_hashes, mixins, has_mixin,
                       max_hashes: int, ladder=DEFAULT_HASH_LADDER,
                       device=None):
    """verify_entries at the closest-fit ladder rung >= the batch's worst
    num_hashes (num_hashes must be on the host or cheap to read)."""
    nh = (num_hashes.cpu().numpy() if isinstance(num_hashes, torch.Tensor)
          else np.asarray(num_hashes))
    needed = int(nh.max()) if nh.size else 1
    rung = fit_max_hashes(needed, max_hashes, ladder)
    return verify_entries(start_hashes, num_hashes, mixins, has_mixin, rung,
                          device)


def entry_verify_fit(start_hashes, num_hashes, mixins, has_mixin, end_hashes,
                     max_hashes: int, ladder=DEFAULT_HASH_LADDER, device=None):
    """entry_verify riding the ladder."""
    got = verify_entries_fit(start_hashes, num_hashes, mixins, has_mixin,
                             max_hashes, ladder, device)
    return (got == _t(end_hashes, torch.uint8, got.device)).all(1)


def warm_verify_ladder(batch: int, max_hashes: int,
                       ladder=DEFAULT_HASH_LADDER, heartbeat=None,
                       device=None) -> int:
    """Build the kernel and launch each reachable rung once at `batch`
    zero lanes, the results fetched; `heartbeat` is poked between rungs.
    Returns the number of rungs (the JAX package's compiled count)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        build.load("poh_spans")
    rungs = sorted({fit_max_hashes(s, max_hashes, ladder)
                    for s in (*ladder, max_hashes) if s <= max_hashes}
                   | {int(max_hashes)})
    z32 = torch.zeros((batch, 32), dtype=torch.uint8, device=dev)
    zn = torch.zeros((batch,), dtype=torch.int32, device=dev)
    zb = torch.zeros((batch,), dtype=torch.bool, device=dev)
    for r in rungs:
        verify_entries(z32, zn, z32, zb, r).cpu()
        if heartbeat is not None:
            heartbeat()
    return len(rungs)
