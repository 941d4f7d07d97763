"""PoH spans: every lane of a blob extends its own SHA-256 chain through
its steps (csrc/poh_spans.cu, replacing
firedancer_tpu/ballet/poh_engine.py::poh_spans_blob and, with one step a
lane, firedancer_tpu/ballet/poh.py::verify_entries).

A blob row is start[32] | steps * (mixin[32] | n u32 LE | has_mixin u8 |
active u8).  A step does min(n - 1, cap) plain appends, then one append
that absorbs the mixin (has_mixin) or a plain one; n <= 0 and an inactive
step pass the state through.  The result is every step's end state,
uint8 (lanes, steps * 32).  On a CUDA tensor the wrapper launches the
kernel or raises; on a CPU tensor it runs the plain version.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import sha256 as sh

LANE_HDR_SZ = 32
STEP_SZ = 38  # mixin[32] | n u32 | has_mixin u8 | active u8


def row_bytes(steps: int) -> int:
    return LANE_HDR_SZ + steps * STEP_SZ


def _step_fields(blob, s: int):
    base = LANE_HDR_SZ + s * STEP_SZ
    nb = blob[:, base + 32:base + 36].to(torch.int64)
    n = nb[:, 0] | (nb[:, 1] << 8) | (nb[:, 2] << 16) | (nb[:, 3] << 24)
    n = torch.where(n >= 2**31, n - 2**32, n)        # the int32 the JAX reads
    return (sh.bytes_to_state(blob[:, base:base + 32]), n,
            blob[:, base + 36] != 0, blob[:, base + 37] != 0)


def poh_spans_plain(blob, steps: int, caps):
    """The plain torch version: the JAX scan's masked appends, run to the
    longest lane's min(n - 1, cap) instead of to the cap."""
    state = sh.bytes_to_state(blob[:, :LANE_HDR_SZ])
    outs = []
    for s in range(steps):
        mix, n, has_mixin, active = _step_fields(blob, s)
        m = (n - 1).clamp(0, int(caps[s]))
        st = state
        for i in range(int(m.max()) if m.numel() else 0):
            st = torch.where(i < m, sh.fixed32_words(st), st)
        last = torch.where(has_mixin, sh.fixed64_words(st, mix),
                           sh.fixed32_words(st))
        res = torch.where(n > 0, last, state)
        state = torch.where(active, res, state)
        outs.append(sh.state_to_bytes(state))
    return torch.cat(outs, 1)


@functools.lru_cache(maxsize=64)
def caps_tensor(caps: tuple, device: torch.device) -> torch.Tensor:
    """The per-step caps as an int32 tensor on the device, made once per
    geometry (an upload from pageable memory would wait for the stream)."""
    return torch.tensor(caps, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("poh_spans").fd_poh_spans
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, i, i, p, p, p]
    fn.restype = i
    return fn


def poh_spans(blob, steps: int, caps):
    """Every step's end state, uint8 (lanes, steps * 32).  blob: uint8
    (lanes, row_bytes(steps)) with unit column stride; caps: one hash cap
    a step (ints)."""
    caps = tuple(int(c) for c in caps)
    if len(caps) != steps or any(c < 0 for c in caps):
        raise ValueError(f"need {steps} caps >= 0, got {caps}")
    if (blob.dtype != torch.uint8 or blob.dim() != 2
            or blob.shape[1] != row_bytes(steps) or blob.stride(1) != 1):
        raise ValueError(f"blob: need uint8 (lanes, {row_bytes(steps)}) "
                         f"rows, got {blob.dtype} {tuple(blob.shape)}")
    if blob.device.type == "cpu":
        return poh_spans_plain(blob, steps, caps)
    lanes = blob.shape[0]
    out = torch.empty((lanes, steps * 32), dtype=torch.uint8,
                      device=blob.device)
    if lanes == 0 or steps == 0:
        return out
    ct = caps_tensor(caps, blob.device)
    with torch.cuda.device(blob.device):
        rc = _fn()(blob.data_ptr(), blob.stride(0), lanes, steps,
                   ct.data_ptr(), out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"poh_spans kernel launch failed: CUDA error {rc}")
    poh_spans.launches += 1
    return out


poh_spans.launches = 0
