"""Carry the JAX package's inputs and intermediates across to the port.

The system has no trained weights: what the two packages must share are
their inputs (numpy batches and packed blobs) and, for comparing
intermediates, field elements.  The JAX package stores an element as
(22, batch) radix-2^12 limb planes, the port as (10, batch) 26/25-bit
limbs (ops/f25519.py); both map to canonical Python ints, so tests
compare values, never raw limbs.  Scalars mod L use radix-2^12 limbs on
both sides, and signed windows the same (magnitude, sign) planes.
Nothing here imports JAX: JAX arrays arrive as numpy arrays and leave as
numpy arrays.
"""

import numpy as np
import torch

from .ops import curve25519 as cv
from .ops import f25519 as fe

JAX_LIMB_BITS = 12
JAX_NLIMB = 22


def batch_from_numpy(msgs, lens, sigs, pubs, device):
    """The JAX package's four verify_batch arrays -> port tensors."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)
    return (t(msgs, np.uint8), t(lens, np.int32), t(sigs, np.uint8),
            t(pubs, np.uint8))


def blob_from_numpy(blob, device) -> torch.Tensor:
    """A packed (batch, ml + PACKED_EXTRA) row blob -> a port tensor."""
    return torch.from_numpy(np.ascontiguousarray(blob, dtype=np.uint8)).to(
        device)


def _jax_limbs_to_ints(planes) -> list[int]:
    a = np.asarray(planes, dtype=np.int64).reshape(JAX_NLIMB, -1)
    return [sum(int(v) << (JAX_LIMB_BITS * i) for i, v in enumerate(col))
            % fe.P for col in a.T]


def field_from_jax_limbs(planes, device="cpu") -> torch.Tensor:
    """JAX (22, batch) limb planes (any magnitudes) -> port (10, batch)."""
    return fe.from_ints(_jax_limbs_to_ints(planes), device)


def point_from_jax(point, device="cpu") -> cv.Point:
    """A JAX Point of (22, n) limb planes (as numpy arrays, or anything
    with X, Y, Z, T), any Z -> a port Point of (10, n) planes holding the
    same coordinates mod p (not an affine form: Z stays as it was)."""
    return cv.Point(*(field_from_jax_limbs(point[i], device)
                      for i in range(4)))


def field_to_jax_limbs(t) -> np.ndarray:
    """Port (10, n) field elements -> JAX (22, n) uint32 limb planes of
    the canonical values, the form the JAX kernels take."""
    vals = fe.to_ints(t)
    mask = (1 << JAX_LIMB_BITS) - 1
    return np.array([[(v >> (JAX_LIMB_BITS * i)) & mask for v in vals]
                     for i in range(JAX_NLIMB)],
                    np.uint32).reshape(JAX_NLIMB, len(vals))


def point_to_jax(p: cv.Point) -> tuple:
    """A port Point, any Z -> (X, Y, Z, T) as JAX (22, n) uint32 limb
    planes, for a JAX Point of the same coordinates."""
    return tuple(field_to_jax_limbs(t) for t in p)


def windows_from_jax(w, device="cpu") -> torch.Tensor:
    """JAX (nwin, n) uint32 4-bit windows -> an int64 port tensor."""
    return torch.from_numpy(np.asarray(w).astype(np.int64)).to(device)


def signed_windows_from_jax(wins, device="cpu") -> tuple:
    """JAX signed window planes (smag, ssgn, kmag, ksgn), each (64, n)
    uint32 -> the port's uint8 (64, n) planes (ops/reduce_recode.py)."""
    return tuple(torch.from_numpy(np.asarray(w).astype(np.uint8)).to(device)
                 for w in wins)


def scalar_limbs_from_jax(limbs, device="cpu") -> torch.Tensor:
    """JAX (22, n) int32 scalar limbs (radix 2^12, as the port's
    ops/scalar25519.py) -> an int64 port tensor."""
    return torch.from_numpy(np.asarray(limbs).astype(np.int64)).to(device)


def field_to_ints(t) -> list[int]:
    """Field elements of either side -> canonical Python ints mod p: a
    port tensor (10, batch), or JAX limb planes (22, batch)."""
    if isinstance(t, torch.Tensor) and t.shape[0] == fe.NLIMB:
        return fe.to_ints(t)
    return _jax_limbs_to_ints(t)
