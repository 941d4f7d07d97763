"""Carry the JAX package's inputs and intermediates across to the port.

The system has no trained weights: what the two packages must share are
their inputs (numpy batches and packed blobs) and, for comparing
intermediates, field elements.  The JAX package stores an element as
(22, batch) radix-2^12 limb planes, the port as (10, batch) 26/25-bit
limbs (ops/f25519.py); both map to canonical Python ints, so tests
compare values, never raw limbs.  Nothing here imports JAX: JAX arrays
arrive as numpy arrays.
"""

import numpy as np
import torch

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


def field_to_ints(t) -> list[int]:
    """Field elements of either side -> canonical Python ints mod p: a
    port tensor (10, batch), or JAX limb planes (22, batch)."""
    if isinstance(t, torch.Tensor) and t.shape[0] == fe.NLIMB:
        return fe.to_ints(t)
    return _jax_limbs_to_ints(t)
