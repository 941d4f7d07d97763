"""Reed-Solomon erasure coding over GF(2^8): shred FEC (ref:
src/ballet/reedsol/); the port's own copy of
firedancer_tpu/ballet/reedsol.py.

The code is systematic RS interpolating the data shreds at field points
0..k-1 and evaluating parity at points k..n-1 over GF(2^8) mod 0x11D, as
Solana's shreds use.  GF(2^8) multiplication by a constant is
GF(2)-linear on the 8 bits, so encode and recover are each one binary
matrix product: unpack shred bytes to bit-planes, multiply by the
generator's (or the erasure pattern's reconstruction matrix's) bit-matrix
mod 2, repack.  The device paths run that product on the GF(2) kernel
(ops/gf2_recover.py, csrc/gf2_recover.cu), one launch a call, which takes
the GF(2^8) matrix and expands its bit-matrix itself; the
reconstruction matrices are built on the host per erasure pattern
(O(k^3) GF Gauss-Jordan) and LRU-cached.  _bitmatrix stays as the host
model of that expansion (the JAX package's device paths take its
output).  device=False is the
table-driven host model.  torch_device picks the card the device paths
run on: None is the GPU (raising where there is none); tests pass "cpu",
which runs the kernel's plain version.

Limits mirror the reference: <= 67 data and <= 67 parity shreds
(fd_reedsol.h:29-30).
"""

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..ops import gf2_recover as gf2

DATA_SHREDS_MAX = 67
PARITY_SHREDS_MAX = 67

_POLY = 0x11D  # x^8+x^4+x^3+x^2+1, the GF(2^8) modulus Solana's RS uses

# exp/log tables for generator 2 (primitive for 0x11D)
_EXP = np.zeros(512, dtype=np.uint8)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= _POLY
_EXP[255:510] = _EXP[0:255]  # wraparound so exp[a+b] needs no mod


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(_EXP[255 - _LOG[a]])


def gf_pow(a: int, e: int) -> int:
    if e == 0:
        return 1
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * e) % 255])


def _mat_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product (host, table-driven)."""
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.uint8)
    for i in range(A.shape[0]):
        for j in range(B.shape[1]):
            acc = 0
            for t in range(A.shape[1]):
                acc ^= gf_mul(int(A[i, t]), int(B[t, j]))
            out[i, j] = acc
    return out


def _mat_inv(M: np.ndarray) -> np.ndarray:
    """GF(2^8) Gauss-Jordan inverse; raises if singular."""
    n = M.shape[0]
    a = M.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix (not enough independent shreds)")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        s = gf_inv(int(a[col, col]))
        for j in range(n):
            a[col, j] = gf_mul(int(a[col, j]), s)
            inv[col, j] = gf_mul(int(inv[col, j]), s)
        for r in range(n):
            if r != col and a[r, col]:
                f = int(a[r, col])
                for j in range(n):
                    a[r, j] ^= gf_mul(f, int(a[col, j]))
                    inv[r, j] ^= gf_mul(f, int(inv[col, j]))
    return inv


@functools.lru_cache(maxsize=None)
def _systematic(k: int, n: int) -> bytes:
    """n x k systematic generator: row r = evaluations making codeword[r]
    the degree<k interpolation of data at points 0..k-1 evaluated at r.
    Top k rows are the identity.  Cached as bytes (hashable)."""
    V = np.zeros((n, k), dtype=np.uint8)
    for r in range(n):
        for c in range(k):
            V[r, c] = gf_pow(r, c)
    A = _mat_mul(V, _mat_inv(V[:k, :]))
    assert np.array_equal(A[:k], np.eye(k, dtype=np.uint8))
    return A.tobytes()


def generator_matrix(k: int, n: int) -> np.ndarray:
    return np.frombuffer(_systematic(k, n), dtype=np.uint8).reshape(n, k)


def _bitmatrix(M: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix (R, C) to its GF(2) bit-matrix (8R, 8C):
    out_bit[8r+j, 8c+i] = bit j of (M[r,c] * x^i).  Bit i = (byte>>i)&1."""
    R, C = M.shape
    out = np.zeros((8 * R, 8 * C), dtype=np.int8)
    for r in range(R):
        for c in range(C):
            m = int(M[r, c])
            if not m:
                continue
            for i in range(8):
                prod = gf_mul(m, 1 << i)
                for j in range(8):
                    out[8 * r + j, 8 * c + i] = (prod >> j) & 1
    return out


def _upload(a: np.ndarray, dtype, dev):
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def encode(data_shreds: np.ndarray, parity_cnt: int, device: bool = True,
           torch_device=None) -> np.ndarray:
    """Encode parity shreds.  data_shreds: (k, sz) uint8.  Returns (p, sz).

    device=True runs the bit-plane product on the GF(2) kernel (the
    production path); device=False is the host table-driven golden model.
    """
    k, sz = data_shreds.shape
    n = k + parity_cnt
    if k > DATA_SHREDS_MAX or parity_cnt > PARITY_SHREDS_MAX:
        raise ValueError("shred counts exceed protocol limits")
    P = generator_matrix(k, n)[k:, :]  # (p, k), the non-identity rows
    if not device:
        return _mat_mul(P, data_shreds.astype(np.uint8))
    dev = resolve_device(torch_device)
    return gf2.gf2_encode(_upload(data_shreds, np.uint8, dev),
                          _upload(P, np.uint8, dev)).cpu().numpy()


# ---------------------------------------------------------------------------
# Recovery: cached reconstruction matrices + fused single-dispatch recover.
#
# The combined (n, k) matrix R = A @ inv(A[use, :]) maps the k used
# surviving codeword bytes straight to the WHOLE codeword (data recover +
# parity re-derive in one product); rows of R at used survivor positions
# are the selection identity, so the consistency check reduces to
# comparing the re-derived codeword against every surviving shred.  R is
# LRU-cached per (k, n, erasure-pattern); the kernel expands its GF(2)
# bit-matrix on the card.

_RECOVER_CACHE_MAX = 1024


@functools.lru_cache(maxsize=_RECOVER_CACHE_MAX)
def _recover_matrices(k: int, n: int, use: tuple) -> bytes:
    """R's bytes for surviving indices `use` (len k): the first half of the
    JAX package's (R, bit-matrix) pair, whose second half the kernel
    computes itself.

    Fast path: when the first k survivors are exactly 0..k-1 (no data
    erasures) the inner inverse is the identity — _mat_inv is skipped
    entirely and R is the systematic generator itself."""
    A = generator_matrix(k, n)
    if use == tuple(range(k)):
        R = A  # identity reconstruction: no data erasures
    else:
        R = _mat_mul(A, _mat_inv(A[list(use), :]))
    return R.tobytes()


def recover_cache_info():
    """Hit/miss accounting for the reconstruction-matrix LRU."""
    return _recover_matrices.cache_info()


def recover_cache_clear() -> None:
    _recover_matrices.cache_clear()


def _recover_gfmat(k: int, n: int, use: tuple) -> np.ndarray:
    return np.frombuffer(_recover_matrices(k, n, use),
                         dtype=np.uint8).reshape(n, k)


class CorruptSetError(ValueError):
    """recover()'s surviving shreds disagree with one another (ERR_CORRUPT):
    the set can never be assembled from them.  A ValueError, so callers
    that catch every recovery failure still match; the Blockstore catches
    only this one."""


def recover(
    shreds: list, k: int, sz: int, device: bool = True, torch_device=None
) -> list:
    """Recover a full FEC set from any >= k surviving shreds.

    shreds: length-n list; entry i is the (sz,)-byte shred i or None if
    erased (indices [0,k) data, [k,n) parity).  Returns the complete list.
    Raises ValueError if fewer than k survive (ERR_PARTIAL analogue), and
    its subclass CorruptSetError if the surviving set is inconsistent
    (ERR_CORRUPT analogue).

    One launch of the GF(2) kernel (B = 1): the combined cached matrix R
    recovers data AND re-derives parity in a single bit-plane product.
    With no data erasures the reconstruction is the identity: survivors
    pass through and only the parity rows of R do work.
    """
    n = len(shreds)
    if k > DATA_SHREDS_MAX or n - k > PARITY_SHREDS_MAX:
        raise ValueError("shred counts exceed protocol limits")
    have = [i for i, s in enumerate(shreds) if s is not None]
    if len(have) < k:
        raise ValueError(f"unrecoverable: only {len(have)} of {k} needed shreds")
    use = tuple(have[:k])
    S = np.stack([np.asarray(shreds[i], dtype=np.uint8) for i in use])  # (k, sz)

    if use == tuple(range(k)) and not device:
        # all-data fast path (host): no recover product at all — data IS
        # the survivors; go straight to parity re-derive + consistency check
        full_arr = np.concatenate(
            [S, _mat_mul(generator_matrix(k, n)[k:, :], S)]
            if n > k else [S])
    elif device:
        dev = resolve_device(torch_device)
        full_arr = gf2.gf2_encode(
            _upload(S, np.uint8, dev),
            _upload(_recover_gfmat(k, n, use), np.uint8, dev)).cpu().numpy()
    else:
        full_arr = _mat_mul(_recover_gfmat(k, n, use), S)

    full = [np.asarray(full_arr[i], dtype=np.uint8) for i in range(n)]
    for i in have:
        if not np.array_equal(np.asarray(shreds[i], dtype=np.uint8), full[i]):
            raise CorruptSetError(
                f"corrupt: shred {i} inconsistent with encoding")
    return full


# ---------------------------------------------------------------------------
# Batched multi-set recovery: many FEC sets per launch.
#
# Surviving shreds from B sets pad/stack into (B, K, S) against a stacked
# per-set reconstruction matrix (B, N, K); one launch re-derives
# every codeword and computes the per-set consistency verdict (recovered
# == every surviving shred).  Zero-padding is self-consistent: padded
# rows/columns of a GF(2)-linear map produce zeros, which compare equal
# against the zero-padded reference.
#
# The packed-blob form (the dispatch engine's workload, ShredRecoverIngest
# in disco/shred_tiles.py): one FEC set per row, surv[K*S] | ref[N*S] |
# have[N], all uint8; the per-set reconstruction matrix rides in a
# sibling (B, N, K) array.  Verdict row = full[N*S] | ok[1], so the
# engine harvests ONE device array.


def recover_blob_row_bytes(k_max: int, n_max: int, sz: int) -> int:
    return (k_max + n_max) * sz + n_max


def recover_verdict_row_bytes(n_max: int, sz: int) -> int:
    return n_max * sz + 1


def recover_blob(blob: torch.Tensor, gfmat: torch.Tensor,
                 k_max: int, n_max: int, sz: int) -> torch.Tensor:
    """Packed-row batched recover: blob (B, recover_blob_row_bytes(...))
    uint8 + gfmat (B, n_max, k_max) uint8 (the JAX package takes the
    bit-matrices, (B, 8*n_max, 8*k_max) int8), tensors on one device ->
    (B, n_max*sz + 1) uint8 verdict rows (recovered codeword bytes, then
    the ok flag), one launch of the GF(2) kernel."""
    return gf2.recover_blob(blob, gfmat, k_max, n_max, sz)


def _stack_recover_batch(sets: list):
    """Host-side pack: validate + stack B sets for the fused dispatch.

    Returns (surv, gfmat, ref, have, metas, errs) where metas[i] is
    (k, n, sz, have_idx) for packable sets and errs[i] is a ValueError for
    sets rejected before dispatch (too few survivors / over limits)."""
    B = len(sets)
    metas, errs = [None] * B, [None] * B
    K = N = S = 1
    packable = []
    for bi, (shreds, k, sz) in enumerate(sets):
        n = len(shreds)
        have = [i for i, s in enumerate(shreds) if s is not None]
        if k > DATA_SHREDS_MAX or n - k > PARITY_SHREDS_MAX:
            errs[bi] = ValueError("shred counts exceed protocol limits")
            continue
        if len(have) < k:
            errs[bi] = ValueError(
                f"unrecoverable: only {len(have)} of {k} needed shreds")
            continue
        metas[bi] = (k, n, sz, have)
        K, N, S = max(K, k), max(N, n), max(S, sz)
        packable.append(bi)
    surv = np.zeros((B, K, S), dtype=np.uint8)
    gfmat = np.zeros((B, N, K), dtype=np.uint8)
    ref = np.zeros((B, N, S), dtype=np.uint8)
    have_m = np.zeros((B, N), dtype=bool)
    for bi in packable:
        shreds, k, sz = sets[bi]
        _, n, _, have = metas[bi]
        use = tuple(have[:k])
        for r, i in enumerate(use):
            surv[bi, r, :sz] = np.asarray(shreds[i], dtype=np.uint8)
        gfmat[bi, :n, :k] = _recover_gfmat(k, n, use)
        for i in have:
            ref[bi, i, :sz] = np.asarray(shreds[i], dtype=np.uint8)
            have_m[bi, i] = True
    return surv, gfmat, ref, have_m, metas, errs


def _finish_recover_batch(full: np.ndarray, ok: np.ndarray,
                          metas: list, errs: list) -> list:
    """Per-set outcomes off a materialized batch verdict: the recovered
    full shred list, or the ValueError describing why the set failed
    (never raises per-set — an erasure storm must not sink the batch)."""
    out = []
    for bi, meta in enumerate(metas):
        if meta is None:
            out.append(errs[bi])
            continue
        k, n, sz, have = meta
        if not bool(ok[bi]):
            out.append(ValueError(
                "corrupt: a surviving shred is inconsistent with the "
                "re-derived encoding"))
            continue
        out.append([np.asarray(full[bi, i, :sz], dtype=np.uint8)
                    for i in range(n)])
    return out


def recover_batch(sets: list, device: bool = True,
                  torch_device=None) -> list:
    """Recover many FEC sets in ONE launch.

    sets: list of (shreds, k, sz) triples with the recover() per-set
    contract.  Returns a list of per-set outcomes: the recovered full
    shred list on success, else the ValueError (ERR_PARTIAL/ERR_CORRUPT
    analogue) for that set — errors never propagate across sets.

    device=False runs the table-driven host golden model per set
    (bit-identity reference for the stacked device path)."""
    if not sets:
        return []
    if not device:
        out = []
        for shreds, k, sz in sets:
            try:
                out.append(recover(shreds, k, sz, device=False))
            except ValueError as e:
                out.append(e)
        return out
    surv, gfmat, ref, have_m, metas, errs = _stack_recover_batch(sets)
    dev = resolve_device(torch_device)
    full_d, ok_d = gf2.gf2_recover(
        _upload(surv, np.uint8, dev), _upload(gfmat, np.uint8, dev),
        _upload(ref, np.uint8, dev), _upload(have_m, bool, dev))
    return _finish_recover_batch(full_d.cpu().numpy(), ok_d.cpu().numpy(),
                                 metas, errs)
