"""Reed-Solomon recover and encode as one GF(2) bit-matrix product a set
(csrc/gf2_recover.cu, replacing firedancer_tpu/ballet/reedsol.py's
_recover_batch_core, recover_blob and _encode_device).

A set's survivors are K rows of S bytes; its matrix M is N x K GF(2^8)
bytes (reedsol's reconstruction or generator rows), which stands for its
(8N, 8K) bit-matrix: entry [8r + j, 8c + i] is bit j of M[r, c] * x^i
(reedsol._bitmatrix, which the JAX package's device paths take).  The
product unpacks each byte column to 8K bits (bit i of row r at 8r + i),
multiplies mod 2 and repacks N output rows.  For recovery the set's ok
flag is all((full == ref) | ~have).  On a CUDA tensor the wrappers launch
the kernel or raise; on a CPU tensor they run the plain version.
"""

import ctypes
import functools

import torch

from ..kernels import build

MAX_K = 67     # DATA_SHREDS_MAX
MAX_N = 134    # data + parity shreds of one set
POLY = 0x11D   # the GF(2^8) modulus


def _unpack(surv):
    """(B, K, S) uint8 -> (B, 8K, S) bit planes, bit i of row r at 8r+i."""
    B, K, S = surv.shape
    sh = torch.arange(8, dtype=torch.uint8, device=surv.device)
    return ((surv[:, :, None, :] >> sh[None, None, :, None]) & 1).reshape(
        B, 8 * K, S)


def bitmatrix_plain(gfm):
    """(B, N, K) uint8 GF(2^8) matrices -> their (B, 8N, 8K) int8
    bit-matrices, entry [8r + j, 8c + i] bit j of M[r, c] * x^i."""
    B, N, K = gfm.shape
    p = gfm.to(torch.int32)
    prods = []
    for _ in range(8):                       # M * x^i, i = 0..7
        prods.append(p)
        p = ((p << 1) ^ torch.where(p >= 0x80, POLY, 0)) & 0xFF
    prods = torch.stack(prods, -1)           # (B, N, K, i)
    sh = torch.arange(8, dtype=torch.int32, device=gfm.device)
    bits = (prods[..., None] >> sh) & 1      # (B, N, K, i, j)
    return bits.permute(0, 1, 4, 2, 3).reshape(B, 8 * N, 8 * K).to(
        torch.int8)


def product_plain(surv, gfm):
    """The plain torch product: expand M, unpack, an integer matrix
    product, & 1, repack.  The product runs in float32, exact here: every
    term is a 0/1 entry times a 0/1 bit and a sum has at most 8 * 67
    terms, far below 2^24.  (B, K, S) uint8 x (B, N, K) uint8 -> (B, N, S)
    uint8."""
    B, K, S = surv.shape
    N = gfm.shape[1]
    bits = _unpack(surv).to(torch.float32)
    acc = torch.bmm(bitmatrix_plain(gfm).to(torch.float32),
                    bits).to(torch.int64) & 1
    sh = torch.arange(8, dtype=torch.int64, device=surv.device)
    return (acc.reshape(B, N, 8, S) << sh[None, None, :, None]).sum(2).to(
        torch.uint8)


def ok_plain(full, ref, have):
    """Per-set consistency: every surviving row equals its re-derived
    one.  (B, N, S), (B, N, S), (B, N) bool -> (B,) bool."""
    B = full.shape[0]
    return ((full == ref) | ~have[:, :, None]).reshape(B, -1).all(1)


def gf2_recover_plain(surv, gfm, ref, have):
    full = product_plain(surv, gfm)
    return full, ok_plain(full, ref, have)


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("gf2_recover").fd_gf2_recover
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, q, p, p, q, p, q, i, i, i, i, p, q, p, q, p]
    fn.restype = i
    return fn


def _check(surv, gfm):
    if surv.dtype != torch.uint8 or surv.dim() != 3:
        raise ValueError(f"survivors: need uint8 (B, K, S), got "
                         f"{surv.dtype} {tuple(surv.shape)}")
    B, K, S = surv.shape
    if (gfm.dtype != torch.uint8 or gfm.dim() != 3 or gfm.shape[0] != B
            or gfm.shape[2] != K or gfm.device != surv.device):
        raise ValueError(f"matrix: need uint8 (B, N, K) = ({B}, N, {K}) "
                         f"on the survivors' device, got {gfm.dtype} "
                         f"{tuple(gfm.shape)}")
    N = gfm.shape[1]
    if K > MAX_K or N > MAX_N:
        raise ValueError(f"K {K}, N {N}: past the kernel's limits "
                         f"({MAX_K}, {MAX_N})")
    return B, K, N, S


def _launch(surv, surv_row, gfm, ref, ref_row, have, have_row, B, K, N, S,
            full, full_row, ok, ok_row):
    """One launch over B sets given by base pointers and row strides."""
    gfm = gfm.contiguous()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(surv.device):
        rc = _fn()(surv.data_ptr(), surv_row, gfm.data_ptr(), ptr(ref),
                   ref_row, ptr(have), have_row, B, K, N, S,
                   full.data_ptr(), full_row, ptr(ok), ok_row,
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"gf2_recover kernel launch failed: {rc}")
    gf2_recover.launches += 1


def gf2_recover(surv, gfm, ref, have):
    """Recover B sets in one launch.  surv (B, K, S) uint8, gfm (B, N, K)
    uint8, ref (B, N, S) uint8, have (B, N) bool -> (full (B, N, S)
    uint8, ok (B,) bool)."""
    B, K, N, S = _check(surv, gfm)
    if ref.shape != (B, N, S) or have.shape != (B, N):
        raise ValueError(f"ref {tuple(ref.shape)} / have "
                         f"{tuple(have.shape)}: need ({B}, {N}, {S}) / "
                         f"({B}, {N})")
    if surv.device.type == "cpu":
        return gf2_recover_plain(surv, gfm, ref, have)
    full = torch.empty((B, N, S), dtype=torch.uint8, device=surv.device)
    ok = torch.empty(B, dtype=torch.uint8, device=surv.device)
    if B and S:
        surv, ref = surv.contiguous(), ref.contiguous()
        have = have.to(torch.uint8).contiguous()
        _launch(surv, K * S, gfm, ref, N * S, have, N, B, K, N, S, full,
                N * S, ok, 1)
    elif B:
        ok.fill_(1)
    return full, ok.bool()


def gf2_encode(data, gfm):
    """Parity rows of one set: data (k, sz) uint8, gfm (p, k) uint8 ->
    (p, sz) uint8, with no consistency check."""
    B, K, N, S = _check(data[None], gfm[None])
    if data.device.type == "cpu":
        return product_plain(data[None], gfm[None])[0]
    out = torch.empty((N, S), dtype=torch.uint8, device=data.device)
    if N and S:
        if K == 0:
            return out.zero_()
        _launch(data.contiguous(), K * S, gfm, None, 0, None, 0, 1, K, N,
                S, out, N * S, None, 0)
    return out


def recover_blob_plain(blob, gfm, k_max: int, n_max: int, sz: int):
    B = blob.shape[0]
    ks, ns = k_max * sz, n_max * sz
    full, ok = gf2_recover_plain(
        blob[:, :ks].reshape(B, k_max, sz), gfm,
        blob[:, ks:ks + ns].reshape(B, n_max, sz),
        blob[:, ks + ns:ks + ns + n_max] != 0)
    return torch.cat([full.reshape(B, ns), ok[:, None].to(torch.uint8)], 1)


def recover_blob(blob, gfm, k_max: int, n_max: int, sz: int):
    """Packed-row recover (reedsol.recover_blob): blob (B, (k_max + n_max)
    * sz + n_max) uint8 rows surv | ref | have, gfm (B, n_max, k_max)
    uint8 -> (B, n_max * sz + 1) uint8 verdict rows, the recovered
    codeword then the ok flag.  The kernel reads the rows in place."""
    B = blob.shape[0]
    ks, ns = k_max * sz, n_max * sz
    if (blob.dtype != torch.uint8 or blob.dim() != 2
            or blob.shape[1] != ks + ns + n_max):
        raise ValueError(f"blob: need uint8 (B, {ks + ns + n_max}), got "
                         f"{blob.dtype} {tuple(blob.shape)}")
    _check(blob[:, :ks].reshape(B, k_max, sz), gfm)
    if gfm.shape[1] != n_max:
        raise ValueError(f"matrix rows {gfm.shape[1]} != {n_max}")
    if blob.device.type == "cpu":
        return recover_blob_plain(blob, gfm, k_max, n_max, sz)
    out = torch.empty((B, ns + 1), dtype=torch.uint8, device=blob.device)
    if B:
        if not sz:
            return out.fill_(1)
        blob = blob.contiguous()
        row = blob.shape[1]
        _launch(blob, row, gfm, blob[:, ks:], row, blob[:, ks + ns:],
                row, B, k_max, n_max, sz, out, ns + 1, out[:, ns:], ns + 1)
    return out


gf2_recover.launches = 0
