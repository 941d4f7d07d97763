"""The antipa verify tail: the kernel after the SHA-512 kernel in the
antipa mode, ed25519.verify_batch_antipa (csrc/antipa_tail.cu; it
replaces no Pallas kernel: the JAX package runs these steps as XLA
device code, firedancer_tpu/ops/ed25519.py::verify_batch_antipa).

antipa_tail(pub, r, s, digest) -> bool (n,): A decompresses and is not
of small order, R decompresses and its encoded y is not one of the five
small-order y values, S < L, and with k = digest mod L halved to u == v
k (mod L) (scalar25519.halve_scalar), c = v S mod L and R~ = -R where v
>= 0, R where v < 0, the point [c]B + [u](-A) + [|v|]R~ is the identity.
Inputs are uint8 row views of any row stride: pub, r and s (n, 32),
digest (n, 64).  On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it runs antipa_tail_plain, the JAX graph's steps
in torch.  The kernel groups the same sum otherwise (c split at 2^128,
signed digits); the bit depends on the point only, so the two agree bit
for bit.
"""

import ctypes
import functools

import torch

from ..kernels import build
from . import curve25519 as cv
from . import f25519 as fe
from . import scalar25519 as sc
from .dsm import kernel_consts as chain_consts
from .r_check import _parse_r_bytes
from .sha512_kernel import _rows

NWIN = 32   # windows of u and |v| the chain reads (they are < 2^128)


def antipa_tail_plain(pub, r, s, digest):
    """The plain torch version, the JAX graph's steps in its order."""
    ok_a, a_pt = cv.decompress(pub)
    ok_a = ok_a & ~cv.is_small_order_affine(a_pt)
    ok_r, r_pt = cv.decompress(r)
    small_r = _parse_r_bytes(r)[2]
    ok_s = sc.is_canonical(s)
    u, av, v_pos = sc.halve_scalar(sc.reduce_512(digest))
    c = sc.mul_mod_l(sc.bytes_to_limbs(s, 22), av)     # |v| S mod L
    c = torch.where(v_pos, c, sc.neg_mod_l(c))
    r_neg = cv.neg(r_pt)
    r_eff = cv.Point(*(torch.where(v_pos, n, p)
                       for n, p in zip(r_neg, r_pt)))
    chain = cv.double_scalar_mul_halved(
        sc.limbs_to_windows(u)[:NWIN], sc.limbs_to_windows(av)[:NWIN],
        cv.neg(a_pt), r_eff, NWIN)
    q = cv.add(chain, cv.scalar_mul_base(sc.limbs_to_windows(c)))
    return ok_s & ok_a & ok_r & ~small_r & cv.is_identity(q)


@functools.lru_cache(maxsize=None)
def kernel_consts(device) -> torch.Tensor:
    """The kernel's int32 (77, 10) constants: the strict chain's 41 rows
    (dsm.kernel_consts), then [0..8](2^128 B) as (y - x, y + x, 2dxy,
    -2dxy) rows (csrc/antipa_tail.cu ap_consts)."""
    b = (cv.BASE_X, cv.BASE_Y, 1, cv.BASE_X * cv.BASE_Y % fe.P)
    for _ in range(128):
        b = cv._pt_add_host(b, b)
    hi = [v for row in cv.base_table_ints(b) for v in row]
    return torch.cat([chain_consts(device),
                      torch.tensor([fe.int_to_limbs(v) for v in hi],
                                   dtype=torch.int32, device=device)])


@functools.lru_cache(maxsize=None)
def _fn():
    fn = build.load("antipa_tail").fd_antipa_tail
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, ll, p, ll, p, ll, p, ll, p, i, p, p]
    fn.restype = i
    return fn


def antipa_tail(pub, r, s, digest):
    if pub.device.type == "cpu":
        return antipa_tail_plain(pub, r, s, digest)
    n = pub.shape[0]
    for t, w, name in ((pub, 32, "pub"), (r, 32, "r"), (s, 32, "s"),
                       (digest, 64, "digest")):
        _rows(t, w, name)
        if t.device != pub.device or t.shape[0] != n:
            raise ValueError(f"{name}: device or row count differs")
    dev = pub.device
    ok = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return ok.bool()
    consts = kernel_consts(dev)
    with torch.cuda.device(dev):
        rc = _fn()(pub.data_ptr(), pub.stride(0), r.data_ptr(), r.stride(0),
                   s.data_ptr(), s.stride(0), digest.data_ptr(),
                   digest.stride(0), consts.data_ptr(), n, ok.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"antipa_tail kernel launch failed: CUDA error {rc}")
    antipa_tail.launches += 1
    return ok.view(torch.bool)


antipa_tail.launches = 0
