"""The MSM comparisons' shared case (tests/test_torch_rlc_msm.py and
tests/test_torch_rlc_msm_interpret.py): points [k_i]B and their windows,
as JAX limb planes and through interop as port planes, with the expected
sum on Python ints; and the affine forms the comparisons use."""

import functools

import jax.numpy as jnp
import numpy as np

from firedancer_tpu.ops import curve25519 as jcv
from firedancer_tpu.ops import f25519 as jfe
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import scalar25519 as sc

P = fe.P
# the main case: N points whose scalars fill NWIN windows (128 bits);
# N is a multiple of every m the comparisons take (2, 3 and 8)
M, N, NWIN = 2, 24, 32
# m -> (points, windows, seed) of the slow-marked interpret lane trees
SMALL = {3: (12, 8, 33), 8: (16, 8, 38)}


def affine(xyz) -> tuple[int, int]:
    x, y, z = xyz
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def port_affine(pt) -> tuple[int, int]:
    return affine([interop.field_to_ints(t)[0] for t in pt[:3]])


def jax_affine(pt) -> tuple[int, int]:
    return affine([interop.field_to_ints(np.asarray(t).reshape(-1, 1))[0]
                   for t in pt[:3]])


@functools.lru_cache(maxsize=None)
def case(n: int = N, nwin: int = NWIN, seed: int = 31):
    """n points [k_i]B (projective, from Python-int adds) as JAX limb
    planes and through interop as port planes, their windows both ways,
    and the expected affine sum."""
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(8), "little") for _ in range(n)]
    pts = [ed._scalar_mul_base_host(k) for k in ks]
    jplanes = tuple(np.stack([jfe._to_limbs_py(p[i]) for p in pts], axis=1)
                    for i in range(4))
    sb = np.zeros((n, 32), np.uint8)
    sb[:, :nwin // 2] = rng.integers(0, 256, (n, nwin // 2), np.uint8)
    sb[:, nwin // 2 - 1] |= 0x80
    jwin = np.asarray(jcv.scalar_windows(jnp.asarray(sb)))[:nwin]
    s_vals = [int.from_bytes(bytes(r), "little") for r in sb]
    want = affine(ed._scalar_mul_base_host(
        sum(k * s for k, s in zip(ks, s_vals)) % sc.L)[:3])
    port = (interop.windows_from_jax(jwin), interop.point_from_jax(jplanes))
    jax_args = (jnp.asarray(jwin), jcv.Point(*map(jnp.asarray, jplanes)))
    return port, jax_args, want
