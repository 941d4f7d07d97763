"""The port's MSM (the plain version of csrc/msm.cu and its fold) against
the JAX package's XLA cv.msm, for both selects, on the same points and
scalars: at m = 2 with full 128-bit scalars over 32 windows, and against
the Pallas curve_pallas.msm in interpret mode too; at m = 3 and 8 (a lane
tree with an odd partial, and one of three full levels) with 32-bit
scalars over 8 windows.  The top nibble is >= 8, so that the p16 recode
carries out of the top window.  The selects and the two packages take
different paths (other tables, other coordinates, another order of
adds), so the sums are compared as affine points, as
tests/test_curve_pallas.py compares them, and against the sum computed
on Python ints.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import curve25519 as jcv
from firedancer_tpu.ops import curve_pallas as jcp
from firedancer_tpu.ops import f25519 as jfe
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import msm as ms
from firedancer_tpu_torch.ops import scalar25519 as sc

P = fe.P
M, N, NWIN = 2, 16, 32


def _affine(xyz) -> tuple[int, int]:
    x, y, z = xyz
    zi = pow(z, P - 2, P)
    return x * zi % P, y * zi % P


def _port_affine(pt) -> tuple[int, int]:
    return _affine([interop.field_to_ints(t)[0] for t in pt[:3]])


def _jax_affine(pt) -> tuple[int, int]:
    return _affine([interop.field_to_ints(np.asarray(t).reshape(-1, 1))[0]
                    for t in pt[:3]])


# m -> (points, windows, seed) of the cases at m = 3 and 8
SMALL = {3: (12, 8, 33), 8: (16, 8, 38)}


@functools.lru_cache(maxsize=None)
def _case(n, nwin, seed):
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
    want = _affine(ed._scalar_mul_base_host(
        sum(k * s for k, s in zip(ks, s_vals)) % sc.L)[:3])
    port = (interop.windows_from_jax(jwin), interop.point_from_jax(jplanes))
    jax_args = (jnp.asarray(jwin), jcv.Point(*map(jnp.asarray, jplanes)))
    return port, jax_args, want


@pytest.fixture(scope="module")
def case():
    return _case(N, NWIN, 31)


def test_interop_carries_points_and_windows(case):
    (win, pt), _, _ = case
    assert win.dtype == torch.int64 and win.shape == (NWIN, N)
    assert tuple(pt.X.shape) == (fe.NLIMB, N)
    assert int(win.max()) >= 8 and int(win[NWIN - 1].min()) >= 8


def test_msm_plain_matches_xla_msm(case):
    port, jax_args, want = case
    assert _jax_affine(jcv.msm(*jax_args, m=M, nwin=NWIN)) == want
    for select in ms.SELECTS:
        assert _port_affine(ms.msm_plain(*port, M, NWIN, select)) == want
        # the wrapper takes the same plain version for CPU tensors
        assert _port_affine(ms.msm(*port, M, NWIN, select)) == want


@pytest.mark.parametrize("select", ms.SELECTS)
def test_msm_plain_matches_pallas_interpret(case, select):
    port, jax_args, want = case
    got = jcp.msm(*jax_args, m=M, nwin=NWIN, blk=8, interpret=True,
                  select=select)
    assert _jax_affine(got) == _port_affine(
        ms.msm_plain(*port, M, NWIN, select)) == want


@functools.lru_cache(maxsize=None)
def _xla_affine(m):
    n, nwin, seed = SMALL[m]
    _, jax_args, _ = _case(n, nwin, seed)
    return _jax_affine(jcv.msm(*jax_args, m=m, nwin=nwin))


@pytest.mark.parametrize("select,m", [(sel, m) for m in SMALL
                                      for sel in ms.SELECTS])
def test_msm_lane_tree_matches_xla_msm(select, m):
    """The lane tree at m = 3 (an odd partial carried up) and m = 8 (three
    full levels): the plain version's sum is XLA cv.msm's and the one on
    Python ints."""
    n, nwin, seed = SMALL[m]
    port, _, want = _case(n, nwin, seed)
    assert _xla_affine(m) == _port_affine(
        ms.msm_plain(*port, m, nwin, select)) == want
