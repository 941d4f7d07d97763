"""The port's MSM (the plain version of csrc/msm.cu and its fold) against
the JAX package's XLA cv.msm, for both selects, on the same points and
scalars: N = 24 points with full 128-bit scalars over 32 windows
(tests/_torch_msm_case.py), summed by the port at m = 2, and by its lane
tree at m = 3 (an odd partial carried up) and m = 8 (three full levels),
each against one XLA cv.msm of the case at m = 2, compiled once for the
module.  The Pallas kernel in interpret mode is
tests/test_torch_rlc_msm_interpret.py's.  The top nibble is >= 8, so
that the p16 recode carries out of the top window.  The selects and the
two packages take different paths (other tables, other coordinates,
another order of adds), so the sums are compared as affine points, as
tests/test_curve_pallas.py compares them, and against the sum computed
on Python ints.
"""

import functools

import pytest
import torch

from firedancer_tpu.ops import curve25519 as jcv
from firedancer_tpu_torch.ops import f25519 as fe
from firedancer_tpu_torch.ops import msm as ms
from _torch_msm_case import M, N, NWIN, case, jax_affine, port_affine
from _torch_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _xla_affine():
    """XLA cv.msm's sum of the case at m = M (one compile)."""
    _, jax_args, _ = case()
    return jax_affine(jcv.msm(*jax_args, m=M, nwin=NWIN))


def test_interop_carries_points_and_windows():
    (win, pt), _, _ = case()
    assert win.dtype == torch.int64 and win.shape == (NWIN, N)
    assert tuple(pt.X.shape) == (fe.NLIMB, N)
    assert int(win.max()) >= 8 and int(win[NWIN - 1].min()) >= 8


def test_msm_plain_matches_xla_msm():
    port, _, want = case()
    assert _xla_affine() == want
    for select in ms.SELECTS:
        assert port_affine(ms.msm_plain(*port, M, NWIN, select)) == want
        # the wrapper takes the same plain version for CPU tensors
        assert port_affine(ms.msm(*port, M, NWIN, select)) == want


@pytest.mark.parametrize("select,m", [(sel, m) for m in (3, 8)
                                      for sel in ms.SELECTS])
def test_msm_lane_tree_matches_xla_msm(select, m):
    """The lane tree at m = 3 (an odd partial carried up) and m = 8 (three
    full levels): the plain version's sum is XLA cv.msm's and the one on
    Python ints."""
    port, _, want = case()
    assert _xla_affine() == port_affine(
        ms.msm_plain(*port, m, NWIN, select)) == want
