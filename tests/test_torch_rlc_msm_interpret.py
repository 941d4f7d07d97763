"""The port's MSM (the plain version of csrc/msm.cu and its fold) against
the JAX package's Pallas curve_pallas.msm in interpret mode, all lanes
in one block, for both selects: on tests/_torch_msm_case.py's main case
(24 points, 128-bit scalars over 32 windows, m = 2), and, in
slow-marked tests, on lane trees at m = 3 and 8 with 32-bit scalars over
8 windows.  The XLA cv.msm comparisons are
tests/test_torch_rlc_msm.py's.  Sums are compared as affine points and
against the sum on Python ints.
"""

import pytest

from firedancer_tpu.ops import curve_pallas as jcp
from firedancer_tpu_torch.ops import msm as ms
from _torch_msm_case import (M, N, NWIN, SMALL, case, jax_affine,
                             port_affine)
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("select", ms.SELECTS)
def test_msm_plain_matches_pallas_interpret(select):
    port, jax_args, want = case()
    got = jcp.msm(*jax_args, m=M, nwin=NWIN, blk=N // M, interpret=True,
                  select=select)
    assert jax_affine(got) == port_affine(
        ms.msm_plain(*port, M, NWIN, select)) == want


@pytest.mark.slow
@pytest.mark.parametrize("select,m", [(sel, m) for m in SMALL
                                      for sel in ms.SELECTS])
def test_msm_lane_tree_matches_pallas_interpret(select, m):
    """The lane tree at m = 3 and 8 against the Pallas curve_pallas.msm in
    interpret mode, all lanes in one block.  Slow: on a CPU host interpret
    mode takes about 150 s a select at m = 3 and over 7 min at m = 8."""
    n, nwin, seed = SMALL[m]
    port, jax_args, want = case(n, nwin, seed)
    got = jcp.msm(*jax_args, m=m, nwin=nwin, blk=n // m, interpret=True,
                  select=select)
    assert jax_affine(got) == port_affine(
        ms.msm_plain(*port, m, nwin, select)) == want
