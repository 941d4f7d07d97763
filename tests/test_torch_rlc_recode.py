"""The RLC scalar chain's kernel on the CPU: rlc_recode_plain against the
JAX package's Pallas kernel (curve_pallas.rlc_recode) in interpret mode
at 8 lanes, and against the JAX package's XLA chain and Python ints on
more lanes; and _rlc_scalars, which now runs rlc_recode, against the
chain it replaced.

The lanes are those of tests/test_ed25519_rlc.py (random S, half of them
non-canonical) with the edges S = L - 1, L and 2^256 - 1, z = 0, 1 and
2^128 - 1, and a digest of all 0xff.  Every comparison is exact
(tolerance 0): the chain is integer arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import torch

from firedancer_tpu.ops import curve_pallas as jcp
from firedancer_tpu.ops import scalar25519 as jsc
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.ops import rlc_recode as rl
from firedancer_tpu_torch.ops import scalar25519 as sc
from _torch_threads import one_torch_thread  # noqa: F401

L = sc.L


def _lanes(n: int, seed: int):
    """s (n, 32), digest (n, 64), z (n, 16) as numpy, edges first."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    s[: n // 2, 31] &= 0x0F              # half canonical, half not
    d = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    z = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    for i, v in enumerate((L - 1, L, 2**256 - 1)):
        s[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    d[0] = 0xFF
    z[0], z[1], z[2] = 0, 0xFF, 0
    z[2, 0] = 1
    return s, d, z


def _ints(rows) -> list[int]:
    return [int.from_bytes(bytes(r), "little") for r in rows]


def test_rlc_recode_plain_matches_pallas_interpret():
    s, d, z = _lanes(8, 0)
    ok_j, ww_j, zw_j, zs_j = jcp.rlc_recode(
        jnp.asarray(s), jnp.asarray(d), jnp.asarray(z), blk=8,
        interpret=True)
    ok_t, ww_t, zw_t, zs_t = rl.rlc_recode_plain(
        *(torch.from_numpy(a) for a in (s, d, z)))
    assert ok_t.tolist() == np.asarray(ok_j).tolist()
    assert ww_t.dtype == zw_t.dtype == torch.uint8
    assert ww_t.tolist() == np.asarray(ww_j).tolist()
    assert zw_t.tolist() == np.asarray(zw_j).tolist()
    assert zs_t.tolist() == interop.scalar_limbs_from_jax(zs_j).tolist()
    # the CPU wrapper is the plain version
    got = rl.rlc_recode(*(torch.from_numpy(a) for a in (s, d, z)))
    assert all(torch.equal(a, b) for a, b in
               zip(got, (ok_t, ww_t, zw_t, zs_t)))


def test_rlc_recode_plain_matches_xla_chain_and_ints():
    n = 40
    s, d, z = _lanes(n, 1)
    ok_t, ww_t, zw_t, zs_t = rl.rlc_recode_plain(
        *(torch.from_numpy(a) for a in (s, d, z)))
    zl = jsc.bytes_to_limbs(jnp.asarray(z), 11)
    k = jsc.reduce_512(jnp.asarray(d))
    assert ok_t.tolist() == np.asarray(
        jsc.is_canonical(jnp.asarray(s))).tolist()
    assert ww_t.tolist() == np.asarray(
        jsc.limbs_to_windows(jsc.mul_mod_l(k, zl))).tolist()
    assert zs_t.tolist() == np.asarray(jsc.mul_mod_l(
        jsc.bytes_to_limbs(jnp.asarray(s), 22), zl)).tolist()
    s_i, d_i, z_i = _ints(s), _ints(d), _ints(z)
    assert [sc.to_int(zs_t[:, j]) for j in range(n)] == [
        a * b % L for a, b in zip(s_i, z_i)]
    w = [sum(int(v) << (4 * i) for i, v in enumerate(ww_t[:, j].tolist()))
         for j in range(n)]
    assert w == [b * (a % L) % L for a, b in zip(d_i, z_i)]
    assert [sum(int(v) << (4 * i) for i, v in enumerate(zw_t[:, j].tolist()))
            for j in range(n)] == z_i


def test_rlc_scalars_match_the_chain_they_replace():
    """_rlc_scalars (rlc_recode, then sum_mod_l in torch) gives the bits,
    windows and c of the torch chain it replaced, and c = sum z s mod L."""
    n = 24
    s, d, z = _lanes(n, 2)
    st, dt, zt = (torch.from_numpy(a) for a in (s, d, z))
    ok, w_win, z_win, c_win = ed._rlc_scalars(dt, st, zt)
    z_limbs = sc.bytes_to_limbs(zt, 11)
    c_limbs = sc.sum_mod_l(sc.mul_mod_l(sc.bytes_to_limbs(st, 22), z_limbs),
                           axis=0)
    assert ok.tolist() == sc.is_canonical(st).tolist()
    assert w_win.tolist() == sc.limbs_to_windows(
        sc.mul_mod_l(sc.reduce_512(dt), z_limbs)).tolist()
    assert z_win.tolist() == sc.limbs_to_windows(
        torch.cat([z_limbs, torch.zeros_like(z_limbs)]))[:32].tolist()
    assert c_win.tolist() == sc.limbs_to_windows(c_limbs)[:, None].tolist()
    assert sum(int(v) << (4 * i) for i, v in enumerate(
        c_win[:, 0].tolist())) == sum(
            a * b for a, b in zip(_ints(s), _ints(z))) % L
