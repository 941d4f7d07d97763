"""The port's Reed-Solomon (firedancer_tpu_torch/ballet/reedsol.py, the
GF(2) kernel's plain version on CPU tensors) against the JAX package's
reedsol, its device paths jitted on the CPU, byte for byte on seeded
sets: the GF tables, the generator and bit-matrices (the port's
expansion of a matrix against the JAX package's), encode, recover,
recover_batch and recover_blob with equal, ragged and mixed-geometry
erasure patterns, a corrupt set, the protocol limits and the
reconstruction-matrix cache's accounting.  The kernel itself is held
against the plain version on the card (chip_smoke.py phase 16a,
tests/test_torch_kernels.py) and its lane code in
test_torch_csrc_host."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ballet import reedsol as jrs
from firedancer_tpu_torch.ballet import reedsol as rs
from firedancer_tpu_torch.ops import gf2_recover as gf2
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


def _codeword(rng, k: int, p: int, sz: int) -> list:
    data = rng.integers(0, 256, (k, sz), np.uint8)
    par = jrs.encode(data, p, device=False)
    return [data[i] for i in range(k)] + [par[j] for j in range(p)]


def _erase(cw: list, drop) -> list:
    return [None if i in drop else s for i, s in enumerate(cw)]


def test_gf_tables_and_matrices_equal_the_jax_package():
    assert np.array_equal(rs._EXP, jrs._EXP)
    assert np.array_equal(rs._LOG, jrs._LOG)
    rng = np.random.default_rng(1)
    for a, b in rng.integers(0, 256, (64, 2)):
        a, b = int(a), int(b)
        assert rs.gf_mul(a, b) == jrs.gf_mul(a, b)
        assert rs.gf_pow(a, b) == jrs.gf_pow(a, b)
        if a:
            assert rs.gf_inv(a) == jrs.gf_inv(a)
    for k, n in ((1, 2), (4, 7), (32, 64), (67, 134)):
        assert np.array_equal(rs.generator_matrix(k, n),
                              jrs.generator_matrix(k, n))
    m = rng.integers(0, 256, (5, 3), np.uint8)
    assert np.array_equal(rs._bitmatrix(m), jrs._bitmatrix(m))
    use = (0, 2, 5, 6)
    R, bits = jrs._recover_matrices(4, 8, use)
    assert rs._recover_matrices(4, 8, use) == R
    # the port keeps R alone: its kernel and plain version expand R into
    # the bit-matrix that the JAX package caches beside it
    gm = np.frombuffer(R, np.uint8).reshape(1, 8, 4)
    assert gf2.bitmatrix_plain(torch.from_numpy(gm.copy()))[0].numpy(
    ).tobytes() == bits


@pytest.mark.parametrize("k,p,sz", [(1, 1, 7), (4, 3, 50), (32, 32, 1019)])
def test_encode_equals_the_jax_package(k, p, sz):
    data = np.random.default_rng(k).integers(0, 256, (k, sz), np.uint8)
    got = rs.encode(data, p, torch_device=CPU)
    assert np.array_equal(got, jrs.encode(data, p))
    assert np.array_equal(got, jrs.encode(data, p, device=False))
    assert np.array_equal(rs.encode(data, p, device=False), got)


@pytest.mark.parametrize("drop", [(), (1, 3), (0, 1, 2), (4, 6)])
def test_recover_equals_the_jax_package(drop):
    cw = _codeword(np.random.default_rng(7), 4, 3, 40)
    shreds = _erase(cw, drop)
    for device in (True, False):
        got = rs.recover(shreds, 4, 40, device=device, torch_device=CPU)
        want = jrs.recover(shreds, 4, 40, device=device)
        assert [bytes(x) for x in got] == [bytes(x) for x in want]
        assert [bytes(x) for x in got] == [bytes(x) for x in cw]


def test_recover_refusals_equal_the_jax_package():
    cw = _codeword(np.random.default_rng(8), 4, 3, 40)
    bad = _erase(cw, (0,))
    bad[5] = bad[5].copy()
    bad[5][3] ^= 1
    few = _erase(cw, (0, 1, 2, 3))
    for shreds, k in ((bad, 4), (few, 4), ([cw[0]] * 69, 1),
                      ([cw[0]] * 68, 68)):
        for device in (True, False):
            with pytest.raises(ValueError) as e_port:
                rs.recover(shreds, k, 40, device=device, torch_device=CPU)
            with pytest.raises(ValueError) as e_jax:
                jrs.recover(shreds, k, 40, device=device)
            assert str(e_port.value) == str(e_jax.value)
    with pytest.raises(ValueError, match="protocol limits"):
        rs.encode(np.zeros((68, 8), np.uint8), 1, torch_device=CPU)
    with pytest.raises(ValueError, match="protocol limits"):
        rs.encode(np.zeros((4, 8), np.uint8), 68, torch_device=CPU)


def _mixed_sets(rng):
    """Equal, ragged and mixed-geometry sets, a corrupt one, one with
    too few survivors and one over the limits."""
    sets = []
    for i in range(4):                       # 8:8, ragged erasures
        cw = _codeword(rng, 8, 8, 64)
        sets.append((_erase(cw, set(range(0, 2 * i, 2)) | {9 + i}), 8, 64))
    cw = _codeword(rng, 3, 5, 33)            # smaller k, n and sz
    sets.append((_erase(cw, (0, 4)), 3, 33))
    cw = _codeword(rng, 1, 1, 64)            # k = 1
    sets.append((_erase(cw, (0,)), 1, 64))
    cw = _codeword(rng, 8, 8, 64)            # corrupt survivor
    bad = _erase(cw, (2,))
    bad[12] = bad[12].copy()
    bad[12][7] ^= 0x40
    sets.append((bad, 8, 64))
    sets.append((_erase(_codeword(rng, 4, 2, 64), (0, 1, 2)), 4, 64))
    sets.append(([cw[0]] * 69, 1, 64))
    return sets


def _outcomes(out):
    return [repr(o) if isinstance(o, ValueError) else
            [bytes(x) for x in o] for o in out]


def test_recover_batch_equals_the_jax_package():
    sets = _mixed_sets(np.random.default_rng(9))
    got = rs.recover_batch(sets, torch_device=CPU)
    want = jrs.recover_batch(sets)
    assert _outcomes(got) == _outcomes(want)
    host = jrs.recover_batch(sets, device=False)
    assert [isinstance(o, ValueError) for o in host] == [
        isinstance(o, ValueError) for o in got]
    assert [o for o in _outcomes(got) if isinstance(o, list)] == [
        o for o in _outcomes(host) if isinstance(o, list)]
    assert isinstance(got[6], ValueError) and "corrupt" in str(got[6])
    assert rs.recover_batch([], torch_device=CPU) == []


def test_recover_blob_equals_the_jax_package():
    rng = np.random.default_rng(10)
    sets = _mixed_sets(rng)[:7]
    surv, gfmat, ref, have, _, _ = rs._stack_recover_batch(sets)
    B, K, S = surv.shape
    N = ref.shape[1]
    blob = np.concatenate([surv.reshape(B, -1), ref.reshape(B, -1),
                           have.astype(np.uint8)], 1)
    # two padding rows: zero survivors, zero matrix, all ok
    blob = np.concatenate([blob, np.zeros((2, blob.shape[1]), np.uint8)])
    gfmat = np.concatenate([gfmat, np.zeros((2,) + gfmat.shape[1:],
                                            np.uint8)])
    # the JAX package takes each matrix's bit-matrix, the port the matrix
    bitmat = np.stack([jrs._bitmatrix(m) for m in gfmat])
    assert blob.shape[1] == rs.recover_blob_row_bytes(K, N, S)
    got = rs.recover_blob(torch.from_numpy(blob), torch.from_numpy(gfmat),
                          K, N, S).numpy()
    want = np.asarray(jrs.recover_blob(jnp.asarray(blob),
                                       jnp.asarray(bitmat), k_max=K,
                                       n_max=N, sz=S))
    assert got.shape == (B + 2, rs.recover_verdict_row_bytes(N, S))
    assert np.array_equal(got, want)
    assert got[:, -1].tolist() == [1] * 6 + [0] + [1, 1]


def test_gf2_wrappers_refuse_bad_shapes():
    surv = torch.zeros((2, 4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="matrix"):
        gf2.gf2_recover(surv, torch.zeros((2, 16, 16), dtype=torch.int8),
                        torch.zeros((2, 2, 8), dtype=torch.uint8),
                        torch.zeros((2, 2), dtype=torch.bool))
    with pytest.raises(ValueError, match="limits"):
        gf2.gf2_encode(torch.zeros((68, 8), dtype=torch.uint8),
                       torch.zeros((1, 68), dtype=torch.uint8))


def test_recover_cache_accounting_equals_the_jax_package():
    rng = np.random.default_rng(11)
    cw = _codeword(rng, 6, 4, 16)
    patterns = [(1,), (1,), (0, 7), (), (1,)]
    for mod in (rs, jrs):
        mod.recover_cache_clear()
    for drop in patterns:
        rs.recover(_erase(cw, drop), 6, 16, device=False)
        jrs.recover(_erase(cw, drop), 6, 16, device=False)
    a, b = rs.recover_cache_info(), jrs.recover_cache_info()
    assert (a.hits, a.misses, a.currsize) == (b.hits, b.misses, b.currsize)
    assert (a.hits, a.misses) == (2, 2)
    rs.recover_batch([(_erase(cw, (1,)), 6, 16)], torch_device=CPU)
    assert rs.recover_cache_info().hits == 3
