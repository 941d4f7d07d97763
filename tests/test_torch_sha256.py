"""The port's SHA-256 (firedancer_tpu_torch/ops/sha256.py) and the plain
version of the mixin-tree kernel (ops/mixin_tree.py) against the JAX
package's sha256, fixed-length forms and _mixin_roots, and hashlib, bit
for bit on seeded inputs.  CPU tensors run the plain versions; the
kernels themselves are held against these on the card (chip_smoke.py
phase 15) and their lane code against hashlib in test_torch_csrc_host."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ballet import bmtree as jbmtree
from firedancer_tpu.ballet import entry as jentry
from firedancer_tpu.ops import sha256 as jsh
from firedancer_tpu_torch.ballet import bmtree
from firedancer_tpu_torch.ops import mixin_tree as mt
from firedancer_tpu_torch.ops import sha256 as sh
from _torch_threads import one_torch_thread  # noqa: F401


def test_constants_equal_the_jax_package():
    assert sh.H0 == [int(x) for x in jsh._H0]
    assert sh.K == [int(x) for x in jsh._K]
    assert sh.PAD64_WK == [int(x) for x in jsh._PAD64_WK]
    assert sh.PAD32_TAILW == [int(x) for x in jsh._PAD32_TAILW]
    dev = torch.device("cpu")
    assert sh._pad64_wk_dev(dev).tolist() == sh.PAD64_WK
    assert sh._pad32_tailw_dev(dev).tolist() == sh.PAD32_TAILW


LENS = [0, 1, 31, 55, 56, 63, 64, 65, 119, 120, 150]


def test_pad_messages_equals_the_jax_package():
    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 256, (len(LENS), 150), dtype=np.uint8)
    lens = np.array(LENS, dtype=np.int32)
    got, nb = sh.pad_messages(torch.from_numpy(msgs), torch.from_numpy(lens),
                              4)
    want, jnb = jsh.pad_messages(jnp.asarray(msgs), jnp.asarray(lens), 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(nb.numpy(), np.asarray(jnb))


def test_sha256_equals_the_jax_package_and_hashlib():
    rng = np.random.default_rng(4)
    msgs = rng.integers(0, 256, (len(LENS), 150), dtype=np.uint8)
    lens = np.array(LENS, dtype=np.int32)
    got = sh.sha256(torch.from_numpy(msgs), torch.from_numpy(lens)).numpy()
    want = np.asarray(jsh.sha256(jnp.asarray(msgs), jnp.asarray(lens)))
    assert np.array_equal(got, want)
    for i, n in enumerate(LENS):
        assert bytes(got[i]) == hashlib.sha256(bytes(msgs[i, :n])).digest()


@pytest.mark.parametrize("width", [32, 64])
def test_fixed_forms_equal_the_jax_package_and_hashlib(width):
    rng = np.random.default_rng(width)
    m = rng.integers(0, 256, (9, width), dtype=np.uint8)
    m[0] = 0
    m[1] = 255
    port = sh.sha256_fixed32 if width == 32 else sh.sha256_fixed64
    jax_fn = jsh.sha256_fixed32 if width == 32 else jsh.sha256_fixed64
    got = port(torch.from_numpy(m)).numpy()
    assert np.array_equal(got, np.asarray(jax_fn(jnp.asarray(m))))
    for i in range(len(m)):
        assert bytes(got[i]) == hashlib.sha256(bytes(m[i])).digest()


def test_word_forms_and_state_to_bytes():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    st = sh.bytes_to_state(torch.from_numpy(a))
    assert st.shape == (8, 5)
    assert np.array_equal(sh.state_to_bytes(st).numpy(), a)
    j = jsh.state_to_bytes(jnp.asarray(st.numpy().astype(np.uint32)))
    assert np.array_equal(np.asarray(j), a)
    one = sh.state_to_bytes(sh.fixed32_words(st)).numpy()
    mix = sh.state_to_bytes(sh.fixed64_words(
        st, sh.bytes_to_state(torch.from_numpy(b)))).numpy()
    for i in range(5):
        assert bytes(one[i]) == hashlib.sha256(bytes(a[i])).digest()
        assert bytes(mix[i]) == hashlib.sha256(bytes(a[i]) + bytes(b[i])
                                               ).digest()


def _sig_trees(rng, B: int, W: int, widths):
    sigs = rng.integers(0, 256, (B, W, 64), dtype=np.uint8)
    return sigs, np.array(widths, dtype=np.int32)


@pytest.mark.parametrize("W", [1, 2, 8, 64])
def test_mixin_tree_plain_equals_the_jax_package_and_np_tree(W):
    """Every width from 1 to W in one batch, against jitted _mixin_roots
    and the host tree (bmtree.np_tree, both packages)."""
    rng = np.random.default_rng(100 + W)
    widths = list(range(1, W + 1))
    sigs, w = _sig_trees(rng, W, W, widths)
    got = mt.mixin_tree(torch.from_numpy(sigs), torch.from_numpy(w)).numpy()
    want = np.asarray(jentry._mixin_jit(W, W)(jnp.asarray(sigs),
                                               jnp.asarray(w)))
    assert np.array_equal(got, want)
    for i, n in enumerate(widths):
        leaves = [bytes(sigs[i, j]) for j in range(n)]
        root = bmtree.np_tree(leaves)[-1][0]
        assert root == jbmtree.np_tree(leaves)[-1][0]
        assert bytes(got[i]) == root


def test_mixin_tree_widths_1_to_33_at_w64():
    rng = np.random.default_rng(33)
    sigs, w = _sig_trees(rng, 33, 64, list(range(1, 34)))
    got = mt.mixin_tree(torch.from_numpy(sigs), torch.from_numpy(w)).numpy()
    for i in range(33):
        leaves = [bytes(sigs[i, j]) for j in range(i + 1)]
        assert bytes(got[i]) == bmtree.np_tree(leaves)[-1][0]


def test_mixin_tree_refuses_bad_shapes():
    with pytest.raises(ValueError):
        mt.mixin_tree(torch.zeros((2, 3, 64), dtype=torch.uint8),
                      torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        mt.mixin_tree(torch.zeros((2, 4, 32), dtype=torch.uint8),
                      torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        mt.mixin_tree(torch.zeros((2, 4, 64), dtype=torch.uint8),
                      torch.ones(3, dtype=torch.int32))
