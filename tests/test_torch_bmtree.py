"""The port's batched shred proof walk (ballet/bmtree.batch_walk_roots,
the merkle walk kernel's plain version on CPU tensors) against the JAX
package's batch_walk_roots under jax.jit and np_batch_walk_roots, at
ragged depths and leaf lengths (each SHA-256 padding edge), and the host
proof helpers np_proof and np_verify_proof.  Bytes equal.  The kernel
itself is held against the plain version on the card (chip_smoke.py
phase 16b, tests/test_torch_kernels.py) and its lane code in
test_torch_csrc_host."""

import jax
import numpy as np
import pytest
import torch

from firedancer_tpu.ballet import bmtree as jbm
from firedancer_tpu_torch.ballet import bmtree as bm
from firedancer_tpu_torch.ops import bmtree_walk as bw
from _torch_threads import one_torch_thread  # noqa: F401

# 26 + len on each padding edge (mod 64 = 55, 56, 63, 0), the empty leaf
# and the longest
EDGE_LENS = [0, 1, 29, 30, 37, 38, 93, 94, 101, 102, 1164]


def _lanes(seed: int, B: int, maxlen: int, D: int):
    rng = np.random.default_rng(seed)
    leaf = rng.integers(0, 256, (B, maxlen), np.uint8)
    lens = rng.integers(0, maxlen + 1, B).astype(np.int32)
    edge = [min(x, maxlen) for x in EDGE_LENS][:B]
    lens[:len(edge)] = edge
    idxs = rng.integers(0, 1 << 15, B).astype(np.int32)
    proofs = rng.integers(0, 256, (B, D, 20), np.uint8)
    depths = (np.arange(B) % (D + 1)).astype(np.int32)
    return leaf, lens, idxs, proofs, depths


def test_batch_walk_roots_equals_the_jax_package():
    """16 lanes: every depth 0-15, the leaf lengths around each padding
    edge, against the JAX walk under jax.jit and the hashlib twin."""
    leaf, lens, idxs, proofs, depths = _lanes(1, 16, 1164, 15)
    got = bm.batch_walk_roots(leaf, lens, idxs, proofs, depths,
                              device="cpu").numpy()
    want = np.asarray(jax.jit(jbm.batch_walk_roots)(leaf, lens, idxs,
                                                    proofs, depths))
    assert np.array_equal(got, want)
    host = bm.np_batch_walk_roots(
        [leaf[i, :lens[i]] for i in range(16)], idxs.tolist(),
        [list(proofs[i, :depths[i]]) for i in range(16)])
    assert [bytes(r) for r in got] == host
    assert host == jbm.np_batch_walk_roots(
        [leaf[i, :lens[i]] for i in range(16)], idxs.tolist(),
        [list(proofs[i, :depths[i]]) for i in range(16)])


def test_plain_walk_on_strided_tensors_equals_hashlib():
    """The wrapper's CPU path on tensor views into a wider blob (as the
    shred tile passes them), and the int columns as tensors."""
    leaf, lens, idxs, proofs, depths = _lanes(2, 12, 200, 4)
    blob = torch.from_numpy(np.concatenate(
        [leaf, proofs.reshape(12, -1), np.zeros((12, 7), np.uint8)], 1))
    got = bw.bmtree_walk(blob[:, :200], torch.from_numpy(lens),
                         torch.from_numpy(idxs),
                         blob[:, 200:280].unflatten(1, (4, 20)),
                         torch.from_numpy(depths))
    host = bm.np_batch_walk_roots(
        [leaf[i, :lens[i]] for i in range(12)], idxs.tolist(),
        [list(proofs[i, :depths[i]]) for i in range(12)])
    assert [bytes(r) for r in got.numpy()] == host


@pytest.mark.parametrize("what,val", [("lengths", -1), ("lengths", 201),
                                      ("depths", -1), ("depths", 5)])
def test_walk_refuses_out_of_range_lengths_and_depths(what, val):
    leaf, lens, idxs, proofs, depths = _lanes(3, 4, 200, 4)
    {"lengths": lens, "depths": depths}[what][2] = val
    with pytest.raises(ValueError, match=f"{what} outside"):
        bm.batch_walk_roots(leaf, lens, idxs, proofs, depths, device="cpu")


def test_np_proof_and_verify_equal_the_jax_package():
    rng = np.random.default_rng(4)
    leaves = [rng.bytes(int(n)) for n in rng.integers(0, 300, 13)]
    for kw in ({}, {"node_sz": 20, "leaf_prefix": bm.LEAF_PREFIX_LONG,
                    "node_prefix": bm.NODE_PREFIX_LONG}):
        levels = bm.np_tree(leaves, **kw)
        assert levels == jbm.np_tree(leaves, **kw)
        root = levels[-1][0]
        for i, leaf in enumerate(leaves):
            proof = bm.np_proof(levels, i)
            assert proof == jbm.np_proof(levels, i)
            assert bm.np_verify_proof(leaf, i, proof, root, **kw)
            assert jbm.np_verify_proof(leaf, i, proof, root, **kw)
            assert not bm.np_verify_proof(leaf + b"x", i, proof, root, **kw)
    assert (bm.LEAF_PREFIX_LONG, bm.NODE_PREFIX_LONG, bm.MERKLE_NODE_SZ) \
        == (jbm.LEAF_PREFIX_LONG, jbm.NODE_PREFIX_LONG, jbm.MERKLE_NODE_SZ)
