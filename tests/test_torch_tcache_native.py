"""The port's NativeTCache (firedancer_tpu_torch/tango/tcache.py over
native/txnparse.cpp) on the CPU, against the JAX package's NativeTCache
and against the port's TCache, its plain version: the same seeded tag
sequences through each must give the same answer to every query, insert
and batch call, across eviction at depth, the zero tag, duplicates inside
one insert_batch_dedup batch, and reset."""

import numpy as np
import pytest

from firedancer_tpu.tango.tcache import NativeTCache as JNativeTCache
from firedancer_tpu_torch.tango.tcache import NativeTCache, TCache
from _torch_threads import one_torch_thread  # noqa: F401


def _three(depth):
    return NativeTCache(depth), JNativeTCache(depth), TCache(depth)


def _tags(rng, n, span):
    """n tags over 0..span-1 (0 the null tag; a small span repeats tags
    and makes the window evict), plus some full-width 64-bit tags."""
    tags = rng.integers(0, span, n, dtype=np.uint64)
    wide = rng.random(n) < 0.1
    tags[wide] = rng.integers(1 << 62, 1 << 64, int(wide.sum()),
                              dtype=np.uint64, endpoint=False)
    return tags


@pytest.mark.parametrize("depth,span", [(1, 4), (2, 6), (7, 20), (64, 100),
                                        (1000, 3000)])
def test_batches_match_jax_and_plain(depth, span):
    """Rounds of insert_batch_dedup, query_batch and insert_batch over
    tags drawn with repeats inside a batch: every mask equal, and after
    each round every tag seen so far queries the same."""
    rng = np.random.default_rng(depth)
    caches = _three(depth)
    seen = set()
    for rnd in range(12):
        tags = _tags(rng, int(rng.integers(1, 3 * depth + 8)), span)
        seen |= set(tags.tolist())
        if rnd % 3 == 2:
            for c in caches:
                c.insert_batch(tags)
        else:
            masks = [c.insert_batch_dedup(tags) for c in caches]
            for m in masks:
                assert m.dtype == bool and m.shape == tags.shape
            assert masks[0].tolist() == masks[1].tolist() == \
                masks[2].tolist()
        probe = np.array(sorted(seen), np.uint64)
        hits = [c.query_batch(probe).tolist() for c in caches]
        assert hits[0] == hits[1] == hits[2]
        assert hits[0] == [caches[2].query(int(t)) for t in probe]
        assert sum(hits[0]) <= depth


def test_eviction_order_zero_tag_and_in_batch_dups():
    """Depth 3: the fourth distinct tag evicts the first; the zero tag is
    never cached nor a hit; a tag twice in one batch is a dup the second
    time; a dup does not refresh its place in the window."""
    for c in _three(3):
        assert c.insert_batch_dedup(
            np.array([5, 0, 5, 6, 0, 7], np.uint64)).tolist() == [
                False, False, True, False, False, False]
        assert not c.query(0) and c.insert(0) is False
        assert c.insert(5) is True           # still in the window
        assert c.insert(8) is False          # evicts 5, the oldest
        assert c.query_batch(np.array([5, 6, 7, 8], np.uint64)).tolist() == [
            False, True, True, True]
        assert c.insert(5) is False          # back in, evicts 6
        assert not c.query(6) and c.query(7)


def test_reset_empties_the_window():
    rng = np.random.default_rng(3)
    tags = _tags(rng, 50, 40)
    caches = _three(16)
    for c in caches:
        c.insert_batch(tags)
        c.reset()
        assert not c.query_batch(tags).any()
    masks = [c.insert_batch_dedup(tags).tolist() for c in caches]
    assert masks[0] == masks[1] == masks[2]


def test_native_handle_and_depth_checks():
    c = NativeTCache(4)
    assert isinstance(c.handle, int) and c.handle
    h = c.handle
    c.reset()
    assert c.handle                           # a fresh window
    del c, h
    for cls in (NativeTCache, TCache):
        with pytest.raises(ValueError, match="depth"):
            cls(0)
