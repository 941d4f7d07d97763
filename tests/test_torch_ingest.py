"""The port's serving engine (SigVerifier.make_ingest, PackedIngest)
against the contracts of tests/test_ingest_overlap.py, case by case under
the same names, on the CPU, and its harvested bits against the JAX
package's PackedIngest on the same seeded batches.

  1. NO TORN BUFFER: a rotating blob is never repacked while its
     dispatch is inflight.
  2. BACKPRESSURE: the inflight window is bounded at `depth`; when every
     blob is pinned, submit blocks on a harvest before repacking.
  3. BIT-IDENTICAL: verdicts through the rotation equal serial
     dispatch_blob verdicts batch for batch, across blob reuse.

The pipeline's own pool (disco.pipeline._Bucket) keeps the same
invariant.
"""

import numpy as np
import pytest
import torch

from firedancer_tpu.models import verifier as jv
from firedancer_tpu_torch.disco.pipeline import _Bucket
from firedancer_tpu_torch.models.verifier import (
    PackedDispatchEngine,
    SigVerifier,
    VerifierConfig,
    WorkloadDesc,
    make_example_batch,
)
from _torch_threads import one_torch_thread  # noqa: F401

BATCH = 64
ML = 96


@pytest.fixture(scope="module")
def verifier():
    return SigVerifier(VerifierConfig(batch=BATCH, msg_maxlen=ML),
                       device="cpu")


@pytest.fixture(scope="module")
def batches(verifier):
    """Three distinct batches with mixed verdicts, each with its serial
    dispatch_blob bits."""
    out = []
    for seed, valid in ((1, True), (2, False), (3, True)):
        args = [np.asarray(a) for a in make_example_batch(
            BATCH, ML, valid=valid, sign_pool=8, seed=seed)]
        if valid:  # flip a couple of sig bytes for a mixed verdict
            args[2] = args[2].copy()
            args[2][seed, 0] ^= 0xFF
        ref = np.asarray(verifier.packed_dispatch(*args))
        assert ref.any() != ref.all()  # genuinely mixed
        out.append((args, ref))
    return out


@pytest.mark.parametrize("nbuf,depth", [(2, 1), (3, 2)])
def test_no_repack_while_inflight(verifier, batches, nbuf, depth):
    """Contract 1: _pack_into never targets a blob whose dispatch is
    still in the inflight window."""
    eng = verifier.make_ingest(ml=ML, nbuf=nbuf, depth=depth)
    orig = eng._pack_into

    def guarded(buf, *a):
        pinned = {id(eng._bufs[b]) for _, b in eng._inflight}
        assert id(buf) not in pinned, "repacked an inflight buffer"
        assert any(buf is b for b in eng._bufs)
        return orig(buf, *a)

    eng._pack_into = guarded
    for i in range(8):
        eng.submit(*batches[i % 3][0])
    eng.drain()
    assert eng.dispatches == 8


@pytest.mark.parametrize("nbuf,depth", [(4, 2), (3, 1)])
def test_backpressure_bounds_window(verifier, batches, nbuf, depth):
    """Contract 2a: depth bounds the steady-state window; every submit
    past the window retires exactly the overflow, in dispatch order."""
    eng = verifier.make_ingest(ml=ML, nbuf=nbuf, depth=depth)
    retired = []
    for i in range(9):
        out = eng.submit(*batches[i % 3][0])
        assert eng.inflight_depth <= depth
        retired += out
    assert eng.max_depth_seen == depth + 1
    retired += eng.drain()
    assert len(retired) == 9
    for i, ok in enumerate(retired):  # dispatch order preserved
        np.testing.assert_array_equal(ok, batches[i % 3][1])


def test_backpressure_when_all_buffers_pinned(verifier, batches):
    """Contract 2b: depth >= nbuf exhausts the free ring first; submit
    must then block on the oldest harvest (counted) instead of tearing."""
    eng = verifier.make_ingest(ml=ML, nbuf=2, depth=4)
    eng.submit(*batches[0][0])
    eng.submit(*batches[1][0])
    assert eng.backpressure_waits == 0
    out = eng.submit(*batches[2][0])  # no free buffer: forced harvest
    assert eng.backpressure_waits == 1
    assert len(out) == 1
    np.testing.assert_array_equal(out[0], batches[0][1])
    eng.drain()
    assert eng.stats() == {
        "dispatches": 3, "backpressure_waits": 1, "max_depth_seen": 2,
        "inflight_depth": 0, "pack_us_txn": eng.pack_us_txn}


@pytest.mark.parametrize("nbuf,depth", [(3, 2), (2, 1)])
def test_overlapped_bit_identical_to_serial(verifier, batches, nbuf, depth):
    """Contract 3: rotated-blob verdicts == serial verdicts, batch for
    batch, across enough submissions that every blob is reused."""
    eng = verifier.make_ingest(ml=ML, nbuf=nbuf, depth=depth)
    got = []
    for i in range(9):
        got += eng.submit(*batches[i % 3][0])
    got += eng.drain()
    assert len(got) == 9
    for i, ok in enumerate(got):
        np.testing.assert_array_equal(ok, batches[i % 3][1])


def test_reused_buffer_is_rezeroed(verifier):
    """Stale-padding regression: a long-message batch followed by a
    short-message batch through the SAME rotation must not leak the long
    batch's bytes into the short batch's zero-padded columns."""
    long_args = [np.asarray(a) for a in make_example_batch(
        BATCH, ML, valid=True, sign_pool=8, seed=11)]
    short = [np.asarray(a) for a in make_example_batch(
        BATCH, 32, valid=True, sign_pool=8, seed=12)]
    wide = np.zeros((BATCH, ML), np.uint8)
    wide[:, :32] = short[0]
    short_args = [wide, short[1], short[2], short[3]]
    ref = np.asarray(verifier.packed_dispatch(*short_args))
    assert ref.all()
    eng = verifier.make_ingest(ml=ML, nbuf=2, depth=1)
    for _ in range(3):  # cycle both buffers through the long batch
        eng.submit(*long_args)
    eng.drain()
    eng.submit(*short_args)
    (ok,) = eng.drain()
    np.testing.assert_array_equal(ok, ref)


def test_engine_param_validation(verifier):
    with pytest.raises(ValueError):
        verifier.make_ingest(nbuf=1)
    with pytest.raises(ValueError):
        verifier.make_ingest(nbuf=2, depth=0)
    rlc = SigVerifier(VerifierConfig(batch=BATCH, msg_maxlen=ML),
                      mode="rlc", device="cpu")
    with pytest.raises(ValueError, match="per-sig-only"):
        rlc.make_ingest()
    # host blobs are pinned for a CUDA verifier only
    assert not any(b.is_pinned() for b in verifier.make_ingest()._bufs)


def test_bucket_pool_rotation_zeroed():
    """Pipeline-level pool: reset() rotates a FREE blob in (fresh while
    the pool is dry, reused and re-zeroed after release())."""
    bk = _Bucket(4, 32, n_buffers=2)
    first = bk.blob
    first.fill_(7)
    bk.reset()                    # first still pinned under its dispatch
    assert bk.blob is not first
    bk.release(first)             # verdict materialized
    bk.reset()
    assert bk.blob is first       # reused from the pool
    assert not bk.arr.any()       # and re-zeroed
    # the NumPy views write the active blob
    bk.msgs[0, 0] = 1
    bk.set_len(1, 0x01020304)
    assert bk.blob[0, 0] == 1
    assert bk.blob[1, 32 + 96:].tolist() == [4, 3, 2, 1]


def test_pipeline_packed_pool_bounded():
    """The pool never exceeds n_buffers even if more blobs are released
    (age-flush bursts): excess blobs fall to the GC."""
    bk = _Bucket(4, 32, n_buffers=2)
    blobs = []
    for _ in range(4):
        blobs.append(bk.blob)
        bk.reset()
    for b in blobs:
        bk.release(b)
    assert len(bk._pool) == 2


class _Slow:
    """A verdict future that is ready only once `ready` is set."""

    def __init__(self, bits):
        self.bits = bits
        self.ready = False

    def is_ready(self):
        return self.ready

    def copy_to_host_async(self):
        pass

    def __array__(self, dtype=None, copy=None):
        return self.bits


def test_poll_harvests_only_ready_verdicts_and_failed_pack_frees_blob():
    """poll() never blocks: it stops at the first verdict not ready.  A
    fill that raises returns its blob to the free ring."""
    futs = []

    def dispatch(buf):
        futs.append(_Slow(buf.numpy()[:, 0].astype(bool).copy()))
        return futs[-1]

    eng = PackedDispatchEngine(
        WorkloadDesc(rows=4, row_bytes=8, dispatch=dispatch), nbuf=3,
        depth=2)
    for v in (1, 0):
        eng.submit_packed(lambda b, v=v: b.fill_(v), 4)
    assert eng.poll() == []
    futs[1].ready = True
    assert eng.poll() == []                  # the oldest is not ready
    futs[0].ready = True
    got = eng.poll()
    assert [g.tolist() for g in got] == [[True] * 4, [False] * 4]
    assert eng.inflight_depth == 0
    free = len(eng._free)

    def bad_pack(buf):
        raise RuntimeError("bad pack")

    with pytest.raises(RuntimeError, match="bad pack"):
        eng.submit_packed(bad_pack, 4)
    assert len(eng._free) == free and eng.dispatches == 2
    rows = torch.ones((4, 8), dtype=torch.uint8)
    eng.submit_rows(rows)
    futs[-1].ready = True
    (ok,) = eng.drain()
    assert ok.tolist() == [True] * 4 and len(eng._free) == free


@pytest.fixture(scope="module")
def jax_ingest():
    return jv.SigVerifier(jv.VerifierConfig(batch=BATCH, msg_maxlen=ML))


def test_engine_bits_match_jax_packed_ingest(verifier, batches, jax_ingest):
    """The port engine's harvested bits equal the JAX package's
    PackedIngest's on the same seeded batches, batch for batch."""
    port = verifier.make_ingest(ml=ML, nbuf=3, depth=2)
    ref = jax_ingest.make_ingest(ml=ML, nbuf=3, depth=2)
    got, want = [], []
    for i in range(4):
        args = batches[i % 3][0]
        got += port.submit(*args)
        want += ref.submit(*args)
    got += port.drain()
    want += ref.drain()
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, batches[i % 3][1])
    assert {k: v for k, v in port.stats().items() if k != "pack_us_txn"} \
        == {k: v for k, v in ref.stats().items() if k != "pack_us_txn"}
