"""The port's PoH chain, span engine and entry mixins
(firedancer_tpu_torch/ballet/poh.py, poh_engine.py, entry.py) against the
JAX package's, bit for bit, on seeded inputs and on device "cpu", where
the PoH spans and mixin-tree kernels run their plain versions.  The cases
of tests/test_poh_engine.py, each against the JAX function too."""

import hashlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ballet import entry as jentry
from firedancer_tpu.ballet import poh as jpoh
from firedancer_tpu.ballet import poh_engine as jpe
from firedancer_tpu_torch.ballet import entry as entry_lib
from firedancer_tpu_torch.ballet import poh as poh_lib
from firedancer_tpu_torch.ballet import poh_engine as pe
from firedancer_tpu_torch.kernels import build
from firedancer_tpu_torch.ops import poh_spans as ps
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


def _entries(rng, n: int, max_n: int):
    """Seeded segments: starts, num_hashes (0 and past max_hashes too),
    mixins, has_mixin."""
    starts = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    nums = rng.integers(0, max_n + 1, n).astype(np.int32)
    mixins = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    has = rng.integers(0, 2, n).astype(bool)
    return starts, nums, mixins, has


def _host_segment(start, n, mix, has, max_hashes):
    """The JAX scan's result on the host: min(n - 1, max_hashes) appends,
    then the last hash; n <= 0 passes through."""
    if n <= 0:
        return bytes(start)
    h = bytes(start)
    for _ in range(min(n - 1, max_hashes)):
        h = hashlib.sha256(h).digest()
    return hashlib.sha256(h + bytes(mix) if has else h).digest()


@pytest.mark.parametrize("max_hashes", [1, 4, 8])
def test_verify_entries_equals_the_jax_package(max_hashes):
    """Includes n == 0, n == 1, and n - 1 > max_hashes (the JAX scan
    stops at max_hashes; the kernel's loop bound is the same)."""
    rng = np.random.default_rng(max_hashes)
    starts, nums, mixins, has = _entries(rng, 12, max_hashes + 4)
    nums[:3] = [0, 1, max_hashes + 3]
    got = poh_lib.verify_entries(starts, nums, mixins, has, max_hashes,
                                 device=CPU).numpy()
    want = np.asarray(jpoh.verify_entries(
        jnp.asarray(starts), jnp.asarray(nums), jnp.asarray(mixins),
        jnp.asarray(has), max_hashes))
    assert np.array_equal(got, want)
    for i in range(12):
        assert bytes(got[i]) == _host_segment(starts[i], int(nums[i]),
                                              mixins[i], has[i], max_hashes)


def test_append_and_mixin_equal_the_jax_package():
    rng = np.random.default_rng(7)
    st = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    mix = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    for n in (0, 1, 5):
        got = poh_lib.append(torch.from_numpy(st), n).numpy()
        assert np.array_equal(got, np.asarray(jpoh.append(jnp.asarray(st),
                                                          n)))
    got = poh_lib.mixin(torch.from_numpy(st), torch.from_numpy(mix)).numpy()
    assert np.array_equal(got, np.asarray(jpoh.mixin(jnp.asarray(st),
                                                     jnp.asarray(mix))))


def test_fit_max_hashes_ladder():
    for args in ((1, 1024), (3, 1024), (4, 1024), (5, 1024), (0, 1024),
                 (9999, 64), (33, 64, (16, 48)), (12500, 12500)):
        assert poh_lib.fit_max_hashes(*args) == jpoh.fit_max_hashes(*args)
    fit = poh_lib.fit_max_hashes
    assert fit(1, 1024) == 1
    assert fit(3, 1024) == 4
    assert fit(5, 1024) == 8
    assert fit(9999, 64) == 64
    assert fit(33, 64, ladder=(16, 48)) == 48


def test_verify_entries_fit_and_entry_verify_match_host():
    start = b"\x22" * 32
    h = start
    entries = []
    for i in range(5):
        mix = bytes([i]) * 32 if i % 2 else None
        n = i + 1
        h = entry_lib.next_hash(h, n, mix)
        entries.append((n, mix, h))
    starts = np.zeros((5, 32), np.uint8)
    nums = np.array([e[0] for e in entries], np.int32)
    mixins = np.zeros((5, 32), np.uint8)
    has = np.zeros((5,), np.bool_)
    ends = np.zeros((5, 32), np.uint8)
    prev = start
    for i, (n, mix, hh) in enumerate(entries):
        starts[i] = np.frombuffer(prev, np.uint8)
        if mix is not None:
            mixins[i] = np.frombuffer(mix, np.uint8)
            has[i] = True
        ends[i] = np.frombuffer(hh, np.uint8)
        prev = hh
    got = poh_lib.verify_entries_fit(starts, nums, mixins, has, max_hashes=8,
                                     device=CPU).numpy()
    want = np.asarray(jpoh.verify_entries_fit(starts, nums, mixins, has,
                                              max_hashes=8))
    assert np.array_equal(got, want)
    for i, (_, _, hh) in enumerate(entries):
        assert bytes(got[i]) == hh
    bad = ends.copy()
    bad[3, 0] ^= 1
    ok = poh_lib.entry_verify_fit(starts, nums, mixins, has, bad,
                                  max_hashes=8, device=CPU).numpy()
    jok = np.asarray(jpoh.entry_verify_fit(starts, nums, mixins, has, bad,
                                           max_hashes=8))
    assert ok.tolist() == jok.tolist() == [True, True, True, False, True]
    ok = poh_lib.entry_verify(starts, nums, mixins, has, ends, 8,
                              device=CPU).numpy()
    assert ok.all()


@pytest.mark.parametrize("max_hashes", [8, 20])
def test_warm_verify_ladder_counts_rungs(max_hashes):
    beats = []
    n = poh_lib.warm_verify_ladder(batch=2, max_hashes=max_hashes,
                                   heartbeat=lambda: beats.append(1),
                                   device=CPU)
    assert n == jpoh.warm_verify_ladder(batch=2, max_hashes=max_hashes)
    assert n == len(beats) == {8: 4, 20: 6}[max_hashes]


# ------------------------------------------------------------ device mixin

def test_txn_mixins_device_equals_the_jax_package_and_host():
    rng = np.random.default_rng(11)

    def mk(i):
        return bytes([1]) + rng.bytes(64) + bytes([i])

    batches = [[mk(i) for i in range(w)] for w in (1, 2, 3, 5, 8, 31)]
    got = entry_lib.txn_mixins_device(batches, pad_batch=8, pad_width=32,
                                      device=CPU)
    want = jentry.txn_mixins_device(batches, pad_batch=8, pad_width=32)
    assert np.array_equal(got, want)
    for i, ts in enumerate(batches):
        assert bytes(got[i]) == entry_lib.txn_mixin(ts) \
            == jentry.txn_mixin(ts)


def test_txn_mixins_device_rejects_empty_microblock():
    with pytest.raises(ValueError):
        entry_lib.txn_mixins_device([[]], device=CPU)
    assert entry_lib.txn_mixins_device([], device=CPU).shape == (0, 32)


def test_warm_txn_mixins_counts_shapes():
    assert entry_lib.warm_txn_mixins(2, 8, device=CPU) == 4


def test_entry_wire_equals_the_jax_package():
    rng = np.random.default_rng(12)
    txns = [rng.bytes(int(n)) for n in rng.integers(65, 300, 5)]
    es = [entry_lib.Entry(3, rng.bytes(32), txns[:2]),
          entry_lib.Entry(7, rng.bytes(32), []),
          entry_lib.Entry(1, rng.bytes(32), txns[2:])]
    jes = [jentry.Entry(e.num_hashes, e.hash, list(e.txns)) for e in es]
    assert [e.serialize() for e in es] == [e.serialize() for e in jes]
    blob = entry_lib.serialize_batch(es)
    assert blob == jentry.serialize_batch(jes)
    assert entry_lib.deserialize_batch(blob + blob) == es + es
    for mod in (entry_lib, jentry):
        with pytest.raises(ValueError):
            mod.deserialize_batch(blob[:30])
    tb = entry_lib.serialize_txn_batch(txns)
    assert tb == jentry.serialize_txn_batch(txns)
    assert entry_lib.deserialize_txn_batch(tb) == (txns, len(tb))
    with pytest.raises(ValueError):
        entry_lib.deserialize_txn_batch(tb[:-1])


def test_next_hash_and_verify_chain():
    start = b"\x09" * 32
    txns = [b"\x01" + bytes([i]) * 70 for i in range(3)]
    es = []
    h = start
    for n, t in ((4, None), (1, txns[:2]), (6, None), (2, txns[2:])):
        mix = None if t is None else entry_lib.txn_mixin(t)
        h = entry_lib.next_hash(h, n, mix)
        assert h == jentry.next_hash(es[-1].hash if es else start, n, mix)
        es.append(entry_lib.Entry(n, h, t or []))
    assert entry_lib.verify_chain(start, es)
    es[2] = entry_lib.Entry(5, es[2].hash, [])
    assert not entry_lib.verify_chain(start, es)


# ------------------------------------------------------------- poh engine

def _run(eng, specs):
    outs = [eng.split_verdict(v) for v in eng.submit_lanes(specs)]
    outs += [eng.split_verdict(v) for v in eng.drain()]
    return outs


def test_host_spans_chain_rule():
    start = b"\x01" * 32
    m1, m2 = b"\xaa" * 32, b"\xbb" * 32
    spec = [(start, [(1, m1), (1, m2), (6, None)])]
    golden = pe.host_spans(spec, steps=3)
    assert np.array_equal(golden, jpe.host_spans(spec, steps=3))
    h = entry_lib.next_hash(start, 1, m1)
    assert bytes(golden[0, 0]) == h
    h = entry_lib.next_hash(h, 1, m2)
    assert bytes(golden[0, 1]) == h
    assert bytes(golden[0, 2]) == entry_lib.next_hash(h, 6, None)


@pytest.mark.parametrize("caps", [None, (1, 8)])
def test_engine_bit_exact_vs_host_and_the_jax_engine(caps):
    specs = [
        (b"\x03" * 32, [(1, b"\xcc" * 32), (7, None)]),
        (b"\x04" * 32, [(1, None), (0, None)]),   # n=0 tail = passthrough
    ]
    eng = pe.PohEngine(lanes=2, steps=2, max_hashes=8, step_caps=caps,
                       device=CPU)
    jeng = jpe.PohEngine(lanes=2, steps=2, max_hashes=8, unroll=4,
                         step_caps=caps)
    (planes,) = _run(eng, specs)
    (jplanes,) = _run(jeng, specs)
    assert np.array_equal(planes, np.asarray(jplanes))
    assert np.array_equal(planes, pe.host_spans(specs, steps=2))


def test_engine_matches_the_jax_engine_on_seeded_blobs():
    """poh_spans_blob on random rows (inactive steps, n == 0, n past a
    step's cap, mixins) against the JAX kernel function."""
    rng = np.random.default_rng(21)
    steps, caps = 3, (5, 2, 9)
    blob = np.zeros((10, pe.row_bytes(steps)), np.uint8)
    blob[:, :32] = rng.integers(0, 256, (10, 32))
    for s in range(steps):
        b = pe.LANE_HDR_SZ + pe.STEP_SZ * s
        blob[:, b:b + 32] = rng.integers(0, 256, (10, 32))
        n = rng.integers(0, 12, 10).astype("<u4")
        blob[:, b + 32:b + 36] = n.view(np.uint8).reshape(10, 4)
        blob[:, b + 36] = rng.integers(0, 2, 10)
        blob[:, b + 37] = rng.integers(0, 2, 10)
    got = pe.poh_spans_blob(torch.from_numpy(blob), steps, 9,
                            step_caps=caps).numpy()
    want = np.asarray(jpe.poh_spans_blob(jnp.asarray(blob), steps, 9,
                                         unroll=1, step_caps=caps))
    assert np.array_equal(got, want)


def test_engine_idle_lane_passthrough():
    eng = pe.PohEngine(lanes=3, steps=1, max_hashes=4, device=CPU)
    (planes,) = _run(eng, [(b"\x05" * 32, [(4, None)])])   # lanes 1,2 idle
    (jplanes,) = _run(jpe.PohEngine(lanes=3, steps=1, max_hashes=4,
                                    unroll=2), [(b"\x05" * 32, [(4, None)])])
    assert np.array_equal(planes, np.asarray(jplanes))
    assert bytes(planes[0, 0]) == entry_lib.next_hash(b"\x05" * 32, 4, None)
    assert bytes(planes[1, 0]) == b"\x00" * 32


def test_engine_rejects_mixin_without_hash():
    eng = pe.PohEngine(lanes=1, steps=1, max_hashes=4, device=CPU)
    with pytest.raises(ValueError):
        eng.submit_lanes([(b"\x06" * 32, [(0, b"\xdd" * 32)])])
    with pytest.raises(ValueError):
        pe.host_spans([(b"\x06" * 32, [(0, b"\xdd" * 32)])], steps=1)
    with pytest.raises(ValueError):
        eng.submit_lanes([(b"\x06" * 32, [(5, None)])])     # n > cap
    # the engine survives a rejected submit
    (planes,) = _run(eng, [(b"\x07" * 32, [(2, None)])])
    assert bytes(planes[0, 0]) == entry_lib.next_hash(b"\x07" * 32, 2, None)


def test_engine_steady_state_builds_nothing(monkeypatch):
    """After warm(), dispatches load no kernel library; on the CPU nothing
    launches either (the launch count is the card's, chip_smoke phase
    15)."""
    eng = pe.PohEngine(lanes=2, steps=2, max_hashes=4, device=CPU)
    eng.warm()
    loads = []
    monkeypatch.setattr(build, "load", lambda name: loads.append(name))
    l0 = ps.poh_spans.launches
    mix = b"\xee" * 32
    for i in range(3):
        specs = [(bytes([i + 1]) * 32, [(1, mix), (3, None)]),
                 (bytes([i + 2]) * 32, [(2, None), (2, None)])]
        (planes,) = _run(eng, specs)
        assert np.array_equal(planes, pe.host_spans(specs, steps=2))
    assert loads == [] and ps.poh_spans.launches == l0
    st = eng.stats()
    assert st["dispatches"] == 4 and st["inflight_depth"] == 0


def test_engine_refuses_bad_geometry():
    with pytest.raises(ValueError):
        pe.PohEngine(lanes=0, steps=1, max_hashes=1, device=CPU)
    with pytest.raises(ValueError):
        pe.PohEngine(lanes=1, steps=2, max_hashes=4, step_caps=(1,),
                     device=CPU)
    with pytest.raises(ValueError):
        pe.PohEngine(lanes=1, steps=1, max_hashes=4, step_caps=(5,),
                     device=CPU)
    with pytest.raises(ValueError):
        ps.poh_spans(torch.zeros((1, 70), dtype=torch.uint8), 2, (1, 1))


def test_span_row_layout():
    assert pe.row_bytes(3) == jpe.row_bytes(3) == 32 + 3 * 38
    assert (pe.LANE_HDR_SZ, pe.STEP_SZ) == (jpe.LANE_HDR_SZ, jpe.STEP_SZ)
    assert struct.calcsize("<32sIBB") == pe.STEP_SZ
