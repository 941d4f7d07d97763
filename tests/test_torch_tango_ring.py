"""The port's tango fabric (firedancer_tpu_torch/tango/ring.py over
firedancer_tpu_torch/native/tango.cpp) on the CPU: the cases of
tests/test_tango_ring.py and the two ring cases of
tests/test_race_stress.py against the port, and rings shared with the JAX
package: frags one package publishes read the same, metas and bytes,
through the other's consumer."""

import multiprocessing as mp
import os

import numpy as np
import pytest

import _torch_ring_procs as procs
from firedancer_tpu.tango import ring as jring
from firedancer_tpu_torch.tango import ring as pring
from firedancer_tpu_torch.tango.ring import (
    FRAG_META_DTYPE,
    Cnc,
    Dcache,
    FSeq,
    MCache,
    Workspace,
    ctl,
    packed_row_ml,
    rx_burst,
    tx_burst,
)


@pytest.fixture()
def ws():
    w = Workspace(f"fdtpu_ttest_ring{os.getpid()}", 1 << 20, create=True)
    yield w
    import gc
    gc.collect()
    w.close()
    w.unlink()


def test_mcache_publish_query(ws):
    mc = MCache.new(ws, depth=8, seq0=100)
    assert mc.seq_query() == 100
    rc, _ = mc.query(100)
    assert rc == -1  # not yet published

    seq = mc.publish(sig=0xDEAD, chunk=3, sz=17, ctl_=ctl(origin=5))
    assert seq == 100
    rc, m = mc.query(100)
    assert rc == 0
    assert m["sig"] == 0xDEAD and m["chunk"] == 3 and m["sz"] == 17
    assert m["ctl"] == ctl(origin=5)

    # consumer that fell a full lap behind sees overrun
    for _ in range(8):
        mc.publish(sig=1)
    rc, _ = mc.query(100)
    assert rc == 1


def test_mcache_burst(ws):
    mc = MCache.new(ws, depth=16)
    for i in range(10):
        mc.publish(sig=i)
    metas, rc = mc.consume_burst(0, 32)
    assert len(metas) == 10 and rc == -1  # caught up
    assert list(metas["sig"]) == list(range(10))
    metas, rc = mc.consume_burst(0, 4)
    assert len(metas) == 4 and rc == 0  # burst full


def test_dcache_roundtrip(ws):
    mc = MCache.new(ws, depth=4)
    dc = Dcache.new(ws, mtu=1232, depth=4)
    chunk = dc.chunk0
    payload = bytes(range(200))
    nxt = dc.write(chunk, payload)
    seq = mc.publish(sig=7, chunk=chunk, sz=len(payload))
    rc, m = mc.query(seq)
    assert rc == 0
    assert dc.read(m["chunk"], m["sz"]) == payload
    assert nxt > chunk

    # compact ring wraps before overflowing the region
    for _ in range(1000):
        assert nxt * dc.chunk_sz + 1232 <= dc.data_sz
        nxt = dc.write(nxt, b"x" * 1232)


def test_fseq_cnc(ws):
    fs = FSeq.new(ws, seq0=5)
    assert fs.query() == 5
    fs.update(9)
    assert fs.query() == 9
    fs.diag_add(FSeq.DIAG_OVRNP_CNT, 3)
    assert fs.diag(FSeq.DIAG_OVRNP_CNT) == 3

    cn = Cnc.new(ws)
    assert cn.signal_query() == Cnc.SIGNAL_BOOT
    cn.signal(Cnc.SIGNAL_RUN)
    assert cn.signal_query() == Cnc.SIGNAL_RUN
    cn.heartbeat(12345)
    assert cn.heartbeat_query() == 12345


def test_multiprocess_reliable_flow():
    """One producer and two reliable consumers, each its own spawned
    process joining the workspace by layout replay (the JAX test forks;
    this one spawns, as the test process has imported torch)."""
    name = f"fdtpu_ttest_mp{os.getpid()}"
    ws = Workspace(name, 1 << 20, create=True)
    ctx = mp.get_context("spawn")
    ps = []
    try:
        MCache.new(ws, procs.DEPTH)
        for _ in range(2):
            FSeq.new(ws)
        q = ctx.Queue()
        ps = [ctx.Process(target=procs.consumer, args=(name, i, q))
              for i in range(2)]
        ps.append(ctx.Process(target=procs.producer, args=(name,)))
        for p in ps:
            p.start()
        want = sum(i * 3 + 1 for i in range(procs.N_FRAGS))
        results = [q.get(timeout=90) for _ in range(2)]
        assert sorted(results) == [(0, want), (1, want)]
        for p in ps:
            p.join(30)
        assert all(p.exitcode == 0 for p in ps)
    finally:
        for p in ps:
            if p.is_alive():
                p.kill()
        import gc
        gc.collect()
        ws.close()
        ws.unlink()


def test_unreliable_consumer_detects_overrun(ws):
    mc = MCache.new(ws, depth=4)
    for i in range(10):
        mc.publish(sig=i)
    # consumer at 0 is 10 behind a depth-4 ring: overrun; resync
    rc, _ = mc.query(0)
    assert rc == 1
    resync = mc.seq_query()
    assert resync == 10
    metas, rc = mc.consume_burst(resync - 4, 4)
    assert len(metas) == 4 and list(metas["sig"]) == [6, 7, 8, 9]


def test_rx_burst_drops_frag_wider_than_buffer(ws):
    """A frag whose sz exceeds the ENTIRE rx buffer is consumed and
    counted as filtered, not left to wedge the input."""
    mc = MCache.new(ws, depth=8)
    dc = Dcache.new(ws, mtu=512, depth=8)
    payloads = [b"x" * 400, b"ok", b"fine"]  # first exceeds the 64B rx buf
    starts = np.array([0, 400, 402], np.int64)
    lens = np.array([400, 2, 4], np.int32)
    sigs = np.array([1, 2, 3], np.uint64)
    tx_burst(mc, dc, 0, b"".join(payloads), starts, lens, sigs)

    buf = np.zeros(64, np.uint8)
    metas = np.zeros(8, dtype=FRAG_META_DTYPE)
    offs = np.zeros(9, np.int64)
    rc, consumed, kept, filt = rx_burst(mc, dc, 0, 8, buf, metas, offs)
    assert rc == -1 and consumed == 3
    assert filt == 1 and kept == 2
    assert bytes(buf[offs[0]:offs[1]]) == b"ok"
    assert bytes(buf[offs[1]:offs[2]]) == b"fine"


def _race_ring(tag):
    name = f"fdtpu_ttest_{tag}{os.getpid()}"
    ws = Workspace(name, 1 << 22, create=True)
    mc = MCache.new(ws, procs.RACE_DEPTH)
    dc = Dcache.new(ws, procs.RACE_MTU, procs.RACE_DEPTH, burst=4)
    return name, ws, mc, dc


@pytest.mark.slow
def test_ring_no_torn_frags_under_load():
    """One producer and one consumer process, 4000 checksummed frags
    through a 64-deep ring with reliable backpressure: any seqlock tear
    fails."""
    name, ws, mc, dc = _race_ring("race")
    fs = FSeq.new(ws)
    ctxmp = mp.get_context("spawn")
    err_q = ctxmp.Queue()
    args = (name, mc.off, dc.off, fs.off, 4000, err_q)
    ps = [ctxmp.Process(target=procs.race_consumer, args=args),
          ctxmp.Process(target=procs.race_producer, args=args)]
    try:
        for p in ps:
            p.start()
        for p in ps:
            p.join(150)
        errs = []
        while not err_q.empty():
            errs.append(err_q.get())
        assert not errs, errs
        assert all(p.exitcode == 0 for p in ps)
    finally:
        for p in ps:
            if p.is_alive():
                p.kill()
        mc = dc = fs = None
        ws.unlink()


@pytest.mark.slow
def test_ring_overrun_detection_unreliable_reader():
    """Fast producer, slow unreliable reader: overruns are flagged by the
    seqlock, and every frag that validates checksums clean."""
    name, ws, mc, dc = _race_ring("race2")
    ctxmp = mp.get_context("spawn")
    err_q, done_q = ctxmp.Queue(), ctxmp.Queue()
    n = 3000
    reader = ctxmp.Process(target=procs.unreliable_reader,
                           args=(name, mc.off, dc.off, n, err_q, done_q))
    reader.start()
    try:
        cur = dc.chunk0
        for seq in range(n):  # unthrottled: laps the reader constantly
            data = procs.payload(seq)
            nxt = dc.write(cur, data)
            mc.publish(sig=seq, chunk=cur, sz=len(data), ctl_=ctl())
            cur = nxt
        reader.join(150)
        errs = []
        while not err_q.empty():
            errs.append(err_q.get())
        assert not errs, errs
        assert reader.exitcode == 0
        seen, _ = done_q.get(timeout=5)
        assert seen > 0
    finally:
        if reader.is_alive():
            reader.kill()
        mc = dc = None
        ws.unlink()


# -- rings shared with the JAX package ----------------------------------------


def test_packed_row_ml_equals_the_jax_package():
    for maxlen in range(1, 2049):
        assert packed_row_ml(maxlen) == jring.packed_row_ml(maxlen)
    assert FRAG_META_DTYPE == jring.FRAG_META_DTYPE
    for origin in (0, 5):
        for som, eom, err in ((1, 1, 0), (1, 0, 1), (0, 1, 0)):
            assert ctl(origin, som, eom, err) == jring.ctl(origin, som, eom,
                                                           err)


MTU = 1280


def _frags(seed):
    """Frags of every size 0..MTU, random bytes and sigs, in random
    order (numpy from a seed)."""
    rng = np.random.default_rng(seed)
    lens = rng.permutation(np.arange(MTU + 1)).astype(np.int32)
    starts = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    buf = rng.integers(0, 256, int(lens.sum()), dtype=np.uint8)
    sigs = rng.integers(0, 1 << 63, len(lens), dtype=np.uint64)
    return buf, starts, lens, sigs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_rings(writer):
    """One package creates the workspace and tx_bursts frags of every size
    0..MTU; the other joins by the same offsets and reads them through
    rx_burst and per-frag query/read: equal metas and equal bytes."""
    name = f"fdtpu_ttest_x{writer}{os.getpid()}"
    W, R = (jring, pring) if writer == "jax" else (pring, jring)
    buf, starts, lens, sigs = _frags(7 if writer == "jax" else 8)
    n = len(lens)
    depth = 2048
    wws = W.Workspace(name, 8 << 20, create=True)
    rws = None
    try:
        wmc = W.MCache.new(wws, depth, seq0=3)
        wdc = W.Dcache.new(wws, MTU, depth)
        wfs = W.FSeq.new(wws, 3)
        wcnc = W.Cnc.new(wws)
        # a few per-frag publishes ahead of the burst
        chunk = wdc.chunk0
        for i in range(3):
            nxt = wdc.write(chunk, bytes([i]) * (i + 1))
            wmc.publish(sig=100 + i, chunk=chunk, sz=i + 1,
                        ctl_=W.ctl(origin=i), tsorig=7, tspub=9)
            chunk = nxt
        last, chunk = W.tx_burst(wmc, wdc, chunk, buf, starts, lens, sigs,
                                 tsorig=11, tspub=13)
        assert last == 3 + 3 + n - 1
        wfs.update(42)
        wfs.diag_add(W.FSeq.DIAG_SLOW_CNT, 5)
        wcnc.signal(W.Cnc.SIGNAL_DRAIN)
        wcnc.heartbeat(777)

        rws = R.Workspace(name, 0)
        rmc = R.MCache.join(rws, rws.alloc(R.MCache.footprint(depth)))
        rdc = R.Dcache.join(rws, rws.alloc(R.Dcache.footprint(MTU, depth)))
        rfs = R.FSeq.join(rws, rws.alloc(64))
        rcnc = R.Cnc.join(rws, rws.alloc(64))
        assert (rmc.off, rdc.off, rfs.off, rcnc.off) == (
            wmc.off, wdc.off, wfs.off, wcnc.off)
        assert rmc.seq0() == 3 and rmc.seq_query() == 3 + 3 + n
        assert (rdc.mtu, rdc.data_sz, rdc.wmark) == (
            wdc.mtu, wdc.data_sz, wdc.wmark)
        assert rfs.query() == 42 and rfs.diag(R.FSeq.DIAG_SLOW_CNT) == 5
        assert rcnc.signal_query() == R.Cnc.SIGNAL_DRAIN
        assert rcnc.heartbeat_query() == 777
        for i in range(3):
            rc, m = rmc.query(3 + i)
            assert rc == 0 and int(m["sig"]) == 100 + i
            assert int(m["ctl"]) == R.ctl(origin=i)
            assert (int(m["tsorig"]), int(m["tspub"])) == (7, 9)
            assert rdc.read(int(m["chunk"]), int(m["sz"])) == \
                bytes([i]) * (i + 1)
        rbuf = np.zeros(n * MTU, np.uint8)
        rmetas = np.zeros(n, dtype=R.FRAG_META_DTYPE)
        roffs = np.zeros(n + 1, np.int64)
        rc, cons, kept, filt = R.rx_burst(rmc, rdc, 6, n, rbuf, rmetas, roffs)
        assert (rc, cons, kept, filt) == (0, n, n, 0)
        assert (rmetas["seq"] == np.arange(6, 6 + n)).all()
        assert (rmetas["sig"] == sigs).all()
        assert (rmetas["sz"] == lens).all()
        assert (rmetas["ctl"] == R.ctl()).all()
        assert (rmetas["tsorig"] == 11).all() and (rmetas["tspub"] == 13).all()
        assert (np.diff(roffs) == lens).all()
        assert np.array_equal(rbuf[:roffs[n]], buf)
        # the writer's own consumer reads the identical metas
        wmetas, _ = wmc.consume_burst(6, n)
        assert wmetas.tobytes() == rmetas.tobytes()
        for i in (0, n // 2, n - 1):
            assert rdc.read(int(rmetas[i]["chunk"]), int(lens[i])) == \
                buf[starts[i]:starts[i] + lens[i]].tobytes()
    finally:
        import gc
        rmc = rdc = rfs = rcnc = wmc = wdc = wfs = wcnc = None  # noqa: F841
        gc.collect()
        if rws is not None:
            rws.close()
        wws.close()
        wws.unlink()
