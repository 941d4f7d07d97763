"""The port's credit controller (firedancer_tpu_torch/tango/fctl.py) on the
CPU: the fctl cases of tests/test_util_tango_extras.py and
tests/test_supervision.py against the port, and the port's Fctl against
the JAX package's on the same seeded sequence of consumer moves and
publishes."""

import os

import numpy as np

from firedancer_tpu.tango.fctl import Fctl as JaxFctl
from firedancer_tpu_torch.disco import topo as topo_mod
from firedancer_tpu_torch.disco.topo import TopoBuilder
from firedancer_tpu_torch.tango.fctl import Fctl


class _FakeFseq:
    def __init__(self, seq=0):
        self.seq = seq
        self.slow = 0

    def query(self):
        return self.seq

    def update(self, seq):
        self.seq = seq

    def diag_add(self, idx, delta=1):
        self.slow += delta


class _FakeMcache:
    def __init__(self, seq):
        self._seq = seq

    def seq_query(self):
        return self._seq


def _mini_spec(tag: str):
    return (
        TopoBuilder(f"tf{tag}{os.getpid()}", wksp_mb=8)
        .link("a_b", depth=64, mtu=256)
        .tile("src", "sink", outs=["a_b"])
        .tile("v:0", "verify", ins=["a_b"])
        .build()
    )


def test_fctl_credit_accounting():
    rx1, rx2 = _FakeFseq(), _FakeFseq()
    f = Fctl(cr_max=64).rx_add(rx1).rx_add(rx2)
    assert f.rx_cnt == 2
    # producer at seq 0: full credits
    assert f.cr_query(0) == 64
    # slowest consumer 60 behind caps credits at 4
    rx1.seq, rx2.seq = 4, 32
    assert f.cr_query(64) == 4
    # consume into backpressure
    f.cr_avail = 2
    assert f.consume(2)
    assert not f.consume(1)
    assert f.in_backp and f.backp_cnt == 1
    # housekeeping refresh: consumers caught up -> resume
    rx1.seq = rx2.seq = 64
    assert f.tx_cr_update(64) == 64
    assert not f.in_backp
    # backpressured refresh below resume threshold charges the slow diag
    rx1.seq = 0
    f.cr_avail = 0
    f.in_backp = True
    f.tx_cr_update(64)
    assert rx1.slow >= 1


def test_fctl_rx_evict_unblocks_producer():
    fs_dead, fs_live = _FakeFseq(0), _FakeFseq(90)
    f = Fctl(cr_max=64).rx_add(fs_dead).rx_add(fs_live)
    assert f.cr_query(100) == 0          # dead consumer pins credits
    assert f.rx_evict(fs_dead) is True
    assert f.rx_cnt == 1
    assert f.cr_query(100) == 64 - 10    # only the live consumer counts
    assert f.rx_evict(fs_dead) is False  # already gone


def test_evict_dead_consumer_fast_forwards():
    fs = _FakeFseq(3)
    cur = Fctl.evict_dead_consumer(fs, _FakeMcache(777))
    assert cur == 777 and fs.query() == 777
    # and again in real shm: FSeq.reset is the supervisor-side store
    jt = topo_mod.create(_mini_spec("ev"))
    try:
        fseq = jt.fseq[("v:0", "a_b")]
        mc = jt.links["a_b"].mcache
        fseq.update(1)
        for i in range(5):
            mc.publish(i)
        assert Fctl.evict_dead_consumer(fseq, mc) == mc.seq_query()
        assert fseq.query() == mc.seq_query()
    finally:
        jt.close()
        jt.unlink()


def test_fctl_evict_then_rejoin_no_double_credit_no_redelivery():
    """After the supervisor fast-forwards a dead consumer's fseq, the
    credits refill once: a consumer that rejoins at the evicted cursor
    (the cursor a drain manifest records) and publishes it gets no second
    refill, and no frag below the cursor is left outstanding for it.
    The JAX package's respawned Mux resumes there by itself; the port has
    no respawn, so the rejoin is the cursor's publish alone."""
    jt = topo_mod.create(_mini_spec("rj"))
    try:
        mc = jt.links["a_b"].mcache
        for i in range(10):
            mc.publish(i)
        fseq = jt.fseq[("v:0", "a_b")]
        fseq.update(mc.seq0() + 3)   # consumer died 7 frags behind
        f = Fctl(cr_max=8).rx_add(fseq)
        assert f.cr_query(mc.seq_query()) == 1  # 8 - 7 lag
        cursor = Fctl.evict_dead_consumer(fseq, mc)
        assert cursor == mc.seq_query()
        assert f.cr_query(mc.seq_query()) == 8  # fully refilled
        fseq.update(cursor)                     # the rejoin's first publish
        assert fseq.query() == cursor
        assert f.cr_query(mc.seq_query()) == 8
        assert mc.seq_query() - fseq.query() == 0
        for i in range(3):                      # the producer goes on
            mc.publish(10 + i)
        assert f.cr_query(mc.seq_query()) == 5
    finally:
        jt.close()
        jt.unlink()


def test_fctl_matches_the_jax_package():
    """The same seeded sequence of consumer moves, publishes, consumes,
    refreshes and evictions through both packages' Fctl: the same credits,
    backpressure state and slow charges at every step."""
    rng = np.random.default_rng(2024)
    fs = [[_FakeFseq(), _FakeFseq(), _FakeFseq()] for _ in range(2)]
    ctls = [Fctl(cr_max=32), JaxFctl(cr_max=32)]
    for c, rxs in zip(ctls, fs):
        for rx in rxs:
            c.rx_add(rx)
    seq = 0
    for step in range(2000):
        op = int(rng.integers(0, 5))
        arg = int(rng.integers(0, 8))
        who = int(rng.integers(0, 3))
        outs = []
        for c, rxs in zip(ctls, fs):
            if op == 0:      # a consumer catches up part of the way
                rxs[who].seq = min(seq, rxs[who].seq + arg)
                outs.append(None)
            elif op == 1:
                outs.append(c.consume(arg))
            elif op == 2:
                outs.append(c.tx_cr_update(seq))
            elif op == 3:
                outs.append(c.cr_query(seq))
            elif step % 500 == 499:
                outs.append(c.rx_evict(rxs[who]))
            else:
                outs.append(None)
        if op == 1 and outs[0]:
            seq += arg
        assert outs[0] == outs[1], step
        a, b = ctls
        assert (a.cr_avail, a.in_backp, a.backp_cnt, a.backp_exit_cnt,
                a.rx_cnt) == (b.cr_avail, b.in_backp, b.backp_cnt,
                              b.backp_exit_cnt, b.rx_cnt), step
        assert [r.slow for r in fs[0]] == [r.slow for r in fs[1]], step
        assert [r.seq for r in fs[0]] == [r.seq for r in fs[1]], step
