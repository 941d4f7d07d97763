"""The port's turbine tree host code against the JAX package's: chacha20
(blocks, encrypt, ChaCha20Rng draws in both rejection modes), wsample,
the leader schedule, ShredDest.compute_first and compute_children and
StakeCI, and the UDP socket backend the retransmit sends ride (a burst
to itself over loopback)."""

import time

import numpy as np
import pytest

from firedancer_tpu.ballet import chacha20 as jcc
from firedancer_tpu.ballet import shred as jsl
from firedancer_tpu.ballet import wsample as jws
from firedancer_tpu.disco import shred_dest as jsd
from firedancer_tpu.flamenco import leaders as jld
from firedancer_tpu_torch.ballet import chacha20 as cc
from firedancer_tpu_torch.ballet import shred as sl
from firedancer_tpu_torch.ballet import wsample as ws
from firedancer_tpu_torch.disco import shred_dest as sd
from firedancer_tpu_torch.flamenco import leaders as ld
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.waltz.aio import Pkt
from firedancer_tpu_torch.waltz.udpsock import UdpSock


def test_chacha20_equals_the_jax_package():
    key = bytes(range(32))
    for nonce in (bytes(12), bytes(range(8))):
        assert cc.chacha20_blocks(key, nonce, 7, 5) == \
            jcc.chacha20_blocks(key, nonce, 7, 5)
    data = bytes(range(200))
    assert cc.chacha20_encrypt(key, bytes(12), 1, data) == \
        jcc.chacha20_encrypt(key, bytes(12), 1, data)
    a, b = cc.ChaCha20Rng(key), jcc.ChaCha20Rng(key)
    for i in range(400):
        n = 1 + (i * 7919) % 1000003
        mode = (cc.ChaCha20Rng.MODE_MOD, cc.ChaCha20Rng.MODE_SHIFT)[i % 2]
        assert a.roll_u64(n, mode) == b.roll_u64(n, mode)
    assert [a.next_u32() for _ in range(70)] == [b.next_u32()
                                                 for _ in range(70)]
    assert a.next_u64() == b.next_u64()


def test_wsample_equals_the_jax_package():
    weights = [5, 0, 17, 3, 1000, 2, 0, 44]
    for mode in (cc.ChaCha20Rng.MODE_MOD, cc.ChaCha20Rng.MODE_SHIFT):
        a = ws.WSample(weights, mode=mode)
        b = jws.WSample(weights, mode=mode)
        ra, rb = cc.ChaCha20Rng(bytes(32)), jcc.ChaCha20Rng(bytes(32))
        assert a.sample_many(ra, 50) == b.sample_many(rb, 50)
        assert [a.sample_and_remove(ra) for _ in range(6)] == \
            [b.sample_and_remove(rb) for _ in range(6)]
    with pytest.raises(ValueError):
        ws.WSample([0, 0])


def _keys(n):
    return [ed.keypair_from_seed(bytes([i + 1]) * 32)[0] for i in range(n)]


def test_leader_schedule_equals_the_jax_package():
    keys = _keys(6)
    stakes = {k: (i + 1) * 1000 for i, k in enumerate(keys)}
    stakes[keys[2]] = 0
    for epoch in (0, 3):
        assert ld.leader_schedule(epoch, stakes, 101) == \
            jld.leader_schedule(epoch, stakes, 101)


def test_shred_dest_equals_the_jax_package():
    keys = _keys(12)
    fs = sl.make_fec_set(b"t" * 700, 11, 1, 1, 0,
                         lambda r: ed.sign(bytes(32), r), data_cnt=4,
                         code_cnt=4, torch_device="cpu")
    shreds = [sl.parse(r) for r in fs.data_shreds + fs.code_shreds]
    jshreds = [jsl.parse(r) for r in fs.data_shreds + fs.code_shreds]
    stakes = {k: (0 if i >= 8 else 10_000 * (i + 1))
              for i, k in enumerate(keys)}
    leader = keys[3]
    for me in (keys[0], keys[5], keys[10]):
        outs = []
        for mod, ss in ((sd, shreds), (jsd, jshreds)):
            ci = mod.StakeCI(me, slots_per_epoch=64)
            ci.set_stakes(0, stakes)
            for i, k in enumerate(keys):
                ci.set_contact(k, "127.0.0.1", 9000 + i)
            dest = ci.sdest_for(11, lambda slot: leader)
            lead = mod.StakeCI(leader, slots_per_epoch=64)
            lead.set_stakes(0, stakes)
            first = lead.sdest_for(11, lambda slot: leader).compute_first(ss)
            kids = [dest.compute_children([s], fo)[0] for s in ss
                    for fo in (1, 2, 200)]
            outs.append((first, kids, [(d.pubkey, d.stake, d.addr)
                                       for d in dest.dests]))
        assert outs[0] == outs[1]
    assert sd.shred_seed(11, 3, True, leader) == \
        jsd.shred_seed(11, 3, True, leader)


def test_udpsock_burst_over_loopback():
    rx = UdpSock(bind_ip="127.0.0.1")
    tx = UdpSock(bind_ip="127.0.0.1")
    try:
        pkts = [Pkt(bytes([i]) * (100 + i), ("127.0.0.1", rx.port))
                for i in range(5)]
        assert tx.aio().send(pkts) == 5
        got = []
        for _ in range(1000):
            got += rx.recv_burst()
            if len(got) == 5:
                break
            time.sleep(0.001)
        assert sorted(p.payload for p in got) == sorted(p.payload
                                                        for p in pkts)
        assert all(p.addr == tx.addr for p in got)
    finally:
        rx.close()
        tx.close()
