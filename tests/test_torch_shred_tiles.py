"""The port's shred-lane tiles (firedancer_tpu_torch/disco/shred_tiles.py)
against the JAX package's, on device "cpu", where the merkle walk, the
strict verify and the GF(2) kernels run their plain versions.

- _ShredSigBatcher: the port's "device" backend against the JAX "host"
  backend on one burst holding valid shreds, a forged signature, the
  wrong leader, an unknown leader, a legacy shred and a duplicate (the
  JAX device backend would compile its verify graph; its host backend
  gives the same bits).
- ShredRecoverIngest on the same sets, a corrupt one among them: the same
  verdict rows.
- ShredTile (turbine ingress and retransmit), ShredRecoverTile and
  StoreTile, each package's under its own Mux in threads, on the same
  shreds published into the shred tile's net in-link: the same frags on
  every link, the same counters, the same retransmits to a child socket,
  and the store completing the slot.  The leader role is refused.
- The port's StoreTile on a leader-signed set whose survivors disagree,
  in a live slot after the good one: it drops the set, counts it once
  and runs on to its halt, with complete_slot left at the good slot
  (the JAX StoreTile raises on such a set)."""

import os
import threading
import time

import numpy as np
import pytest

from firedancer_tpu.ballet import shred as jsl
from firedancer_tpu_torch.ballet import reedsol as rs
from firedancer_tpu_torch.ballet import shred as sl
from firedancer_tpu_torch.disco import shred_tiles as st
from firedancer_tpu_torch.disco import topo as topo_mod
from firedancer_tpu_torch.disco.mux import Mux
from firedancer_tpu_torch.tango.ring import Cnc
from firedancer_tpu_torch.waltz.udpsock import UdpSock
from _torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import (fec_set, forge, lane_stream, legacy_shred,
                        shred_keys, turbine_cfg)

KEYS = shred_keys()
LEADER, OTHER = KEYS["leader"], KEYS["other"]


def _fec(entry, slot, fec_idx, k=8, done=False):
    return fec_set(entry, slot, fec_idx, k, done, device="cpu")


def test_batcher_device_backend_equals_the_jax_host_backend():
    from firedancer_tpu.disco.tiles import _ShredSigBatcher as JBatcher
    fs = _fec(b"d" * 700, 5, 0)
    raws = fs.data_shreds + fs.code_shreds
    burst = [(r, LEADER) for r in raws[:4]]
    burst += [(forge(raws[5]), LEADER), (raws[6], OTHER), (raws[7], None),
              (legacy_shred(5), LEADER), (raws[0], LEADER)]
    burst += [(r, LEADER) for r in raws[8:11]]     # a partial second chunk
    port = st._ShredSigBatcher(batch=8, backend="device", device="cpu")
    port.warm()
    jax_b = JBatcher(batch=8, backend="host")
    out = []
    for b, parse in ((port, sl.parse), (jax_b, jsl.parse)):
        for i, (raw, leader) in enumerate(burst):
            b.add(parse(raw), raw, i, leader)
        assert b.full and not b.due() or b is jax_b
        out.append([(tag, ok) for _, _, tag, ok in b.flush()])
        assert len(b) == 0
    assert out[0] == out[1]
    assert [ok for _, ok in out[0]] == [True] * 4 + [False] * 4 + [True] * 4


def _recover_triples(k=8):
    rng = np.random.default_rng(12)
    trips = []
    for i in range(3):
        entry = rng.integers(0, 256, 2000 + 300 * i, np.uint8).tobytes()
        fs = _fec(entry, 30 + i, 0, k)
        raws = fs.data_shreds + fs.code_shreds
        r = sl.FecResolver(torch_device="cpu")
        for j, raw in enumerate(raws):
            if j not in (1, k + i):
                r.add(sl.parse(raw))
        trips.append(r.recover_args())
    bad = list(trips[1][0])
    idx = max(i for i, s in enumerate(bad) if s is not None)
    bad[idx] = bad[idx].copy()
    bad[idx][5] ^= 0x10
    return trips[:1] + [(bad, trips[1][1], trips[1][2])] + trips[2:]


def test_recover_ingest_equals_the_jax_ingest():
    from firedancer_tpu.disco.tiles import ShredRecoverIngest as JIngest
    trips = _recover_triples()
    port = st.ShredRecoverIngest(k_max=8, n_max=16, sz=1059, batch=4,
                                 nbuf=2, device="cpu")
    jing = JIngest(k_max=8, n_max=16, sz=1059, batch=4, nbuf=2)
    outs = []
    for ing in (port, jing):
        ing.warm()
        got = list(ing.submit_sets(trips)) + list(ing.submit_sets(trips[:1]))
        got += ing.drain()
        assert len(got) == 2 and ing.dispatches == 3
        outs.append(got)
    for a, b in zip(*outs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    full, ok = port.split_verdict(np.asarray(outs[0][0]))
    assert ok.tolist() == [True, False, True, True]
    assert [bytes(x) for x in full[0]] == [
        bytes(x) for x in rs.recover(*trips[0], device=False)]
    with pytest.raises(ValueError, match="geometry"):
        port.submit_sets([([np.zeros(64, np.uint8)] * 4, 2, 64)])
    with pytest.raises(ValueError, match="> engine batch"):
        port.submit_sets(trips * 2)


def _wait(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {what}")


def _published(jt, link):
    lnk = jt.links[link]
    out = []
    for seq in range(lnk.mcache.seq0(), lnk.mcache.seq_query()):
        rc, m = lnk.mcache.query(seq)
        assert rc == 0
        out.append((lnk.dcache.read(int(m["chunk"]), int(m["sz"])),
                    int(m["sig"])))
    return out


def lane_spec(pkg, name, child_port, k, sig_backend, extra, batch_sets=2,
              depth=256):
    return (pkg.TopoBuilder(name, wksp_mb=32)
            .link("net", depth=depth, mtu=1280)
            .link("s_store", depth=depth, mtu=1280)
            .link("s_rec", depth=depth, mtu=1280)
            .link("r_sink", depth=64, mtu=64 * 1280)
            .tile("n", "sink", outs=["net"])
            .tile("shred", "shred", ins=["net"], outs=["s_store", "s_rec"],
                  net_ins=["net"], turbine=turbine_cfg(KEYS, child_port, 32),
                  sig_batch=8, sig_flush_age_us=10**9,
                  sig_backend=sig_backend, **extra)
            .tile("store", "store", ins=["s_store"], max_slots=1, **extra)
            .tile("rec", "shred_recover", ins=["s_rec"], outs=["r_sink"],
                  fec_data_cnt=k, batch_sets=batch_sets,
                  flush_age_us=10**9, **extra)
            .tile("sink", "sink", ins=[pkg.InLink("r_sink",
                                                  reliable=False)])
            .build())


def test_lane_tiles_under_the_mux_equal_the_jax_tiles():
    from firedancer_tpu.disco import topo as jtopo
    from firedancer_tpu.disco.mux import Mux as JMux
    from firedancer_tpu.disco import tiles as jtiles
    frags, entries, valid, n_forged = lane_stream(5, 3, 8, 6, 8, 16,
                                                  device="cpu")
    assert len(frags) % 8 == 0      # whole admission bursts, no age flush
    runs = []
    for pkg, mux_cls, tiles, backend, extra in (
            (topo_mod, Mux, st.TILES, "host", {"device": "cpu"}),
            (jtopo, JMux, jtiles.TILES, "host", {})):
        child = UdpSock(bind_ip="127.0.0.1")
        spec = lane_spec(pkg, f"tsl{len(runs)}{os.getpid()}", child.port, 8,
                         backend, extra)
        jt = pkg.create(spec)
        try:
            names = ("shred", "store", "rec")
            vts = {n: tiles[{"rec": "shred_recover"}.get(n, n)]()
                   for n in names}
            ths = [threading.Thread(target=mux_cls(jt, n, vts[n]).run,
                                    daemon=True) for n in names]
            for th in ths:
                th.start()
            for n in names:
                _wait(lambda: jt.cnc[n].signal_query() == Cnc.SIGNAL_RUN,
                      120, f"{n} RUN")
            # the child counts the shred tile's datagrams only: its port
            # is ephemeral on the loopback, where other tests send too
            # (one stray datagram stands for them)
            sender = ("127.0.0.1", vts["shred"].tsock.port)
            stray = UdpSock(bind_ip="127.0.0.1")
            stray.sock.sendto(b"stray", ("127.0.0.1", child.port))
            stray.close()
            lnk = jt.links["net"]
            chunk = lnk.dcache.chunk0
            for f in frags:
                nxt = lnk.dcache.write(chunk, f)
                lnk.mcache.publish(0, chunk, len(f))
                chunk = nxt
            lnk = None

            def done():
                rm = jt.metrics["rec"].snapshot()
                return (rm["fec_complete_cnt"] + rm["fec_fail_cnt"]
                        == len(entries) + 1
                        and jt.metrics["store"].snapshot()["complete_slot"])

            _wait(done, 120, "every set recovered and the slot stored")
            got_udp = []

            def retransmits():
                got_udp.extend(p for p in child.recv_burst()
                               if tuple(p.addr) == sender)
                return len(got_udp) >= jt.metrics["shred"].snapshot()[
                    "turbine_tx_cnt"]

            _wait(retransmits, 30, "the retransmits")
            for n in names:
                jt.cnc[n].signal(Cnc.SIGNAL_HALT)
            for th in ths:
                th.join(60)
                assert not th.is_alive()
            runs.append({
                "links": {ln: _published(jt, ln)
                          for ln in ("s_store", "s_rec", "r_sink")},
                "metrics": {n: jt.metrics[n].snapshot() for n in names},
                "udp": sorted(p.payload for p in got_udp)})
        finally:
            child.close()
            jt.close()
            jt.unlink()
    port, jax_run = runs
    assert port["links"] == jax_run["links"]
    assert port["udp"] == jax_run["udp"] and port["udp"]
    assert [p for p, _ in port["links"]["r_sink"]] == entries
    keys = {"shred": ("shred_rx_cnt", "shred_sig_fail_cnt", "sig_batch_cnt",
                      "turbine_tx_cnt", "shred_parse_fail_cnt",
                      "sig_deadline_flush_cnt"),
            "store": ("shred_store_cnt", "parse_fail_cnt", "complete_slot"),
            "rec": ("shred_rx_cnt", "fec_complete_cnt", "fec_recovered_cnt",
                    "fec_dispatch_cnt", "fec_fail_cnt",
                    "fec_host_fallback_cnt")}
    for n, ks in keys.items():
        assert {k: port["metrics"][n][k] for k in ks} == \
            {k: jax_run["metrics"][n][k] for k in ks}, n
    pm = port["metrics"]
    assert pm["shred"]["shred_sig_fail_cnt"] == n_forged
    assert pm["rec"]["fec_fail_cnt"] == 1
    assert pm["shred"]["shred_rx_cnt"] == len(valid)
    assert pm["rec"]["fec_host_fallback_cnt"] == 0
    assert pm["store"]["complete_slot"] == 5
    assert len(port["udp"]) == pm["shred"]["turbine_tx_cnt"]


def test_store_tile_survives_a_corrupt_set_in_a_live_slot():
    frags, entries, valid, n_forged = lane_stream(
        5, 3, 8, 6, 8, 16, device="cpu", live_corrupt=True)
    assert len(frags) % 8 == 0
    child = UdpSock(bind_ip="127.0.0.1")
    spec = lane_spec(topo_mod, f"tsc{os.getpid()}", child.port, 8, "host",
                     {"device": "cpu"})
    jt = topo_mod.create(spec)
    errors = []

    def run(mux):
        try:
            mux.run()
        except BaseException as exc:     # the tile died: the test fails
            errors.append(exc)
    try:
        names = ("shred", "store", "rec")
        vts = {n: st.TILES[{"rec": "shred_recover"}.get(n, n)]()
               for n in names}
        ths = [threading.Thread(target=run, args=(Mux(jt, n, vts[n]),),
                                daemon=True) for n in names]
        for th in ths:
            th.start()
        for n in names:
            _wait(lambda: jt.cnc[n].signal_query() == Cnc.SIGNAL_RUN,
                  120, f"{n} RUN")
        lnk = jt.links["net"]
        chunk = lnk.dcache.chunk0
        for f in frags:
            nxt = lnk.dcache.write(chunk, f)
            lnk.mcache.publish(0, chunk, len(f))
            chunk = nxt
        lnk = None

        def done():
            return (vts["store"].store.corrupt_set_cnt
                    and jt.metrics["store"].snapshot()["shred_store_cnt"]
                    == len(valid))

        _wait(done, 120, "every admitted shred stored")
        for n in names:
            jt.cnc[n].signal(Cnc.SIGNAL_HALT)
        for th in ths:
            th.join(60)
            assert not th.is_alive()
        sm = jt.metrics["store"].snapshot()
    finally:
        child.close()
        jt.close()
        jt.unlink()
    assert errors == []
    assert vts["store"].drain_manifest(None) == {"corrupt_set_cnt": 1}
    assert sm["complete_slot"] == 5 and sm["parse_fail_cnt"] == 0
    # the dropped set's later shreds are ignored, not counted again
    store = vts["store"].store
    bad = [r for r in valid if sl.parse(r).slot == 6]
    assert len(bad) == 9 and store.slots[6].corrupt_sets == {0}
    assert not store.insert_shred(bad[-1])
    assert store.corrupt_set_cnt == 1 and not store.slot_complete(6)


def test_shred_tile_refuses_the_leader_role():
    class Ctx:
        class tile:
            in_links = [topo_mod.InLink("entries")]
            out_links = ("s_out",)
        cfg = {"net_ins": []}
    with pytest.raises(NotImplementedError, match="keyguard"):
        st.ShredTile().init(Ctx())
