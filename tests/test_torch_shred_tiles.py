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
  and the store completing the slot.
- The leader role: the port's shred and sign tiles under the port's Mux
  and the JAX ones under the JAX Mux on the same seeded entry frames
  (a mid-slot batch_max cut, done bits, a missed done marker): the same
  shreds, sign traffic and turbine root sends; entry in-links without a
  shred_sign out-link raise ValueError in both.  In processes, a drain
  cuts the open slot while the sign tile serves, and a plain halt never
  raises for it and counts what it leaves unshredded.
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
    """Entry in-links without a shred_sign out-link to the keyguard raise
    ValueError at init, in both packages."""
    from firedancer_tpu.disco import tiles as jtiles

    class Ctx:
        class tile:
            in_links = [topo_mod.InLink("entries")]
            out_links = ("s_out",)
        cfg = {"net_ins": [], "device": "cpu"}
    for cls in (st.ShredTile, jtiles.ShredTile):
        with pytest.raises(ValueError, match="shred_sign"):
            cls().init(Ctx())


# ------------------------------------------------- the leader's tail

def leader_frames(seed: int = 23) -> list:
    """Seeded poh entry frames (sig, payload) as poh_dev publishes them:
    slot 3 long enough for a mid-slot batch_max cut, closed by its done
    bit; slot 4 with no done marker, closed by slot 5's first entry; slot
    5 and slot 6 closed by their done bits.  Entries carry random txn
    bytes (the shred tile never parses them)."""
    from firedancer_tpu_torch.ballet import entry as el
    rng = np.random.default_rng(seed)
    frames = []
    for slot, n, done in ((3, 30, True), (4, 3, False), (5, 2, True),
                          (6, 1, True)):
        for i in range(n):
            txns = [rng.bytes(int(rng.integers(200, 1200)))
                    for _ in range(int(rng.integers(0, 4)))]
            e = el.Entry(int(rng.integers(1, 64)), rng.bytes(32), txns)
            last = done and i == n - 1
            frames.append((slot | (st.SLOT_DONE_BIT if last else 0),
                           e.serialize()))
    return frames


def _set_cuts(frames, batch_max=16 << 10) -> dict:
    """The sets the leader role cuts from `frames`: slot -> [entries of
    each set], the tile's cut rule on the frame sizes."""
    out, slot, cur, size = {}, None, [], 0
    for sig, payload in frames:
        s = sig & ~st.SLOT_DONE_BIT
        if slot is None:
            slot = s
        if s != slot:
            out.setdefault(slot, []).append(cur)
            slot, cur, size = s, [], 0
        cur.append(payload)
        size += len(payload)
        if sig & st.SLOT_DONE_BIT:
            out.setdefault(slot, []).append(cur)
            slot, cur, size = s + 1, [], 0
        elif size >= batch_max:
            out.setdefault(slot, []).append(cur)
            cur, size = [], 0
    return out


def leader_turbine_cfg(keys: dict, ports: tuple) -> dict:
    """The leader's [turbine] table: itself and two staked peers with
    contacts on the loopback, so each shred's tree root is one of them."""
    return {"identity": keys["leader"].hex(), "fanout": 200, "port": 0,
            "slots_per_epoch": 32,
            "stakes": {keys["leader"].hex(): [1000, "", 0],
                       keys["me"].hex(): [500, "127.0.0.1", ports[0]],
                       keys["child"].hex(): [300, "127.0.0.1", ports[1]]}}


def leader_tail_topo(pkg, name, key_path, extra, turbine=None,
                     archive=""):
    """entries (written by the test) -> shred <-> sign; shred -> store and
    an unconsumed net link."""
    # a leader admits no net shreds: the host admission backend keeps
    # the JAX tile's boot free of its verify graph's compile
    tcfg = {"turbine": turbine, "sig_backend": "host"} if turbine else {}
    return (pkg.TopoBuilder(name, wksp_mb=32)
            .link("entries", depth=256, mtu=64 << 10)
            .link("shred_sign", depth=16, mtu=128)
            .link("sign_shred", depth=16, mtu=128)
            .link("s_store", depth=1024, mtu=1280)
            .link("s_net", depth=1024, mtu=1280)
            .tile("p", "sink", outs=["entries"])
            .tile("shred", "shred", ins=["entries"],
                  outs=["shred_sign", "s_store", "s_net"], **tcfg, **extra)
            .tile("sign", "sign", ins=["shred_sign"], outs=["sign_shred"],
                  key_path=key_path)
            .tile("store", "store", ins=["s_store"], max_slots=8,
                  **({"archive_path": archive} if archive else {}),
                  **extra)
            .build())


def _write_frames(jt, frames):
    lnk = jt.links["entries"]
    chunk = lnk.dcache.chunk0
    for sig, payload in frames:
        nxt = lnk.dcache.write(chunk, payload)
        lnk.mcache.publish(sig, chunk, len(payload))
        chunk = nxt


def test_leader_role_under_the_mux_equals_the_jax_tiles(tmp_path):
    """The port's shred (leader role) and sign tiles under the port's Mux
    and the JAX ones under the JAX Mux, on the same entry frames: the
    same shreds on both fan-out links, the same sign requests and
    replies, the same turbine root sends to two loopback peers, the same
    counters; the port's store holds every slot complete with the
    frames' entries."""
    from firedancer_tpu.disco import keyguard as jkg
    from firedancer_tpu.disco import topo as jtopo
    from firedancer_tpu.disco.mux import Mux as JMux
    from firedancer_tpu.disco import tiles as jtiles
    from firedancer_tpu_torch.ballet import entry as el
    from firedancer_tpu_torch.disco import tiles as ptiles
    from chip_smoke import LEADER_SEED
    kpath = str(tmp_path / "leader.json")
    jkg.keypair_write(kpath, LEADER_SEED, LEADER)
    frames = leader_frames()
    cuts = _set_cuts(frames)
    n_sets = sum(map(len, cuts.values()))
    # a mid-slot cut in slot 3, slot 4 closed by the slot change
    assert len(cuts[3]) >= 2 and [len(cuts[s]) for s in (4, 5, 6)] == [
        1, 1, 1]
    runs = []
    for pkg, mux_cls, tiles, extra in (
            (topo_mod, Mux, ptiles.TILES, {"device": "cpu"}),
            (jtopo, JMux, jtiles.TILES, {})):
        peers = (UdpSock(bind_ip="127.0.0.1"), UdpSock(bind_ip="127.0.0.1"))
        spec = leader_tail_topo(
            pkg, f"tlr{len(runs)}{os.getpid()}", kpath, extra,
            turbine=leader_turbine_cfg(KEYS, tuple(p.port for p in peers)))
        jt = pkg.create(spec)
        try:
            names = ("shred", "sign", "store")
            vts = {n: tiles[n]() for n in names}
            ths = [threading.Thread(target=mux_cls(jt, n, vts[n]).run,
                                    daemon=True) for n in names]
            for th in ths:
                th.start()
            for n in names:
                _wait(lambda: jt.cnc[n].signal_query() == Cnc.SIGNAL_RUN,
                      120, f"{n} RUN")
            sender = ("127.0.0.1", vts["shred"].tsock.port)
            _write_frames(jt, frames)
            got_udp = ([], [])

            def done():
                for i, peer in enumerate(peers):
                    got_udp[i].extend(p.payload for p in peer.recv_burst()
                                      if tuple(p.addr) == sender)
                sm = jt.metrics["shred"].snapshot()
                return (sm["fec_set_cnt"] == n_sets
                        and jt.metrics["store"].snapshot()["shred_store_cnt"]
                        == n_sets * 64
                        and sum(map(len, got_udp)) == sm["turbine_tx_cnt"])

            _wait(done, 120, "every set cut and stored")
            for n in names:
                jt.cnc[n].signal(Cnc.SIGNAL_HALT)
            for th in ths:
                th.join(60)
                assert not th.is_alive()
            # the last set's root sends may land after the store has it
            _wait(done, 10, "every root send")
            store = vts["store"].store
            runs.append({
                "links": {ln: _published(jt, ln) for ln in (
                    "s_store", "s_net", "shred_sign", "sign_shred")},
                "metrics": {n: jt.metrics[n].snapshot() for n in names},
                "udp": [sorted(u) for u in got_udp],
                "slots": {slot: (store.slot_complete(slot),
                                 store.slot_entries(slot))
                          for slot in cuts}})
            vts = store = None
        finally:
            for peer in peers:
                peer.close()
            jt.close()
            jt.unlink()
    port, jax_run = runs
    assert port["links"] == jax_run["links"]
    assert port["udp"] == jax_run["udp"] and all(port["udp"])
    keys = {"shred": ("fec_set_cnt", "shred_tx_cnt", "turbine_tx_cnt"),
            "sign": ("sign_cnt", "refuse_cnt"),
            "store": ("shred_store_cnt", "parse_fail_cnt", "complete_slot")}
    for n, ks in keys.items():
        assert {k: port["metrics"][n][k] for k in ks} == \
            {k: jax_run["metrics"][n][k] for k in ks}, n
    pm = port["metrics"]
    assert pm["sign"]["sign_cnt"] == pm["shred"]["fec_set_cnt"] == n_sets
    assert pm["sign"]["refuse_cnt"] == 0
    assert pm["shred"]["shred_tx_cnt"] == 2 * 64 * n_sets
    assert pm["shred"]["unshred_entry_cnt"] == 0
    assert pm["store"]["complete_slot"] == 6
    # shreds carry the slot as their sig; each set is signed by the key
    shreds = [sl.parse(p) for p, _ in port["links"]["s_store"]]
    assert [q for _, q in port["links"]["s_store"]] == [s.slot for s in
                                                        shreds]
    assert all(len(p) == 64 for p, _ in port["links"]["sign_shred"])
    for slot, sets in cuts.items():
        complete, got = port["slots"][slot]
        assert complete
        assert [e.serialize() for e in got] == [p for cut in sets
                                                for p in cut]


def test_leader_tail_drain_stores_the_open_slot_and_halt_counts_it(
        tmp_path, monkeypatch):
    """The leader's tail in processes on device "cpu": entry frames that
    leave slot 7 open.  drain() cuts it while the sign tile still serves,
    so the store's archive holds every slot complete and nothing is
    counted unshredded; a plain halt of the same run never raises, and
    the open slot's entries are either shredded or counted in
    unshred_entry_cnt."""
    from firedancer_tpu_torch.ballet import entry as el
    from firedancer_tpu_torch.disco.keyguard import keypair_write
    from firedancer_tpu_torch.disco.run import TopoRun
    from firedancer_tpu_torch.flamenco.blockstore import SlotArchive
    from chip_smoke import LEADER_SEED
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kpath = str(tmp_path / "leader.json")
    keypair_write(kpath, LEADER_SEED, LEADER)
    tail = [(7, el.Entry(5, bytes([i]) * 32, [bytes([i]) * 300])
             .serialize()) for i in range(4)]
    frames = leader_frames()[-3:] + tail        # slots 5, 6, then 7 open
    for drained in (True, False):
        arch = str(tmp_path / f"slots{drained}.bin")
        spec = leader_tail_topo(topo_mod, f"tld{int(drained)}{os.getpid()}",
                                kpath, {"device": "cpu"}, archive=arch)
        run = TopoRun(spec)
        try:
            run.wait_ready(timeout=120)
            _write_frames(run.jt, frames)
            _wait(lambda: run.metrics("shred")["in_frag_cnt"] == len(frames)
                  and run.metrics("store")["complete_slot"] == 6, 60,
                  "slots 5 and 6 stored")
            if drained:
                assert run.drain(30.0) is True
            else:
                run.halt()
            assert run.exitcodes == {t.name: 0 for t in spec.tiles}
            sm, gm = run.metrics("shred"), run.metrics("sign")
        finally:
            run.close()
        archive = SlotArchive(arch)
        try:
            stored = {s: el.deserialize_batch(archive.get(s))
                      for s in archive.slots()}
        finally:
            archive.close()
        assert gm["sign_cnt"] == sm["fec_set_cnt"] and gm["refuse_cnt"] == 0
        if drained:
            assert sorted(stored) == [5, 6, 7]
            assert [e.serialize() for e in stored[7]] == [p for _, p in tail]
            assert sm["unshred_entry_cnt"] == 0
        else:
            assert 5 in stored and 6 in stored
            assert sm["unshred_entry_cnt"] in (0, len(tail))
            assert (sm["unshred_entry_cnt"] == 0) == (sm["fec_set_cnt"] == 3)


def test_leader_role_counts_what_a_halt_leaves_unsigned(tmp_path):
    """The halt race step by step, the port's leader tile on a real ctx
    with each tile's cnc set by hand: a signer that fails while this
    tile runs is a fault and the cut raises; at a halt (this tile's cnc
    HALT, the signer exited to BOOT) the cut's entries, and the frame of
    a slot change, are counted in unshred_entry_cnt and the loop is asked
    to exit; fini counts what a parked signer (DRAINED) cannot sign.  No
    request reaches shred_sign once the signer reads down."""
    from firedancer_tpu_torch.disco.keyguard import (KeyguardDown,
                                                     keypair_write)
    from chip_smoke import LEADER_SEED
    kpath = str(tmp_path / "leader.json")
    keypair_write(kpath, LEADER_SEED, LEADER)
    spec = leader_tail_topo(topo_mod, f"tlh{os.getpid()}", kpath,
                            {"device": "cpu"})
    jt = topo_mod.create(spec)
    try:
        frames = [p for _, p in leader_frames()[:3]]
        req = jt.links["shred_sign"].mcache
        seq0 = req.seq_query()

        def tile_on(own, signer):
            jt.cnc["shred"].signal(Cnc.SIGNAL_RUN)
            tile, mux = st.ShredTile(), None
            mux = Mux(jt, "shred", tile)
            tile.init(mux.ctx)
            jt.cnc["shred"].signal(own)
            jt.cnc["sign"].signal(signer)
            return tile, mux.ctx

        def lost():
            return jt.metrics["shred"].snapshot()["unshred_entry_cnt"]

        tile, ctx = tile_on(Cnc.SIGNAL_RUN, Cnc.SIGNAL_FAIL)
        tile.on_frag(ctx, 0, {"sig": 3}, frames[0])
        with pytest.raises(KeyguardDown):
            tile.on_frag(ctx, 0, {"sig": 3 | st.SLOT_DONE_BIT}, frames[1])
        assert lost() == 0 and not ctx.halted
        # a done frame at a halt: the held entry and the frame
        tile, ctx = tile_on(Cnc.SIGNAL_HALT, Cnc.SIGNAL_BOOT)
        tile.on_frag(ctx, 0, {"sig": 3}, frames[0])
        tile.on_frag(ctx, 0, {"sig": 3 | st.SLOT_DONE_BIT}, frames[1])
        assert (lost(), ctx.halted, tile.entries) == (2, True, [])
        # a slot change at a halt: the slot's two entries and the frame
        tile, ctx = tile_on(Cnc.SIGNAL_HALT, Cnc.SIGNAL_BOOT)
        tile.on_frag(ctx, 0, {"sig": 3}, frames[0])
        tile.on_frag(ctx, 0, {"sig": 3}, frames[1])
        tile.on_frag(ctx, 0, {"sig": 4}, frames[2])
        assert (lost(), ctx.halted) == (5, True)
        # fini with a parked signer
        tile, ctx = tile_on(Cnc.SIGNAL_RUN, Cnc.SIGNAL_DRAINED)
        tile.on_frag(ctx, 0, {"sig": 3}, frames[0])
        tile.on_frag(ctx, 0, {"sig": 3}, frames[1])
        tile.fini(ctx)
        assert lost() == 7 and tile.entries == []
        assert req.seq_query() == seq0
        tile = ctx = None
    finally:
        jt.close()
        jt.unlink()
