"""The port's leader lane (firedancer_tpu_torch/disco/leader_tiles.py:
LeaderPackTile and PohDevTile; app/config.py leader-bench) against the JAX
package's tiles, on device "cpu", where the PoH spans and mixin-tree
kernels run their plain versions.

- The K-tick splice cases of tests/test_leader_shard.py, the port's tile
  and the JAX tile driven by the same recording ctx: the same published
  entries and counters.
- The pack tile on the same per-txn frags, both native_pack settings.
- Both tiles under the port's Mux and the JAX ones under the JAX Mux on
  the same packed arena frags: the same microblock frags, and entry
  streams that re-verify and carry those microblocks in order (when a
  tick closes is the housekeeping clock's, so the tick entries differ).
- leader-bench in spawned processes (the case of
  tests/test_leader_pipeline.py), with forged txns injected beside the
  source's: every txn the host verifier passes appears once in the
  entries, no other does, and the chain re-verifies."""

import collections
import dataclasses
import os
import threading
import time

import numpy as np
import pytest

from firedancer_tpu.ballet import entry as jentry
from firedancer_tpu.ballet import poh as jpoh
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch.app import config as app_config
from firedancer_tpu_torch.ballet import entry as entry_lib
from firedancer_tpu_torch.ballet import poh as poh_lib
from firedancer_tpu_torch.ballet import txn as txn_lib
from firedancer_tpu_torch.disco import leader_tiles as lt
from firedancer_tpu_torch.disco import topo as topo_mod
from firedancer_tpu_torch.disco.mux import Mux
from firedancer_tpu_torch.disco.run import TopoRun
from firedancer_tpu_torch.disco.tiles import read_capture, source_txn_stream
from firedancer_tpu_torch.tango.ring import Cnc, tx_burst
from _torch_threads import one_torch_thread  # noqa: F401

SLOT_DONE = 1 << 63


class _Metrics:
    def __init__(self):
        self.d = collections.Counter()

    def add(self, k, v=1):
        self.d[k] += v

    def set(self, k, v):
        self.d[k] = v


class _Ctx:
    def __init__(self, cfg):
        self.cfg = cfg
        self.metrics = _Metrics()
        self.out = []

    def publish(self, payload, sig=0):
        self.out.append((bytes(payload), sig))


def _wait(pred, timeout_s, what=""):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {what}")


def _entries(frags):
    return [entry_lib.Entry.deserialize(p)[0] for p, _ in frags]


# ------------------------------------------------ K-tick PoH splice vs JAX

def _drive_pohdev(tile, mb_plan, hpt=8, tps=4, mb_cap=3, k=2, **extra):
    ctx = _Ctx(dict(hashes_per_tick=hpt, ticks_per_slot=tps,
                    mb_per_tick=mb_cap, spec_ticks=k, spec_spans=3,
                    mixin_txn_max=8, **extra))
    tile.init(ctx)
    for mbs in mb_plan:
        for mb in mbs:
            tile._mb_q.append(mb)
        tile.house(ctx)
        tile.after_credit(ctx)
    tile.fini(ctx)
    # inflight_depth is a gauge of when a verdict was polled: the clock's
    m = dict(ctx.metrics.d)
    m.pop("inflight_depth")
    return ctx.out, m


def _both_pohdev(mb_plan, **kw):
    from firedancer_tpu.disco.tiles import PohDevTile as JPohDevTile
    got = _drive_pohdev(lt.PohDevTile(), mb_plan, device="cpu", **kw)
    want = _drive_pohdev(JPohDevTile(), mb_plan, unroll=4, **kw)
    assert got == want
    return _entries(got[0]), got[1]


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_ktick_splice_equals_the_jax_tile_at_every_offset(j):
    """Mixins at every offset of the mixin region (j = 0..mb_cap): the
    port's published entries and counters equal the JAX tile's, and the
    chain is the host rule's, with the splice geometry P+1 / 1.. / tail."""
    hpt, mb_cap = 8, 3
    mbs = [[bytes([10 * j + i]) * 65] for i in range(j)]
    entries, m = _both_pohdev([list(mbs), [], []], hpt=hpt, mb_cap=mb_cap)
    assert entry_lib.verify_chain(bytes(32), entries)
    assert sum(len(e.txns) for e in entries) == j
    if j == 0:
        assert m.get("spec_miss_cnt", 0) == 0
        assert all(e.num_hashes == hpt for e in entries)
    else:
        p = hpt - mb_cap - 1
        shapes = [e.num_hashes for e in entries[:j + 1]]
        assert shapes == [p + 1] + [1] * (j - 1) + [mb_cap + 1 - j]
        assert m["rehash_cnt"] == mb_cap + 1 - j
        assert m["splice_dispatch_cnt"] == 1
    assert m.get("recheck_fail_cnt", 0) == 0
    assert m["recheck_ok_cnt"] > 0


def test_ktick_window_spec_hits_and_invalidation_equal_the_jax_tile():
    entries, m = _both_pohdev([[] for _ in range(6)], tps=8, k=3)
    assert entry_lib.verify_chain(bytes(32), entries)
    assert m["spec_hit_cnt"] == 6
    assert m["dispatch_cnt"] == 2
    assert m.get("splice_dispatch_cnt", 0) == 0
    entries, m = _both_pohdev([[], [[b"\x42" * 65]], [], []], tps=8, k=3)
    assert entry_lib.verify_chain(bytes(32), entries)
    assert m["spec_miss_cnt"] == 1 and m["splice_dispatch_cnt"] == 1


def test_slot_done_and_deferred_microblocks_equal_the_jax_tile():
    """More microblocks than a tick holds (they defer), two slots, and a
    seed hash: SLOT_DONE_BIT on each slot's last entry only."""
    plan = [[[bytes([i, t]) * 40 for i in range(1 + t % 3)]
             for t in range(5)], [], [], [], [[b"\x07" * 70]], [], []]
    entries, m = _both_pohdev(plan, hpt=6, tps=3, mb_cap=2, k=2,
                              seed_hash="ab" * 32, start_slot=5)
    assert entry_lib.verify_chain(bytes.fromhex("ab" * 32), entries)
    assert m["mb_deferred_cnt"] > 0
    assert sum(len(e.txns) for e in entries) == 1 + 2 + 3 + 1 + 2 + 1


def test_pohdev_refuses_no_mixin_room():
    with pytest.raises(ValueError):
        lt.PohDevTile().init(_Ctx(dict(hashes_per_tick=1, device="cpu")))


# ------------------------------------------------------- pack tile vs JAX

def _pack_txns():
    """Signed-looking txns for the pack tile (pack does not verify):
    plain, hot-account writers, votes, a priority fee, and one garbage
    frag."""
    from firedancer_tpu_torch.ballet import pack
    out = []
    for i in range(12):
        extra = [bytes([200 + i % 2]) * 32] if i % 3 == 0 else []
        prog = pack.VOTE_PROG_ID if i % 5 == 4 else b"\x07" * 32
        msg = txn_lib.build_unsigned(
            [bytes([i + 1]) * 32], b"\x11" * 32, [(len(extra) + 1, b"\x00",
                                                  bytes(4 + i))],
            extra_accounts=extra + [prog], readonly_unsigned_cnt=1)
        out.append(txn_lib.assemble([bytes([i]) * 64], msg))
    out.insert(7, b"\x01garbage")
    return out


@pytest.mark.parametrize("native_pack", [0, 1])
def test_leader_pack_tile_equals_the_jax_tile(native_pack):
    from firedancer_tpu.disco.tiles import LeaderPackTile as JLeaderPackTile
    outs = []
    for tile in (lt.LeaderPackTile(), JLeaderPackTile()):
        ctx = _Ctx(dict(max_txn=4, max_pending=8, block_us=10**9,
                        native_pack=native_pack))
        tile.init(ctx)
        assert tile.pack.native == bool(native_pack)
        for w in _pack_txns():
            tile.on_frag(ctx, 0, None, w)
        tile.house(ctx)
        assert tile.drain(ctx) is True
        tile.fini(ctx)
        outs.append((ctx.out, dict(ctx.metrics.d)))
    assert outs[0] == outs[1]
    out, m = outs[0]
    assert m["parse_fail_cnt"] == 1 and m["txn_in_cnt"] == 13
    assert [s for _, s in out] == list(range(len(out)))
    got = [t for p, _ in out for t in entry_lib.deserialize_txn_batch(p)[0]]
    assert sorted(got) == sorted(w for w in _pack_txns() if w[0] == 1
                                 and len(w) > 20)


def test_leader_pack_tile_refuses_what_is_not_ported():
    # the sharded pack boots: shard 1 of 2 keeps its fee-payer partition
    # and publishes the merge wire (tests/test_torch_leader_shard.py
    # holds both against the JAX tiles)
    ctx = _Ctx(dict(shard_cnt=2, shard_idx=1, native_pack=0))
    tile = lt.LeaderPackTile()
    tile.init(ctx)
    ws = _pack_txns()
    for w in ws:
        tile.on_frag(ctx, 0, None, w)
    tile.fini(ctx)
    owned = [w for w in ws if (txn_lib.fee_payer(w) is not None and
             lt.pack_lib.acct_key(txn_lib.fee_payer(w)) % 2 == 1)]
    assert ctx.metrics.d["shard_steer_cnt"] == len(owned) > 0
    hdr = lt.LeaderPackTile.MERGE_HDR
    inner = [p[hdr.size + 16 * hdr.unpack_from(p, 0)[0]:] for p, _ in ctx.out]
    got = [t for p in inner for t in entry_lib.deserialize_txn_batch(p)[0]]
    assert got and set(got) <= set(owned)
    with pytest.raises(ValueError):
        lt.LeaderPackTile().init(_Ctx(dict(native_pack=2)))


# --------------------------------------- both tiles under the Mux vs JAX

def _published(jt, link):
    lnk = jt.links[link]
    mc, dc = lnk.mcache, lnk.dcache
    out = []
    for seq in range(mc.seq0(), mc.seq_query()):
        rc, m = mc.query(seq)
        assert rc == 0
        out.append((dc.read(int(m["chunk"]), int(m["sz"])), int(m["sig"])))
    return out


def _arena(wires):
    offs = np.zeros(len(wires) + 1, np.uint32)
    offs[1:] = np.cumsum([len(w) for w in wires])
    return offs.tobytes() + b"".join(wires)


def test_tiles_under_the_mux_equal_the_jax_tiles():
    """leader_pack (packed egress rx, the C scheduler) and poh_dev, each
    under its package's Mux in a thread, on the same three arena frags:
    the same microblock frags; each entry stream re-verifies from the
    seed and carries those microblocks in order; the slot closes at
    halt."""
    from firedancer_tpu.disco import topo as jtopo
    from firedancer_tpu.disco.mux import Mux as JMux
    from firedancer_tpu.disco.tiles import LeaderPackTile as JLeaderPackTile
    from firedancer_tpu.disco.tiles import PohDevTile as JPohDevTile

    wires = [w for w in _pack_txns() if len(w) > 20]
    groups = [wires[:5], wires[5:6], wires[6:]]
    pack_cfg = dict(packed_egress=1, max_txn=4, max_pending=64,
                    block_us=10**9, native_pack=1)
    poh_cfg = dict(hashes_per_tick=8, ticks_per_slot=4, mb_per_tick=3,
                   spec_ticks=2, spec_spans=3, mixin_txn_max=4)
    runs = []
    for pkg, mux_cls, pack_tile, poh_tile, extra in (
            (topo_mod, Mux, lt.LeaderPackTile(), lt.PohDevTile(),
             dict(device="cpu")),
            (jtopo, JMux, JLeaderPackTile(), JPohDevTile(),
             dict(unroll=4))):
        spec = (pkg.TopoBuilder(f"tlm{len(runs)}{os.getpid()}", wksp_mb=32)
                .link("v_p", depth=16, mtu=8192)
                .link("p_d", depth=256, mtu=4 + 4 * 1284)
                .link("d_s", depth=2048, mtu=48 + 4 * 1284)
                .tile("src", "sink", outs=["v_p"])
                .tile("pack", "leader_pack", ins=["v_p"], outs=["p_d"],
                      **pack_cfg)
                .tile("poh", "poh_dev", ins=["p_d"], outs=["d_s"],
                      **poh_cfg, **extra)
                .tile("s", "sink", ins=[pkg.InLink("d_s", reliable=False)])
                .build())
        jt = pkg.create(spec)
        try:
            ths = [threading.Thread(target=mux_cls(jt, name, tile).run,
                                    daemon=True)
                   for name, tile in (("pack", pack_tile), ("poh", poh_tile))]
            for th in ths:
                th.start()
            for name in ("pack", "poh"):
                _wait(lambda: jt.cnc[name].signal_query() == Cnc.SIGNAL_RUN,
                      120, f"{name} RUN")
            # one frag at a time, each taken before the next: the pack
            # tile schedules once a burst, so burst boundaries that the
            # poll's timing drew would change the microblocks
            lnk = jt.links["v_p"]
            chunk, taken = lnk.dcache.chunk0, 0
            for g in groups:
                nxt = lnk.dcache.write(chunk, _arena(g))
                lnk.mcache.publish(0, chunk, len(g))
                chunk = nxt
                taken += len(g)
                _wait(lambda: jt.metrics["pack"].snapshot()["txn_in_cnt"]
                      == taken, 60, "the pack tile taking the frag")

            def absorbed():
                pm = jt.metrics["pack"].snapshot()
                dm = jt.metrics["poh"].snapshot()
                return (pm["txn_in_cnt"] == len(wires) and pm["pending"] == 0
                        and dm["mb_rx_cnt"] == pm["microblock_cnt"]
                        and dm["mixin_cnt"] == pm["microblock_cnt"])

            _wait(absorbed, 120, "every microblock mixed into the chain")
            for name in ("pack", "poh"):
                jt.cnc[name].signal(Cnc.SIGNAL_HALT)
            for th in ths:
                th.join(60)
                assert not th.is_alive()
            runs.append((_published(jt, "p_d"), _published(jt, "d_s"),
                         jt.metrics["poh"].snapshot()["recheck_fail_cnt"]))
            lnk = None
        finally:
            jt.close()
            jt.unlink()
    (mbs, ents, fails), (jmbs, jents, jfails) = runs
    assert mbs == jmbs
    assert [s for _, s in mbs] == list(range(len(mbs)))
    want = [entry_lib.deserialize_txn_batch(p)[0] for p, _ in mbs]
    assert sorted(t for m in want for t in m) == sorted(wires)
    for frags, verify in ((ents, entry_lib.verify_chain),
                          (jents, jentry.verify_chain)):
        es = _entries(frags)
        assert verify(bytes(32), es)
        assert [e.txns for e in es if e.txns] == want
        assert frags[-1][1] & SLOT_DONE
    assert fails == jfails == 0


# ------------------------------------------- leader-bench in processes

@pytest.fixture
def _one_thread_children(monkeypatch):
    # spawned tile processes do not inherit torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _host_ok(wire) -> bool:
    """The JAX package's host verifier over every signature of a txn."""
    t = txn_lib.parse(wire)
    msg = t.message(wire)
    return all(jed.verify_one_host(s, msg, k) for s, k in
               zip(t.signatures(wire), t.signer_pubkeys(wire)))


def leader_bench_spec(cfg):
    """The leader-bench topology of `cfg`, with a second in-link into
    verify:0 that a caller writes by hand (its producer a sink-kind tile
    that publishes nothing)."""
    spec = app_config.build_topology(cfg)
    tiles = tuple(
        dataclasses.replace(t, in_links=t.in_links
                            + (topo_mod.InLink("inj_verify"),))
        if t.name == "verify:0" else t for t in spec.tiles)
    return dataclasses.replace(
        spec, links=spec.links + (topo_mod.LinkSpec("inj_verify", 256,
                                                    1280),),
        tiles=(topo_mod.TileSpec("inj", "sink", (), ("inj_verify",), {}),)
        + tiles).validate()


def test_leader_bench_in_processes(tmp_path, _one_thread_children,
                                  monkeypatch):
    """leader-bench at small [leader] sizes, every tile a spawned process
    on device "cpu": 24 source txns plus 8 valid and 8 forged injected.
    The sink's entries re-verify from the seed (verify_chain, and the
    port's and the JAX package's verify_entries_fit), every txn the host
    verifier passes appears exactly once and no other, the last entry of
    each slot carries SLOT_DONE_BIT, and every tile exits 0.  The
    poh_dev tile's drain manifest records its dispatches and no kernel
    launch (the plain versions run on the CPU)."""
    n, seed = 24, 42
    monkeypatch.setenv("FDTPU_DRAIN_DIR", str(tmp_path / "drain"))
    cap = tmp_path / "entries.bin"
    cfg = app_config.load(environ={})
    cfg["name"] = f"tlb{os.getpid()}"
    cfg["topology"] = "leader-bench"
    cfg["development"].update(source_count=n, bench_seed=seed)
    cfg["tiles"]["verify"].update(device="cpu", buckets=[[16, 256]],
                                  flush_age_ns=20_000_000)
    cfg["leader"].update(hashes_per_tick=4, ticks_per_slot=4, mb_per_tick=3,
                         mixin_txn_max=8, capture_path=str(cap),
                         device="cpu")
    cfg["supervision"]["drain_timeout_s"] = 60.0
    spec = leader_bench_spec(cfg)
    src = [w for _, w in source_txn_stream(seed, 4, n)]
    forged = []
    for _, w in source_txn_stream(8, 4, 8):
        b = bytearray(w)
        b[1 + 40] ^= 1
        forged.append(bytes(b))
    inj = [w for _, w in source_txn_stream(7, 4, 8)] + forged
    inj = [inj[i] for i in np.random.default_rng(9).permutation(len(inj))]
    want = sorted(w for w in src + inj if _host_ok(w))
    assert len(want) == n + 8
    run = TopoRun(spec)
    try:
        run.wait_ready(timeout=180)
        lnk = run.jt.links["inj_verify"]
        lens = np.array([len(w) for w in inj], np.int32)
        starts = np.zeros(len(inj), np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        sigs = np.array([int.from_bytes(w[1:9], "little") & ((1 << 63) - 1)
                         for w in inj], np.uint64)
        tx_burst(lnk.mcache, lnk.dcache, lnk.dcache.chunk0, b"".join(inj),
                 starts, lens, sigs)
        lnk = None

        def mixed():
            assert run.poll() is None, "a tile failed"
            pm, dm = run.metrics("leader_pack"), run.metrics("poh_dev")
            return (pm["sched_txn_cnt"] == len(want)
                    and dm["mixin_cnt"] == pm["microblock_cnt"])

        _wait(mixed, 180, "every valid txn mixed into the chain")
        assert run.drain(60.0) is True
        assert run.exitcodes == {t.name: 0 for t in spec.tiles}
        pd = run.metrics("poh_dev")
        assert pd["recheck_fail_cnt"] == pd["parse_fail_cnt"] == 0
        assert pd["recheck_ok_cnt"] > 0 and pd["spec_hit_cnt"] > 0
        assert run.metrics("leader_pack")["parse_fail_cnt"] == 0
        assert run.metrics("verify:0")["verify_fail_cnt"] == 8
        st = run._load_drain_manifest("poh_dev")["tile_state"]
        assert st["launches"] == {"poh_spans": 0, "mixin_tree": 0}
        assert 0 < st["dispatch_cnt"] <= pd["dispatch_cnt"]
        assert 0 < st["splice_dispatch_cnt"] <= pd["splice_dispatch_cnt"]
    finally:
        run.close()
    recs = read_capture(str(cap))
    entries = [entry_lib.Entry.deserialize(p)[0] for _, p in recs]
    assert entry_lib.verify_chain(bytes(32), entries)
    assert sorted(t for e in entries for t in e.txns) == want
    # the done bit marks each slot's last entry (the sink may halt before
    # the slot that fini closes reaches it)
    slots = [s & ~SLOT_DONE for s, _ in recs]
    assert len(set(slots)) > 1
    for i, (s, _) in enumerate(recs[:-1]):
        assert bool(s & SLOT_DONE) == (slots[i + 1] != slots[i])
    # the batched re-check over the same stream, both packages
    k = len(entries)
    starts = np.zeros((k, 32), np.uint8)
    nums = np.zeros((k,), np.int32)
    mixins = np.zeros((k, 32), np.uint8)
    has = np.zeros((k,), np.bool_)
    prev = bytes(32)
    for i, e in enumerate(entries):
        starts[i] = np.frombuffer(prev, np.uint8)
        nums[i] = e.num_hashes
        if not e.is_tick:
            mixins[i] = np.frombuffer(entry_lib.txn_mixin(e.txns), np.uint8)
            has[i] = True
        prev = e.hash
    got = poh_lib.verify_entries_fit(starts, nums, mixins, has, 4,
                                     device="cpu").numpy()
    assert np.array_equal(got, np.asarray(jpoh.verify_entries_fit(
        starts, nums, mixins, has, max_hashes=4)))
    assert [bytes(g) for g in got] == [e.hash for e in entries]


def test_leader_bench_config_boots_and_refuses_shards():
    cfg = app_config.load(environ={})
    cfg["topology"] = "leader-bench"
    spec = app_config.build_topology(cfg)
    assert [t.kind for t in spec.tiles] == ["source", "verify", "leader_pack",
                                           "poh_dev", "sink"]
    poh = [t for t in spec.tiles if t.kind == "poh_dev"][0].cfg
    assert (poh["hashes_per_tick"], poh["ticks_per_slot"],
            poh["spec_ticks"], poh["mb_per_tick"]) == (16, 8, 4, 8)
    # the sharded pack boots: two fee-payer shards merged before poh_dev
    cfg["leader"]["pack_shards"] = 2
    spec = app_config.build_topology(cfg)
    assert [(t.name, t.kind) for t in spec.tiles][2:5] == [
        ("leader_pack:0", "leader_pack"), ("leader_pack:1", "leader_pack"),
        ("leader_merge", "leader_merge")]
    merge = [t for t in spec.tiles if t.kind == "leader_merge"][0]
    assert [il.link for il in merge.in_links] == ["pack_merge:0",
                                                   "pack_merge:1"]
    assert list(merge.out_links) == ["pack_poh"]
    # the JAX package's XLA scan unroll has no counterpart in the kernel
    with pytest.raises(NotImplementedError, match="unroll"):
        app_config.load(environ={"FDTPU_LEADER_UNROLL": "8"})
