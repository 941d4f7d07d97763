"""The port's fault injection (firedancer_tpu_torch/disco/faultinject.py)
against the JAX package's: the plan grammar and its kind/exact overlay,
the tile and boot-generation gates, and the decision streams (drops, bit
flips, kills, dispatch failures) that one plan, seed and tile name draw
in each package.  Then the port's Mux arming the plan on its rx paths."""

import os

import numpy as np
import pytest

from firedancer_tpu.disco import faultinject as jfi
from firedancer_tpu_torch.disco import faultinject as pfi
from firedancer_tpu_torch.disco import topo as topo_mod
from firedancer_tpu_torch.disco.mux import Mux
from firedancer_tpu_torch.disco.topo import TopoBuilder
from firedancer_tpu_torch.tango.ring import Cnc

PLANS = [
    "verify=delay_frag_us:50,seed:9; verify:1=kill_after_frags:10,boot:0"
    ";source=drop_frag_p:0.25",
    "verify:0=fail_dispatch_n:3",
    "verify=fail_dispatch_p:0.5,seed:2;dedup=corrupt_payload_p:0.1",
    " ; verify:0 = stall_heartbeat_s:1.5 , boot:1 ;",
    "v:0:kill@3",
]
TILES = ["verify:0", "verify:1", "source", "dedup", "sink"]


@pytest.mark.parametrize("text", PLANS)
def test_parse_and_overlay_equal_the_jax_package(text):
    plans = pfi.parse_plan(text)
    assert plans == jfi.parse_plan(text)
    for tile in TILES:
        assert pfi.plan_for(tile, plans) == jfi.plan_for(tile, plans)


def test_parse_and_overlay_semantics():
    plans = pfi.parse_plan(PLANS[0])
    assert plans["verify"] == {"delay_frag_us": 50, "seed": 9}
    assert plans["source"] == {"drop_frag_p": 0.25}
    # the kind entry applies to every instance; the exact entry overlays
    # it knob by knob
    assert pfi.plan_for("verify:0", plans) == {"delay_frag_us": 50,
                                              "seed": 9}
    assert pfi.plan_for("verify:1", plans) == {
        "delay_frag_us": 50, "seed": 9, "kill_after_frags": 10, "boot": 0}
    assert pfi.plan_for("dedup", plans) is None


@pytest.mark.parametrize("restart_cnt", [0, 1])
def test_for_tile_gating_equals_the_jax_package(restart_cnt):
    env = {"FDTPU_FAULTS": "verify:0=kill_after_frags:5,boot:0"}
    cases = [("dedup", None, env), ("verify:0", None, {}),
             ("verify:0", None, env),
             ("verify:0", {"faults": "verify:0=delay_frag_us:7"}, env),
             ("x", {"faults": {"drop_frag_p": 0.5}}, {}),
             ("verify:0", {"faults": {"boot": 1, "fail_dispatch_n": 2}}, {})]
    for tile, cfg, environ in cases:
        p = pfi.for_tile(tile, cfg, restart_cnt=restart_cnt,
                         environ=environ)
        j = jfi.for_tile(tile, cfg, restart_cnt=restart_cnt,
                         environ=environ)
        assert (p is None) == (j is None), (tile, cfg, environ)
        if p is not None:
            assert p.knobs == j.knobs
    # no plan names the tile -> None (the zero-overhead contract); the
    # boot gate lets a respawned incarnation run fault-free
    assert pfi.for_tile("dedup", environ=env) is None
    assert pfi.for_tile("verify:0", environ=env) is not None
    assert pfi.for_tile("verify:0", restart_cnt=1, environ=env) is None
    f = pfi.for_tile("verify:0", cfg={"faults": "verify:0=delay_frag_us:7"},
                     environ=env)
    assert f._kill_after == 5 and f._delay_s == pytest.approx(7e-6)


@pytest.mark.parametrize("tile,seed", [("verify:0", 4), ("verify:1", 4),
                                       ("dedup", 11)])
def test_frag_streams_equal_the_jax_package(tile, seed):
    knobs = {"drop_frag_p": 0.3, "corrupt_payload_p": 0.3, "seed": seed}
    p, j = pfi.FaultInjector(tile, knobs), jfi.FaultInjector(tile, knobs)
    rng = np.random.default_rng(seed)
    pays = [rng.bytes(int(n)) for n in rng.integers(1, 200, 96)]
    got = [p.frag(x) for x in pays]
    assert got == [j.frag(x) for x in pays]
    drops = sum(1 for _, d in got if d)
    flips = [(x, y) for x, (y, d) in zip(pays, got) if not d and y != x]
    assert drops and flips
    for x, y in flips:
        diff = np.bitwise_xor(np.frombuffer(x, np.uint8),
                              np.frombuffer(y, np.uint8))
        assert int(np.unpackbits(diff).sum()) == 1


class _Dcache:
    """A dcache stand-in over one buffer: view(chunk, n) as the ring's."""

    def __init__(self, buf):
        self.buf = buf

    def view(self, chunk, n):
        return self.buf[chunk:chunk + n]


def test_view_and_burst_streams_equal_the_jax_package():
    knobs = {"drop_frag_p": 0.25, "corrupt_payload_p": 0.4, "seed": 3,
             "kill_after_frags": 1000}
    metas = np.zeros(48, dtype=[("chunk", np.uint64), ("sz", np.uint16)])
    metas["chunk"] = np.arange(48) * 64
    base = np.random.default_rng(5).integers(0, 256, 48 * 64,
                                             dtype=np.uint8)
    bufs = [base.copy(), base.copy()]
    outs = []
    for mod, buf in zip((pfi, jfi), bufs):
        f = mod.FaultInjector("verify:0", knobs)
        kept, nd = f.frags_view(metas.copy(), _Dcache(buf))
        offs = np.arange(0, 48 * 64 + 1, 64)
        take = f.burst(48, buf, offs)
        outs.append((kept.tolist(), nd, take, f.frag_cnt))
    assert outs[0] == outs[1]
    assert np.array_equal(bufs[0], bufs[1])
    assert not np.array_equal(bufs[0], base)
    assert outs[0][1] > 0


def test_kill_fires_before_the_nth_frag(monkeypatch):
    exits = []
    monkeypatch.setattr(pfi.os, "_exit", lambda code: exits.append(code))
    f = pfi.FaultInjector("v", {"kill_after_frags": 3})
    f.frag(b"x")
    f.frag(b"x")
    assert not exits
    f.frag(b"x")  # the 3rd frag is never processed
    assert exits == [pfi.KILL_EXIT_CODE] == [jfi.KILL_EXIT_CODE]


def test_batch_kill_defers_to_the_frag_boundary(monkeypatch):
    exits = []
    monkeypatch.setattr(pfi.os, "_exit", lambda code: exits.append(code))
    f = pfi.FaultInjector("v", {"kill_after_frags": 150})
    assert f.burst(100, None, None) == 100   # wholly under the threshold
    assert not exits
    assert f.burst(100, None, None) == 49    # trimmed to frags 101..149
    assert not exits                         # deferred past the batch
    f.house()                                # the next entry: the kill
    assert exits == [pfi.KILL_EXIT_CODE]


@pytest.mark.parametrize("knobs", [{"fail_dispatch_n": 2},
                                   {"fail_dispatch_p": 0.5, "seed": 7},
                                   {"fail_dispatch_n": 1,
                                    "fail_dispatch_p": 0.3, "seed": 1}])
def test_dispatch_streams_equal_the_jax_package(knobs):
    def stream(mod):
        f = mod.FaultInjector("verify:0", knobs)
        out = []
        for _ in range(32):
            try:
                f.dispatch()
                out.append(None)
            except mod.InjectedDispatchError as e:
                out.append(str(e))
        return out, f.dispatch_cnt
    got = stream(pfi)
    assert got == stream(jfi)
    if knobs.get("fail_dispatch_n") and not knobs.get("fail_dispatch_p"):
        n = knobs["fail_dispatch_n"]
        assert all(got[0][:n]) and not any(got[0][n:])   # then heals


def _spec(tag, **vcfg):
    return (TopoBuilder(f"tfi{tag}{os.getpid()}", wksp_mb=8)
            .link("a_b", depth=64, mtu=256)
            .tile("src", "sink", outs=["a_b"])
            .tile("v:0", "sink", ins=["a_b"], **vcfg)
            .build())


class _Rec:
    def __init__(self):
        self.got = []

    def on_frag(self, ctx, iidx, meta, payload):
        self.got.append(bytes(payload))


def test_mux_drops_what_the_plan_draws():
    """The port's Mux on a plan of drops and bit flips: the scalar rx
    path hands the tile exactly what the JAX injector's stream keeps,
    and counts the drops as filtered frags."""
    plan = "v:0=drop_frag_p:0.3,corrupt_payload_p:0.2,seed:5"
    jt = topo_mod.create(_spec("md", faults=plan))
    try:
        lnk = jt.links["a_b"]
        rng = np.random.default_rng(8)
        pays = [rng.bytes(32) for _ in range(40)]
        chunk = 0
        for i, p in enumerate(pays):
            view = lnk.dcache.write_view(chunk, len(p))
            view[:] = np.frombuffer(p, np.uint8)
            lnk.mcache.publish(sig=i, chunk=chunk, sz=len(p))
            chunk = lnk.dcache.advance(chunk, len(p))
        vt = _Rec()
        mux = Mux(jt, "v:0", vt)
        assert mux.fault is not None
        cnc = jt.cnc["v:0"]

        def stop(*_):
            if len(vt.got) + jt.metrics["v:0"].get("in_filt_cnt") >= 40:
                cnc.signal(Cnc.SIGNAL_HALT)
        vt.after_credit = stop
        mux.run()
        ref = jfi.FaultInjector(
            "v:0", jfi.plan_for("v:0", jfi.parse_plan(plan)))
        want = [p2 for p2, d in (ref.frag(p) for p in pays) if not d]
        assert vt.got == want
        assert jt.metrics["v:0"].get("in_filt_cnt") == len(pays) - len(want)
        mux = None
    finally:
        jt.close()
        jt.unlink()
