"""The verify tile's self-healing guard in the port
(firedancer_tpu_torch/disco/pipeline.py GuardedVerifier) against the JAX
package's: the state machine (retries, per-batch fallback, degraded mode,
re-probe, the harvest deadline) on a scripted fake device with an
injected clock, case by case in both packages; the host fallback
(models/verifier.py host_verify_blob) bit for bit against the port's
SigVerifier on device "cpu" and the JAX package's host verifier, on
seeded rows and the golden corpus; and the port's verify tile under an
injected dispatch failure, which degrades and recovers with its accepted
set unchanged."""

import json
import os

import numpy as np
import pytest
import torch

from firedancer_tpu.disco import faultinject as jfi
from firedancer_tpu.disco import pipeline as jpl
from firedancer_tpu.models import verifier as jver
from firedancer_tpu_torch.disco import faultinject as pfi
from firedancer_tpu_torch.disco import pipeline as ppl
from firedancer_tpu_torch.disco.tiles import source_txn_stream
from firedancer_tpu_torch.disco.verify_tile import VerifyTile
from firedancer_tpu_torch.models import verifier as pver
from firedancer_tpu_torch.ops import ed25519 as ed
from _torch_threads import one_torch_thread  # noqa: F401

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PKGS = {"port": (ppl, pfi), "jax": (jpl, jfi)}


def _host_odd(blob, maxlen=None):
    # a deterministic fake host backend: odd lanes pass
    return np.arange(len(blob)) % 2 == 1


class _FlakyFn:
    """A fake device verifier with scripted per-call behavior, on the
    surface both packages' guards wrap for the tile (dispatch_blob)."""

    mode = "strict"

    def __init__(self, script, device=None):
        self.script = list(script)  # "ok" | "raise" | "hang"
        self.calls = 0
        if device is not None:
            self.device = device

    def dispatch_blob(self, blob, maxlen=None):
        mode = self.script[min(self.calls, len(self.script) - 1)]
        self.calls += 1
        if mode == "raise":
            raise RuntimeError("injected device loss")
        if mode == "hang":
            return _Hung()
        return np.ones(len(blob), dtype=bool)


class _Hung:
    def is_ready(self):
        return False

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("device gone")


def _gv(pkg, fn, **kw):
    t = [0.0]
    kw.setdefault("clock", lambda: t[0])
    kw.setdefault("host_blob", _host_odd)
    return PKGS[pkg][0].GuardedVerifier(fn, **kw), t


def _blob(n=8):
    return np.zeros((n, 4), np.uint8)


def _state(g):
    return (g.degraded, g.device_fail_cnt, g.fallback_lanes, g.reprobe_cnt,
            g._consec, g.fn.calls)


@pytest.mark.parametrize("pkg", PKGS)
def test_retry_masks_a_transient_failure(pkg):
    g, _ = _gv(pkg, _FlakyFn(["raise", "ok"]), retries=1, fail_threshold=3)
    assert np.asarray(g.dispatch_blob(_blob())).all() and not g.degraded
    assert g.device_fail_cnt == 0 and g.fallback_lanes == 0


def _arc(pkg):
    """fallback -> degraded -> failed probe -> recovery, every state."""
    g, t = _gv(pkg, _FlakyFn(["raise"] * 9 + ["ok"]), retries=0,
               fail_threshold=3, reprobe_s=5.0)
    states = []
    for step in range(4):
        ok = np.asarray(g.dispatch_blob(_blob()))
        states.append((ok.tolist(), _state(g), g.fallback_vps()))
    t[0] += 6.0
    np.asarray(g.dispatch_blob(_blob()))
    states.append(_state(g))
    g.fn.script, g.fn.calls = ["ok"], 0
    t[0] += 6.0
    states.append((np.asarray(g.dispatch_blob(_blob())).tolist(),
                   _state(g)))
    states.append(np.asarray(g.dispatch_blob(_blob())).tolist())
    return states


def test_fallback_degraded_recovery_arc_equals_the_jax_package():
    assert _arc("port") == _arc("jax")


@pytest.mark.parametrize("pkg", PKGS)
def test_batch_fallback_then_degraded_then_recovery(pkg):
    g, t = _gv(pkg, _FlakyFn(["raise"] * 9 + ["ok"]), retries=0,
               fail_threshold=3, reprobe_s=5.0)
    expect = _host_odd(_blob())
    for i in range(2):   # failures 1..2: per-batch fallback, still healthy
        assert np.array_equal(np.asarray(g.dispatch_blob(_blob())), expect)
        assert not g.degraded and g.device_fail_cnt == i + 1
    np.asarray(g.dispatch_blob(_blob()))   # failure 3 crosses the threshold
    assert g.degraded and g.device_fail_cnt == 3
    calls0 = g.fn.calls       # degraded: the device fn is not called
    np.asarray(g.dispatch_blob(_blob()))
    assert g.fn.calls == calls0
    assert g.fallback_vps() == 0   # clock frozen: no division by zero
    t[0] += 6.0               # past the reprobe window: the probe fails
    np.asarray(g.dispatch_blob(_blob()))
    assert g.fn.calls == calls0 + 1 and g.degraded and g.reprobe_cnt == 1
    g.fn.script, g.fn.calls = ["ok"], 0
    t[0] += 6.0               # the device heals: the probe recovers
    assert np.asarray(g.dispatch_blob(_blob())).all()
    assert not g.degraded and g._consec == 0
    assert np.asarray(g.dispatch_blob(_blob())).all()


@pytest.mark.parametrize("pkg", PKGS)
def test_harvest_deadline_counts_as_failure(pkg):
    g, t = _gv(pkg, _FlakyFn(["hang"]), retries=0, fail_threshold=2,
               deadline_s=1.0)
    v = g.dispatch_blob(_blob())
    assert not v.is_ready()
    t[0] += 2.0               # past the deadline: the harvest must not hang
    assert v.is_ready()
    assert np.array_equal(np.asarray(v), _host_odd(_blob()))
    assert g.device_fail_cnt == 1 and not g.degraded
    v2 = g.dispatch_blob(_blob())
    t[0] += 2.0
    np.asarray(v2)
    assert g.degraded


@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_zero_disables_the_hang_watchdog(pkg):
    g, t = _gv(pkg, _FlakyFn(["hang"]), retries=0, fail_threshold=2,
               deadline_s=0.0)
    v = g.dispatch_blob(_blob())
    t[0] += 1e6
    assert not v.is_ready()
    v._dev = np.ones(8, dtype=bool)   # the slow device finally completes
    assert v.is_ready() and np.asarray(v).all()
    assert g.device_fail_cnt == 0 and not g.degraded


@pytest.mark.parametrize("pkg", PKGS)
def test_consec_clears_only_on_a_materialized_verdict(pkg):
    g, _ = _gv(pkg, _FlakyFn(["raise", "ok", "raise", "raise"]), retries=0,
               fail_threshold=3)
    np.asarray(g.dispatch_blob(_blob()))
    assert g._consec == 1
    np.asarray(g.dispatch_blob(_blob()))   # a verdict materializes
    assert g._consec == 0
    np.asarray(g.dispatch_blob(_blob()))
    np.asarray(g.dispatch_blob(_blob()))
    assert g._consec == 2 and not g.degraded


@pytest.mark.parametrize("pkg", PKGS)
def test_fault_injection_drives_dispatch(pkg):
    fault = PKGS[pkg][1].FaultInjector("v", {"fail_dispatch_n": 2})
    g, t = _gv(pkg, _FlakyFn(["ok"]), retries=0, fail_threshold=2,
               reprobe_s=1.0, fault=fault)
    assert np.array_equal(np.asarray(g.dispatch_blob(_blob())),
                          _host_odd(_blob()))
    np.asarray(g.dispatch_blob(_blob()))
    assert g.degraded and g.fn.calls == 0   # raised before the device
    t[0] += 2.0
    assert np.asarray(g.dispatch_blob(_blob())).all()
    assert not g.degraded and g.fn.calls == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_surface_mirrors_the_wrapped_fn(pkg):
    g, _ = _gv(pkg, _FlakyFn(["ok"], device="cpu"))
    assert hasattr(g, "dispatch_blob")
    assert g.mode == "strict" and g.device == "cpu"
    assert np.asarray(g.dispatch_blob(np.zeros((4, 8), np.uint8))).shape \
        == (4,)


def _card_guard(script, fault=None, **kw):
    # a fake verifier whose device is the card: torch.device("cuda") is
    # only a name here, nothing touches a GPU
    kw.setdefault("retries", 0)
    return _gv("port", _FlakyFn(script, device=torch.device("cuda")),
               fail_threshold=3, fault=fault, **kw)


def test_card_dispatch_failure_raises_and_never_falls_back():
    g, _ = _card_guard(["raise", "ok"], retries=1)
    assert g.on_card
    assert np.asarray(g.dispatch_blob(_blob())).all()   # a retry masks one
    g.fn.script, g.fn.calls = ["raise"], 0
    with pytest.raises(ppl.DeviceFault, match="injected device loss"):
        g.dispatch_blob(_blob())
    assert g.fn.calls == 2 and g.faulted
    assert (g.device_fail_cnt, g.fallback_lanes, g.degraded,
            g.reprobe_cnt, g.fallback_vps()) == (1, 0, False, 0, 0)


def test_card_late_verdict_raises_and_is_never_read():
    g, t = _card_guard(["hang"], deadline_s=1.0)
    v = g.dispatch_blob(_blob())
    assert not v.is_ready()
    t[0] += 2.0
    assert v.is_ready()
    with pytest.raises(ppl.DeviceFault, match="deadline"):
        np.asarray(v)
    assert (g.device_fail_cnt, g.fallback_lanes, g.degraded) == (1, 0, False)


def test_card_injected_failure_raises_before_the_device():
    fault = pfi.FaultInjector("verify:0", {"fail_dispatch_n": 1})
    g, _ = _card_guard(["ok"], fault=fault)
    with pytest.raises(ppl.DeviceFault, match="injected"):
        g.dispatch_blob(_blob())
    assert g.fn.calls == 0 and g.device_fail_cnt == 1 and g.faulted


def _torsion_blob():
    """A packed blob of one order-2 torsion forgery whose v is even (the
    antipa twin accepts it, the strict one rejects it), an honest row
    and a padding row."""
    from chip_smoke import torsion_forgeries
    msg = bytes(range(32))
    sig, pub, *_ = torsion_forgeries(msg)[0]
    msgs, lens, sigs, pubs = pver.make_example_batch(3, 64, seed=31,
                                                     lens=[32, 32, 0])
    msgs[0, :32] = np.frombuffer(msg, np.uint8)
    sigs[0] = np.frombuffer(sig, np.uint8)
    pubs[0] = np.frombuffer(pub, np.uint8)
    msgs[2], lens[2], sigs[2], pubs[2] = 0, 0, 0, 0
    return pver.pack_blob(msgs, lens, sigs, pubs)


def test_port_host_backend_serves_antipa():
    """host_verify_blob(mode="antipa") is verify_one_host_antipa row by
    row (lengths clamped, padding rows rejected), and the JAX package's
    antipa backend gives the same bits."""
    blob = _torsion_blob()
    got = pver.host_verify_blob(blob, mode="antipa").tolist()
    ml = blob.shape[1] - ed.PACKED_EXTRA
    want = [ed.verify_one_host_antipa(bytes(r[ml:ml + 64]), bytes(r[:32]),
                                      bytes(r[ml + 64:ml + 96]))
            for r in blob[:2]] + [False]
    assert got == want == [True, True, False]
    assert got == jver.host_verify_blob(blob, mode="antipa").tolist()
    assert pver.host_verify_blob(blob).tolist() == [False, True, False]
    with pytest.raises(ValueError, match="unknown verifier mode"):
        pver.host_verify_blob(blob, mode="rlc")


def test_port_guard_fallback_routes_by_mode():
    """On device "cpu" a failed dispatch falls back to the host twin of
    the wrapped verifier's mode: the even-v order-2 forgery reads False
    behind a strict verifier and True behind an antipa one."""
    blob = _torsion_blob()
    bits = {}
    for mode in ("strict", "antipa"):
        sv = pver.SigVerifier(pver.VerifierConfig(4, 64), mode=mode,
                              device="cpu")
        g = ppl.GuardedVerifier(sv, fail_threshold=1, retries=0,
                                fault=pfi.FaultInjector(
                                    "verify:0", {"fail_dispatch_n": 1}))
        bits[mode] = np.asarray(g.dispatch_blob(blob)).tolist()
        assert g.degraded and g.fallback_lanes == 3 and not g.on_card
    assert bits == {"strict": [False, True, False],
                    "antipa": [True, True, False]}


@pytest.fixture(scope="module")
def seeded_blob():
    msgs, lens, sigs, pubs, _ = pver.make_adversarial_batch(22, 96, seed=23)
    lens[3] = 200          # past ml: clamped, as verify_blob clamps
    lens[5] = -4
    return pver.pack_blob(msgs, lens, sigs, pubs)


def test_host_fallback_equals_the_device_path_on_seeded_rows(seeded_blob):
    sv = pver.SigVerifier(pver.VerifierConfig(32, 96), device="cpu")
    dev = np.asarray(sv.dispatch_blob(seeded_blob)).astype(bool)
    host = pver.host_verify_blob(seeded_blob)
    assert host.tolist() == dev.tolist()
    assert host.tolist() == jver.host_verify_blob(seeded_blob).tolist()
    assert host.tolist() == ed.host_verify_blob(seeded_blob)
    assert 0 < host.sum() < len(host)


def test_host_fallback_gives_the_golden_corpus_its_bits():
    vecs = []
    for name in ("wycheproof", "cctv", "malleability"):
        with open(os.path.join(_GOLDEN, f"{name}_ed25519.json")) as f:
            vecs += json.load(f)
    msgs = [bytes.fromhex(v["msg"]) for v in vecs]
    ml = max(map(len, msgs))
    m = np.zeros((len(vecs), ml), np.uint8)
    for i, x in enumerate(msgs):
        m[i, :len(x)] = np.frombuffer(x, np.uint8)
    sigs = np.array([list(bytes.fromhex(v["sig"])) for v in vecs], np.uint8)
    pubs = np.array([list(bytes.fromhex(v["pub"])) for v in vecs], np.uint8)
    blob = pver.pack_blob(m, np.array(list(map(len, msgs)), np.int32),
                          sigs, pubs)
    got = pver.host_verify_blob(blob).tolist()
    assert got == [v["ok"] for v in vecs]
    assert got == jver.host_verify_blob(blob).tolist()


class _Ctx:
    """A recording tile ctx whose `_mux` carries the fault plan, as the
    port's Mux hands the tile its FaultInjector."""

    def __init__(self, cfg, fault=None):
        self.cfg = cfg
        self.trace = None
        self.published = []
        self.vals = {}
        self.metrics = self
        self._mux = type("M", (), {"fault": fault})()

    def set(self, k, v):
        self.vals[k] = v

    def hist_store(self, k, h):
        pass

    def publish_burst(self, buf, starts, lens, sigs):
        buf = bytes(buf)
        for s, n in zip(starts, lens):
            self.published.append(buf[int(s):int(s) + int(n)])


def _tile_accepts(wires, fault=None, **sup):
    """The port tile on device "cpu": wires in bursts of 6, a dispatch
    after each burst; returns (accepted wires, metrics, guard)."""
    cfg = {"device": "cpu", "buckets": [[8, 256]], "flush_age_ns": 0,
           "max_inflight": 0, "supervision": sup}
    tile, ctx = VerifyTile(), _Ctx(cfg, fault)
    tile.init(ctx)
    for lo in range(0, len(wires), 6):
        part = wires[lo:lo + 6]
        offs = np.zeros(len(part) + 1, np.int64)
        np.cumsum([len(w) for w in part], out=offs[1:])
        metas = np.zeros(len(part), dtype=[("sig", np.uint64)])
        tile.on_burst(ctx, 0, metas, np.frombuffer(b"".join(part), np.uint8),
                      offs, len(part))
        tile._forward(ctx, tile.pipe.flush())
        tile._sync_metrics(ctx)
    tile.fini(ctx)
    return ctx.published, ctx.vals, tile.guard


def test_port_tile_degrades_and_recovers_with_the_same_verdicts():
    """fail_dispatch_n:2 with a threshold of 2 and no retry: the first two
    dispatches fail and fall back, the guard degrades, the third dispatch
    probes the healed device and recovers; the accepted wires are those
    of a run without faults, which are the host verifier's."""
    wires = [w for _, w in source_txn_stream(31, 4, 24)]
    for i in (2, 9, 20):                    # forged: a signature bit
        b = bytearray(wires[i])
        b[1 + 40] ^= 1
        wires[i] = bytes(b)
    want, clean, g0 = _tile_accepts(wires)
    assert len(want) == 21
    assert (clean["device_fail_cnt"], clean["fallback_lane_cnt"],
            clean["degraded_mode"], clean["reprobe_cnt"]) == (0, 0, 0, 0)
    fault = pfi.FaultInjector("verify:0", {"fail_dispatch_n": 2})
    got, m, g = _tile_accepts(wires, fault, device_fail_threshold=2,
                              device_retry=0, device_reprobe_s=0.0)
    assert got == want
    assert (m["device_fail_cnt"], m["fallback_lane_cnt"],
            m["degraded_mode"], m["reprobe_cnt"]) == (2, 2 * 8, 0, 1)
    assert fault.dispatch_cnt == 4          # one a burst; fini has none


def test_port_tile_with_a_card_guard_fails_on_a_device_fault():
    """The tile's side of a DeviceFault (the guard set to its card
    behavior, the verifier on the CPU): the fault goes up out of the
    tile's callback, the faulted batch is not published, fini writes the
    metrics and sends nothing more to the verifier, and the next
    incarnation (a new tile, the fault plan spent) verdicts what follows
    as a run without faults does."""
    wires = [w for _, w in source_txn_stream(37, 4, 12)]
    want, _, _ = _tile_accepts(wires[6:])
    fault = pfi.FaultInjector("verify:0", {"fail_dispatch_n": 1})
    cfg = {"device": "cpu", "buckets": [[8, 256]], "flush_age_ns": 0,
           "max_inflight": 0, "supervision": {"device_retry": 0}}
    tile, ctx = VerifyTile(), _Ctx(cfg, fault)
    tile.init(ctx)
    tile.guard.on_card = True
    calls = []
    inner = tile.guard.fn.dispatch_blob
    tile.guard.fn.dispatch_blob = lambda *a, **k: (calls.append(1),
                                                   inner(*a, **k))[1]
    part = wires[:6]
    offs = np.zeros(len(part) + 1, np.int64)
    np.cumsum([len(w) for w in part], out=offs[1:])
    metas = np.zeros(len(part), dtype=[("sig", np.uint64)])
    tile.on_burst(ctx, 0, metas, np.frombuffer(b"".join(part), np.uint8),
                  offs, len(part))
    with pytest.raises(ppl.DeviceFault):
        tile._forward(ctx, tile.pipe.flush())
    tile.fini(ctx)
    assert ctx.published == [] and calls == []
    assert (ctx.vals["device_fail_cnt"], ctx.vals["fallback_lane_cnt"],
            ctx.vals["degraded_mode"]) == (1, 0, 0)
    assert len(want) == 6
    got, m, _ = _tile_accepts(wires[6:], fault)
    assert got == want and m["device_fail_cnt"] == 0
