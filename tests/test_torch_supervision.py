"""The port's supervisor (firedancer_tpu_torch/disco/run.py) against the
JAX package's: SupervisionPolicy from the config and its backoff; poll()
and /healthz over every state, draining included, with the heartbeats
stamped on an injected clock (no sleep against a margin); the Mux's
resume from the fseq cursor; and, in processes on device "cpu", a
respawn after an injected kill with no verdict published twice, a
rolling restart with none lost, and a SIGTERM drain through the
supervise loop."""

import os
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from firedancer_tpu.app import config as jconfig
from firedancer_tpu.disco.run import SupervisionPolicy as JPolicy
from firedancer_tpu_torch.app import config as pconfig
from firedancer_tpu_torch.disco import flightrec
from firedancer_tpu_torch.disco import topo as topo_mod
from firedancer_tpu_torch.disco.mux import Mux
from firedancer_tpu_torch.disco.run import SupervisionPolicy, TopoRun
from firedancer_tpu_torch.disco.tiles import read_capture, source_txn_stream
from firedancer_tpu_torch.disco.topo import TopoBuilder
from firedancer_tpu_torch.tango.ring import Cnc, tx_burst


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    # spawned tile processes do not inherit torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _wait(pred, timeout_s, what=""):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {what}")


_FIELDS = ("restart_policy", "max_restarts", "backoff_initial_s",
           "backoff_max_s", "backoff_jitter", "boot_grace_s",
           "heartbeat_stale_s", "heartbeat_stale_by_kind",
           "device_fail_threshold", "device_retry", "device_deadline_s",
           "device_reprobe_s", "drain_timeout_s", "drain_manifest_dir")


@pytest.mark.parametrize("sup", [
    None,
    {"restart_policy": "respawn", "max_restarts": "2",
     "backoff_initial_s": "0.01", "heartbeat_stale_s": "1.5",
     "heartbeat_stale": {"verify": "3"}, "device_retry": "0",
     "device_deadline_s": "0.5"},
])
def test_policy_from_cfg_equals_the_jax_package(sup):
    if sup is None:
        p = SupervisionPolicy.from_cfg(pconfig.load(environ={}))
        j = JPolicy.from_cfg(jconfig.load(environ={}))
    else:
        p = SupervisionPolicy.from_cfg({"supervision": sup})
        j = JPolicy.from_cfg({"supervision": sup})
    assert [getattr(p, f) for f in _FIELDS] == [getattr(j, f)
                                                for f in _FIELDS]
    for kind in ("verify", "net", None):
        assert p.stale_ns(kind) == j.stale_ns(kind)


def test_backoff_equals_the_jax_package():
    for kw in ({}, {"backoff_initial_s": 0.5, "backoff_max_s": 4.0,
                    "backoff_jitter": 0.0}):
        p, j = SupervisionPolicy(**kw), JPolicy(**kw)
        for tile in ("verify:0", "verify:1", ""):
            got = [p.backoff_s(a, tile) for a in range(1, 12)]
            assert got == [j.backoff_s(a, tile) for a in range(1, 12)]
    p = SupervisionPolicy()
    for a in range(1, 12):
        base = min(0.25 * 2 ** (a - 1), 8.0)
        assert base * 0.8 <= p.backoff_s(a, "verify:0") <= base * 1.2
    assert p.backoff_s(3, "verify:0") != p.backoff_s(3, "verify:1")


def _mini_spec(tag: str):
    return (TopoBuilder(f"tsv{tag}{os.getpid()}", wksp_mb=8)
            .link("a_b", depth=64, mtu=256)
            .tile("src", "sink", outs=["a_b"])
            .tile("v:0", "verify", ins=["a_b"])
            .build())


class _FakeProc:
    def __init__(self, alive=True):
        self._alive = alive
        self.exitcode = None if alive else 1

    def is_alive(self):
        return self._alive

    def join(self, *a):
        pass

    def terminate(self):
        self._alive = False
        self.exitcode = 0

    def kill(self):
        self.terminate()


class _Clock:
    def __init__(self):
        self.t = 10 ** 15

    def __call__(self):
        return self.t


def _fake_run(tag, **policy):
    clock = _Clock()
    run = TopoRun(_mini_spec(tag), start=False, metrics_port=0,
                  policy=SupervisionPolicy(**policy), clock_ns=clock)
    run.procs = {"src": _FakeProc(), "v:0": _FakeProc()}
    return run, clock


def _get(run, path):
    """(status, body) of one GET on the run's endpoint."""
    url = f"http://127.0.0.1:{run.metrics_port}{path}"
    try:
        r = urllib.request.urlopen(url, timeout=60)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_poll_and_healthz_states_on_an_injected_clock():
    run, clock = _fake_run("hz", heartbeat_stale_s=0.05,
                           heartbeat_stale_by_kind={"verify": 30.0})
    try:
        def health():
            code, body = run.http.health()
            return code, body.decode().split("\n")[0]

        # tiles still in BOOT within grace: poll holds fire, /healthz 503
        assert run.poll() is None
        assert health() == (503, "unhealthy")
        code, body = _get(run, "/healthz")
        assert code == 503 and body.startswith("unhealthy\n")
        # everything RUN with fresh heartbeats: healthy
        for cnc in run.jt.cnc.values():
            cnc.signal(Cnc.SIGNAL_RUN)
            cnc.heartbeat(clock.t)
        assert run.poll() is None
        code, body = _get(run, "/healthz")
        assert code == 200 and body.startswith("ok\n") and "slo " in body
        # a degraded verify tile: 200, flagged
        run.jt.metrics["v:0"].set("degraded_mode", 1)
        code, body = health()
        assert code == 200 and body == "degraded"
        assert b"v:0" in run.http.health()[1]
        run.jt.metrics["v:0"].set("degraded_mode", 0)
        # per-kind staleness: 0.2 s on the clock is past src's 50 ms, not
        # past the verify tile's 30 s
        clock.t += int(0.2e9)
        assert run.poll() == "src"
        code, body = run.http.health()
        assert code == 503 and b"src" in body and b"v:0" not in body
        # a dead process beats everything
        run.jt.cnc["src"].heartbeat(clock.t)
        run.procs["src"]._alive = False
        assert run.poll() == "src"
        # a tile wedged in BOOT past its grace window is a failure too
        run.procs["src"]._alive = True
        run.jt.cnc["src"].signal(Cnc.SIGNAL_BOOT)
        run._boot_deadline["src"] = time.monotonic() - 1.0
        assert run.poll() == "src"
    finally:
        run.procs = {}
        run.close()


def test_poll_and_healthz_report_draining_on_an_injected_clock():
    run, clock = _fake_run("dh", heartbeat_stale_s=30.0)
    try:
        for cnc in run.jt.cnc.values():
            cnc.signal(Cnc.SIGNAL_RUN)
            cnc.heartbeat(clock.t)
        # a DRAINing tile with a live heartbeat: poll holds fire, healthz
        # serves 200 "draining"
        run.jt.cnc["v:0"].signal(Cnc.SIGNAL_DRAIN)
        assert run.poll() is None
        code, body = _get(run, "/healthz")
        assert code == 200 and body.startswith("draining\nv:0\n")
        run.jt.cnc["v:0"].signal(Cnc.SIGNAL_DRAINED)
        assert run.poll() is None
        assert run.http.health()[1].startswith(b"draining\n")
        # a wedged drain (stale heartbeat) is still a failure
        run.jt.cnc["v:0"].signal(Cnc.SIGNAL_DRAIN)
        clock.t += int(120e9)
        run.jt.cnc["src"].heartbeat(clock.t)
        assert run.poll() == "v:0"
        code, body = run.http.health()
        assert code == 503 and b"v:0: stale heartbeat (draining)" in body
        # a tile mid drain is exempt from poll entirely, even reaped
        run._draining.add("v:0")
        run.procs["v:0"]._alive = False
        assert run.poll() is None
        run._draining.discard("v:0")
        assert run.poll() == "v:0"
    finally:
        run.procs = {}
        run.close()


def test_metrics_endpoint_renders_the_blocks_and_the_supervisor():
    run, clock = _fake_run("me")
    try:
        run.jt.metrics["v:0"].set("device_fail_cnt", 3)
        code, body = _get(run, "/metrics")
        assert code == 200
        assert 'fdtpu_device_fail_cnt{tile="v:0",kind="verify"} 3' in body
        assert "fdtpu_flightrec_evict_cnt{} 0" in body
        assert 'fdtpu_link_lag{link="a_b",producer="src",consumer="v:0"}' \
            in body
        assert _get(run, "/nope")[0] == 404
    finally:
        run.procs = {}
        run.close()


def test_mux_respawn_resumes_from_the_fseq_cursor():
    spec = _mini_spec("rs")
    jt = topo_mod.create(spec)
    try:
        mc = jt.links["a_b"].mcache
        for i in range(10):
            mc.publish(i)
        fseq = jt.fseq[("v:0", "a_b")]
        cursor = mc.seq_query() - 3
        fseq.update(cursor)

        class _Vt:
            pass

        m0 = Mux(jt, "v:0", _Vt())              # first boot: from seq0
        assert m0.ins[0].seq == mc.seq0()
        assert m0.fault is None and m0.restart_cnt == 0
        m1 = Mux(jt, "v:0", _Vt(), restart_cnt=1)
        assert m1.ins[0].seq == cursor          # respawn: from the cursor
        assert m1.restart_cnt == 1
        m0 = m1 = None  # noqa: F841
        import gc
        gc.collect()
    finally:
        jt.close()
        jt.unlink()


def _inj_spec(tag, tmp_path, n, **vcfg):
    """source -> verify:0 -> dedup -> sink, with a second in-link of the
    verify tile that the test writes by hand (its producer a sink-kind
    tile that publishes nothing)."""
    return (TopoBuilder(f"tsv{tag}{os.getpid()}", wksp_mb=16)
            .link("src_verify", depth=4096, mtu=1280)
            .link("inj_verify", depth=256, mtu=1280)
            .link("verify_dedup", depth=256, mtu=1280)
            .link("dedup_sink", depth=256, mtu=1280)
            .tile("source", "source", outs=["src_verify"], count=n, seed=5,
                  rate_ns=20_000_000)
            .tile("inj", "sink", outs=["inj_verify"])
            .tile("verify:0", "verify", ins=["src_verify", "inj_verify"],
                  outs=["verify_dedup"], device="cpu", buckets=[[16, 256]],
                  flush_age_ns=10_000_000, **vcfg)
            .tile("dedup", "dedup", ins=["verify_dedup"], outs=["dedup_sink"])
            .tile("sink", "sink", ins=["dedup_sink"],
                  capture_path=str(tmp_path / "cap.bin"))
            .build())


def _inject(run, wires):
    lnk = run.jt.links["inj_verify"]
    lens = np.array([len(w) for w in wires], np.int32)
    starts = np.zeros(len(wires), np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    sigs = np.array([int.from_bytes(w[1:9], "little") & ((1 << 63) - 1)
                     for w in wires], np.uint64)
    tx_burst(lnk.mcache, lnk.dcache, lnk.dcache.chunk0, b"".join(wires),
             starts, lens, sigs)


def test_respawn_after_an_injected_kill_publishes_no_verdict_twice(tmp_path):
    """verify:0 is killed before its 16th frag (kill_after_frags:16,boot:0)
    under restart_policy respawn: the supervisor writes a respawn bundle,
    respawns it once, and the new incarnation runs fault-free from its
    fseq cursor.  The sink captures no txn twice, the lost txns are one
    run of the source's stream (the outage window), and txns injected
    after the respawn all arrive."""
    n = 40
    spec = _inj_spec("rp", tmp_path, n,
                     faults="verify:0=kill_after_frags:16,boot:0")
    policy = SupervisionPolicy(restart_policy="respawn", max_restarts=2,
                               backoff_initial_s=0.05, backoff_jitter=0.0,
                               drain_timeout_s=60.0)
    flight = tmp_path / "flight"
    run = TopoRun(spec, policy=policy, flight_dir=str(flight))
    sup = threading.Thread(target=run.supervise, kwargs={"poll_s": 0.02},
                           daemon=True)
    try:
        run.wait_ready(timeout=120)
        p0 = run.procs["verify:0"]
        sup.start()
        _wait(lambda: not p0.is_alive(), 60, "the injected kill")
        assert p0.exitcode == 86
        _wait(lambda: (run.procs["verify:0"] is not p0
                       and run.jt.cnc["verify:0"].signal_query()
                       == Cnc.SIGNAL_RUN), 120, "the respawned RUN")
        assert run.restarts == {"verify:0": 1}
        late = [w for _, w in source_txn_stream(77, 4, 8)]
        _inject(run, late)
        cap = tmp_path / "cap.bin"
        _wait(lambda: run.metrics("source")["txn_gen_cnt"] == n
              and sum(w in late for _, w in read_capture(str(cap))) == 8,
              120, "the injected txns at the sink")
        run._drain_req = True
        sup.join(120)
        assert not sup.is_alive()
        assert run.exitcodes == {t.name: 0 for t in spec.tiles}
        got = [w for _, w in read_capture(str(cap))]
        assert len(got) == len(set(got)), "a verdict published twice"
        assert run.metrics("dedup")["dup_drop_cnt"] == 0
        stream = [w for _, w in source_txn_stream(5, 4, n)]
        assert set(got) <= set(stream) | set(late)
        assert set(late) <= set(got)
        kept = [w in set(got) for w in stream]
        lost = [i for i, k in enumerate(kept) if not k]
        assert lost and lost == list(range(lost[0], lost[-1] + 1))
        reasons = sorted(flightrec.load_bundle(str(flight / d))["manifest"]
                         ["reason"] for d in os.listdir(flight))
        assert reasons == ["respawn"]
    finally:
        run._halting = True
        if sup.is_alive():
            sup.join(30)
        run.close()


def _packed_rows(wires, rows, ml):
    """One packed-wire frag: the wires in the device blob row layout
    (msg | sig | pub | len-le32), zero rows after them."""
    from firedancer_tpu_torch.ballet import txn as txn_lib
    from firedancer_tpu_torch.tango.ring import PACKED_ROW_EXTRA
    blk = np.zeros((rows, ml + PACKED_ROW_EXTRA), np.uint8)
    for j, w in enumerate(wires):
        t = txn_lib.parse(w)
        msg = t.message(w)
        blk[j, :len(msg)] = np.frombuffer(msg, np.uint8)
        blk[j, ml:] = np.frombuffer(w[1:65] + t.signer_pubkeys(w)[0]
                                    + np.int32(len(msg)).tobytes(), np.uint8)
    return blk


def test_packed_wire_respawn_loses_only_the_frags_of_the_outage(tmp_path):
    """A packed_wire verify:0 killed before its 6th frag
    (kill_after_frags:6,boot:0) under restart_policy respawn: of the
    frags across the kill the tile took the two ahead of the doomed one
    (their credits held until the verdict) and acked the rest unread.  A
    taken frag is verdicted whole or lost whole, in dispatch order; no
    txn reaches the sink twice, and frags written after the respawn all
    arrive."""
    from firedancer_tpu_torch.tango.ring import packed_row_ml
    rows, ml, per = 8, packed_row_ml(256), 2
    stride = ml + 100
    spec = (TopoBuilder(f"tsvpw{os.getpid()}", wksp_mb=16)
            .link("inj_verify", depth=32, mtu=rows * stride)
            .link("verify_dedup", depth=256, mtu=1280)
            .link("dedup_sink", depth=256, mtu=1280)
            .tile("inj", "sink", outs=["inj_verify"])
            .tile("verify:0", "verify", ins=["inj_verify"],
                  outs=["verify_dedup"], device="cpu", packed_wire=1,
                  buckets=[[rows, ml]],
                  faults="verify:0=kill_after_frags:6,boot:0")
            .tile("dedup", "dedup", ins=["verify_dedup"], outs=["dedup_sink"])
            .tile("sink", "sink", ins=["dedup_sink"],
                  capture_path=str(tmp_path / "cap.bin"))
            .build())
    wires = [w for _, w in source_txn_stream(91, 4, 14 * per)]
    frags = [wires[i:i + per] for i in range(0, len(wires), per)]
    first, cross, late = frags[:3], frags[3:11], frags[11:]
    policy = SupervisionPolicy(restart_policy="respawn", max_restarts=2,
                               backoff_initial_s=0.05, backoff_jitter=0.0,
                               drain_timeout_s=60.0)
    run = TopoRun(spec, policy=policy)
    sup = threading.Thread(target=run.supervise, kwargs={"poll_s": 0.02},
                           daemon=True)
    cap = tmp_path / "cap.bin"
    at = {"chunk": None}

    def inject(batch):
        lnk = run.jt.links["inj_verify"]
        if at["chunk"] is None:
            at["chunk"] = lnk.dcache.chunk0
        metas = []
        for f in batch:
            blk = _packed_rows(f, rows, ml)
            chunk = at["chunk"]
            lnk.dcache.write_view(chunk, blk.nbytes)[:] = blk.ravel()
            at["chunk"] = lnk.dcache.advance(chunk, blk.nbytes)
            metas.append((chunk, int.from_bytes(f[0][1:9], "little")
                          & ((1 << 63) - 1), len(f)))
        for chunk, sig, n in metas:
            lnk.mcache.publish(sig=sig, chunk=chunk, sz=n)

    def got():
        return [w for _, w in read_capture(str(cap))]

    try:
        run.wait_ready(timeout=120)
        p0 = run.procs["verify:0"]
        sup.start()
        inject(first)
        _wait(lambda: len(got()) == 3 * per, 60, "the first frags")
        inject(cross)
        _wait(lambda: not p0.is_alive(), 60, "the injected kill")
        assert p0.exitcode == 86
        _wait(lambda: (run.procs["verify:0"] is not p0
                       and run.jt.cnc["verify:0"].signal_query()
                       == Cnc.SIGNAL_RUN), 120, "the respawned RUN")
        inject(late)
        _wait(lambda: {w for f in late for w in f} <= set(got()), 120,
              "the frags written after the respawn")
        run._drain_req = True
        sup.join(120)
        assert not sup.is_alive()
        assert run.exitcodes == {t.name: 0 for t in spec.tiles}
        assert run.restarts == {"verify:0": 1}
        out = got()
        assert len(out) == len(set(out)), "a verdict published twice"
        assert run.metrics("dedup")["dup_drop_cnt"] == 0
        done = [sum(w in set(out) for w in f) for f in cross]
        n_done = sum(d == per for d in done)
        assert done == [per] * n_done + [0] * (len(cross) - n_done)
        assert n_done <= 2            # the frags taken before the kill
        assert set(out) == {w for f in first + cross[:n_done] + late
                            for w in f}
    finally:
        run._halting = True
        if sup.is_alive():
            sup.join(30)
        run.close()


def test_rolling_restart_loses_no_txn(tmp_path):
    """A rolling restart of verify:0 mid-stream with a new flush age: the
    drain parks it with a manifest, the successor resumes from the
    drained cursor, and every txn of the stream reaches the sink once."""
    n = 48
    spec = _inj_spec("rr", tmp_path, n)
    policy = SupervisionPolicy(drain_timeout_s=60.0,
                               drain_manifest_dir=str(tmp_path / "man"))
    run = TopoRun(spec, policy=policy)
    try:
        run.wait_ready(timeout=120)
        _wait(lambda: run.metrics("verify:0")["txn_in_cnt"] >= 8, 60,
              "some txns verified")
        assert run.rolling_restart("verify:0",
                                   {"flush_age_ns": 5_000_000}) is True
        assert run.restarts == {"verify:0": 1}
        assert run.spec.tiles[2].cfg["flush_age_ns"] == 5_000_000
        run.wait_ready(timeout=120)
        cap = tmp_path / "cap.bin"
        _wait(lambda: len(read_capture(str(cap))) == n, 120,
              "the whole stream at the sink")
        assert run.drain() is True
        got = sorted(read_capture(str(cap)))
        assert got == sorted(source_txn_stream(5, 4, n))
        assert run.metrics("dedup")["dup_drop_cnt"] == 0
    finally:
        run.close()


def test_sigterm_drains_through_the_supervise_loop(tmp_path):
    """SIGTERM to a supervisor with drain configured: the handler asks
    for a drain, supervise() drains in dependency order and returns
    None, every tile exits 0 with every txn verdicted, and close() puts
    the handlers back."""
    n = 24
    spec = _inj_spec("st", tmp_path, n)
    before = signal.getsignal(signal.SIGTERM)
    run = TopoRun(spec, policy=SupervisionPolicy(drain_timeout_s=60.0))
    try:
        assert signal.getsignal(signal.SIGTERM) is not before
        run.wait_ready(timeout=120)
        cap = tmp_path / "cap.bin"
        _wait(lambda: len(read_capture(str(cap))) == n, 120,
              "the whole stream at the sink")
        threading.Timer(0.2, os.kill, (os.getpid(), signal.SIGTERM)).start()
        assert run.supervise(poll_s=0.02) is None
        assert run.exitcodes == {t.name: 0 for t in spec.tiles}
        assert sorted(read_capture(str(cap))) == sorted(
            source_txn_stream(5, 4, n))
        assert any("signal-initiated topology drain" in e
                   for e in run.events)
    finally:
        run.close()
    assert signal.getsignal(signal.SIGTERM) is before
