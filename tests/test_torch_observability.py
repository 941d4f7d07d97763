"""The port's observability layer against the JAX package's on the same
inputs: chrome_trace, hop_table and SpanRecorder over seeded span
arrays; the SLO engine's stage stats, burn and table; the attribution
samples, families and verdicts and prometheus_render over one workspace
the port creates and the JAX package joins (the layouts are byte for
byte the same); a flight bundle the port writes, rendered through both
packages' render_bundle; and the port's MetricTile serving /metrics."""

import json
import os
import re
import time
import urllib.request

import numpy as np
import pytest

from firedancer_tpu.disco import attrib as jattrib
from firedancer_tpu.disco import flightrec as jflight
from firedancer_tpu.disco import metrics as jmetrics
from firedancer_tpu.disco import slo as jslo
from firedancer_tpu.disco import topo as jtopo
from firedancer_tpu.disco import trace as jtrace
from firedancer_tpu_torch.disco import attrib as pattrib
from firedancer_tpu_torch.disco import flightrec as pflight
from firedancer_tpu_torch.disco import metrics as pmetrics
from firedancer_tpu_torch.disco import slo as pslo
from firedancer_tpu_torch.disco import topo as ptopo
from firedancer_tpu_torch.disco import trace as ptrace
from firedancer_tpu_torch.disco.tiles import TILES
from firedancer_tpu_torch.disco.topo import TopoBuilder
from firedancer_tpu_torch.tango.ring import Cnc, FSeq

KINDS = {"source": "source", "verify:0": "verify", "dedup": "dedup",
         "sink": "sink"}


def _spans(seed: int) -> dict:
    """Seeded span arrays a tile: every span kind, lane-tagged device and
    coalesce spans on the verify tile, hop and age stamps."""
    rng = np.random.default_rng(seed)
    out = {}
    for tile in KINDS:
        n = int(rng.integers(20, 60))
        recs = np.zeros(n, dtype=ptrace.TRACE_REC_DTYPE)
        recs["ts"] = np.sort(rng.integers(10 ** 12, 10 ** 12 + 10 ** 9, n))
        recs["dur"] = rng.integers(0, 5_000_000, n)
        recs["seq"] = np.arange(n)
        recs["hop_ns"] = rng.integers(0, 3_000_000, n)
        recs["age_ns"] = rng.integers(0, 6_000_000, n)
        recs["kind"] = rng.integers(1, 10, n)
        recs["iidx"] = rng.integers(0, 3, n)
        if tile == "verify:0":
            recs["iidx"][::3] |= ptrace.LANE_LAT
        recs["cnt"] = rng.integers(1, 64, n)
        out[tile] = recs
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_trace_exports_equal_the_jax_package(seed, tmp_path):
    spans = _spans(seed)
    assert ptrace.TRACE_REC_DTYPE == jtrace.TRACE_REC_DTYPE
    assert ptrace.KIND_NAMES == jtrace.KIND_NAMES
    assert ptrace.chrome_trace(spans) == jtrace.chrome_trace(spans)
    assert ptrace.hop_table(spans) == jtrace.hop_table(spans)
    ptrace.write_chrome_trace(str(tmp_path / "p.json"), spans)
    jtrace.write_chrome_trace(str(tmp_path / "j.json"), spans)
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())


def test_span_recorder_equals_the_jax_package():
    recs = []
    for mod in (ptrace, jtrace):
        r = mod.SpanRecorder("bench")
        for i, (name, dur) in enumerate((("pack", 4_000), ("upload", 90_000),
                                         ("pack", 6_000), ("verify", 7e6))):
            r.record(name, 10 ** 9 + i * 10 ** 7, int(dur), cnt=i + 1)
        with r.span("finish", cnt=3):
            pass
        recs.append(r)
    p, j = recs
    n = len(p.records()) - 1          # the timed span differs in time
    assert np.array_equal(p.records()[:n], j.records()[:n])
    assert [p.stage_name(i) for i in range(5)] == [
        j.stage_name(i) for i in range(5)]
    p._recs[-1] = j._recs[-1]
    assert p.chrome() == j.chrome()
    assert p.table() == j.table()


@pytest.mark.parametrize("target_ms", [2.0, 0.5])
def test_slo_stage_stats_and_burn_equal_the_jax_package(target_ms):
    spans = _spans(3)
    got = pslo.stage_stats(spans, KINDS, target_ms)
    assert got == jslo.stage_stats(spans, KINDS, target_ms)
    b = pslo.burn(spans, KINDS, target_ms)
    assert b == jslo.burn(spans, KINDS, target_ms)
    assert b["n"] > 0
    assert pslo.render_table(got, b, target_ms) == jslo.render_table(
        got, b, target_ms)
    # a verify-terminated topology grades on the verify tile's ages
    v = {"verify:0": spans["verify:0"]}
    assert pslo.burn(v, KINDS, target_ms) == jslo.burn(v, KINDS, target_ms)


def _spec(tag):
    return (TopoBuilder(f"tob{tag}{os.getpid()}", wksp_mb=16)
            .link("src_v", depth=256, mtu=1280)
            .link("v_d", depth=16, mtu=1280)
            .link("d_s", depth=64, mtu=1280)
            .tile("source", "source", outs=["src_v"])
            .tile("verify:0", "verify", ins=["src_v"], outs=["v_d"])
            .tile("dedup", "dedup", ins=["v_d"], outs=["d_s"])
            .tile("sink", "sink", ins=["d_s"])
            .build())


@pytest.fixture
def joined():
    """One workspace the port creates, with metrics, hists, out-link
    gauges, fseq diags, cnc states and spans written through the port,
    and the same workspace joined by the JAX package."""
    spec = _spec("w")
    pj = ptopo.create(spec)
    jj = jtopo.join(spec)
    try:
        rng = np.random.default_rng(9)
        for name, blk in pj.metrics.items():
            for slot in list(blk.snapshot())[:12]:
                blk.set(slot, int(rng.integers(0, 10 ** 6)))
            for h in blk.hist_names():
                for v in rng.integers(100, 10 ** 9, 20):
                    blk.hist_sample(h, int(v))
        pj.metrics["verify:0"].set("degraded_mode", 1)
        pj.metrics["verify:0"].set("device_fail_cnt", 3)
        pj.metrics["verify:0"].set("out0_occ_hwm", 15)
        pj.links["v_d"].mcache.publish(sig=1)
        for i in range(14):
            pj.links["v_d"].mcache.publish(sig=i)
        pj.fseq[("dedup", "v_d")].diag_add(FSeq.DIAG_SLOW_CNT, 4)
        pj.fseq[("sink", "d_s")].diag_add(FSeq.DIAG_OVRNP_CNT, 2)
        for name, recs in _spans(4).items():
            for r in recs[:30]:
                pj.trace[name].record(int(r["kind"]), int(r["ts"]),
                                      int(r["dur"]), iidx=int(r["iidx"]),
                                      hop_ns=int(r["hop_ns"]),
                                      age_ns=int(r["age_ns"]),
                                      cnt=int(r["cnt"]), seq=int(r["seq"]))
        pj.cnc["dedup"].signal(Cnc.SIGNAL_FAIL)
        yield spec, pj, jj
    finally:
        jj.close()
        pj.close()
        pj.unlink()


def test_prometheus_render_equals_the_jax_package(joined):
    spec, pj, jj = joined
    pfam = pattrib.link_families(pj)
    assert pfam == jattrib.link_families(jj)
    body = pmetrics.prometheus_render(pj.metrics, extra=pfam)
    assert body == jmetrics.prometheus_render(jj.metrics, extra=pfam)
    assert 'fdtpu_degraded_mode{tile="verify:0",kind="verify"} 1' in body
    # one HELP and one TYPE a family, its samples contiguous after them
    seen, cur = set(), None
    for line in body.splitlines():
        if line.startswith("# TYPE "):
            cur = line.split()[2]
            assert cur not in seen
            seen.add(cur)
        elif not line.startswith("#"):
            assert line.startswith(cur), (cur, line)
    pmetrics.lint_schema()
    jmetrics.lint_schema()
    extra = [("fdtpu_link_note", "counter", "label escaping probe",
              {"who": 'we"ird\\name\nnewline'}, 1)]
    assert pmetrics._labels(extra[0][3]) == jmetrics._labels(extra[0][3])
    assert 'who="we\\"ird\\\\name\\nnewline"' in pmetrics.prometheus_render(
        {}, extra=extra)


def test_attribution_verdicts_equal_the_jax_package(joined):
    spec, pj, jj = joined
    prev = pattrib.link_sample(pj)
    pj.fseq[("dedup", "v_d")].diag_add(FSeq.DIAG_SLOW_CNT, 40)
    pj.metrics["dedup"].add("busy_ns", 10 ** 9)
    cur = pattrib.link_sample(pj)
    cur["t"] = prev["t"] + 10 ** 9
    jcur = jattrib.link_sample(jj)
    jcur["t"] = cur["t"]
    assert jcur == cur
    v = pattrib.bottleneck(prev, cur)
    assert v == jattrib.bottleneck(prev, cur)
    assert v[0] == "verify:0->dedup (v_d)" and "slow consumer dedup" in v[1]
    assert pattrib.snapshot_verdict(cur) == jattrib.snapshot_verdict(cur)
    assert pattrib.render_top(spec, prev, cur) == jattrib.render_top(
        spec, prev, cur)
    assert pattrib.producers_of(spec) == jattrib.producers_of(spec)


def test_slo_collect_and_healthz_field_equal_the_jax_package(joined):
    spec, pj, jj = joined
    ps, pk = pslo.collect(pj)
    js, jk = jslo.collect(jj)
    assert pk == jk == KINDS
    assert all(np.array_equal(ps[t], js[t]) for t in ps)
    assert pslo.healthz_field(pj) == jslo.healthz_field(jj)


def test_port_flight_bundle_renders_the_same_through_both(joined, tmp_path):
    spec, pj, jj = joined
    cfg = {"observability": {"slo_target_ms": 2.0}, "secret": object()}
    path = pflight.write_bundle(
        str(tmp_path), pj, reason="degrade", tile="verify:0",
        restarts={"verify:0": 1}, config=cfg,
        events=["00:00:01 spawn verify:0 gen=0 pid=1",
                "00:00:02 tile verify:0 degraded (CPU fallback)"])
    b = pflight.load_bundle(path)
    assert b["manifest"]["reason"] == "degrade"
    assert b["manifest"]["tiles"]["dedup"]["cnc"] == "FAIL"
    assert b["metrics"]["verify:0"]["slots"]["device_fail_cnt"] == 3
    assert b["links"]["links"]["v_d|dedup"]["slow"] == 4
    out = pflight.render_bundle(path)
    assert out == jflight.render_bundle(path)
    assert "reason degrade" in out and "final spans of verify:0:" in out
    assert "bottleneck at death: verify:0->dedup (v_d)" in out
    # the JAX package's bundle of the same workspace renders the same too
    jpath = jflight.write_bundle(str(tmp_path / "j"), jj, reason="degrade",
                                 tile="verify:0", restarts={"verify:0": 1},
                                 config=cfg, events=b["events"])
    jb = jflight.load_bundle(jpath)
    assert jb["manifest"]["tiles"] == b["manifest"]["tiles"]
    # the two bundles were written moments apart: their `created` stamps
    # may differ by a second
    def unstamped(text):
        return re.sub(r"created \S+", "created", text).split("\n")[1:]
    assert unstamped(pflight.render_bundle(jpath)) == unstamped(out)
    # rotation keeps the newest bundles
    for _ in range(3):
        pflight.write_bundle(str(tmp_path), pj, reason="sigusr2")
        time.sleep(0.01)
    assert pflight.rotate(str(tmp_path), 2) == 2
    assert len([d for d in os.listdir(tmp_path)
                if os.path.exists(tmp_path / d / "manifest.json")]) == 2


class _TileCtx:
    def __init__(self, topo, cfg):
        self.topo = topo
        self.cfg = cfg


def test_metric_tile_serves_metrics_and_healthz(joined):
    spec, pj, jj = joined
    assert "metric" in TILES
    tile, ctx = TILES["metric"](), _TileCtx(pj, {"port": 0})
    tile.init(ctx)
    try:
        base = f"http://127.0.0.1:{tile.server.port}"
        r = urllib.request.urlopen(f"{base}/metrics", timeout=60)
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
        assert body == pmetrics.prometheus_render(
            pj.metrics, extra=pattrib.link_families(pj))
        assert 'fdtpu_device_fail_cnt{tile="verify:0",kind="verify"} 3' \
            in body
        code, health = tile.server.health()
        assert code == 503 and health.startswith(b"unhealthy\n")
        for cnc in pj.cnc.values():
            cnc.signal(Cnc.SIGNAL_RUN)
            cnc.heartbeat(time.monotonic_ns())
        code, health = tile.server.health()
        assert code == 200 and health.startswith(b"degraded\nverify:0\n")
    finally:
        tile.fini(ctx)
