"""The port's topology layout and config (firedancer_tpu_torch/disco/topo.py,
metrics.py, trace.py, autotune.py, app/config.py) on the CPU, held against
the JAX package: the JAX package creates a topology and the port's join of
the same spec finds every link, cnc, fseq, metrics block, trace ring and
knob pod at the same offset (and the reverse); a metric, span or knob one
package writes reads the same through the other.  Also the port's
verify-bench spec against the JAX package's, its config layers, and the
rule that no file of the port includes or imports anything of JAX or the
JAX package."""

import ast
import os
import re
from pathlib import Path

import numpy as np
import pytest

from firedancer_tpu.app import config as jconfig
from firedancer_tpu.disco import metrics as jmetrics
from firedancer_tpu.disco import topo as jtopo
from firedancer_tpu.disco import trace as jtrace
from firedancer_tpu_torch.app import config as pconfig
from firedancer_tpu_torch.disco import autotune as pautotune
from firedancer_tpu_torch.disco import metrics as pmetrics
from firedancer_tpu_torch.disco import topo as ptopo
from firedancer_tpu_torch.disco import trace as ptrace
from firedancer_tpu_torch.disco.run import SupervisionPolicy, dependency_order

ROOT = Path(__file__).resolve().parent.parent


def _specs(tag, packed, nverify):
    """The verify-bench spec from each package's own config at the same
    settings (the port's under the JAX spec's app name)."""
    out = []
    for cm in (jconfig, pconfig):
        cfg = cm.load(environ={})
        cfg["topology"] = "verify-bench"
        cfg["name"] = f"tl{tag}{os.getpid()}"
        cfg["layout"]["verify_tile_count"] = nverify
        cfg["development"]["packed_wire"] = packed
        cfg["development"]["source_count"] = 100
        out.append(cm.build_topology(cfg))
    return out


def _shape(spec):
    return (spec.app, spec.wksp_mb,
            [(l.name, l.depth, l.mtu, l.burst) for l in spec.links],
            [(t.name, t.kind, [(i.link, i.reliable, i.polled)
                               for i in t.in_links], t.out_links)
             for t in spec.tiles])


@pytest.mark.parametrize("packed,nverify", [(0, 1), (1, 2)])
def test_verify_bench_spec_equals_the_jax_package(packed, nverify):
    js, ps = _specs("s", packed, nverify)
    assert _shape(ps) == _shape(js)
    for pt, jt in zip(ps.tiles, js.tiles):
        # the port's verify cfg adds `device` (None: the GPU); it carries
        # the whole [supervision] section (the guard's device_* keys and
        # the respawn keys) and [ingest] native_hostpath as the JAX
        # package's does
        want = dict(jt.cfg)
        assert {k: v for k, v in pt.cfg.items() if k != "device"} == want
        assert pt.cfg.get("device", None) is None


@pytest.mark.parametrize("packed,nverify", [(0, 1), (1, 2)])
def test_leader_bench_spec_equals_the_jax_package(packed, nverify):
    """leader-bench from each package's own config at the same settings:
    the same links and tiles, and the same tile cfgs but for the keys the
    port adds (`device`) or lacks (the poh tile's XLA scan `unroll`)."""
    specs = []
    for cm in (jconfig, pconfig):
        cfg = cm.load(environ={})
        cfg["topology"] = "leader-bench"
        cfg["name"] = f"tlb{os.getpid()}"
        cfg["layout"]["verify_tile_count"] = nverify
        cfg["development"]["packed_wire"] = packed
        cfg["ingest"]["egress_packed"] = packed
        specs.append(cm.build_topology(cfg))
    js, ps = specs
    assert _shape(ps) == _shape(js)
    assert [t.kind for t in ps.tiles][-3:] == ["leader_pack", "poh_dev",
                                               "sink"]
    for pt, jt in zip(ps.tiles, js.tiles):
        want = dict(jt.cfg)
        want.pop("unroll", None)
        assert {k: v for k, v in pt.cfg.items() if k != "device"} == want
        assert pt.cfg.get("device", None) is None
    pl = {k: v for k, v in pconfig.load(environ={})["leader"].items()
          if k != "device"}
    jl = jconfig.load(environ={})["leader"]
    assert pl == {k: v for k, v in jl.items() if k != "unroll"}


def _offsets(jt):
    return {
        "links": {n: (l.mcache.off, l.mcache.depth,
                      l.dcache.off if l.dcache is not None else None)
                  for n, l in jt.links.items()},
        "cnc": {n: c.off for n, c in jt.cnc.items()},
        "fseq": {k: f.off for k, f in jt.fseq.items()},
    }


@pytest.mark.parametrize("creator", ["jax", "port"])
def test_join_finds_the_other_package_layout(creator):
    """One package creates the verify-bench workspace (packed, two verify
    tiles), the other joins the same spec: equal offsets everywhere, and
    every metric, span and knob written on one side reads the same on the
    other."""
    js, ps = _specs(creator[0], 1, 2)
    C, J = ((jtopo, ptopo) if creator == "jax" else (ptopo, jtopo))
    c_spec, j_spec = (js, ps) if creator == "jax" else (ps, js)
    made = C.create(c_spec)
    try:
        joined = J.join(j_spec)
        try:
            assert _offsets(joined) == _offsets(made)
            rng = np.random.default_rng(11)
            for name in (t.name for t in ps.tiles):
                mw, mr = made.metrics[name], joined.metrics[name]
                assert mr.snapshot() == mw.snapshot()
                assert all(v == 0 for v in mr.snapshot().values())
                assert mr._arr.ctypes.data == mw._arr.ctypes.data + (
                    joined.ws.ptr().value - made.ws.ptr().value)
                for slot in mw.snapshot():
                    mw.set(slot, int(rng.integers(0, 1 << 62)))
                assert mr.snapshot() == mw.snapshot()
                for h in mw.hist_names():
                    for v in rng.uniform(0, 1e9, 5):
                        mw.hist_sample(h, float(v))
                    we, wc, ws = mw.hist_snapshot(h)
                    re_, rc, rs = mr.hist_snapshot(h)
                    assert np.array_equal(we, re_)
                    assert np.array_equal(wc, rc) and ws == rs
                tw, tr = made.trace[name], joined.trace[name]
                for i in range(7):
                    tw.record(ptrace.KIND_DEVICE, 1000 + i, 50 + i, iidx=i,
                              hop_ns=3, age_ns=4, cnt=i + 1, seq=9 + i)
                _, w = tw.snapshot()
                _, r = tr.snapshot()
                assert r.tobytes() == w.tobytes() and len(r) == 7
                kw, kr = made.knobs[name], joined.knobs[name]
                for knob in kw.names:
                    kw.write(knob, float(rng.integers(1, 1000)))
                kw.commit()
                assert kr.gen == kw.gen == 1
                assert kr.read_set() == kw.read_set()
            # drop the shm views before the workspace unmaps
            mw = mr = tw = tr = kw = kr = w = r = None  # noqa: F841
            import gc
            gc.collect()
        finally:
            joined.close()
    finally:
        made.close()
        made.unlink()


def test_layout_schema_equals_the_jax_package():
    assert pmetrics.footprint() == jmetrics.footprint()
    assert ptrace.footprint() == jtrace.footprint()
    assert ptrace.TRACE_REC_DTYPE == jtrace.TRACE_REC_DTYPE
    from firedancer_tpu.disco import autotune as jautotune
    assert pautotune.pod_footprint() == jautotune.pod_footprint()
    assert pautotune.KNOBS == jautotune.KNOBS
    for kind in set(jmetrics.TILE_SLOTS) | set(pmetrics.TILE_SLOTS):
        assert pmetrics.slot_defs(kind) == jmetrics.slot_defs(kind)
        assert pmetrics.hist_defs(kind) == jmetrics.hist_defs(kind)
    for k in ("KIND_FRAG", "KIND_BURST", "KIND_COALESCE", "KIND_DEVICE",
              "KIND_COMPILE", "KIND_DISPATCH", "KIND_PUBLISH",
              "KIND_HARVEST", "LANE_LAT"):
        assert getattr(ptrace, k) == getattr(jtrace, k)


def test_layout_join_determinism():
    spec = (
        ptopo.TopoBuilder(f"tljd{os.getpid()}", wksp_mb=8)
        .link("a_b", depth=64, mtu=512)
        .tile("a", "sink", outs=["a_b"])
        .tile("b", "sink", ins=["a_b"])
        .build()
    )
    creator = ptopo.create(spec)
    try:
        joiner = ptopo.join(spec)
        try:
            assert (joiner.links["a_b"].mcache.off
                    == creator.links["a_b"].mcache.off)
            lnk = creator.links["a_b"]
            lnk.dcache.write(0, b"hello tango")
            seq = lnk.mcache.publish(sig=7, chunk=0, sz=11)
            rc, meta = joiner.links["a_b"].mcache.query(seq)
            assert rc == 0 and int(meta["sig"]) == 7
            assert joiner.links["a_b"].dcache.read(
                int(meta["chunk"]), 11) == b"hello tango"
            creator.fseq[("b", "a_b")].update(seq + 1)
            assert joiner.fseq[("b", "a_b")].query() == seq + 1
            lnk = meta = None  # noqa: F841
        finally:
            joiner.close()
    finally:
        creator.close()
        creator.unlink()


def test_spec_validation_and_affinity():
    B = ptopo.TopoBuilder
    with pytest.raises(ValueError, match="two producers"):
        (B("v").link("l", 4).tile("a", "sink", outs=["l"])
         .tile("b", "sink", outs=["l"]).build())
    with pytest.raises(ValueError, match="no producer"):
        B("v").link("l", 4).tile("a", "sink", ins=["l"]).build()
    with pytest.raises(ValueError, match="unknown link"):
        B("v").tile("a", "sink", ins=["m"]).build()
    spec = ptopo.TopoSpec("afftest", (ptopo.LinkSpec("l", 4, 64),), (
        ptopo.TileSpec("a", "source", (), ("l",)),
        ptopo.TileSpec("b", "sink", (), (), {"cpu_idx": 9}),
        ptopo.TileSpec("c", "sink", (), ()),
    ))
    out = ptopo.assign_affinity(spec, "3,5")
    assert [t.cfg.get("cpu_idx") for t in out.tiles] == [3, 9, 3]
    assert ptopo.assign_affinity(spec, "") is spec
    assert ptopo.assign_affinity(spec, None) is spec
    auto = ptopo.assign_affinity(spec, "auto")
    assert all(t.cfg.get("cpu_idx") is not None for t in auto.tiles)


def test_dependency_order_producers_first():
    spec = (
        ptopo.TopoBuilder(f"tdep{os.getpid()}", wksp_mb=8)
        .link("s_v", depth=64, mtu=256)
        .link("v_d", depth=64, mtu=64)
        .tile("dedup", "sink", ins=["v_d"])          # declared consumer-first
        .tile("verify:0", "verify", ins=["s_v"], outs=["v_d"])
        .tile("source", "sink", outs=["s_v"])
        .build()
    )
    order = dependency_order(spec)
    assert sorted(order) == sorted(t.name for t in spec.tiles)
    assert order.index("source") < order.index("verify:0")
    assert order.index("verify:0") < order.index("dedup")
    from firedancer_tpu.disco.run import dependency_order as jorder
    js = jtopo.TopoSpec(spec.app, tuple(
        jtopo.LinkSpec(l.name, l.depth, l.mtu, l.burst) for l in spec.links),
        tuple(jtopo.TileSpec(t.name, t.kind, tuple(
            jtopo.InLink(i.link) for i in t.in_links), t.out_links)
            for t in spec.tiles))
    assert jorder(js) == order


def test_policy_from_cfg():
    cfg = pconfig.load(environ={})
    p = SupervisionPolicy.from_cfg(cfg)
    from firedancer_tpu.disco.run import SupervisionPolicy as JPolicy
    jp = JPolicy.from_cfg(jconfig.load(environ={})).__dict__
    assert p.__dict__ == {k: jp[k] for k in p.__dict__}
    assert p.stale_ns("verify") == int(120.0 * 1e9)
    assert p.stale_ns(None) == int(60.0 * 1e9)
    assert p.drain_timeout_s == 0.0 and p.drain_manifest_dir == ""
    p = SupervisionPolicy.from_cfg({"supervision": {
        "drain_timeout_s": "2.5", "drain_manifest_dir": "/tmp/dm"}})
    assert p.drain_timeout_s == 2.5 and p.drain_manifest_dir == "/tmp/dm"


def test_config_layers_and_refusals(tmp_path):
    f = tmp_path / "c.toml"
    f.write_text("[layout]\nverify_tile_count = 3\n"
                 "[tiles.verify]\nbuckets = [[16, 256]]\n")
    cfg = pconfig.load(str(f), environ={
        "FDTPU_DEVELOPMENT_SOURCE_COUNT": "77",
        "FDTPU_TILES_VERIFY_FLUSH_AGE_NS": "5"})
    assert cfg["layout"]["verify_tile_count"] == 3
    assert cfg["development"]["source_count"] == 77
    assert cfg["tiles"]["verify"]["flush_age_ns"] == 5
    assert cfg["tiles"]["verify"]["batch"] == 64
    spec = pconfig.build_topology(cfg)
    assert [t.name for t in spec.tiles] == [
        "source", "verify:0", "verify:1", "verify:2", "dedup", "sink"]
    assert spec.tiles[1].cfg["buckets"] == [[16, 256]]
    with pytest.raises(ValueError, match="deadline_us"):
        pconfig.load(environ={"FDTPU_LATENCY_DEADLINE_USS": "3"})
    for topo_name, missing in (("fdtpu", "net, quic, pack, bank, poh, "
                                         "sign$"),
                               ("leader-bench", "leader_merge")):
        c = pconfig.load(environ={})
        c["topology"] = topo_name
        c["leader"]["pack_shards"] = 2     # leader-bench boots at 1
        with pytest.raises(NotImplementedError, match=missing) as exc:
            pconfig.build_topology(c)
        if topo_name == "fdtpu":
            # the port has the shred lane's tiles
            assert "shred" not in str(exc.value)
            assert "store" not in str(exc.value)
    c = pconfig.load(environ={})
    c["autotune"]["enabled"] = 1
    with pytest.raises(NotImplementedError, match="Autotuner"):
        pconfig.build_topology(c)
    # the respawn and guard keys, refused before their code was ported,
    # load as the JAX package loads them and reach the policy
    for env, key in (("FDTPU_SUPERVISION_MAX_RESTARTS", "max_restarts"),
                     ("FDTPU_SUPERVISION_DEVICE_RETRY", "device_retry")):
        for val in ("0", "1"):
            c = pconfig.load(environ={env: val})
            assert c["supervision"] == jconfig.load(
                environ={env: val})["supervision"]
            assert getattr(SupervisionPolicy.from_cfg(c), key) == int(val)
    # [ingest] native_hostpath: on by default, the env overlays it, and
    # every verify tile gets it, as in the JAX package's topology
    assert pconfig.load(environ={})["ingest"]["native_hostpath"] == 1
    assert [t.cfg["native_hostpath"] for t in spec.tiles
            if t.kind == "verify"] == [1, 1, 1]
    for val in (0, 1):
        env = {"FDTPU_INGEST_NATIVE_HOSTPATH": str(val)}
        c = pconfig.load(environ=env)
        assert c["ingest"]["native_hostpath"] == val
        assert c["ingest"] == jconfig.load(environ=env)["ingest"]
        vt = [t for t in pconfig.build_topology(c).tiles
              if t.kind == "verify"]
        assert [t.cfg["native_hostpath"] for t in vt] == [val]


def test_port_includes_and_imports_nothing_of_jax():
    """No file of the port, the host C++ and the CUDA sources included,
    includes or imports JAX or the JAX package, and neither does
    chip_smoke.py (parsed, not grepped: strings that name the JAX
    package's files do not count)."""
    pkg = ROOT / "firedancer_tpu_torch"
    py = sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in py:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "firedancer_tpu"), (
                    f"{f.relative_to(ROOT)} imports {name}")
    native = [p for ext in ("*.cpp", "*.cu", "*.cuh", "*.h")
              for p in pkg.rglob(ext)]
    assert pkg / "native" / "tango.cpp" in native
    for f in native:
        for line in f.read_text().splitlines():
            m = re.match(r'\s*#\s*include\s*[<"]([^>"]+)[>"]', line)
            if m:
                assert "firedancer_tpu/" not in m.group(1) and \
                    "jax" not in m.group(1), f"{f}: {line}"
                if '"' in line:
                    # a quoted include names a file of the port itself
                    assert (f.parent / m.group(1)).resolve().is_relative_to(
                        pkg), f"{f}: {line}"
