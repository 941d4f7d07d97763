"""The port's tile runtime in one process on the CPU
(firedancer_tpu_torch/disco/mux.py and run.py, with the port's VerifyTile):
the drain cases of tests/test_supervision.py against the port, and the
port VerifyTile under the port Mux, in a thread, with frags published by
hand into its in-link: packed-wire rx holding each frag's credit until
its verdict is harvested, a torn frag dropped whole with its release
fired once, and a drain or a halt with open buckets and batches in flight
that still publishes a verdict for every admitted txn.  A gate in front
of the verifier (a verdict not ready until the test opens it) stands in
for a busy card.  The published sigs are held against the JAX package's
host verifier; the slow case holds them against the JAX VerifyTile under
the JAX Mux."""

import json
import os
import threading
import time

import numpy as np
import pytest

from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch.ballet import txn as txn_lib
from firedancer_tpu_torch.disco import topo as topo_mod
from firedancer_tpu_torch.disco.mux import Mux
from firedancer_tpu_torch.disco.run import SupervisionPolicy, TopoRun
from firedancer_tpu_torch.disco.topo import InLink, TopoBuilder
from firedancer_tpu_torch.disco.verify_tile import VerifyTile
from firedancer_tpu_torch.ops import ed25519 as ed
from firedancer_tpu_torch.tango.ring import (PACKED_ROW_EXTRA, Cnc, Dcache,
                                             MCache, Workspace, packed_row_ml,
                                             tx_burst)
from _torch_threads import one_torch_thread  # noqa: F401

ML = packed_row_ml(256)          # 284: a row stride of 384 bytes
STRIDE = ML + PACKED_ROW_EXTRA
ROWS = 16
_SEEDS = [bytes([0x60 + i]) * 32 for i in range(4)]
_PUBS = [ed.keypair_from_seed(s)[0] for s in _SEEDS]


def _wait(pred, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _txn(rng, nonce, bad=False):
    k = nonce % len(_SEEDS)
    msg = txn_lib.build_unsigned(
        [_PUBS[k]], rng.bytes(32),
        [(1, b"\x00", int(nonce).to_bytes(8, "little"))], [rng.bytes(32)])
    sig = ed.sign(_SEEDS[k], msg)
    if bad:
        sig = bytes([sig[0], sig[1] ^ 1]) + sig[2:]
    return txn_lib.assemble([sig], msg)


def _host_ok(wire) -> bool:
    t = txn_lib.parse(wire)
    msg = t.message(wire)
    return all(jed.verify_one_host(s, msg, k) for s, k in
               zip(t.signatures(wire), t.signer_pubkeys(wire)))


def _packed_frag(rng, base, n_valid, forged=()):
    """ROWS packed rows: n_valid signed single-sig txns (the rows in
    `forged` with a flipped signature bit), the rest stamped the way the
    source tile stamps its firehose (a random tag over the signature)."""
    rows = np.zeros((ROWS, STRIDE), np.uint8)
    wires = []
    tpl = _txn(rng, base)
    for r in range(ROWS):
        if r < n_valid:
            w = _txn(rng, base + r, bad=r in forged)
        else:
            tag = rng.integers(1, 1 << 62, 1, dtype=np.uint64).tobytes()
            w = tpl[:1] + tag + tpl[9:]
        msg, pub = w[65:], _PUBS[(base + (r if r < n_valid else 0))
                                 % len(_SEEDS)]
        rows[r, :len(msg)] = np.frombuffer(msg, np.uint8)
        rows[r, ML:ML + 64] = np.frombuffer(w[1:65], np.uint8)
        rows[r, ML + 64:ML + 96] = np.frombuffer(pub, np.uint8)
        rows[r, ML + 96:] = np.array([len(msg)], np.int32).view(np.uint8)
        wires.append(w)
    return rows, wires


class _Gate:
    """A verifier front: dispatch_blob dispatches through the real
    verifier, but the verdict reads as not ready until open() (a card
    still busy with the batch)."""

    def __init__(self, fn):
        self.fn = fn
        self.device = fn.device
        self.mode = fn.mode
        self.opened = threading.Event()
        self.dispatches = 0

    def open(self):
        self.opened.set()

    def dispatch_blob(self, blob, maxlen=None):
        self.dispatches += 1
        return _GatedVerdict(self.fn.dispatch_blob(blob, maxlen=maxlen),
                             self.opened)


class _GatedVerdict:
    def __init__(self, v, opened):
        self.v = v
        self.opened = opened

    def is_ready(self):
        return self.opened.is_set() and self.v.is_ready()

    def copy_to_host_async(self):
        self.v.copy_to_host_async()

    def __array__(self, dtype=None, copy=None):
        self.opened.wait(30)
        return np.asarray(self.v) if dtype is None else \
            np.asarray(self.v).astype(dtype)


def _published(jt, link):
    """(payload, sig) of every frag on `link`, in seq order."""
    lnk = jt.links[link]
    mc, dc = lnk.mcache, lnk.dcache
    out = []
    for seq in range(mc.seq0(), mc.seq_query()):
        rc, m = mc.query(seq)
        assert rc == 0
        out.append((dc.read(int(m["chunk"]), int(m["sz"])), int(m["sig"])))
    return out


def _verify_topo(tag, in_mtu, in_depth, **vcfg):
    """src (driven by hand) -> v (the port's VerifyTile) -> s (not run;
    an unreliable consumer, so v is never backpressured)."""
    return (
        TopoBuilder(f"tm{tag}{os.getpid()}", wksp_mb=16)
        .link("src_v", depth=in_depth, mtu=in_mtu)
        .link("v_s", depth=512, mtu=1280)
        .tile("src", "sink", outs=["src_v"])
        .tile("v", "verify", ins=["src_v"], outs=["v_s"], device="cpu",
              **vcfg)
        .tile("s", "sink", ins=[InLink("v_s", reliable=False)])
        .build())


class _Running:
    """A Mux over the tile in a thread; HALT and join on exit."""

    def __init__(self, jt, name, vt):
        self.jt, self.vt = jt, vt
        self.mux = Mux(jt, name, vt)
        self.mux.HOUSE_NS = 1_000_000  # 1 ms housekeeping: fast DRAIN
        self.cnc = jt.cnc[name]
        self.error = None
        self.th = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        try:
            self.mux.run()
        except BaseException as e:  # the test re-raises it on exit
            self.error = e

    def __enter__(self):
        self.th.start()
        _wait(lambda: (self.cnc.signal_query() == Cnc.SIGNAL_RUN
                       or self.error is not None), what="RUN")
        if self.error is not None:
            raise self.error
        return self

    def __exit__(self, *exc):
        self.cnc.signal(Cnc.SIGNAL_HALT)
        self.th.join(30)
        assert not self.th.is_alive()
        self.mux = None
        if self.error is not None and exc[0] is None:
            raise self.error


def _publish_rows(lnk, chunk, rows, n):
    view = lnk.dcache.write_view(chunk, rows.nbytes).reshape(rows.shape)
    view[:] = rows
    tag = int(rows[0, ML:ML + 8].view(np.uint64)[0])
    seq = lnk.mcache.publish(sig=tag, chunk=chunk, sz=n)
    return seq, lnk.dcache.advance(chunk, rows.nbytes)


def test_packed_wire_holds_credits_until_the_verdict(tmp_path):
    """Packed-wire rx under the port's Mux: while a frag's verdict is
    pending, credits_held > 0 and the in-link fseq stays behind the
    published seq; after the harvest both are level, each row's verdict
    equals the host verifier's, the drain parks with a manifest."""
    rng = np.random.default_rng(41)
    spec = _verify_topo("pw", ROWS * STRIDE, 16, packed_wire=1,
                        buckets=[[ROWS, ML]], flush_age_ns=10 ** 12,
                        supervision={"drain_manifest_dir": str(tmp_path)})
    jt = topo_mod.create(spec)
    try:
        tile = VerifyTile()
        lnk = jt.links["src_v"]
        fseq = jt.fseq[("v", "src_v")]
        with _Running(jt, "v", tile) as run:
            gate = _Gate(tile.pipe.verify_fn)
            tile.pipe.verify_fn = gate
            frags = [_packed_frag(rng, 0, 10, forged=(2, 7)),
                     _packed_frag(rng, 100, 0),
                     _packed_frag(rng, 200, 12, forged=(0,)),
                     _packed_frag(rng, 300, 0)]
            chunk, last = 0, None
            for rows, _ in frags:
                last, chunk = _publish_rows(lnk, chunk, rows, ROWS)
            _wait(lambda: gate.dispatches == 4, what="4 dispatches")
            _wait(lambda: run.vt.credits_held(0) == 4, what="held credits")
            time.sleep(0.01)   # housekeeping passes while pending
            assert fseq.query() < last + 1
            assert fseq.query() == lnk.mcache.seq0()
            gate.open()
            _wait(lambda: (tile.credits_held(0) == 0
                           and fseq.query() == last + 1),
                  what="credits back after the harvest")
            _wait(lambda: jt.metrics["v"].get("batch_cnt") == 4,
                  what="metrics sync")
            run.cnc.signal(Cnc.SIGNAL_DRAIN)
            _wait(lambda: run.cnc.signal_query() == Cnc.SIGNAL_DRAINED,
                  what="DRAINED")
            man = json.loads((tmp_path / "v.manifest.json").read_text())
            assert man["cursors"]["src_v"] == last + 1
        want = [(w, int.from_bytes(w[1:9], "little"))
                for _, wires in frags for w in wires if _host_ok(w)]
        assert len(want) == 8 + 11
        assert _published(jt, "v_s") == want
        m = jt.metrics["v"].snapshot()
        assert m["txn_in_cnt"] == 4 * ROWS and m["torn_drop_cnt"] == 0
        assert m["verify_pass_cnt"] == len(want)
        assert m["verify_fail_cnt"] == 4 * ROWS - len(want)
        assert m["drain_cnt"] == 1
        tile = run = lnk = fseq = None  # noqa: F841
        import gc
        gc.collect()
    finally:
        jt.close()
        jt.unlink()


def test_knob_pod_reaches_apply_knobs():
    """A knob pod generation committed by a supervisor reaches the
    tile's apply_knobs at the mux's next housekeeping: the pipeline's
    inflight window, the age flush and the deadline (the spill age keeps
    its factor) change live; knob_apply_cnt counts the generation."""
    spec = _verify_topo("kn", 1280, 64, buckets=[[16, 256]])
    jt = topo_mod.create(spec)
    try:
        tile = VerifyTile()
        with _Running(jt, "v", tile):
            pod = jt.knobs["v"]
            assert tile.pipe.lat_spill_age_ns == 4 * 2000 * 1000
            pod.write("max_inflight", 3)
            pod.write("flush_age_ns", 5e6)
            pod.write("deadline_us", 4000)
            pod.commit()
            _wait(lambda: jt.metrics["v"].get("knob_apply_cnt") == 1,
                  what="the knob generation applied")
            assert tile.pipe.max_inflight == 3
            assert tile.flush_age_ns == 5_000_000
            assert tile.pipe.deadline_us == 4000
            assert tile.pipe.lat_spill_age_ns == 4 * 4000 * 1000
        tile = pod = None  # noqa: F841
    finally:
        jt.close()
        jt.unlink()


class _Ctx:
    """A recording ctx around one in-link mcache (torn-drop case)."""

    def __init__(self, cfg, mc):
        self.cfg = cfg
        self.mc = mc
        self.trace = None
        self.published = []
        self.metrics = type("M", (), {
            "set": lambda s, k, v: None, "add": lambda s, k, v=1: None,
            "hist_store": lambda s, k, h: None})()

    def in_mcache(self, iidx):
        return self.mc

    def publish_burst(self, buf, starts, lens, sigs):
        self.published += list(sigs)

    def heartbeat(self):
        pass


def test_torn_packed_frag_dropped_whole():
    """A frag the producer laps between rx and the post-dispatch seq
    re-check is dropped whole (torn_drop), never verdicted, and its held
    credit is released exactly once."""
    ws = Workspace(f"fdtpu_ttest_torn{os.getpid()}", 8 << 20, create=True)
    try:
        mc = MCache.new(ws, 4)
        dc = Dcache.new(ws, ROWS * STRIDE, 4)
        rng = np.random.default_rng(5)
        rows, wires = _packed_frag(rng, 0, ROWS)
        dc.write_view(0, rows.nbytes)[:] = rows.ravel()
        for s in range(5):       # seq 0, then lapped by four more
            mc.publish(sig=s + 1, chunk=0, sz=ROWS)
        tile = VerifyTile()
        ctx = _Ctx({"device": "cpu", "packed_wire": 1,
                    "buckets": [[ROWS, ML]], "max_inflight": 0}, mc)
        tile.init(ctx)
        metas, _ = mc.consume_burst(4, 1)
        metas["seq"] = 0
        metas["chunk"] = 0
        tile.on_burst_view(ctx, 0, metas, dc)
        assert tile.credits_held(0) == 0
        assert tile.pipe.metrics.torn_drop == 1
        assert tile.pipe.metrics.torn_txns == ROWS
        assert tile.pipe.metrics.txns_in == 0 and ctx.published == []
        # the same rows un-lapped verify clean
        metas["seq"] = 4
        tile.on_burst_view(ctx, 0, metas, dc)
        assert tile.credits_held(0) == 0
        assert len(ctx.published) == ROWS
        tile = dc = mc = None  # noqa: F841
        import gc
        gc.collect()
    finally:
        ws.close()
        ws.unlink()


def _wire_stream(rng, n, n_bad):
    wires = [_txn(rng, 1000 + i, bad=i < n_bad) for i in range(n)]
    order = rng.permutation(n)
    return [wires[i] for i in order]


@pytest.mark.parametrize("how", ["drain", "halt"])
def test_drain_and_fini_verdict_every_admitted_txn(how):
    """Wire frags under the port's Mux at buckets [[16, 256]], with the
    age flush off and every verdict gated: two full buckets in flight and
    an open bucket when the drain (or the halt) comes.  The drain hook,
    or fini at the halt, dispatches the open bucket and waits for every
    verdict: each admitted txn gets one, and the passing ones are
    published."""
    rng = np.random.default_rng(77 if how == "drain" else 78)
    stream = _wire_stream(rng, 40, 6)
    spec = _verify_topo(how[:2], 1280, 256, buckets=[[16, 256]],
                        flush_age_ns=10 ** 12)
    jt = topo_mod.create(spec)
    try:
        tile = VerifyTile()
        lnk = jt.links["src_v"]
        with _Running(jt, "v", tile) as run:
            gate = _Gate(tile.pipe.verify_fn)
            tile.pipe.verify_fn = gate
            buf = b"".join(stream)
            lens = np.array([len(w) for w in stream], np.int32)
            starts = np.zeros(len(stream), np.int64)
            np.cumsum(lens[:-1], out=starts[1:])
            sigs = np.array([int.from_bytes(w[1:9], "little") & ((1 << 63)
                             - 1) for w in stream], np.uint64)
            tx_burst(lnk.mcache, lnk.dcache, 0, buf, starts, lens, sigs)
            _wait(lambda: tile.pipe.metrics.txns_in == 40, what="intake")
            assert gate.dispatches == 2 and tile.pipe.has_open
            assert len(tile.pipe.inflight) == 2
            if how == "drain":
                run.cnc.signal(Cnc.SIGNAL_DRAIN)
                _wait(lambda: gate.dispatches == 3, what="open dispatched")
                time.sleep(0.02)
                assert run.cnc.signal_query() == Cnc.SIGNAL_DRAIN
                gate.open()
                _wait(lambda: run.cnc.signal_query() == Cnc.SIGNAL_DRAINED,
                      what="DRAINED")
            else:
                run.cnc.signal(Cnc.SIGNAL_HALT)
                threading.Timer(0.05, gate.open).start()
                run.th.join(30)
            assert not tile.pipe.has_pending
        want = [(w, int.from_bytes(w[1:9], "little")) for w in stream
                if _host_ok(w)]
        assert len(want) == 34
        assert sorted(_published(jt, "v_s")) == sorted(want)
        m = tile.pipe.metrics
        assert m.batches == 3 and m.verify_pass == 34 and m.verify_fail == 6
        tile = run = lnk = None  # noqa: F841
        import gc
        gc.collect()
    finally:
        jt.close()
        jt.unlink()


@pytest.mark.slow
def test_published_sigs_equal_the_jax_tile():
    """The port's VerifyTile and the JAX package's, each under its own
    package's Mux, on the same wire frags at buckets [[16, 256]]: the
    same published (payload, sig) frags in the same order.  Slow: the JAX
    tile's boot compiles its verify graph (about 100 s on a CPU host)."""
    from firedancer_tpu.disco import topo as jtopo
    from firedancer_tpu.disco.mux import Mux as JMux
    from firedancer_tpu.disco.tiles import VerifyTile as JVerifyTile

    rng = np.random.default_rng(90)
    stream = _wire_stream(rng, 40, 6) + [b"\x01garbage" * 20]
    stream.insert(5, stream[9])
    outs = []
    for pkg_topo, mux_cls, vt, dev in ((topo_mod, Mux, VerifyTile(), "cpu"),
                                       (jtopo, JMux, JVerifyTile(), None)):
        b = (pkg_topo.TopoBuilder(f"tmj{len(outs)}{os.getpid()}", wksp_mb=16)
             .link("src_v", depth=256, mtu=1280)
             .link("v_s", depth=512, mtu=1280)
             .tile("src", "sink", outs=["src_v"]))
        cfg = {"buckets": [[16, 256]], "flush_age_ns": 1_000_000}
        if dev:
            cfg["device"] = dev
        spec = (b.tile("v", "verify", ins=["src_v"], outs=["v_s"], **cfg)
                .tile("s", "sink", ins=[pkg_topo.InLink("v_s",
                                                        reliable=False)])
                .build())
        jt = pkg_topo.create(spec)
        try:
            m = mux_cls(jt, "v", vt)
            th = threading.Thread(target=m.run, daemon=True)
            th.start()
            _wait(lambda: jt.cnc["v"].signal_query() == Cnc.SIGNAL_RUN,
                  timeout=600, what="RUN")
            lnk = jt.links["src_v"]
            chunk = 0
            for w in stream:
                nxt = lnk.dcache.write(chunk, w)
                lnk.mcache.publish(int.from_bytes(w[1:9], "little")
                                   & ((1 << 63) - 1), chunk, len(w))
                chunk = nxt
            _wait(lambda: vt.pipe.metrics.txns_in == len(stream)
                  and not vt.pipe.has_pending, timeout=120, what="verdicts")
            jt.cnc["v"].signal(Cnc.SIGNAL_HALT)
            th.join(60)
            outs.append(_published(jt, "v_s"))
            m = lnk = None
            import gc
            gc.collect()
        finally:
            jt.close()
            jt.unlink()
    assert outs[0] == outs[1]
    assert len(outs[0]) == 34


class _HostFn:
    """The JAX package's host verifier behind the four-array surface the
    JAX tile's pipeline calls (no dispatch_blob: four-array buckets,
    which NumPy 2 accepts), in place of its jitted verify graph: the tile
    boots without an XLA compile."""

    mode = "strict"

    def __call__(self, msgs, lens, sigs, pubs):
        import jax.numpy as jnp

        from firedancer_tpu.models.verifier import host_verify_arrays
        return jnp.asarray(host_verify_arrays(msgs, lens, sigs, pubs))


def test_default_config_tile_equals_the_jax_tile(monkeypatch):
    """The port's VerifyTile under the port's Mux and the JAX package's
    under the JAX Mux, each with its own package's default verify-bench
    tile cfg (native_hostpath 1: the native burst parse and tcache), on
    the same wire frags: the same published (payload, sig) frags in the
    same order, equal to the host verifier's, and the same counters.
    The JAX tile verifies on the host (_HostFn), so it boots at once."""
    from firedancer_tpu.app import config as jconfig
    from firedancer_tpu.disco import topo as jtopo
    from firedancer_tpu.disco.mux import Mux as JMux
    from firedancer_tpu.disco.tiles import VerifyTile as JVerifyTile
    from firedancer_tpu_torch.app import config as pconfig
    from firedancer_tpu_torch.tango.tcache import NativeTCache

    monkeypatch.setattr(JVerifyTile, "_make_single_chip_fn",
                        lambda self, cfg, buckets, lat_warm=(): _HostFn())
    rng = np.random.default_rng(91)
    stream = _wire_stream(rng, 40, 6) + [b"\x01garbage" * 20]
    stream.insert(5, stream[9])
    stream.insert(30, stream[2])
    outs, counters = [], []
    for pkg_topo, cm, mux_cls, vt in (
            (topo_mod, pconfig, Mux, VerifyTile()),
            (jtopo, jconfig, JMux, JVerifyTile())):
        (vcfg,) = [t.cfg for t in cm.build_topology(
            cm.load(environ={})).tiles if t.kind == "verify"]
        assert vcfg["native_hostpath"] == 1
        if pkg_topo is topo_mod:
            vcfg = {**vcfg, "device": "cpu"}
        spec = (pkg_topo.TopoBuilder(f"tmd{len(outs)}{os.getpid()}",
                                     wksp_mb=16)
                .link("src_v", depth=256, mtu=1280)
                .link("v_s", depth=512, mtu=1280)
                .tile("src", "sink", outs=["src_v"])
                .tile("v", "verify", ins=["src_v"], outs=["v_s"], **vcfg)
                .tile("s", "sink", ins=[pkg_topo.InLink("v_s",
                                                        reliable=False)])
                .build())
        jt = pkg_topo.create(spec)
        try:
            m = mux_cls(jt, "v", vt)
            th = threading.Thread(target=m.run, daemon=True)
            th.start()
            _wait(lambda: jt.cnc["v"].signal_query() == Cnc.SIGNAL_RUN,
                  timeout=120, what="RUN")
            if pkg_topo is topo_mod:
                assert isinstance(vt.pipe.tcache, NativeTCache)
                assert vt.pipe._hp is not None
            lnk = jt.links["src_v"]
            chunk = 0
            for w in stream:
                nxt = lnk.dcache.write(chunk, w)
                lnk.mcache.publish(int.from_bytes(w[1:9], "little")
                                   & ((1 << 63) - 1), chunk, len(w))
                chunk = nxt
            _wait(lambda: vt.pipe.metrics.txns_in == len(stream)
                  and not vt.pipe.has_pending, timeout=120, what="verdicts")
            jt.cnc["v"].signal(Cnc.SIGNAL_HALT)
            th.join(60)
            assert not th.is_alive()
            outs.append(_published(jt, "v_s"))
            s = vt.pipe.metrics.snapshot()
            counters.append((s["txns_in"], s["parse_fail"],
                             s["too_long_drop"], s["verify_pass"],
                             s["verify_fail"] + s["dedup_drop"]))
            m = lnk = None
            import gc
            gc.collect()
        finally:
            jt.close()
            jt.unlink()
    want = [(w, int.from_bytes(w[1:9], "little")) for w in stream[:-1]
            if _host_ok(w)]
    want = [x for i, x in enumerate(want) if x not in want[:i]]
    assert outs[0] == outs[1] == want
    assert len(want) == 34
    assert counters[0] == counters[1] == (len(stream), 1, 0, 34, 8)


# -- the drain protocol (the cases of tests/test_supervision.py) ----------


def _mini_spec(tag: str, **vcfg):
    return (
        TopoBuilder(f"tms{tag}{os.getpid()}", wksp_mb=8)
        .link("a_b", depth=64, mtu=256)
        .tile("src", "sink", outs=["a_b"])
        .tile("v:0", "verify", ins=["a_b"], **vcfg)
        .build()
    )


class _DrainVt:
    """Records delivered frag seqs; its drain hook reports dry only after
    `wet` polls (an in-flight device batch flushing)."""

    def __init__(self, die_after=None, wet=0):
        self.seqs = []
        self.die_after = die_after
        self.wet = wet
        self.drain_polls = 0

    def on_frag(self, ctx, iidx, meta, payload):
        self.seqs.append(int(meta["seq"]))
        if self.die_after is not None and len(self.seqs) >= self.die_after:
            ctx.halt()

    def drain(self, ctx) -> bool:
        self.drain_polls += 1
        return self.drain_polls > self.wet


class _ManifestVt(_DrainVt):
    def drain_manifest(self, ctx) -> dict:
        return {"drain_polls": self.drain_polls}


def test_mux_drain_manifest_records_the_tiles_state(tmp_path):
    """A vtable's drain_manifest(ctx) hook lands in the manifest under
    tile_state, written after the tile ran dry."""
    jt = topo_mod.create(_mini_spec(
        "dm", supervision={"drain_manifest_dir": str(tmp_path)}))
    try:
        vt = _ManifestVt(wet=2)
        with _Running(jt, "v:0", vt) as run:
            cnc = run.cnc
            cnc.signal(Cnc.SIGNAL_DRAIN)
            _wait(lambda: cnc.signal_query() == Cnc.SIGNAL_DRAINED,
                  what="DRAINED ack")
            man = json.loads((tmp_path / "v_0.manifest.json").read_text())
            assert man["tile"] == "v:0"
            assert man["tile_state"] == {"drain_polls": 3}
        run = None  # noqa: F841
        import gc
        gc.collect()
    finally:
        jt.close()
        jt.unlink()


def test_mux_drain_flushes_parks_and_manifests(tmp_path):
    jt = topo_mod.create(_mini_spec(
        "dr", supervision={"drain_manifest_dir": str(tmp_path)}))
    try:
        mc = jt.links["a_b"].mcache
        for i in range(6):
            mc.publish(i)
        vt = _DrainVt(wet=3)
        with _Running(jt, "v:0", vt) as run:
            cnc = run.cnc
            _wait(lambda: len(vt.seqs) == 6, what="frag consumption")
            cnc.signal(Cnc.SIGNAL_DRAIN)
            _wait(lambda: cnc.signal_query() == Cnc.SIGNAL_DRAINED,
                  what="DRAINED ack")
            assert vt.drain_polls >= 4
            assert jt.fseq[("v:0", "a_b")].query() == mc.seq0() + 6
            snap = jt.metrics["v:0"].snapshot()
            assert snap["drain_cnt"] == 1 and snap["drain_flush_ns"] >= 0
            man = json.loads((tmp_path / "v_0.manifest.json").read_text())
            assert man["tile"] == "v:0" and man["kind"] == "verify"
            assert man["cursors"]["a_b"] == mc.seq0() + 6
            assert man["knob_gen"] == 0 and man["outs"] == {}
            assert "tile_state" not in man
            # the park holds DRAINED, heartbeating
            time.sleep(0.05)
            assert cnc.signal_query() == Cnc.SIGNAL_DRAINED
            hb0 = cnc.heartbeat_query()
            _wait(lambda: cnc.heartbeat_query() > hb0, what="park heartbeat")
        run = None  # noqa: F841
        import gc
        gc.collect()
    finally:
        jt.close()
        jt.unlink()


def test_mux_drain_restart_zero_loss_zero_dup():
    """A tile DRAINed mid-stream takes every frag published before the
    DRAIN exactly once and none after it: the frags published while it
    is parked stay unacknowledged behind its fseq cursor, so a successor
    that resumes at the cursor loses none and repeats none.  (The JAX
    package's respawn resumes there by itself; the port has no
    respawn.)"""
    jt = topo_mod.create(_mini_spec("dz"))
    try:
        mc = jt.links["a_b"].mcache
        fseq = jt.fseq[("v:0", "a_b")]
        for i in range(12):
            mc.publish(i)
        vt0 = _DrainVt()
        with _Running(jt, "v:0", vt0) as run:
            _wait(lambda: len(vt0.seqs) == 12, what="pre-drain consumption")
            run.cnc.signal(Cnc.SIGNAL_DRAIN)
            _wait(lambda: run.cnc.signal_query() == Cnc.SIGNAL_DRAINED,
                  what="DRAINED ack")
            for i in range(6):
                mc.publish(100 + i)
            time.sleep(0.05)
            assert fseq.query() == mc.seq0() + 12
        assert vt0.seqs == list(range(mc.seq0(), mc.seq0() + 12))
        assert fseq.query() == mc.seq0() + 12, "a parked tile acked frags"
        assert mc.seq_query() - fseq.query() == 6, "lost frags"
        run = None  # noqa: F841
        import gc
        gc.collect()
    finally:
        jt.close()
        jt.unlink()


class _FakeProc:
    """A tile process: join() ends it with exit code `code`, unless it is
    wedged; terminate() and kill() end it by a signal."""

    def __init__(self, alive=True, code=0, wedged=False):
        self._alive = alive
        self.code = code
        self.wedged = wedged
        self.exitcode = None if alive else code

    def is_alive(self):
        return self._alive

    def join(self, *a):
        if self._alive and not self.wedged:
            self._alive = False
            self.exitcode = self.code

    def terminate(self):
        self._alive = False
        self.exitcode = -15

    def kill(self):
        self._alive = False
        self.exitcode = -9


def test_halt_raises_on_a_tile_that_does_not_exit_cleanly():
    """halt() records every tile's exit code.  A tile alive at the halt
    that exits non-zero (its fini raised) or has to be terminated makes
    the halt raise, and so the drain and the close; a tile that died
    before the halt is poll()'s to report and does not raise."""
    run = TopoRun(_mini_spec("hx"), start=False)
    try:
        run.procs = {"src": _FakeProc(), "v:0": _FakeProc()}
        assert run.halt() == {"src": 0, "v:0": 0}
        assert run.exitcodes == {"src": 0, "v:0": 0}
        run.procs = {"src": _FakeProc(), "v:0": _FakeProc(code=1)}
        with pytest.raises(RuntimeError, match="'v:0': 1"):
            run.halt()
        run.procs = {"src": _FakeProc(), "v:0": _FakeProc(wedged=True)}
        with pytest.raises(RuntimeError, match="'v:0': -15"):
            run.halt(timeout=0.01)
        run.procs = {"src": _FakeProc(),
                     "v:0": _FakeProc(alive=False, code=-9)}
        assert run.halt() == {"src": 0, "v:0": -9}
        run.procs = {"src": _FakeProc(code=1), "v:0": _FakeProc()}
        with pytest.raises(RuntimeError, match="'src': 1"):
            run.drain(0.0)
    finally:
        run.procs = {"src": _FakeProc(), "v:0": _FakeProc(code=1)}
        with pytest.raises(RuntimeError, match="'v:0': 1"):
            run.close()
    assert not os.path.exists(f"/dev/shm/{run.jt.ws.name}")


def test_drain_tile_acks_and_times_out():
    run = TopoRun(_mini_spec("dt"), start=False,
                  policy=SupervisionPolicy(drain_timeout_s=5.0))
    try:
        run.procs = {"src": _FakeProc(), "v:0": _FakeProc()}
        cnc = run.jt.cnc["v:0"]
        cnc.signal(Cnc.SIGNAL_RUN)

        def _ack():
            while cnc.signal_query() != Cnc.SIGNAL_DRAIN:
                time.sleep(0.002)
            cnc.heartbeat(time.monotonic_ns())
            cnc.signal(Cnc.SIGNAL_DRAINED)

        t = threading.Thread(target=_ack, daemon=True)
        t.start()
        assert run.drain_tile("v:0", 5.0) is True
        t.join(5.0)
        # nobody acks src: a bounded False, never a hang
        t0 = time.monotonic()
        assert run.drain_tile("src", 0.2) is False
        assert time.monotonic() - t0 < 2.0
        # death mid-drain is a False too
        run.procs["v:0"]._alive = False
        cnc.signal(Cnc.SIGNAL_RUN)
        assert run.drain_tile("v:0", 5.0) is False
    finally:
        run.procs = {}
        run.close()


def test_drain_tile_reasserts_over_boot_stamp():
    run = TopoRun(_mini_spec("db"), start=False,
                  policy=SupervisionPolicy(drain_timeout_s=5.0))
    try:
        run.procs = {"src": _FakeProc(), "v:0": _FakeProc()}
        cnc = run.jt.cnc["v:0"]
        cnc.signal(Cnc.SIGNAL_BOOT)

        def _booting_tile():
            while cnc.signal_query() != Cnc.SIGNAL_DRAIN:
                time.sleep(0.002)          # the supervisor raises DRAIN...
            cnc.signal(Cnc.SIGNAL_RUN)     # ...the boot stamp loses it
            while cnc.signal_query() != Cnc.SIGNAL_DRAIN:
                time.sleep(0.002)          # re-asserted by drain_tile
            cnc.heartbeat(time.monotonic_ns())
            cnc.signal(Cnc.SIGNAL_DRAINED)

        t = threading.Thread(target=_booting_tile, daemon=True)
        t.start()
        assert run.drain_tile("v:0", 5.0) is True
        t.join(5.0)
    finally:
        run.procs = {}
        run.close()


def test_load_drain_manifest_validates(tmp_path):
    run = TopoRun(_mini_spec("lm"), start=False, policy=SupervisionPolicy(
        drain_manifest_dir=str(tmp_path)))
    try:
        assert run._load_drain_manifest("v:0") is None
        path = tmp_path / "v_0.manifest.json"
        path.write_text('{"tile": "v:0", "cursors": {"a_b": 3}, "outs": {}}')
        assert run._load_drain_manifest("v:0")["cursors"] == {"a_b": 3}
        path.write_text('{"tile": "v:0", "cursors": {"a_b": -1}, "outs": {}}')
        with pytest.raises(ValueError, match="cursors"):
            run._load_drain_manifest("v:0")
        path.write_text('{"tile": "v:0", "cur')
        with pytest.raises(ValueError, match="torn"):
            run._load_drain_manifest("v:0")
    finally:
        run.close()


@pytest.mark.parametrize("kw,match", [
    ({"metrics_port": 0}, "metrics_port"),
    ({"flight_dir": "/tmp/f"}, "flight_dir"),
    ({"config": {"autotune": {"enabled": 1}}}, "Autotuner"),
    ({"policy": SupervisionPolicy(restart_policy="respawn")}, "respawn"),
])
def test_toporun_refuses_what_is_not_ported(kw, match, tmp_path):
    """Only the autotuner is still refused; the /metrics endpoint, the
    flight recorder and respawn are ported, and each option is live on
    the run it builds."""
    if match == "Autotuner":
        with pytest.raises(NotImplementedError, match=match):
            TopoRun(_mini_spec("nr"), start=False, **kw)
        return
    if "flight_dir" in kw:
        kw = {"flight_dir": str(tmp_path / "f")}
    run = TopoRun(_mini_spec("nr"), start=False, **kw)
    try:
        if match == "metrics_port":
            assert run.metrics_port > 0
        elif match == "flight_dir":
            assert run.flight_dump("sigusr2") is not None
        else:
            assert run.policy.restart_policy == "respawn"
    finally:
        run.close()


def test_fault_plans_are_refused(monkeypatch):
    """Fault plans are armed now, with the JAX package's grammar: a tile
    cfg `faults` plan or FDTPU_FAULTS naming the tile arms the mux's
    FaultInjector; a string outside the grammar names no tile and arms
    nothing, as in the JAX package."""
    from firedancer_tpu.disco import faultinject as jfi
    jt = topo_mod.create(_mini_spec("fp", faults="v:0:kill@3"))
    try:
        assert Mux(jt, "v:0", _DrainVt()).fault is None
        assert jfi.for_tile("v:0", {"faults": "v:0:kill@3"}) is None
    finally:
        jt.close()
        jt.unlink()
    jt = topo_mod.create(_mini_spec("fe", faults="v:0=kill_after_frags:3"))
    try:
        f = Mux(jt, "v:0", _DrainVt()).fault
        assert f is not None and f._kill_after == 3
        monkeypatch.setenv("FDTPU_FAULTS", "v=fail_dispatch_n:2")
        f = Mux(jt, "v:0", _DrainVt()).fault
        assert (f._kill_after, f._fail_n) == (3, 2)
    finally:
        jt.close()
        jt.unlink()
