"""The port's topology in processes on the CPU (the cases of
tests/test_topo_run.py and the packed topology of
tests/test_hostpath_zero_copy.py, without pack and bank): the port's
verify-bench topology, source -> verify -> dedup -> sink, each tile a
spawned process over the port's rings, the verify tiles on device "cpu"
at buckets [[16, 256]].  Every test bounds itself: wait_ready and its wait
loops have deadlines, and the topology halts and unlinks in a finally."""

import os
import time

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch.app import config as app_config
from firedancer_tpu_torch.ballet import txn as txn_lib
from firedancer_tpu_torch.disco.run import TopoRun
from firedancer_tpu_torch.disco.tiles import read_capture, source_txn_stream
from firedancer_tpu_torch.disco.topo import TopoBuilder
from firedancer_tpu_torch.tango.ring import tx_burst


@pytest.fixture(autouse=True)
def _one_thread_children(monkeypatch):
    # spawned tile processes do not inherit torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _wait(pred, timeout_s, what=""):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {what}")


def _bench_cfg(tag, tmp_path, **dev):
    cfg = app_config.load(environ={})
    cfg["name"] = f"tt{tag}{os.getpid()}"
    cfg["tiles"]["verify"].update(device="cpu", buckets=[[16, 256]],
                                  flush_age_ns=20_000_000)
    cfg["tiles"]["sink"] = {"capture_path": str(tmp_path / "cap.bin")}
    cfg["supervision"]["drain_timeout_s"] = 30.0
    cfg["development"].update(dev)
    return cfg


def test_verify_bench_end_to_end(tmp_path):
    """48 distinct valid txns through the port's verify-bench topology:
    all verified, all unique at dedup, the sink's capture equal to
    source_txn_stream, poll() None throughout, and drain() True."""
    n = 48
    cfg = _bench_cfg("e2e", tmp_path, source_count=n)
    spec = app_config.build_topology(cfg)
    run = TopoRun(spec, policy=None)
    try:
        run.wait_ready(timeout=120)

        def arrived():
            assert run.poll() is None, "a tile failed"
            return run.metrics("sink")["frag_cnt"] == n

        _wait(arrived, 120, f"{n} txns at the sink")
        v = run.metrics("verify:0")
        assert v["verify_pass_cnt"] == n
        assert v["verify_fail_cnt"] == v["parse_fail_cnt"] == 0
        assert v["torn_drop_cnt"] == 0 and v["compile_cnt"] == 0
        d = run.metrics("dedup")
        assert d["uniq_cnt"] == n and d["dup_drop_cnt"] == 0
        assert run.drain(30.0) is True
        assert run.exitcodes == {t.name: 0 for t in spec.tiles}
        want = list(source_txn_stream(cfg["development"]["bench_seed"], 4, n))
        got = read_capture(str(tmp_path / "cap.bin"))
        assert sorted(got) == sorted(want)
    finally:
        run.close()


def _host_ok(wire) -> bool:
    """The JAX package's host verifier over every signature of a txn."""
    t = txn_lib.parse(wire)
    msg = t.message(wire)
    return all(jed.verify_one_host(s, msg, k) for s, k in
               zip(t.signatures(wire), t.signer_pubkeys(wire)))


def test_forged_and_repeated_txns_in_processes(tmp_path):
    """source -> verify -> dedup -> sink in processes, with a second
    in-link into the verify tile that the test writes by hand: beside the
    source's 32 txns, 8 valid txns of another stream, 8 forged ones (a
    signature bit flipped), 4 repeats of the source's txns and 2 copies
    of source txns with a message byte changed (same signature, so the
    same tag).  The sink's capture must hold exactly the txns the JAX
    package's host verifier passes, each once, and every tile must exit
    0 at the halt."""
    n, seed = 32, 42
    src = [w for _, w in source_txn_stream(seed, 4, n)]
    forged = []
    for _, w in source_txn_stream(8, 4, 8):
        b = bytearray(w)
        b[1 + 40] ^= 1
        forged.append(bytes(b))
    for w in src[5:7]:
        b = bytearray(w)
        b[-1] ^= 1
        forged.append(bytes(b))
    inj = [w for _, w in source_txn_stream(7, 4, 8)] + forged + src[:4]
    inj = [inj[i] for i in np.random.default_rng(9).permutation(len(inj))]
    want = sorted({(int.from_bytes(w[1:9], "little"), w)
                   for w in src + inj if _host_ok(w)})
    assert len(want) == n + 8
    cap = tmp_path / "cap.bin"
    spec = (
        TopoBuilder(f"ttfg{os.getpid()}", wksp_mb=16)
        .link("src_verify", depth=4096, mtu=1280)
        .link("inj_verify", depth=256, mtu=1280)
        .link("verify_dedup", depth=256, mtu=1280)
        .link("dedup_sink", depth=256, mtu=1280)
        .tile("source", "source", outs=["src_verify"], count=n, seed=seed)
        # a tile that publishes nothing stands as inj_verify's producer
        .tile("inj", "sink", outs=["inj_verify"])
        .tile("verify:0", "verify", ins=["src_verify", "inj_verify"],
              outs=["verify_dedup"], device="cpu", buckets=[[16, 256]],
              flush_age_ns=20_000_000)
        .tile("dedup", "dedup", ins=["verify_dedup"], outs=["dedup_sink"])
        .tile("sink", "sink", ins=["dedup_sink"], capture_path=str(cap))
        .build())
    run = TopoRun(spec)
    try:
        run.wait_ready(timeout=120)
        lnk = run.jt.links["inj_verify"]
        lens = np.array([len(w) for w in inj], np.int32)
        starts = np.zeros(len(inj), np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        sigs = np.array([int.from_bytes(w[1:9], "little") & ((1 << 63) - 1)
                         for w in inj], np.uint64)
        tx_burst(lnk.mcache, lnk.dcache, lnk.dcache.chunk0, b"".join(inj),
                 starts, lens, sigs)
        lnk = None

        def verdicted():
            assert run.poll() is None, "a tile failed"
            v = run.metrics("verify:0")
            return (v["verify_pass_cnt"] + v["verify_fail_cnt"]
                    + v["dedup_drop_cnt"]) == n + len(inj)

        _wait(verdicted, 120, "every txn verdicted")
        assert run.drain(30.0) is True
        assert run.exitcodes == {t.name: 0 for t in spec.tiles}
        assert sorted(read_capture(str(cap))) == want
        v = run.metrics("verify:0")
        # the 8 with a flipped signature bit fail at verify; a same-tag
        # copy fails there too, unless its source txn passed first and
        # the tcache drops it before verify (the order is the scheduler's)
        assert 8 <= v["verify_fail_cnt"] <= len(forged)
        assert v["parse_fail_cnt"] == v["torn_drop_cnt"] == 0
        assert run.metrics("dedup")["uniq_cnt"] == len(want)
    finally:
        run.close()


def test_supervision_detects_tile_death():
    spec = (
        TopoBuilder(f"ttsup{os.getpid()}", wksp_mb=8)
        .link("s_k", depth=64, mtu=256)
        .tile("source", "source", outs=["s_k"], count=4)
        .tile("sink", "sink", ins=["s_k"])
        .build()
    )
    run = TopoRun(spec)
    try:
        run.wait_ready(timeout=60)
        assert run.poll() is None
        run.procs["sink"].terminate()
        _wait(lambda: run.poll() == "sink", 10, "death detection")
    finally:
        run.close()
    # the sink died before the halt (poll's to report); the source halted
    assert run.exitcodes == {"source": 0, "sink": -15}


def test_packed_firehose_two_tiles(tmp_path):
    """Two verify tiles on packed-wire frags of 16 rows: every row taken
    by one tile, both tiles take work, no torn frag, and every stamped
    row fails verify."""
    n = 16 * 24
    cfg = _bench_cfg("pk", tmp_path, packed_wire=1, source_count=n)
    cfg["layout"]["verify_tile_count"] = 2
    cfg["tiles"]["verify"]["batch"] = 16
    spec = app_config.build_topology(cfg)
    run = TopoRun(spec)
    try:
        run.wait_ready(timeout=120)

        def taken():
            assert run.poll() is None, "a tile failed"
            return sum(run.metrics(f"verify:{v}")["verify_fail_cnt"]
                       for v in range(2)) == n

        _wait(taken, 120, f"{n} packed rows verdicted")
        ms = [run.metrics(f"verify:{v}") for v in range(2)]
        assert sum(m["txn_in_cnt"] for m in ms) == n
        assert all(m["txn_in_cnt"] > 0 for m in ms)
        assert all(m["torn_drop_cnt"] == 0 for m in ms)
        assert all(m["verify_fail_cnt"] == m["txn_in_cnt"] for m in ms)
        assert run.drain(30.0) is True
        assert run.exitcodes == {t.name: 0 for t in spec.tiles}
    finally:
        run.close()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="needs a host without a GPU")
def test_boot_failure_is_reported():
    """A verify tile with no device given runs on the GPU; with no GPU its
    boot raises, and wait_ready reports the tile died during boot."""
    spec = (
        TopoBuilder(f"ttbf{os.getpid()}", wksp_mb=8)
        .link("s_v", depth=64, mtu=1280)
        .tile("source", "source", outs=["s_v"], count=1)
        .tile("verify", "verify", ins=["s_v"], buckets=[[4, 64]])
        .build()
    )
    run = TopoRun(spec)
    try:
        with pytest.raises(RuntimeError, match="verify died during boot"):
            run.wait_ready(timeout=60)
    finally:
        run.close()
