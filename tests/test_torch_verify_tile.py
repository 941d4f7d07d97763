"""The port's verify tile (firedancer_tpu_torch/disco/verify_tile.py) on
the CPU: through a recording ctx (the fake-ctx form of
tests/test_aot.py), against the JAX package's VerifyTile on the same
frags, and against the JAX package's host verifier; the settings the
port does not carry yet; and the rule that the port package imports
nothing of JAX or of the JAX package."""

import ast
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from firedancer_tpu.models import verifier as jv
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch.ballet import txn as txn_lib
from firedancer_tpu_torch.disco.pipeline import LAT_PRIO_BIT
from firedancer_tpu_torch.disco.verify_tile import TILES, VerifyTile
from firedancer_tpu_torch.models.verifier import (SigVerifier,
                                                  make_example_batch,
                                                  pack_blob)
from firedancer_tpu_torch.ops import ed25519 as ed
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
CFG = {"buckets": [[16, 256]]}
_SEEDS = [bytes([0x40 + i]) * 32 for i in range(3)]
_PUBS = [ed.keypair_from_seed(s)[0] for s in _SEEDS]


class _Metrics:
    def __init__(self):
        self.d = {}
        self.hists = {}

    def set(self, name, val):
        self.d[name] = val

    def add(self, name, delta=1):
        self.d[name] = self.d.get(name, 0) + delta

    def hist_store(self, name, histf):
        self.hists[name] = histf.counts.copy()


class RecCtx:
    """Records what a tile publishes: per-txn frags as (payload, sig),
    packed verdict frags as (chunk bytes, sig, sz) from an out buffer."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.metrics = _Metrics()
        self.trace = None
        self.published = []
        self.frags = []
        self.out = np.zeros(1 << 16, np.uint8)
        self.beats = 0

    def publish(self, payload, sig=0):
        self.published.append((bytes(payload), int(sig)))

    def publish_burst(self, buf, starts, lens, sigs):
        buf = bytes(buf)
        for s, n, g in zip(starts, lens, sigs):
            self.published.append((buf[int(s):int(s) + int(n)], int(g)))

    def out_reserve(self, nbytes):
        return 0, self.out[:nbytes]

    def out_commit(self, chunk, nbytes, sig=0, sz=0):
        self.frags.append((self.out[chunk:chunk + nbytes].tobytes(),
                           int(sig), int(sz)))

    def heartbeat(self):
        self.beats += 1


def _txn(rng, nonce, nsig=1, data_len=8, bad_sig=None):
    msg = txn_lib.build_unsigned(
        _PUBS[:nsig], rng.randbytes(32),
        [(nsig, bytes(range(nsig)),
          nonce.to_bytes(8, "little") + rng.randbytes(data_len - 8))],
        [rng.randbytes(32)])
    sigs = [ed.sign(s, msg) for s in _SEEDS[:nsig]]
    if bad_sig is not None:
        sigs[bad_sig] = bytes([sigs[bad_sig][0] ^ 1]) + sigs[bad_sig][1:]
    return txn_lib.assemble(sigs, msg)


def _frags():
    """Wire txns with every outcome: valid 1- and 2-signature txns, a
    2-signature txn whose second signature fails, a tampered first
    signature, repeats, a parse failure and a message over 256 bytes."""
    rng = random.Random(11)
    good = [_txn(rng, i) for i in range(20)]
    frags = good[:10] + [_txn(rng, 50, nsig=2), _txn(rng, 51, 2, bad_sig=1),
                         _txn(rng, 52, bad_sig=0), good[3], b"\x01garbage",
                         _txn(rng, 53, data_len=300), good[3]]
    return frags + good[10:] + [good[12], _txn(rng, 54, nsig=2)]


FRAGS = _frags()


def _expected(frags=None, one=jed.verify_one_host):
    """The host verifier's answer (`one` a signature): every signature
    must pass, the first copy of a first-signature tag wins, and no
    message over 256 bytes."""
    out, seen = [], set()
    for p in FRAGS if frags is None else frags:
        try:
            t = txn_lib.parse(p)
        except txn_lib.TxnParseError:
            continue
        msg = t.message(p)
        tag = int.from_bytes(p[1:9], "little")
        if len(msg) > 256 or tag in seen:
            continue
        if all(one(s, msg, k) for s, k in
               zip(t.signatures(p), t.signer_pubkeys(p))):
            seen.add(tag)
            out.append((p, tag))
    return out


def _burst(frags):
    """A ring rx burst: metas with the frag sig, a flat buffer, offsets."""
    buf = b"".join(frags)
    offs = np.zeros(len(frags) + 1, np.int64)
    np.cumsum([len(f) for f in frags], out=offs[1:])
    metas = np.zeros(len(frags), dtype=[("sig", np.uint64)])
    metas["sig"] = [int.from_bytes(f[1:9], "little") & (LAT_PRIO_BIT - 1)
                    for f in frags]
    return metas, np.frombuffer(buf, np.uint8), offs


def _run(tile, ctx, half_lat=False, frags=None):
    """Feed FRAGS (or frags) as two rx bursts, then halt: fini flushes
    the pipeline and publishes the verdicts."""
    frags = FRAGS if frags is None else frags
    tile.init(ctx)
    for part in (frags[:13], frags[13:]):
        metas, buf, offs = _burst(part)
        if half_lat:
            metas["sig"][::2] |= np.uint64(LAT_PRIO_BIT)
        tile.on_burst(ctx, 0, metas, buf, offs, len(part))
    tile.fini(ctx)
    return ctx


def _port_ctx(**cfg):
    return RecCtx({**CFG, "device": "cpu", **cfg})


def test_port_tile_publishes_what_the_host_verifier_accepts():
    ctx = _run(VerifyTile(), _port_ctx())
    assert ctx.published == _expected()
    m = ctx.metrics.d
    assert (m["txn_in_cnt"], m["parse_fail_cnt"], m["too_long_cnt"],
            m["dedup_drop_cnt"], m["compile_cnt"]) == (len(FRAGS), 1, 1, 3, 0)
    assert m["verify_pass_cnt"] == len(ctx.published)
    assert int(ctx.metrics.hists["batch_ns"].sum()) == m["batch_cnt"]
    assert ctx.beats > 0


def test_port_tile_latency_lane_and_scalar_frags():
    """Half the frags carry the latency-class bit (the mixed-burst split);
    then the scalar on_frag path: both publish the same set."""
    lat = _run(VerifyTile(), _port_ctx(
        latency={"enabled": 1, "shapes": [4, 16], "deadline_us": 10 ** 9}),
        half_lat=True)
    assert sorted(lat.published) == sorted(_expected())
    assert lat.metrics.d["compile_cnt"] == 0
    tile, ctx = VerifyTile(), _port_ctx(burst=False)
    tile.init(ctx)
    assert tile.on_burst is None
    for seq, p in enumerate(FRAGS):
        assert not tile.before_frag(ctx, 0, seq, 0)
        tile.on_frag(ctx, 0, {"sig": 0}, p)
    while not tile.drain(ctx):
        pass
    assert ctx.published == _expected()


def test_port_tile_packed_verdict_egress():
    """egress_packed: a packed-row frag's passing rows leave as ONE frag,
    a u32 offsets table then the wires (0x01 | sig | msg)."""
    tile, ctx = VerifyTile(), _port_ctx(egress_packed=1)
    tile.init(ctx)
    want = [p for p, _ in _expected() if txn_lib.parse(p).signature_cnt == 1]
    rows = np.zeros((16, 256 + ed.PACKED_EXTRA), np.uint8)
    for i, p in enumerate(want[:16]):
        t = txn_lib.parse(p)
        msg = t.message(p)
        rows[i, :len(msg)] = np.frombuffer(msg, np.uint8)
        rows[i, 256:320] = np.frombuffer(t.signatures(p)[0], np.uint8)
        rows[i, 320:352] = np.frombuffer(_PUBS[0], np.uint8)
        rows[i, 352:] = np.array([len(msg)], np.int32).view(np.uint8)
    tile._forward_burst(ctx, tile.pipe.submit_packed_rows(rows))
    tile.fini(ctx)
    assert ctx.published == []
    ((blob, sig, k),) = ctx.frags
    offs = np.frombuffer(blob[:4 * (k + 1)], np.uint32)
    body = blob[4 * (k + 1):]
    assert k == 16
    assert sig == int.from_bytes(want[0][1:9], "little") & (LAT_PRIO_BIT - 1)
    assert [body[a:b] for a, b in zip(offs[:-1], offs[1:])] == want[:16]


def test_port_tile_one_verifier_covers_the_ladder():
    """The tile's one SigVerifier is sized to the largest bucket and
    latency shape; a blob of every ladder shape goes through it with the
    host verifier's bits, and a blob past the largest raises."""
    ctx = _port_ctx(buckets=[[4, 64], [2, 128]],
                    latency={"enabled": 1, "shapes": [2, 8]})
    tile = VerifyTile()
    tile.init(ctx)
    # the pipeline dispatches through the tile's guard, which wraps the
    # one SigVerifier
    assert tile.pipe.verify_fn is tile.guard
    fn = tile.guard.fn
    assert isinstance(fn, SigVerifier)
    assert (fn.cfg.batch, fn.cfg.msg_maxlen) == (8, 128)
    assert tile.pipe.metrics.compile_cnt == 0
    for rows, ml in ((4, 64), (2, 128), (2, 64), (8, 64)):
        blob = pack_blob(*make_example_batch(rows, ml, valid=False, seed=5))
        bits = np.asarray(fn.dispatch_blob(blob))
        assert bits.tolist() == jv.host_verify_blob(blob).tolist()
    with pytest.raises(ValueError, match="exceeds the bucket"):
        fn.dispatch_blob(pack_blob(*make_example_batch(9, 64, seed=5)))


@pytest.mark.parametrize("cfg,match", [
    ({"dp_shards": 2}, "dp_shards"),
    ({"aot_require": True}, "aot_require"),
    ({"aot_dir": "store"}, "aot_dir"),
    ({"jax_trace_dir": "trace"}, "jax_trace_dir"),
])
def test_port_tile_refuses_what_is_not_ported(cfg, match):
    with pytest.raises(NotImplementedError, match=match):
        VerifyTile().init(_port_ctx(**cfg))


@pytest.mark.parametrize("how", ["cfg", "env"])
def test_port_tile_serves_antipa_mode(monkeypatch, how):
    """[verify] mode = antipa, or FDTPU_VERIFY_MODE=antipa over a strict
    cfg: the tile warms and serves an antipa SigVerifier under its guard,
    and publishes what the antipa host twin accepts, the torsion
    forgeries whose v is even among them; any other mode still raises."""
    from chip_smoke import torsion_txns
    tors = torsion_txns()
    frags = FRAGS[:20] + [w for w, _ in tors] + FRAGS[20:]
    if how == "env":
        monkeypatch.setenv("FDTPU_VERIFY_MODE", "antipa")
        ctx = _port_ctx(mode="strict")
    else:
        monkeypatch.delenv("FDTPU_VERIFY_MODE", raising=False)
        ctx = _port_ctx(mode="antipa")
    tile = VerifyTile()
    _run(tile, ctx, frags=frags)
    assert tile.verify_mode == "antipa" and tile.guard.fn.mode == "antipa"
    want = _expected(frags, jed.verify_one_host_antipa)
    assert ctx.published == want
    even = [w for w, e in tors if e]
    assert set(even) <= {p for p, _ in want}
    assert not set(even) & {p for p, _ in _expected(frags)}
    assert ctx.metrics.d["compile_cnt"] == 0
    monkeypatch.setenv("FDTPU_VERIFY_MODE", "fast")
    with pytest.raises(ValueError, match="strict|antipa"):
        VerifyTile().init(_port_ctx())


@pytest.mark.parametrize("cfg_val,native", [
    (1, True), (0, False), (None, True)])
def test_port_tile_takes_native_hostpath(cfg_val, native):
    """native_hostpath, which the tile used to refuse: 1 (the config's
    default, and the tile's when the cfg lacks it) runs the packed rows'
    one-pass C submit and finish, 0 their NumPy version.  The tcache is
    native either way, and both publish what the host verifier
    accepts."""
    from firedancer_tpu_torch.tango.tcache import NativeTCache
    cfg = {} if cfg_val is None else {"native_hostpath": cfg_val}
    tile = VerifyTile()
    ctx = _run(tile, _port_ctx(**cfg))
    assert ctx.published == _expected()
    assert isinstance(tile.pipe.tcache, NativeTCache)
    assert (tile.pipe._hp is not None) == native


def test_port_tile_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VerifyTile().init(RecCtx(dict(CFG)))
    assert TILES == {"verify": VerifyTile}


def test_port_imports_nothing_of_jax():
    """Every module of the port, and chip_smoke.py, imports neither JAX
    nor the JAX package (parsed, not grepped, so strings such as
    chip_smoke's "replaces" fields do not count)."""
    files = sorted((ROOT / "firedancer_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "firedancer_tpu"), (
                    f"{f.relative_to(ROOT)} imports {name}")


@pytest.mark.slow
def test_port_tile_matches_jax_tile():
    """The port tile and the JAX package's VerifyTile, one recording ctx
    each, cfg buckets [[16, 256]], the same rx bursts: identical
    published (payload, sig) lists and tile metrics.  Slow: the JAX
    tile's boot compiles its verify graph (about 100 s on a CPU host)."""
    from firedancer_tpu.disco.tiles import VerifyTile as JaxVerifyTile

    port = _run(VerifyTile(), _port_ctx())
    ref = _run(JaxVerifyTile(), RecCtx(dict(CFG)))
    assert port.published == ref.published == _expected()
    # times; the GuardedVerifier gauges; and the
    # lane occupancy: a repeat takes a lane or not as its first copy's
    # batch was harvested yet or not, and the JAX CPU backend dispatches
    # asynchronously
    drop = {"inflight_depth", "compile_ns", "degraded_mode",
            "device_fail_cnt", "fallback_lane_cnt", "reprobe_cnt",
            "fallback_vps", "lanes_filled_cnt", "bucket_fill_pct"}
    assert ({k: v for k, v in port.metrics.d.items() if k not in drop}
            == {k: v for k, v in ref.metrics.d.items() if k not in drop})
    assert port.metrics.hists.keys() == ref.metrics.hists.keys()
