"""The port's host tiles of the verify-bench topology
(firedancer_tpu_torch/disco/tiles.py) against the JAX package's: the
regenerated source stream, and SourceTile, DedupTile and SinkTile driven
through the same callbacks on the same frags by a recording ctx, one
ctx a package.  What each tile publishes, and its counters, must be
equal."""

import collections
import types

import numpy as np
import pytest

from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu_torch.disco import tiles as ptiles
from firedancer_tpu_torch.disco.pipeline import LAT_PRIO_BIT
from firedancer_tpu_torch.tango.ring import FRAG_META_DTYPE


class _Ctx:
    """Records what a tile publishes: (payload, sig) a frag, and each
    reserved-then-committed region with its commit arguments."""

    def __init__(self, cfg, mc=None):
        self.cfg = cfg
        self.tile = types.SimpleNamespace(in_links=[], out_links=["o"])
        self.counts = collections.Counter()
        self.metrics = types.SimpleNamespace(
            add=lambda k, v=1: self.counts.update({k: int(v)}),
            set=lambda k, v: self.counts.update({k: 0}))
        self.out = []
        self.committed = []
        self._mc = mc
        self._res = None

    def publish(self, payload, sig=0, out=0, ctl_=None):
        self.out.append((bytes(payload), int(sig)))

    def publish_burst(self, buf, starts, lens, sigs, out=0):
        buf = np.asarray(buf).reshape(-1)
        for s, n, g in zip(starts, lens, sigs):
            self.out.append((buf[int(s):int(s) + int(n)].tobytes(), int(g)))

    def out_reserve(self, nbytes, out=0):
        self._res = np.full(nbytes, 0xAA, np.uint8)
        return len(self.committed), self._res

    def out_commit(self, chunk, nbytes, sig=0, sz=None, out=0):
        self.committed.append((chunk, nbytes, int(sig), sz,
                               self._res.tobytes()))

    def in_mcache(self, iidx):
        return self._mc


def _run_both(cls_j, cls_p, cfg, drive, mc=None):
    """Init each package's tile on its own ctx and drive it the same way;
    returns the two ctxs and the two tiles."""
    out = []
    for cls in (cls_j, cls_p):
        ctx = _Ctx(dict(cfg), mc)
        tile = cls()
        tile.init(ctx)
        drive(tile, ctx)
        out.append((ctx, tile))
    return out


@pytest.mark.parametrize("seed,keys,count,start", [
    (42, 4, 6, 0), (7, 3, 9, 5), (1234, 4, 3, 2)])
def test_source_txn_stream_equals_the_jax_package(seed, keys, count, start):
    got = list(ptiles.source_txn_stream(seed, keys, count, start))
    want = list(jtiles.source_txn_stream(seed, keys, count, start))
    assert len(got) == count - start
    assert got == want


@pytest.mark.parametrize("cfg,loops", [
    ({"seed": 11, "keys": 3, "count": 5, "lat_every": 2}, 7),
    ({"seed": 5, "count": 40, "burst_n": 16, "lat_every": 3}, 4),
    ({"seed": 9, "count": 40, "packed_rows": 16, "packed_ml": 160,
      "burst_splits": 2}, 3),
], ids=["per_txn", "burst", "packed"])
def test_source_tile_equals_the_jax_tile(cfg, loops):
    def drive(tile, ctx):
        for _ in range(loops):
            tile.after_credit(ctx)

    (jc, _), (pc, _) = _run_both(jtiles.SourceTile, ptiles.SourceTile,
                                 cfg, drive)
    assert pc.out == jc.out and pc.committed == jc.committed
    assert pc.counts == jc.counts
    assert pc.counts["txn_gen_cnt"] == cfg["count"]
    if "burst_n" not in cfg and "packed_rows" not in cfg:
        stream = list(ptiles.source_txn_stream(cfg["seed"], cfg["keys"],
                                               cfg["count"]))
        assert [w for w, _ in pc.out] == [w for _, w in stream]
        assert [s & (LAT_PRIO_BIT - 1) for _, s in pc.out] == [
            t & (LAT_PRIO_BIT - 1) for t, _ in stream]


def _metas(tags, sizes=None, seqs=None, chunks=None):
    m = np.zeros(len(tags), FRAG_META_DTYPE)
    m["sig"] = np.asarray(tags, np.uint64)
    if sizes is not None:
        m["sz"] = sizes
    if seqs is not None:
        m["seq"] = seqs
    if chunks is not None:
        m["chunk"] = chunks
    return m


def test_dedup_tile_per_frag_and_burst_equal_the_jax_tile():
    """Duplicates within a burst, across bursts and between the per-frag
    and the burst path: the same survivors and counters."""
    rng = np.random.default_rng(33)
    pool = rng.integers(1, 1 << 62, 12, dtype=np.uint64)
    singles = rng.choice(pool, 8)
    bursts = []
    for _ in range(4):
        tags = rng.choice(pool, 10)
        offs = np.concatenate([[0], np.cumsum(rng.integers(1, 40, 10))])
        bursts.append((tags, rng.integers(0, 256, int(offs[-1]),
                                          dtype=np.uint8), offs))

    def drive(tile, ctx):
        for t in singles:
            tile.on_frag(ctx, 0, _metas([t])[0], int(t).to_bytes(8, "little"))
        for tags, buf, offs in bursts:
            tile.on_burst(ctx, 0, _metas(tags), buf, offs, len(tags))

    (jc, jt), (pc, pt) = _run_both(jtiles.DedupTile, ptiles.DedupTile, {},
                                   drive)
    assert pc.out == jc.out and pc.counts == jc.counts
    seen = set(singles.tolist()).union(*(t.tolist() for t, _, _ in bursts))
    assert pc.counts["uniq_cnt"] == len(seen) == len(pc.out)
    assert (pt.on_burst_view is None) and (jt.on_burst_view is None)


class _Dcache:
    """A dcache over a byte array: chunk = byte offset."""

    def __init__(self, arr):
        self.arr = arr

    def view(self, chunk, sz):
        return self.arr[chunk:chunk + sz]


class _Mcache:
    """Every seq reads as current except those in `lapped`."""

    def __init__(self, lapped=()):
        self.lapped = set(lapped)

    def query(self, seq):
        return (1 if seq in self.lapped else 0), None


def test_dedup_tile_packed_egress_equals_the_jax_tile():
    """Packed verdict arenas (u32 offs[k+1] | wires), with tags repeated
    across arenas and one arena lapped by its producer: the same
    survivors, torn drops and counters."""
    rng = np.random.default_rng(34)
    wires = [b"\x01" + rng.bytes(64) + rng.bytes(int(n))
             for n in rng.integers(20, 120, 30)]
    arenas, at = [], 0
    buf = bytearray()
    for lo, hi in ((0, 10), (5, 18), (18, 24), (0, 30)):
        ws = wires[lo:hi]
        offs = np.concatenate([[0], np.cumsum([len(w) for w in ws])])
        blob = offs.astype(np.uint32).tobytes() + b"".join(ws)
        arenas.append((at, len(ws)))
        buf += blob
        at += len(blob)
    dc = _Dcache(np.frombuffer(bytes(buf), np.uint8))
    metas = _metas([0] * 4, sizes=[k for _, k in arenas], seqs=[0, 1, 2, 3],
                   chunks=[c for c, _ in arenas])

    def drive(tile, ctx):
        tile.on_burst_view(ctx, 0, metas[:2], dc)
        tile.on_burst_view(ctx, 0, metas[2:], dc)

    cfg = {"packed_egress": 1}
    (jc, jt), (pc, pt) = _run_both(jtiles.DedupTile, ptiles.DedupTile, cfg,
                                   drive, mc=_Mcache(lapped={2}))
    assert pc.out == jc.out and pc.counts == jc.counts
    assert pc.counts["torn_drop_cnt"] == 1
    # the lapped arena's tags never reach the tcache, so its wires pass
    # when the last arena carries them again
    assert [w for w, _ in pc.out] == wires
    assert [s for _, s in pc.out] == [
        int.from_bytes(w[1:9], "little") for w in wires]
    assert (pt.on_burst is None) and (jt.on_burst is None)


@pytest.mark.parametrize("capture", [True, False])
def test_sink_tile_equals_the_jax_tile(tmp_path, capture):
    rng = np.random.default_rng(35)
    frags = [(int(rng.integers(0, 1 << 63)), rng.bytes(int(n)))
             for n in rng.integers(0, 200, 12)]
    caps = []
    for name, cls in (("j", jtiles.SinkTile), ("p", ptiles.SinkTile)):
        path = tmp_path / f"{name}.cap"
        ctx = _Ctx({"capture_path": str(path) if capture else ""})
        tile = cls()
        tile.init(ctx)
        for sig, payload in frags[:6]:
            tile.on_frag(ctx, 0, _metas([sig])[0], payload)
        if tile.on_burst is not None:
            tile.on_burst(ctx, 0, _metas([s for s, _ in frags[6:]]),
                          None, None, 6)
        else:
            for sig, payload in frags[6:]:
                tile.on_frag(ctx, 0, _metas([sig])[0], payload)
        tile.fini(ctx)
        caps.append((ctx.counts, path.read_bytes() if capture else None))
    assert caps[0] == caps[1]
    assert caps[1][0]["frag_cnt"] == 12
    if capture:
        assert ptiles.read_capture(str(tmp_path / "p.cap")) == frags
