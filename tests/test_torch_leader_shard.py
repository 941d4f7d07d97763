"""The port's sharded pack (firedancer_tpu_torch/disco/leader_tiles.py
LeaderPackTile with shard_cnt > 1 and LeaderMergeTile; ballet/pack.py
writable_key_costs and MergeBudget; app/config.py leader-bench with
[leader] pack_shards) against the JAX package's, on the cases of
tests/test_leader_shard.py, each package's tiles driven by the same
recording ctx:

- fee-payer steering: the same fee payers, the same owned partitions and
  steer counts for each shard, the same after a respawn;
- the merge wire: the shards' published frags byte for byte, both
  schedulers of the port against the JAX Python one;
- LeaderMergeTile: the same admission order, seqs, defer and stall
  counts on the hot-account case, the round-robin interleave, the shards'
  real merge-wire frags and the drain;
- MergeBudget's all-or-nothing admission;
- leader-bench with pack_shards = 2: the same tiles, links and MTUs as
  the JAX build_topology."""

import collections

import pytest

from firedancer_tpu.ballet import pack as jpack
from firedancer_tpu.ballet import txn as jtxn
from firedancer_tpu.disco import tiles as jtiles
from firedancer_tpu_torch.app import config as pconfig
from firedancer_tpu_torch.ballet import entry as pentry
from firedancer_tpu_torch.ballet import pack as ppack
from firedancer_tpu_torch.ballet import txn as ptxn
from firedancer_tpu_torch.disco import leader_tiles as lt
from _torch_threads import one_torch_thread  # noqa: F401


def _mk_txn(signer: bytes, writable_extra=(), readonly_extra=(),
            program: bytes = b"\x07" * 32, data: bytes = b"\x00" * 8,
            cu_price=None) -> bytes:
    """The payload of tests/test_leader_shard.py's _mk_txn."""
    extra = list(writable_extra) + list(readonly_extra) + [program]
    n_accts = 1 + len(extra)
    prog_idx = n_accts - 1
    instrs = [(prog_idx, bytes([0]), data)]
    if cu_price is not None:
        cb = jpack.COMPUTE_BUDGET_PROG_ID
        extra = list(writable_extra) + list(readonly_extra) + [program, cb]
        n_accts = 1 + len(extra)
        prog_idx = n_accts - 2
        instrs = [(prog_idx, bytes([0]), data),
                  (n_accts - 1, b"", bytes([3]) + cu_price.to_bytes(8,
                                                                  "little"))]
    msg = jtxn.build_unsigned(
        [signer], b"\x11" * 32, instrs, extra_accounts=extra,
        readonly_unsigned_cnt=len(readonly_extra)
        + (2 if cu_price is not None else 1))
    return jtxn.assemble([b"\x5a" * 64], msg)


def _acct(i: int) -> bytes:
    return i.to_bytes(2, "little") + bytes(30)


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
        return len(self.out) - 1


PKGS = {"port": (lt.LeaderPackTile, lt.LeaderMergeTile),
        "jax": (jtiles.LeaderPackTile, jtiles.LeaderMergeTile)}


def _mixed_payloads(n: int = 90) -> list:
    """Votes, hot-account writers at several priorities and readers: the
    kinds of tests/test_leader_shard.py's schedule sweep."""
    import random
    rng = random.Random(77)
    out = []
    for i in range(n):
        kind = rng.randrange(10)
        signer = _acct(1 + rng.randrange(40))
        if kind < 2:
            out.append(_mk_txn(signer, program=jpack.VOTE_PROG_ID,
                               data=bytes(4)))
        elif kind < 5:
            out.append(_mk_txn(
                signer, writable_extra=[_acct(200 + rng.randrange(3))],
                cu_price=rng.choice([0, 1, 5_000, 10**6])))
        else:
            out.append(_mk_txn(
                signer, readonly_extra=[_acct(300 + rng.randrange(5))],
                data=bytes(4 * rng.randrange(1, 9)),
                cu_price=rng.choice([None, 0, 777, 10**9])))
    return out


def test_fee_payer_matches_the_jax_steering_key():
    for i in range(1, 40):
        p = _mk_txn(_acct(i), cu_price=i * 7 or None)
        o = ptxn.parse(p).acct_addr_off
        assert ptxn.fee_payer(p) == jtxn.fee_payer(p) == p[o:o + 32]
        assert ppack.acct_key(p[o:o + 32]) == jpack.acct_key(p[o:o + 32])
    for bad in (b"\x01", bytes(4)):
        assert ptxn.fee_payer(bad) is jtxn.fee_payer(bad) is None


def _owned(pack_cls, payloads, shard_idx):
    ctx = _Ctx(dict(shard_cnt=2, shard_idx=shard_idx, max_txn=4,
                    max_pending=0, block_us=10**9, native_pack=0))
    tile = pack_cls()
    tile.init(ctx)
    got = set()
    for p in payloads:
        before = tile.pack.pending
        tile._insert(ctx, p)
        if tile.pack.pending > before:
            got.add(p)
    return got, ctx.metrics.d["shard_steer_cnt"]


def test_shard_steering_equals_the_jax_tiles_across_respawn():
    payloads = [_mk_txn(_acct(i)) for i in range(1, 120)]
    payloads.append(b"\x01\x02")          # a broken header: shard 0's
    got = {pkg: [_owned(cls, payloads, s) for s in (0, 1, 0)]
           for pkg, (cls, _) in PKGS.items()}
    assert got["port"] == got["jax"]
    (o0, n0), (o1, n1), again = got["port"]
    assert again == (o0, n0)               # a fresh incarnation
    assert o0 | o1 == set(payloads[:-1]) and not o0 & o1
    assert o0 and o1 and (n0, n1) == (len(o0) + 1, len(o1))


def test_writable_key_costs_equal_the_jax_function():
    for p in _mixed_payloads(40):
        hp = ppack.Pack(bank_tile_cnt=1, native=False)
        hj = jpack.Pack(bank_tile_cnt=1, native=False)
        hp.insert(p, ptxn.parse(p))
        hj.insert(p, jtxn.parse(p))
        mp, mj = hp.schedule(0), hj.schedule(0)
        assert [ppack.writable_key_costs(h) for h in mp.txns] == \
            [jpack.writable_key_costs(h) for h in mj.txns]


def _shard_frags(pack_cls, payloads, shard_idx, native):
    ctx = _Ctx(dict(shard_cnt=2, shard_idx=shard_idx, max_txn=5,
                    max_pending=0, block_us=10**9, native_pack=native))
    tile = pack_cls()
    tile.init(ctx)
    for p in payloads:
        tile.on_frag(ctx, 0, None, p)
    while tile.drain(ctx) is not True:
        pass
    tile.fini(ctx)
    return ctx.out, {k: v for k, v in ctx.metrics.d.items()
                     if k != "pending"}


@pytest.mark.parametrize("native", [0, 1])
def test_merge_wire_equals_the_jax_shards(native):
    payloads = _mixed_payloads()
    for s in (0, 1):
        port = _shard_frags(lt.LeaderPackTile, payloads, s, native)
        jax_ = _shard_frags(jtiles.LeaderPackTile, payloads, s, 0)
        assert port == jax_
        frags, m = port
        assert frags and [q for _, q in frags] == list(range(len(frags)))
        assert m["sched_txn_cnt"] == m["shard_steer_cnt"]
        # the header's totals are the inner batch's: data bytes and one
        # write item per unique writable account
        for wire, _ in frags:
            n, cost, vote, data = lt.LeaderPackTile.MERGE_HDR.unpack_from(
                wire, 0)
            inner = wire[24 + 16 * n:]
            txns, _ = pentry.deserialize_txn_batch(inner)
            assert data == sum(len(t) for t in txns) and vote <= cost


def _merge(merge_cls, feed, block_us=10**9):
    ctx = _Ctx(dict(block_us=block_us))
    tile = merge_cls()
    tile.init(ctx)
    for iidx, frag in feed:
        tile.on_frag(ctx, iidx, None, frag)
    return tile, ctx


def test_merge_enforces_the_global_write_budget_as_the_jax_tile():
    hot = ppack.acct_key(_acct(99))
    near_cap = ppack.MAX_WRITE_COST_PER_ACCT - 10
    mk = lt.LeaderPackTile.MERGE_HDR.pack
    item = lt.LeaderPackTile.MERGE_ITEM.pack
    assert (mk(1, 2, 3, 4), item(5, 6)) == (
        jtiles.LeaderPackTile.MERGE_HDR.pack(1, 2, 3, 4),
        jtiles.LeaderPackTile.MERGE_ITEM.pack(5, 6))
    feed = [(0, mk(1, 1000, 0, 64) + item(hot, near_cap) + b"innerA"),
            (1, mk(1, 1000, 0, 64) + item(hot, near_cap) + b"innerB"),
            (1, b"\x01\x02")]                     # malformed: parse fail
    runs = []
    for _, merge_cls in PKGS.values():
        tile, ctx = _merge(merge_cls, feed)
        first = (list(ctx.out), dict(ctx.metrics.d))
        tile.budget.end_block()                   # the block rolls
        tile._admit(ctx)
        runs.append((first, ctx.out, dict(ctx.metrics.d)))
    assert runs[0] == runs[1]
    (out1, m1), out, m = runs[0]
    assert [p for p, _ in out1] == [b"innerA"]
    assert m1["merge_budget_defer_cnt"] >= 1 and m1["merge_stall_cnt"] >= 1
    assert m1["parse_fail_cnt"] == 1
    assert out == [(b"innerA", 0), (b"innerB", 1)]
    assert m["mb_merge_cnt"] == 2 and m["merge_q"] == 0


def test_merge_budget_all_or_nothing_as_the_jax_budget():
    seen = []
    for mod in (ppack, jpack):
        b = mod.MergeBudget()
        hot = 0x1234
        steps = [b.try_admit(10, 0, 10, [(hot, mod.MAX_WRITE_COST_PER_ACCT)])]
        steps.append(b.try_admit(10, 0, 10, [(0x9999, 5), (hot, 1)]))
        steps.append((b.block_cost, b.block_data,
                      0x9999 in b.acct_write_cost))
        steps.append(b.try_admit(10, 7, 10, [(0x9999, 5)]))
        steps.append((b.block_cost, b.block_vote_cost, b.block_data))
        b.end_block()
        steps.append(b.try_admit(10, 0, 10, [(hot, 1)]))
        seen.append(steps)
    assert seen[0] == seen[1]
    assert seen[0] == [True, False, (10, 10, False), True, (20, 7, 20), True]


def test_merge_round_robin_interleave_as_the_jax_tile():
    runs = []
    for _, merge_cls in PKGS.values():
        ctx = _Ctx(dict(block_us=10**9))
        tile = merge_cls()
        tile.init(ctx)
        # queue by hand so no admission happens between frags
        for tag in (b"a0", b"a1", b"a2"):
            tile._qs.setdefault(0, collections.deque()).append(
                (1, 0, 1, [], tag))
        tile._qs.setdefault(1, collections.deque()).append(
            (1, 0, 1, [], b"b0"))
        tile._admit(ctx)
        runs.append(ctx.out)
    assert runs[0] == runs[1]
    got = [p for p, _ in runs[0]]
    assert set(got[:2]) == {b"a0", b"b0"} and got[2:] == [b"a1", b"a2"]


def test_merge_of_the_shards_frags_and_its_drain_equal_the_jax_tile():
    """Both shards' real merge-wire frags, interleaved as they might
    arrive, with a global data budget so small that heads defer: the same
    merged stream, seqs and counts, and a drain that rolls the block
    until every queued microblock is out."""
    payloads = _mixed_payloads()
    shards = [_shard_frags(jtiles.LeaderPackTile, payloads, s, 0)[0]
              for s in (0, 1)]
    feed = []
    for i in range(max(map(len, shards))):
        for s in (1, 0):
            if i < len(shards[s]):
                feed.append((s, shards[s][i][0]))
    runs = []
    for pkg, (_, merge_cls) in PKGS.items():
        mod = ppack if pkg == "port" else jpack
        cap = mod.MAX_DATA_PER_BLOCK
        mod.MAX_DATA_PER_BLOCK = 3000
        try:
            tile, ctx = _merge(merge_cls, feed)
            first = len(ctx.out)
            n = 0
            while tile.drain(ctx) is not True:
                n += 1
            tile.fini(ctx)
        finally:
            mod.MAX_DATA_PER_BLOCK = cap
        runs.append((first, n, ctx.out, dict(ctx.metrics.d)))
    assert runs[0] == runs[1]
    first, n, out, m = runs[0]
    assert first < len(feed) == len(out) == m["mb_merge_cnt"]
    assert m["merge_budget_defer_cnt"] > 0 and "drain_drop_cnt" not in m
    assert [q for _, q in out] == list(range(len(out)))
    hdr = lt.LeaderPackTile.MERGE_HDR
    inner = sorted(f[24 + 16 * hdr.unpack_from(f, 0)[0]:] for _, f in feed)
    assert sorted(p for p, _ in out) == inner


def _shape(spec, drop=()):
    links = sorted((ln.name, ln.depth, ln.mtu) for ln in spec.links)
    tiles = [(t.name, t.kind, tuple(il.link for il in t.in_links),
              tuple(t.out_links),
              {k: v for k, v in t.cfg.items() if k not in drop})
             for t in spec.tiles]
    return links, tiles


def test_leader_bench_with_two_shards_equals_the_jax_topology():
    from firedancer_tpu.app import config as jconfig
    specs = []
    for mod in (pconfig, jconfig):
        cfg = mod.load(environ={})
        cfg["topology"] = "leader-bench"
        cfg["leader"]["pack_shards"] = 2
        specs.append(mod.build_topology(cfg))
    plinks, ptiles = _shape(specs[0])
    jlinks, jtls = _shape(specs[1])
    assert plinks == jlinks
    assert [t[:4] for t in ptiles] == [t[:4] for t in jtls]
    assert [t[0] for t in ptiles] == [
        "source", "verify:0", "leader_pack:0", "leader_pack:1",
        "leader_merge", "poh_dev", "sink"]
    mtxn = 31
    assert dict((n, m) for n, _, m in plinks)["pack_merge:0"] == (
        4 + mtxn * (4 + 1280) + 24 + 40 * mtxn * 16)
    # the shards' and the merge tile's cfg are the JAX package's
    for p, j in zip(ptiles, jtls):
        if p[1] in ("leader_pack", "leader_merge"):
            assert p[4] == j[4]
    assert [t[4]["shard_idx"] for t in ptiles if t[1] == "leader_pack"] == [
        0, 1]
