"""The port's pack scheduler (firedancer_tpu_torch/ballet/pack.py, with its
C hot loop native/packsched.cpp in the port's host library) against the
JAX package's Pack, in both native_pack settings: the cases of
tests/test_pack.py, the native/Python sweeps of tests/test_leader_shard.py,
and the account keys, each run through both packages with the stream of
microblocks, the metrics and the pending count compared."""

import random

import pytest

from firedancer_tpu.ballet import pack as jpack
from firedancer_tpu.ballet import txn as jtxn
from firedancer_tpu_torch import native as native_mod
from firedancer_tpu_torch.ballet import pack
from firedancer_tpu_torch.ballet import txn as txn_lib

NATIVE = [False, True]


def _mk_txn(signer, writable_extra=(), readonly_extra=(),
            program=b"\x07" * 32, data=b"\x00" * 8, cu_price=None,
            tl=txn_lib):
    """One-signer txn: accounts = [signer(w)] + writable_extra +
    readonly_extra + [program(r)] (+ the compute-budget program)."""
    extra = list(writable_extra) + list(readonly_extra) + [program]
    n_accts = 1 + len(extra)
    prog_idx = n_accts - 1
    instrs = [(prog_idx, bytes([0]), data)]
    if cu_price is not None:
        cb = pack.COMPUTE_BUDGET_PROG_ID
        extra = list(writable_extra) + list(readonly_extra) + [program, cb]
        n_accts = 1 + len(extra)
        prog_idx = n_accts - 2
        instrs = [
            (prog_idx, bytes([0]), data),
            (n_accts - 1, b"", bytes([3]) + cu_price.to_bytes(8, "little")),
        ]
    msg = tl.build_unsigned(
        [signer], b"\x11" * 32, instrs, extra_accounts=extra,
        readonly_unsigned_cnt=len(readonly_extra)
        + (2 if cu_price is not None else 1))
    return tl.assemble([b"\x5a" * 64], msg)


def _acct(i: int) -> bytes:
    return bytes([i]) * 32


class _Both:
    """One scenario run on a package: `pk` its pack module, `tl` its txn
    module; `txn` builds a (payload, parsed) pair with that package."""

    def __init__(self, pk, tl, native):
        self.pk, self.tl, self.native = pk, tl, native

    def txn(self, *a, **kw):
        payload = _mk_txn(*a, tl=self.tl, **kw)
        return payload, self.tl.parse(payload)

    def new(self, **kw):
        p = self.pk.Pack(native=self.native, **kw)
        assert p.native == self.native
        return p


def _drain(p, ids=None):
    """Schedule bank 0 until empty: the stream of microblocks."""
    out = []
    while True:
        mb = p.schedule(0)
        if mb is None:
            return out
        out.append(tuple(ids[h.payload] if ids else h.payload
                         for h in mb.txns))
        p.done(0)


# -- the cases of tests/test_pack.py, each returning what it observed ------

def sc_cost_model(b):
    pay, parsed = b.txn(_acct(1), data=b"\x00" * 40)
    c = b.pk.compute_cost(parsed, pay)
    assert c.total == (b.pk.COST_PER_SIGNATURE + b.pk.COST_PER_WRITABLE_ACCT
                       + 40 // b.pk.INV_COST_PER_INSTR_DATA_BYTE
                       + b.pk.DEFAULT_INSTR_COMPUTE_UNITS)
    vpay, vparsed = b.txn(_acct(2), program=b.pk.VOTE_PROG_ID,
                          data=b"\x00" * 4)
    v = b.pk.compute_cost(vparsed, vpay)
    assert v.is_simple_vote
    assert v.total == (b.pk.COST_PER_SIGNATURE + b.pk.COST_PER_WRITABLE_ACCT
                       + 1 + b.pk.BUILTIN_COSTS[b.pk.VOTE_PROG_ID])
    ppay, pparsed = b.txn(_acct(3), cu_price=5_000_000)
    pc = b.pk.compute_cost(pparsed, ppay)
    return ((c.total, c.is_simple_vote), (v.total, v.is_simple_vote),
            (pc.total, pc.cu_price_micro_lamports, pc.requested_cu),
            b.pk.reward(pparsed, pc))


def sc_priority_order(b):
    p = b.new(bank_tile_cnt=1)
    lo, hi = b.txn(_acct(1)), b.txn(_acct(2), cu_price=5_000_000)
    assert p.insert(*lo) and p.insert(*hi)
    mb = p.schedule(0)
    assert mb.txns[0].payload == hi[0]
    return [h.payload for h in mb.txns]


def sc_conflicting_writes(b):
    p = b.new(bank_tile_cnt=2, max_txn_per_microblock=1)
    shared = _acct(9)
    a = b.txn(_acct(1), writable_extra=[shared])
    c = b.txn(_acct(2), writable_extra=[shared])
    p.insert(*a)
    p.insert(*c)
    assert p.schedule(0) is not None
    assert p.schedule(1) is None
    assert p.metrics["delayed_conflict"] >= 1
    p.done(0)
    mb1 = p.schedule(1)
    assert mb1.txns[0].payload == c[0]
    return dict(p.metrics)


def sc_read_read(b):
    p = b.new(bank_tile_cnt=2, max_txn_per_microblock=1)
    ro = _acct(8)
    p.insert(*b.txn(_acct(1), readonly_extra=[ro]))
    p.insert(*b.txn(_acct(2), readonly_extra=[ro]))
    assert p.schedule(0) is not None
    assert p.schedule(1) is not None
    return dict(p.metrics)


def sc_write_read(b):
    p = b.new(bank_tile_cnt=2, max_txn_per_microblock=1)
    shared = _acct(7)
    p.insert(*b.txn(_acct(1), writable_extra=[shared]))
    p.insert(*b.txn(_acct(2), readonly_extra=[shared]))
    assert p.schedule(0) is not None
    assert p.schedule(1) is None
    p.done(0)
    assert p.schedule(1) is not None
    return dict(p.metrics)


def sc_intra_microblock(b):
    p = b.new(bank_tile_cnt=1, max_txn_per_microblock=8)
    for i in range(4):
        p.insert(*b.txn(_acct(10 + i), writable_extra=[_acct(6)]))
    stream = _drain(p)
    assert [len(m) for m in stream] == [1, 1, 1, 1]
    return stream


def sc_block_cost_limit(b):
    p = b.new(bank_tile_cnt=1, max_txn_per_microblock=1000)
    n = 260
    for i in range(n):
        p.insert(*b.txn(bytes([i % 250, i // 250]) + b"\x00" * 30))
    stream = _drain(p)
    scheduled = sum(len(m) for m in stream)
    assert scheduled < n and p.pending == n - scheduled
    assert p.block_cost <= b.pk.MAX_COST_PER_BLOCK
    p.end_block()
    assert p.schedule(0) is not None
    return stream, p.block_cost, p.pending


def sc_acct_write_limit(b):
    p = b.new(bank_tile_cnt=1, max_txn_per_microblock=1000)
    for i in range(80):
        p.insert(*b.txn(bytes([i]) + b"\x01" * 31, writable_extra=[_acct(5)]))
    stream = _drain(p)
    assert p.block_cost <= b.pk.MAX_WRITE_COST_PER_ACCT
    return stream, p.pending


def sc_priority_pin(b):
    def build():
        p = b.new(bank_tile_cnt=1, max_txn_per_microblock=8)
        ids = {}
        for i, price in [(1, 400_000), (2, 100_000), (3, 400_000),
                         (4, None), (5, 7_000_000)]:
            pay, pr = b.txn(_acct(i), cu_price=price)
            ids[pay] = i
            assert p.insert(pay, pr)
        return [i for m in _drain(p, ids) for i in m]

    first = build()
    assert first == [5, 1, 3, 2, 4] and build() == first
    return first


def sc_max_pending_vote_bypass(b):
    p = b.new(bank_tile_cnt=1, max_pending=2)
    for i in range(2):
        assert p.insert(*b.txn(_acct(1 + i)))
    assert not p.insert(*b.txn(_acct(3)))
    assert p.insert(*b.txn(_acct(4), program=b.pk.VOTE_PROG_ID,
                           data=b"\x00" * 4))
    assert p.pending == 3
    return dict(p.metrics)


def sc_vote_cost_continue(b):
    p = b.new(bank_tile_cnt=1, max_txn_per_microblock=1000)
    vpay, vparsed = b.txn(_acct(200), program=b.pk.VOTE_PROG_ID,
                          data=b"\x00" * 4)
    vote_cost = b.pk.compute_cost(vparsed, vpay).total
    for i in range(b.pk.MAX_VOTE_COST_PER_BLOCK // vote_cost + 5):
        assert p.insert(*b.txn(bytes([i % 250, 1 + i // 250]) + b"\x02" * 30,
                               program=b.pk.VOTE_PROG_ID, data=b"\x00" * 4))
    reg = b.txn(_acct(199))
    assert p.insert(*reg)
    stream = _drain(p)
    assert any(reg[0] in m for m in stream)
    assert p.block_vote_cost <= b.pk.MAX_VOTE_COST_PER_BLOCK
    return stream, p.block_vote_cost, p.pending


def sc_bank_misuse(b):
    p = b.new(bank_tile_cnt=1)
    p.insert(*b.txn(_acct(1)))
    assert p.schedule(0) is not None
    with pytest.raises(ValueError):
        p.schedule(0)
    with pytest.raises(ValueError):
        p.end_block()
    p.done(0)
    p.end_block()
    assert p.clear_pending() == 0
    p.insert(*b.txn(_acct(2)))
    assert p.clear_pending() == 1 and p.pending == 0
    return dict(p.metrics)


SCENARIOS = [sc_cost_model, sc_priority_order, sc_conflicting_writes,
             sc_read_read, sc_write_read, sc_intra_microblock,
             sc_block_cost_limit, sc_acct_write_limit, sc_priority_pin,
             sc_max_pending_vote_bypass, sc_vote_cost_continue,
             sc_bank_misuse]


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_pack_case_equals_the_jax_package(scenario, native):
    """The JAX Pack runs its Python scheduler (its C one is the same code
    as the port's; the sweeps below hold the two C builds together)."""
    got = scenario(_Both(pack, txn_lib, native))
    want = scenario(_Both(jpack, jtxn, False))
    assert got == want


# -- the native/Python sweeps of tests/test_leader_shard.py ----------------

def _sweep_stream(pk, native, payloads, banks=2, max_pending=48):
    p = pk.Pack(bank_tile_cnt=banks, max_txn_per_microblock=5,
                max_pending=max_pending, native=native)
    stream = []
    for pay, parsed in payloads:
        p.insert(pay, parsed)
    stalls = 0
    busy = [False] * banks
    bank = 0
    while stalls < 2 * banks + 2:
        if busy[bank]:
            p.done(bank)
            busy[bank] = False
        mb = p.schedule(bank)
        if mb is None:
            if p.pending and all(not b for b in busy):
                p.end_block()
                stream.append(("END",))
                stalls += 1
            else:
                stalls += 1
        else:
            stalls = 0
            busy[bank] = True
            stream.append((bank, tuple(mb.payloads)))
        bank = (bank + 1) % banks
    for b in range(banks):
        if busy[b]:
            p.done(b)
    return stream, dict(p.metrics), p.pending


def _sweep_payloads(tl, seed=1234):
    rng = random.Random(seed)
    out = []
    for i in range(300):
        kind = rng.randrange(10)
        signer = (1 + rng.randrange(40)).to_bytes(2, "little") + bytes(30)
        if kind < 2:
            pay = _mk_txn(signer, program=pack.VOTE_PROG_ID, data=bytes(4),
                          tl=tl)
        elif kind < 5:
            pay = _mk_txn(signer, writable_extra=[
                (200 + rng.randrange(3)).to_bytes(2, "little") + bytes(30)],
                cu_price=rng.choice([0, 1, 1, 5_000, 5_000, 10**6]), tl=tl)
        else:
            pay = _mk_txn(signer, readonly_extra=[
                (300 + rng.randrange(5)).to_bytes(2, "little") + bytes(30)],
                data=bytes(4 * rng.randrange(1, 9)),
                cu_price=rng.choice([None, 0, 777, 777, 10**9]), tl=tl)
        out.append((pay, tl.parse(pay)))
    return out


@pytest.mark.parametrize("native", NATIVE)
def test_sweep_equals_the_jax_package(native):
    """300 txns of votes, hot-account conflicts and priority ties over two
    banks with block rolls: the port's stream, metrics and pending equal
    the JAX package's C and Python schedulers'."""
    got = _sweep_stream(pack, native, _sweep_payloads(txn_lib))
    jpay = _sweep_payloads(jtxn)
    assert got == _sweep_stream(jpack, False, jpay)
    assert got == _sweep_stream(jpack, True, jpay)


@pytest.mark.parametrize("native", NATIVE)
def test_vote_bypass_and_cap_boundary(native):
    payloads = [(_mk_txn(_acct(i)),) for i in range(1, 8)]
    votes = [_mk_txn(_acct(50 + i), program=pack.VOTE_PROG_ID, data=bytes(4))
             for i in range(3)]
    p = pack.Pack(bank_tile_cnt=1, max_txn_per_microblock=31, max_pending=4,
                  native=native)
    ins = [p.insert(pay, txn_lib.parse(pay)) for (pay,) in payloads]
    assert ins == [True] * 4 + [False] * 3
    assert all(p.insert(v, txn_lib.parse(v)) for v in votes)
    assert p.pending == 7
    assert p.metrics["dropped_heap_full"] == 3
    assert p.metrics["vote_inserted"] == 3


def test_acct_key_equals_the_jax_package_and_the_c_one():
    rng = random.Random(5)
    L = native_mod.lib()
    for _ in range(200):
        addr = bytes(rng.randrange(256) for _ in range(32))
        k = pack.acct_key(addr)
        assert k == jpack.acct_key(addr) == L.fd_pack_acct_key(addr)
    assert pack.BUILTIN_COSTS == jpack.BUILTIN_COSTS
    assert pack.MAX_DATA_PER_BLOCK == jpack.MAX_DATA_PER_BLOCK


def test_merge_budget_equals_the_jax_package():
    """The same seeded admissions and block ends through both packages'
    MergeBudget: the same verdicts and the same budgets after each."""
    rng = random.Random(11)
    keys = [rng.getrandbits(64) for _ in range(6)]
    ours, theirs = pack.MergeBudget(), jpack.MergeBudget()
    caps = (pack.MAX_COST_PER_BLOCK, pack.MAX_VOTE_COST_PER_BLOCK,
            pack.MAX_DATA_PER_BLOCK, pack.MAX_WRITE_COST_PER_ACCT)
    assert caps == (jpack.MAX_COST_PER_BLOCK, jpack.MAX_VOTE_COST_PER_BLOCK,
                    jpack.MAX_DATA_PER_BLOCK, jpack.MAX_WRITE_COST_PER_ACCT)
    verdicts = []
    for step in range(400):
        if step % 97 == 96:
            ours.end_block()
            theirs.end_block()
            continue
        cost = rng.randrange(caps[0] // 40)
        vote = rng.choice((0, rng.randrange(caps[1] // 20)))
        data = rng.randrange(caps[2] // 40)
        items = [(rng.choice(keys), rng.randrange(caps[3] // 8))
                 for _ in range(rng.randrange(4))]
        got = ours.try_admit(cost, vote, data, items)
        assert got == theirs.try_admit(cost, vote, data, items)
        verdicts.append(got)
        assert (ours.block_cost, ours.block_vote_cost, ours.block_data,
                ours.acct_write_cost) == (
            theirs.block_cost, theirs.block_vote_cost, theirs.block_data,
            theirs.acct_write_cost)
    assert True in verdicts and False in verdicts


def test_native_is_required_unless_turned_off(monkeypatch):
    """native=None and True take the C scheduler; a library that does not
    build raises instead of falling back (native=False still works)."""
    assert pack.Pack(bank_tile_cnt=1).native
    assert not pack.Pack(bank_tile_cnt=1, native=False).native

    def broken():
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native_mod, "lib", broken)
    for native in (None, True):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            pack.Pack(bank_tile_cnt=1, native=native)
    assert not pack.Pack(bank_tile_cnt=1, native=False).native
