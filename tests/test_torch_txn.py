"""The port's txn parser, compact-u16 codec and tcache against the JAX
package's (host code, no device): the cases of tests/test_txn.py and
tests/test_tcache.py, each through both packages, which must agree on
every accepted descriptor, every rejection and every cache answer."""

import dataclasses
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from firedancer_tpu.ballet import compact_u16 as jcu16
from firedancer_tpu.ballet import txn as jtxn
from firedancer_tpu.tango.tcache import TCache as JTCache
from firedancer_tpu_torch.ballet import compact_u16 as cu16
from firedancer_tpu_torch.ballet import txn as txn_lib
from firedancer_tpu_torch.tango.tcache import TCache


def _rb(rng: random.Random, n: int) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(n))


def _mk(rng, nsig=1, version=txn_lib.VLEGACY, ninstr=1, extra=1,
        data=b"\x01\x02", lookups=None):
    """(payload, message) of a txn with random keys and signatures."""
    signers = [_rb(rng, 32) for _ in range(nsig)]
    extras = [_rb(rng, 32) for _ in range(extra)]
    instrs = [(nsig, bytes([0]), data)] * ninstr
    args = (signers, _rb(rng, 32), instrs, extras)
    msg = txn_lib.build_unsigned(*args, version=version, lookups=lookups)
    jmsg = jtxn.build_unsigned(*args, version=version, lookups=lookups)
    assert msg == jmsg
    sigs = [_rb(rng, 64) for _ in range(nsig)]
    payload = txn_lib.assemble(sigs, msg)
    assert payload == jtxn.assemble(sigs, jmsg)
    return payload, msg


def _cases():
    """(name, payload) over the cases of tests/test_txn.py."""
    rng = random.Random(2024)
    out = []
    legacy, _ = _mk(rng, nsig=2, extra=2, ninstr=3)
    out.append(("legacy_roundtrip", legacy))
    out.append(("v0_roundtrip", _mk(rng, version=txn_lib.V0)[0]))
    out.append(("v0_lookups", _mk(
        rng, version=txn_lib.V0, data=b"\x07",
        lookups=[(_rb(rng, 32), bytes([0, 1]), bytes([2]))])[0]))
    for nsig in (1, 2, 12):
        for version in (txn_lib.VLEGACY, txn_lib.V0):
            for ninstr in (0, 1, 3):
                out.append((f"nsig{nsig}_v{version}_instr{ninstr}",
                            _mk(rng, nsig, version, ninstr, extra=2)[0]))
    base, _ = _mk(rng)
    out.append(("trailing_bytes", base + b"\x00"))
    for cut in (1, 32, 64, len(base) - 1):
        out.append((f"truncated_{cut}", base[:cut]))
    out.append(("zero_sigs", bytes([0]) + base[1:]))
    out.append(("mtu_overflow", b"\x01" * (txn_lib.MTU + 1)))
    out.append(("header_mismatch", base[:65] + bytes([2]) + base[66:]))
    out.append(("bad_version", base[:65] + bytes([0x81]) + base[66:]))
    signers = [_rb(rng, 32)]
    for name, instr in (("program_is_fee_payer", (0, b"", b"")),
                        ("account_index_out_of_range", (1, bytes([7]), b""))):
        msg = txn_lib.build_unsigned(signers, _rb(rng, 32), [instr],
                                     [_rb(rng, 32)])
        out.append((name, txn_lib.assemble([_rb(rng, 64)], msg)))
    signers = [_rb(rng, 32) for _ in range(3)]
    msg = txn_lib.build_unsigned(signers, _rb(rng, 32), [(3, bytes([0]), b"")],
                                 [_rb(rng, 32) for _ in range(3)],
                                 readonly_signed_cnt=1,
                                 readonly_unsigned_cnt=2)
    out.append(("writability_partition",
                txn_lib.assemble([_rb(rng, 64)] * 3, msg)))
    mut, _ = _mk(rng, nsig=2, extra=2, ninstr=2)
    for k in range(100):
        b = bytearray(mut)
        for _ in range(rng.randint(1, 4)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        if rng.random() < 0.3:
            b = b[:rng.randrange(1, len(b))]
        out.append((f"mutation_{k}", bytes(b)))
    return out


CASES = _cases()


def _parse(lib, payload):
    """The descriptor as plain tuples, or the rejection."""
    try:
        t = lib.parse(payload)
    except lib.TxnParseError:
        return "reject"
    return dataclasses.astuple(t)


@pytest.mark.parametrize("payload", [p for _, p in CASES],
                         ids=[n for n, _ in CASES])
def test_parse_matches_jax(payload):
    got = _parse(txn_lib, payload)
    assert got == _parse(jtxn, payload)
    assert txn_lib.fee_payer(payload) == jtxn.fee_payer(payload)
    if got != "reject":
        t, j = txn_lib.parse(payload), jtxn.parse(payload)
        assert t.signatures(payload) == j.signatures(payload)
        assert t.signer_pubkeys(payload) == j.signer_pubkeys(payload)
        assert t.message(payload) == j.message(payload)
        assert [t.is_writable(i) for i in range(t.acct_addr_cnt)] == [
            j.is_writable(i) for i in range(j.acct_addr_cnt)]


def test_parse_cases_cover_accept_and_reject():
    kinds = {_parse(txn_lib, p) == "reject" for _, p in CASES}
    assert kinds == {True, False}


def test_compact_u16_matches_jax():
    for v in range(0x10000):
        enc = cu16.encode(v)
        assert enc == jcu16.encode(v)
        assert cu16.decode(enc) == (v, len(enc))
    for bad in (bytes([0x80, 0x00]), bytes([0x80, 0x80, 0x00]),
                bytes([0x80, 0x80, 0x04]), bytes([0x80]), b""):
        for lib in (cu16, jcu16):
            with pytest.raises(ValueError):
                lib.decode(bad)


_OPS = st.lists(st.tuples(st.sampled_from(("insert", "query", "reset")),
                          st.integers(0, 12)), max_size=60)


@settings(max_examples=40, deadline=None)
@given(depth=st.integers(1, 6), ops=_OPS)
def test_tcache_matches_jax(depth, ops):
    """Insert/query/reset sequences over a small tag space (0 is the null
    tag), so evictions and repeats are common."""
    port, ref = TCache(depth), JTCache(depth)
    for op, tag in ops:
        if op == "reset":
            port.reset()
            ref.reset()
        else:
            assert getattr(port, op)(tag) == getattr(ref, op)(tag)
    tags = list(range(13))
    assert port.query_batch(tags).tolist() == ref.query_batch(tags).tolist()
