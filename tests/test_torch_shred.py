"""The port's shred wire format and FEC resolver
(firedancer_tpu_torch/ballet/shred.py, with reedsol on the GF(2)
kernel's plain version) against the JAX package's ballet/shred.py: the
bytes of make_fec_set under the same sign_fn at the default 32:32
geometry and at 8:8, parse of every shred and of malformed buffers, and
FecResolver's recover_args, data_regions, recover and assemble_payload
on sets with erasures, all-data completions and a set that arrives as
data only."""

import numpy as np
import pytest

from firedancer_tpu.ballet import shred as jsl
from firedancer_tpu_torch.ballet import shred as sl
from firedancer_tpu_torch.ops import ed25519 as ed
from _torch_threads import one_torch_thread  # noqa: F401

SEED = bytes(range(32))


def _sign(root: bytes) -> bytes:
    return ed.sign(SEED, root)


def _entry(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                np.uint8).tobytes()


@pytest.mark.parametrize("cnt,nbytes", [(32, 30_000), (8, 3_000)])
def test_make_fec_set_equals_the_jax_package(cnt, nbytes):
    entry = _entry(cnt, nbytes)
    kw = dict(slot=9, parent_off=1, version=3, fec_set_idx=64,
              sign_fn=_sign, data_cnt=cnt, code_cnt=cnt, ref_tick=5,
              slot_complete=True)
    got = sl.make_fec_set(entry, torch_device="cpu", **kw)
    want = jsl.make_fec_set(entry, **kw)
    assert got.data_shreds == want.data_shreds
    assert got.code_shreds == want.code_shreds
    assert got.merkle_root == want.merkle_root
    for raw in got.data_shreds + got.code_shreds:
        s, j = sl.parse(raw), jsl.parse(raw)
        assert {k: v for k, v in vars(s).items()} == vars(j)
        assert s.merkle_root() == j.merkle_root() == got.merkle_root
        assert s.proof_nodes() == j.proof_nodes()
        assert s.tree_index() == j.tree_index()
        assert ed.verify_one_host(s.signature, s.merkle_root(),
                                  ed.keypair_from_seed(SEED)[0])


def test_parse_refusals_equal_the_jax_package():
    fs = sl.make_fec_set(b"p" * 500, 3, 1, 1, 0, _sign, data_cnt=4,
                         code_cnt=4, torch_device="cpu")
    raw = fs.data_shreds[0]
    bads = [raw[:80], bytes(raw[:0x40]) + b"\x10" + raw[0x41:],
            raw[:0x40] + b"\xa1" + raw[0x41:],
            raw[:0x49] + (1 << 15).to_bytes(4, "little") + raw[0x4D:],
            raw[:0x56] + (5000).to_bytes(2, "little") + raw[0x58:],
            raw[:200]]
    for b in bads:
        with pytest.raises(jsl.ShredParseError) as e_jax:
            jsl.parse(b)
        with pytest.raises(sl.ShredParseError) as e_port:
            sl.parse(b)
        assert str(e_port.value) == str(e_jax.value)


def _resolvers(fs, drop, order=None):
    raws = fs.data_shreds + fs.code_shreds
    order = range(len(raws)) if order is None else order
    out = []
    for mod in (sl, jsl):
        r = (mod.FecResolver(torch_device="cpu") if mod is sl
             else mod.FecResolver())
        acc = [r.add(mod.parse(raws[i])) for i in order if i not in drop]
        out.append((r, acc))
    return out


@pytest.mark.parametrize("drop", [(1, 3, 10), (0, 1, 2, 3, 4, 5, 6, 7),
                                  (8, 9, 10, 11, 12, 13, 14, 15)])
def test_fec_resolver_equals_the_jax_package(drop):
    entry = _entry(5, 3_000)
    fs = sl.make_fec_set(entry, 5, 1, 1, 0, _sign, data_cnt=8, code_cnt=8,
                         torch_device="cpu")
    (r, acc), (j, jacc) = _resolvers(fs, set(drop))
    assert acc == jacc and all(acc)
    assert r.ready() == j.ready() is True
    args, jargs = r.recover_args(), j.recover_args()
    assert (args is None) == (jargs is None)
    if args is not None:
        assert args[1:] == jargs[1:]
        assert [None if x is None else bytes(x) for x in args[0]] == \
            [None if x is None else bytes(x) for x in jargs[0]]
    if args is None:
        assert r.data_regions() == j.data_regions()
    assert r.recover() == j.recover()
    assert sl.FecResolver.assemble_payload(r.recover()) == entry
    assert r.payloads() == j.payloads() == entry
    assert r.resolved_data_cnt == j.resolved_data_cnt == 8


def test_fec_resolver_refusals_equal_the_jax_package():
    fs = sl.make_fec_set(b"r" * 900, 7, 1, 1, 0, _sign, data_cnt=8,
                         code_cnt=8, torch_device="cpu")
    other = sl.make_fec_set(b"o" * 900, 7, 1, 1, 0, _sign, data_cnt=8,
                            code_cnt=8, torch_device="cpu")
    tampered = bytearray(fs.data_shreds[2])
    tampered[200] ^= 1
    for mod in (sl, jsl):
        r = mod.FecResolver()
        assert r.add(mod.parse(fs.data_shreds[0]))
        assert not r.add(mod.parse(other.data_shreds[1]))   # another root
        assert not r.add(mod.parse(bytes(tampered)))
        assert not r.ready()
        with pytest.raises(ValueError, match="not enough"):
            r.recover_args()
