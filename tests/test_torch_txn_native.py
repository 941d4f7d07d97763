"""The port's native burst txn parser (firedancer_tpu_torch/native/
txnparse.cpp through ballet/txn_native.py) on the CPU, against the JAX
package's (firedancer_tpu/ballet/txn_native.py) and against the port's
scalar parser (ballet/txn.py): the cases of tests/test_txn.py's native
parser tests, a structured corpus and a mutation fuzz, each txn alone and
all of them as bursts that run out of lanes.  The two parsers must agree
on every output (consumed, lanes_used, lane0, nsig, tag, err) and on every
byte they write into the bucket; the bucket form writes the rows of the
pipeline's bucket blob in place."""

import random

import numpy as np
import pytest

from firedancer_tpu.ballet import txn_native as jtn
from firedancer_tpu.tango.tcache import NativeTCache as JNativeTCache
from firedancer_tpu_torch.ballet import txn as txn_lib
from firedancer_tpu_torch.ballet import txn_native as tn
from firedancer_tpu_torch.disco.pipeline import _Bucket
from firedancer_tpu_torch.tango.tcache import NativeTCache
from _torch_threads import one_torch_thread  # noqa: F401


def _rb(rng: random.Random, n: int) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(n))


def _mk(rng, nsig=1, version=txn_lib.VLEGACY, ninstr=1, extra=2,
        data=b"\x01\x02", lookups=None):
    signers = [_rb(rng, 32) for _ in range(nsig)]
    extras = [_rb(rng, 32) for _ in range(extra)]
    msg = txn_lib.build_unsigned(
        signers, _rb(rng, 32), [(nsig, bytes([0]), data)] * ninstr, extras,
        version=version, lookups=lookups)
    return txn_lib.assemble([_rb(rng, 64) for _ in range(nsig)], msg)


def _corpus(seed=99, n_mut=400):
    """Structured txns (1, 2 and 10 signatures, legacy and v0, 0-3
    instructions, a v0 with address lookups, a message over 256 bytes)
    and mutations of a base txn: bytes overwritten, some truncated."""
    rng = random.Random(seed)
    cases = []
    for nsig in (1, 2, 10):
        for version in (txn_lib.VLEGACY, txn_lib.V0):
            for ninstr in (0, 1, 3):
                cases.append(_mk(rng, nsig, version, ninstr))
    cases.append(_mk(rng, 1, txn_lib.V0, data=b"\x07", lookups=[
        (_rb(rng, 32), bytes([0, 1]), bytes([2]))]))
    cases.append(_mk(rng, 1, data=_rb(rng, 400)))
    base = _mk(rng, 2, ninstr=2)
    for _ in range(n_mut):
        b = bytearray(base)
        for _ in range(rng.randint(1, 3)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        if rng.random() < 0.3:
            b = b[:rng.randrange(1, len(b))]
        cases.append(bytes(b))
    cases += [b"", b"\x01", b"\x00" + base[1:], base + b"\x00",
              _rb(rng, 1300)]
    return cases


CORPUS = _corpus()


def _arrays(cap, maxlen):
    return (np.zeros((cap, maxlen), np.uint8), np.zeros(cap, np.int32),
            np.zeros((cap, 64), np.uint8), np.zeros((cap, 32), np.uint8))


def _result(r):
    return (r.consumed, r.lanes_used, r.lane0.tolist(), r.nsig.tolist(),
            r.tag.tolist(), r.err.tolist())


def test_each_txn_matches_jax_and_the_scalar_parser():
    """Each corpus txn alone, 16 lanes of 1232 bytes: the port's parse,
    the JAX package's and ballet/txn.py accept the same txns, and the
    lanes carry the message, signatures and signer keys the scalar parser
    finds, the message zero-padded to the row."""
    n_ok = 0
    for p in CORPUS:
        got, want = _arrays(16, txn_lib.MTU), _arrays(16, txn_lib.MTU)
        r = tn.parse_burst([p], *got, 0)
        assert _result(r) == _result(jtn.parse_burst([p], *want, 0))
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        try:
            t = txn_lib.parse(p)
        except txn_lib.TxnParseError:
            assert r.consumed == 1 and r.err[0] != tn.OK, p.hex()
            continue
        if len(p) > txn_lib.MTU:
            continue
        n_ok += 1
        assert r.err.tolist() == [tn.OK], p.hex()
        assert r.nsig.tolist() == [t.signature_cnt]
        assert int(r.tag[0]) == int.from_bytes(p[1:9], "little")
        msgs, lens, sigs, pubs = got
        m = t.message(p)
        for lane, (s, k) in enumerate(zip(t.signatures(p),
                                          t.signer_pubkeys(p))):
            assert int(lens[lane]) == len(m)
            assert bytes(msgs[lane, :len(m)]) == m
            assert not msgs[lane, len(m):].any()
            assert bytes(sigs[lane]) == s and bytes(pubs[lane]) == k
    assert n_ok >= 20


@pytest.mark.parametrize("cap,maxlen,want_errs", [
    (16, 256, {tn.OK, tn.ERR_PARSE, tn.ERR_TOO_LONG}),
    (8, 1232, {tn.OK, tn.ERR_PARSE, tn.ERR_SIG_CAP}),
    (4, 160, {tn.OK, tn.ERR_PARSE, tn.ERR_TOO_LONG})])
def test_bursts_match_jax_and_fill_the_blob_in_place(cap, maxlen,
                                                     want_errs):
    """The whole corpus as bursts: each call fills a bucket from lane 0
    until the next txn's lanes do not fit (or a 10-signature txn is wider
    than an 8-lane bucket: ERR_SIG_CAP; a message over maxlen:
    ERR_TOO_LONG), then the caller resumes at the next txn with offs[idx:]
    into the same buffer.  The port's bucket form writes the rows of the
    pipeline's _Bucket blob (a torch tensor; its NumPy view) in place,
    and every call's outputs and bytes equal the JAX package's bucket and
    four-array forms."""
    buf, offs = tn.pack_payloads(CORPUS)
    jbuf = np.frombuffer(buf, np.uint8)        # a ring rx scratch: ndarray
    bk = _Bucket(cap, maxlen)
    stride = maxlen + 100
    idx, calls, errs = 0, 0, set()
    while idx < len(CORPUS):
        bk.reset()
        blob_ptr = bk.blob.data_ptr()
        before = bk.blob.clone()
        r = tn.parse_packed_bucket(buf, offs[idx:], bk.arr, maxlen, bk.lens,
                                   0)
        jbk = np.zeros((cap, stride), np.uint8)
        jlens = np.zeros(cap, np.int32)
        jr = jtn.parse_packed_bucket(jbuf, offs[idx:], jbk, maxlen, jlens, 0)
        four = _arrays(cap, maxlen)
        fr = jtn.parse_packed(jbuf, offs[idx:], *four, 0)
        assert _result(r) == _result(jr) == _result(fr)
        assert bk.blob.data_ptr() == blob_ptr
        assert np.array_equal(bk.blob.numpy(), jbk)
        assert np.array_equal(bk.lens, jlens)
        if r.lanes_used:
            assert not np.array_equal(bk.blob.numpy(), before.numpy())
        u = r.lanes_used
        msgs, lens, sigs, pubs = four
        assert np.array_equal(jbk[:u, :maxlen], msgs[:u])
        assert np.array_equal(jbk[:u, maxlen:maxlen + 64], sigs[:u])
        assert np.array_equal(jbk[:u, maxlen + 64:maxlen + 96], pubs[:u])
        assert np.array_equal(
            jbk[:u, maxlen + 96:maxlen + 100].copy().view(np.int32).ravel(),
            lens[:u])
        assert r.lanes_used == int(r.nsig.sum())
        errs |= set(r.err.tolist())
        idx += max(r.consumed, 1)
        calls += 1
    assert calls > 1
    assert errs == want_errs


def test_burst_fill_and_dedup():
    """tests/test_txn.py's burst fill and inline dedup, through both
    packages with each package's native tcache: a burst stops at the
    bucket's capacity, and a txn whose tag is in the window is ERR_DUP
    (query only: the parse inserts nothing)."""
    rng = random.Random(5)
    payloads = [_mk(rng) for _ in range(10)]
    cap = 4
    results = []
    for mod, tcache in ((tn, NativeTCache(64)), (jtn, JNativeTCache(64))):
        arrs = _arrays(cap, 256)
        r = mod.parse_burst(payloads, *arrs, 0, tcache.handle)
        assert r.consumed == 4 and r.lanes_used == 4
        assert r.lane0.tolist() == [0, 1, 2, 3]
        assert not any(tcache.query(int(t)) for t in r.tag)
        tcache.insert(int(r.tag[0]))
        r2 = mod.parse_burst(payloads[:2], *arrs, 0, tcache.handle)
        assert r2.err.tolist() == [tn.ERR_DUP, tn.OK]
        assert r2.nsig.tolist() == [0, 1] and r2.lane0.tolist() == [-1, 0]
        r3 = mod.parse_burst(payloads[4:], *arrs, 2, tcache.handle)
        results.append([_result(x) for x in (r, r2, r3)]
                       + [[a.tobytes() for a in arrs]])
    assert results[0] == results[1]
    assert results[0][2][:2] == (2, 2)       # 2 lanes left from lane 2


def test_bad_bucket_refused():
    buf, offs = tn.pack_payloads([_mk(random.Random(1))])
    with pytest.raises(ValueError, match="maxlen"):
        tn.parse_packed_bucket(buf, offs, np.zeros((4, 300), np.uint8), 256,
                               np.zeros(4, np.int32), 0)
    with pytest.raises(ValueError, match="lens"):
        tn.parse_packed_bucket(buf, offs, np.zeros((4, 356), np.uint8), 256,
                               np.zeros(2, np.int32), 0)
    with pytest.raises(ValueError, match="contiguous"):
        tn.parse_packed(buf, offs, np.zeros((4, 512), np.uint8)[:, ::2],
                        *_arrays(4, 256)[1:], 0)
