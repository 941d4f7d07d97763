"""The port's strict slice against the JAX package's jitted
ed.verify_batch, at ONE compiled shape, (16, 1232): every case is
zero-padded to it and its verdict trimmed back (a lane's bit depends on
its own row, and on no byte past its length), so the module pays one XLA
compile (minutes on a CPU host) for all of them.

First the verify slice (64-byte rows, the kernels' plain versions):
verify_blob and verify_batch on adversarial and ragged lanes, the
SigVerifier surfaces, the three strict layouts (each ends with the
strict finish, ops/r_check.py) beside both host verifiers, and
malformed message lengths.  Then the port's VerifyPipeline over the
port's SigVerifier (device="cpu") against the JAX package's
VerifyPipeline over the same jitted function, at the shapes of
tests/test_pipeline.py (16 x 256, and the ladder [(4, 256), (2,
1232)]): the same txn stream must give the same accepted payloads in
the same order, and the same integer counters in
VerifyMetrics.snapshot() (all but compile_ns, a time); packed-row frags
reach the JAX side through a dispatch_blob that unpacks the rows."""

import dataclasses
import random
import time

import jax
import numpy as np
import pytest
import torch

from firedancer_tpu.disco import pipeline as jpipe
from firedancer_tpu.models import verifier as jver
from firedancer_tpu.ops import ed25519 as jed
from firedancer_tpu_torch import interop
from firedancer_tpu_torch.ballet import txn as txn_lib
from firedancer_tpu_torch.disco import pipeline as pipe
from firedancer_tpu_torch.models import verifier as tv
from firedancer_tpu_torch.models.verifier import SigVerifier, VerifierConfig
from firedancer_tpu_torch.ops import ed25519 as ed
from _torch_threads import one_torch_thread  # noqa: F401

BATCH = 16
MAXLEN = 256
SLICE_ML = 64   # the verify slice's rows
LADDER = [(4, 256), (2, 1232)]
_SEEDS = [bytes([i + 1]) * 32 for i in range(12)]
_PUBS = [ed.keypair_from_seed(s)[0] for s in _SEEDS]


class _JaxFn:
    """jax.jit(ed.verify_batch) behind the surface the JAX pipeline
    calls, at ONE compiled shape: verify is lane-parallel and a lane's
    message bytes past its length are not hashed, so zero-padding the
    rows and the message columns leaves every real lane's bit as it is.
    dispatch_blob unpacks packed rows into the four arrays (lengths
    clamped to the row width, as both packages' host verifiers do)."""

    mode = "strict"
    ROWS, COLS = BATCH, txn_lib.MTU

    def __init__(self):
        self.fn = jax.jit(jed.verify_batch)

    def __call__(self, msgs, lens, sigs, pubs):
        n, ml = np.shape(msgs)
        m = np.zeros((self.ROWS, self.COLS), np.uint8)
        m[:n, :ml] = msgs
        pad = [np.zeros((self.ROWS,) + np.shape(a)[1:], np.asarray(a).dtype)
               for a in (lens, sigs, pubs)]
        for dst, a in zip(pad, (lens, sigs, pubs)):
            dst[:n] = a
        return np.asarray(self.fn(m, *pad))[:n]

    def dispatch_blob(self, blob, maxlen=None):
        blob = np.asarray(blob)
        ml = blob.shape[1] - ed.PACKED_EXTRA
        lens = np.ascontiguousarray(blob[:, ml + 96:]).view(np.int32)
        return self(blob[:, :ml], np.clip(lens.ravel(), 0, ml),
                    blob[:, ml:ml + 64], blob[:, ml + 64:ml + 96])


@pytest.fixture(scope="module")
def jfn():
    return _JaxFn()


@pytest.fixture(scope="module")
def slice_batch(jfn):
    """Adversarial lanes plus ragged valid ones, with the JAX package's
    jitted verify_batch bits (jfn, the module's one compile)."""
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(BATCH, SLICE_ML)
    rng = np.random.default_rng(11)
    ragged = rng.integers(0, SLICE_ML + 1, BATCH - 11).astype(np.int32)
    m2, l2, s2, p2 = tv.make_example_batch(BATCH - 11, SLICE_ML, True, 12,
                                           lens=ragged)
    msgs[11:], lens[11:], sigs[11:], pubs[11:] = m2, l2, s2, p2
    kinds[11:] = ["valid"] * (BATCH - 11)
    want = jfn(msgs, lens, sigs, pubs)
    return msgs, lens, sigs, pubs, kinds, want


def test_verify_blob_matches_jax_verify_batch(slice_batch):
    msgs, lens, sigs, pubs, kinds, want = slice_batch
    blob_np = tv.pack_blob(msgs, lens, sigs, pubs)
    got = ed.verify_blob(interop.blob_from_numpy(blob_np, "cpu")).numpy()
    assert got.tolist() == want.tolist()
    assert [k for k, w in zip(kinds, want) if w] == [
        k for k in kinds if k == "valid"]
    assert got.tolist() == ed.host_verify_blob(blob_np)
    assert got.tolist() == jver.host_verify_blob(blob_np).tolist()


def test_verify_batch_four_arrays_matches_blob(slice_batch):
    msgs, lens, sigs, pubs, _, want = slice_batch
    got = ed.verify_batch(*interop.batch_from_numpy(msgs, lens, sigs, pubs,
                                                    "cpu"))
    assert got.numpy().tolist() == want.tolist()


def test_sig_verifier_dispatch_surfaces(slice_batch):
    msgs, lens, sigs, pubs, _, want = slice_batch
    ver = tv.SigVerifier(tv.VerifierConfig(BATCH, SLICE_ML), device="cpu")
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    for verdict in (ver.dispatch_blob(blob), ver(msgs, lens, sigs, pubs),
                    ver.packed_dispatch(msgs, lens, sigs, pubs)):
        assert verdict.is_ready()
        verdict.copy_to_host_async()
        assert np.asarray(verdict).tolist() == want.tolist()
    with pytest.raises(ValueError):
        ver.dispatch_blob(np.zeros((BATCH + 1, SLICE_ML + ed.PACKED_EXTRA),
                                   np.uint8))


@pytest.fixture(scope="module")
def layout_rows(jfn):
    """Adversarial lanes, then ragged valid ones, as a packed blob, with
    the JAX package's jitted verify_batch bits."""
    msgs, lens, sigs, pubs, kinds = tv.make_adversarial_batch(BATCH, SLICE_ML,
                                                              seed=17)
    m2, l2, s2, p2 = tv.make_example_batch(
        BATCH - 11, SLICE_ML, True, 18,
        lens=np.random.default_rng(19).integers(0, SLICE_ML + 1, BATCH - 11))
    msgs[11:], lens[11:], sigs[11:], pubs[11:] = m2, l2, s2, p2
    kinds[11:] = ["valid"] * (BATCH - 11)
    want = jfn(msgs, lens, sigs, pubs)
    return tv.pack_blob(msgs, lens, sigs, pubs), kinds, want


@pytest.mark.parametrize("tail", ed.TAILS)
def test_layouts_match_jax_verify_batch_and_host(layout_rows, tail):
    """The three strict layouts (each ends with the strict finish,
    ops/r_check.py) against the JAX device graph and both host
    verifiers."""
    blob_np, kinds, want = layout_rows
    got = ed.verify_blob(interop.blob_from_numpy(blob_np, "cpu"),
                         tail=tail).tolist()
    assert got == want.tolist()
    assert got == ed.host_verify_blob(blob_np)
    assert got == jver.host_verify_blob(blob_np).tolist()
    assert [k for k, b in zip(kinds, got) if b] == [
        k for k in kinds if k == "valid"]


def test_malformed_lengths_against_the_jax_device_graph(jfn):
    """Lengths outside [0, ml], through the JAX package's verify_batch
    (its XLA graph at the module's one jitted shape, 16 x 1232: the rows
    past these four and the bytes past a row's ml are zero, the bytes
    lane 0's hash reads), the port's three layouts and both host
    verifiers, on these lanes (ml = 64):
      0: len = ml + 16, signed over the row's bytes and 16 zero bytes;
      1: len = -1, signed over the empty message;
      2: len = 2^31 - 1, signed over the row's ml bytes;
      3: len = ml, a valid signature.
    The port and both host verifiers clamp a length to [0, ml] (no kernel
    reads past its row): lanes 1-3 accept, lane 0 rejects.  The JAX
    device graph does not clamp: it hashes past the row (zeros) for lane
    0 and accepts it; it hashes a 63-byte prefix of R || A for lane 1 and
    a wrapped int32 length for lane 2, and rejects both.  That is a fault
    of the reference (its device graph disagrees with its own host
    verifier), pinned here as it stands until both packages settle it
    together (ROADMAP section 3)."""
    ml = SLICE_ML
    seed = bytes(range(32))
    pub = ed.keypair_from_seed(seed)[0]
    msg = np.random.default_rng(8).bytes(ml)
    rows = [(ml + 16, ed.sign(seed, msg + bytes(16))),
            (-1, ed.sign(seed, b"")),
            (2**31 - 1, ed.sign(seed, msg)),
            (ml, ed.sign(seed, msg))]
    n = len(rows)
    msgs = np.tile(np.frombuffer(msg, np.uint8), (n, 1))
    lens = np.array([ln for ln, _ in rows], np.int32)
    sigs = np.array([list(sg) for _, sg in rows], np.uint8)
    pubs = np.tile(np.frombuffer(pub, np.uint8), (n, 1))
    blob = tv.pack_blob(msgs, lens, sigs, pubs)
    clamped = [False, True, True, True]
    assert ed.host_verify_blob(blob) == clamped
    assert jver.host_verify_blob(blob).tolist() == clamped
    for tail in ed.TAILS:
        assert ed.verify_blob(torch.from_numpy(blob),
                              tail=tail).tolist() == clamped, tail
    assert jfn(msgs, lens, sigs, pubs).tolist() == [True, False,
                                                           False, True]



def make_signed_txn(rng: random.Random, nonce: int, nsig: int = 1,
                    data_len: int = 8) -> bytes:
    """A correctly signed transfer-like txn, random but seeded."""
    msg = txn_lib.build_unsigned(
        _PUBS[:nsig], rng.randbytes(32),
        [(nsig, bytes(range(nsig)),
          nonce.to_bytes(8, "little") + rng.randbytes(data_len - 8))],
        [rng.randbytes(32)])
    return txn_lib.assemble([ed.sign(s, msg) for s in _SEEDS[:nsig]], msg)


def _pair(jfn, buckets=((BATCH, MAXLEN),), **kw):
    """The port pipeline over one SigVerifier that covers every bucket,
    and the JAX one.  The JAX pipeline keeps four-array buckets: its
    packed buckets stamp lengths by assigning bytes to a uint8 slice,
    which NumPy 2 refuses."""
    port_fn = SigVerifier(VerifierConfig(
        max(b for b, _ in buckets), max(m for _, m in buckets)),
        device="cpu")
    return (pipe.VerifyPipeline(port_fn, buckets=buckets, **kw),
            jpipe.VerifyPipeline(jfn, buckets=buckets, packed_rows=False,
                                 **kw))


def _norm(out):
    """Accepted entries as comparable values (the two packages' Txn and
    PackedVerdicts are distinct classes)."""
    res = []
    for e in out:
        if isinstance(e, (pipe.PackedVerdicts, jpipe.PackedVerdicts)):
            res.append(("packed", e.arena.tobytes(), e.offs.tolist(),
                        e.tags.tolist(), e.k))
        else:
            payload, parsed = e
            res.append((bytes(payload), None if parsed is None
                        else dataclasses.astuple(parsed)))
    return res


def _counters(p):
    snap = p.metrics.snapshot()
    return {k: v for k, v in snap.items()
            if isinstance(v, int) and k != "compile_ns"}


def _same(port, ref, drive):
    """Drive both pipelines through the same stream; returns the
    accepted payloads after checking they and the counters agree."""
    got, want = _norm(drive(port)), _norm(drive(ref))
    assert got == want
    assert _counters(port) == _counters(ref)
    return got


def test_end_to_end(jfn):
    rng = random.Random(1)
    good = [make_signed_txn(rng, i) for i in range(5)]
    bad_sig = bytearray(make_signed_txn(rng, 100))
    bad_sig[5] ^= 1
    stream = good + [bytes(bad_sig), rng.randbytes(200), good[0]]

    def drive(p):
        out = []
        for t in stream:
            out += p.submit(t)
        return out + p.flush()

    got = _same(*_pair(jfn, tcache_depth=64), drive)
    assert [g[0] for g in got] == good


def test_multisig_all_lanes_must_pass(jfn):
    rng = random.Random(2)
    t3 = make_signed_txn(rng, 200, nsig=3)
    bad = bytearray(make_signed_txn(rng, 201, nsig=3))
    bad[1 + 64 + 5] ^= 1             # the SECOND signature only

    def drive(p):
        return p.submit(t3) + p.flush() + p.submit(bytes(bad)) + p.flush()

    got = _same(*_pair(jfn, tcache_depth=64), drive)
    assert [g[0] for g in got] == [t3]


def test_batch_overflow_flushes(jfn):
    rng = random.Random(3)
    txns = [make_signed_txn(rng, 1000 + i) for i in range(BATCH + 3)]
    sizes = {}

    def drive(p):
        out = []
        for t in txns:
            out += p.submit(t)
        sizes[id(p)] = len(out)          # auto-flushed when full
        return out + p.flush()

    port, ref = _pair(jfn, tcache_depth=64)
    got = _same(port, ref, drive)
    assert sizes[id(port)] == sizes[id(ref)] == BATCH
    assert [g[0] for g in got] == txns
    assert port.metrics.batches == 2


def test_too_long_dropped(jfn):
    rng = random.Random(4)
    big = make_signed_txn(rng, 5, data_len=400)

    def drive(p):
        return p.submit(big) + p.flush()

    port, ref = _pair(jfn, tcache_depth=64)
    assert _same(port, ref, drive) == []
    assert port.metrics.too_long_drop == 1


def test_full_mtu_txn_verifies_in_bucket_ladder(jfn):
    """A wire-MTU txn routes to the full-width bucket and verifies, while
    small txns fill the narrow one: two device batches."""
    rng = random.Random(5)
    small = [make_signed_txn(rng, i) for i in range(3)]
    data_len = 8
    for _ in range(3):        # the data's compact-u16 length grows a byte
        big = make_signed_txn(rng, 10, data_len=data_len)
        data_len += txn_lib.MTU - len(big)
    assert len(big) == txn_lib.MTU, len(big)

    def drive(p):
        out = []
        for t in small + [big]:
            out += p.submit(t)
        return out + p.flush()

    port, ref = _pair(jfn, buckets=LADDER, tcache_depth=64)
    got = _same(port, ref, drive)
    assert sorted(g[0] for g in got) == sorted(small + [big])
    assert port.metrics.too_long_drop == 0
    assert port.metrics.batches == 2


def test_sig_overflow_dropped_not_crashed(jfn):
    rng = random.Random(6)
    t3 = make_signed_txn(rng, 999, nsig=3)

    def drive(p):
        return p.submit(t3) + p.flush()

    port, ref = _pair(jfn, buckets=[(2, MAXLEN)])
    assert _same(port, ref, drive) == []
    assert port.metrics.sig_overflow_drop == 1


def test_duplicates_dropped(jfn):
    """Exact repeats inside one open batch are dropped at harvest (the tag
    inserts only once verified); repeats of a verified txn are dropped at
    submit; a mangled copy must not block the valid one."""
    rng = random.Random(7)
    a, b = make_signed_txn(rng, 1), make_signed_txn(rng, 2)
    mangled = bytearray(b)
    mangled[40] ^= 1                  # same tag, failing signature

    def drive(p):
        out = []
        for t in (a, a, bytes(mangled), b, a):
            out += p.submit(t)
        out += p.flush()
        for t in (a, b, b):
            out += p.submit(t)
        return out + p.flush()

    port, ref = _pair(jfn, tcache_depth=64)
    got = _same(port, ref, drive)
    assert [g[0] for g in got] == [a, b]
    assert port.metrics.dedup_drop == 5
    assert port.metrics.verify_fail == 1


def test_parse_errors_counted(jfn):
    rng = random.Random(8)
    good = make_signed_txn(rng, 3)
    stream = [good[:50], good + b"\x00", bytes([0]) + good[1:],
              rng.randbytes(90), b"", good]

    def drive(p):
        out = []
        for t in stream:
            out += p.submit(t)
        return out + p.flush()

    port, ref = _pair(jfn, tcache_depth=64)
    got = _same(port, ref, drive)
    assert [g[0] for g in got] == [good]
    assert port.metrics.parse_fail == 5


def _packed_rows(rng, n, nrows, ml):
    """(nrows, ml + 100) packed rows of single-sig txns: row i is the
    message of a signed txn, its signature, the signer's key and its
    length; some tampered, one repeating row 0's tag; zero padding from
    row n on."""
    rows = np.zeros((nrows, ml + ed.PACKED_EXTRA), np.uint8)
    for i in range(n):
        t = make_signed_txn(rng, 500 + i)
        parsed = txn_lib.parse(t)
        msg = parsed.message(t)
        rows[i, :len(msg)] = np.frombuffer(msg, np.uint8)
        rows[i, ml:ml + 64] = np.frombuffer(parsed.signatures(t)[0],
                                            np.uint8)
        rows[i, ml + 64:ml + 96] = np.frombuffer(_PUBS[0], np.uint8)
        rows[i, ml + 96:] = np.array([len(msg)], np.int32).view(np.uint8)
    rows[3, ml + 40] ^= 1             # tampered S
    rows[5, 0] ^= 1                   # tampered message
    rows[7, ml:ml + 8] = rows[0, ml:ml + 8]   # row 0's tag, failing sig
    return rows


@pytest.mark.parametrize("egress_packed", [False, True])
def test_submit_packed_rows(jfn, egress_packed):
    """Packed-row frags: per-row verdicts, tcache dedup across frags and
    within one, zero padding rows excluded, passing rows rebuilt in wire
    form (0x01 | sig | msg) or as one PackedVerdicts arena."""
    rng = random.Random(9)
    rows = _packed_rows(rng, 13, BATCH, MAXLEN)
    again = rows.copy()
    released = []

    def drive(p):
        out = p.submit_packed_rows(rows, n=13,
                                   release_cb=lambda: released.append(1))
        return out + p.submit_packed_rows(again, n=13) + p.flush()

    port, ref = _pair(jfn, tcache_depth=64, egress_packed=egress_packed)
    got = _same(port, ref, drive)
    assert len(released) == 2
    m = port.metrics
    assert (m.verify_pass, m.verify_fail, m.dedup_drop) == (10, 5, 11)
    wires = (pipe.PackedVerdicts(np.frombuffer(got[0][1], np.uint8),
                                 np.array(got[0][2]), None, got[0][4]).wires()
             if egress_packed else [g[0] for g in got])
    assert len(wires) == 10
    for w in wires:
        assert txn_lib.parse(w).signature_cnt == 1


def test_submit_packed_rows_torn_frag_dropped(jfn):
    """A frag whose seqlock re-check fails after the dispatch (the
    producer lapped it) is dropped whole and its credit released; the
    next, intact frag goes through."""
    rng = random.Random(12)
    rows = _packed_rows(rng, 16, BATCH, MAXLEN)
    released = []

    class Mcache:
        def __init__(self, rc):
            self.rc = rc

        def query(self, seq):
            return self.rc, None

    def drive(p):
        out = p.submit_packed_rows(rows, guard=(Mcache(1), 7),
                                   release_cb=lambda: released.append(1))
        return out + p.submit_packed_rows(rows, guard=(Mcache(0), 8))

    port, ref = _pair(jfn, tcache_depth=64)
    got = _same(port, ref, drive)
    assert len(got) == 13 and len(released) == 2
    m = port.metrics
    assert (m.torn_drop, m.torn_txns, m.txns_in) == (1, 16, 16)


def test_latency_lane(jfn):
    """The low-latency lane at shapes (4, 16): lat-class txns accumulate
    beside the bulk bucket, a close ships the closest-fit shape, a
    deadline close fires once the oldest txn ages past deadline_us."""
    rng = random.Random(10)
    txns = [make_signed_txn(rng, 700 + i) for i in range(12)]

    def drive(p):
        out = []
        for i, t in enumerate(txns[:8]):
            out += p.submit(t, lat=i % 2 == 0)
        out += p.flush()                      # lat 4 lanes -> shape 4
        for t in txns[8:]:
            out += p.submit(t, lat=True)
        time.sleep(0.01)
        out += p.dispatch_due()               # deadline close, shape 4
        return out + p.flush()

    port, ref = _pair(jfn, tcache_depth=64, lat_shapes=(4, 16),
                      deadline_us=2000)
    got = _same(port, ref, drive)
    assert sorted(g[0] for g in got) == sorted(txns)
    m = port.metrics
    assert (m.lat_txns, m.lat_batches, m.lat_deadline_closes) == (8, 2, 1)
    assert m.lanes_dispatched == BATCH + 4 + 4


def test_tracer_refused(jfn):
    """The pipeline used to refuse a tracer; it now takes the tile's
    TraceRing.  Each pipeline over its own package's ring, on the same
    stream, synchronous and async: the same spans (kind, index, count) in
    the same order, and has_pending True until the last verdict is
    harvested."""
    from firedancer_tpu.disco import trace as jtrace
    from firedancer_tpu_torch.disco import trace as ptrace

    rng = random.Random(12)
    txns = [make_signed_txn(rng, 3000 + i) for i in range(BATCH + 5)]

    def drive(p):
        out = []
        for t in txns:
            out += p.submit(t)
        assert p.has_pending
        out += p.flush()
        assert not p.has_pending
        return out

    for max_inflight in (0, 2):
        port, ref = _pair(jfn, tcache_depth=64, max_inflight=max_inflight)
        rings = []
        for p, mod in ((port, ptrace), (ref, jtrace)):
            buf = bytearray(mod.footprint(64))
            p.tracer = mod.TraceRing(buf, 0, create=True, depth=64)
            rings.append(p.tracer)
        _same(port, ref, drive)
        spans = [[(int(r["kind"]), int(r["iidx"]), int(r["cnt"]))
                  for r in ring.snapshot()[1]] for ring in rings]
        assert {k for k, _, _ in spans[0]} == {
            ptrace.KIND_COALESCE, ptrace.KIND_COMPILE, ptrace.KIND_DISPATCH,
            ptrace.KIND_DEVICE, ptrace.KIND_HARVEST}
        assert spans[0] == spans[1]


@pytest.mark.parametrize("fn", [
    SigVerifier(VerifierConfig(16, 64), mode="rlc", device="cpu"),
    SigVerifier(VerifierConfig(4, 64), device="cpu").__call__,
], ids=["rlc_verifier", "four_array_callable"])
def test_non_packed_verifier_refused(fn):
    """Buckets are packed blobs only: a verifier without a strict
    dispatch_blob is refused at construction."""
    with pytest.raises(ValueError, match="strict verifier with "
                       "dispatch_blob"):
        pipe.VerifyPipeline(fn, batch=4, msg_maxlen=64)


# -- the native burst path: submit_burst -----------------------------------


def _burst_stream(rng, nonce0):
    """Wire txns with every burst outcome: valid 1- and 2-signature
    txns, a forged first and a forged second signature, a mangled copy
    with a valid txn's tag, exact repeats in one burst and across bursts,
    messages over 256 bytes (rerouted on a ladder, dropped on one bucket),
    a 5-signature txn, and parse failures."""
    good = [make_signed_txn(rng, nonce0 + i) for i in range(20)]
    two = [make_signed_txn(rng, nonce0 + 50 + i, nsig=2) for i in range(3)]
    forged1 = bytearray(make_signed_txn(rng, nonce0 + 60))
    forged1[9] ^= 1
    forged2 = bytearray(make_signed_txn(rng, nonce0 + 61, nsig=2))
    forged2[1 + 64 + 9] ^= 1
    mangled = bytearray(good[4])
    mangled[40] ^= 1
    big = [make_signed_txn(rng, nonce0 + 70 + i, data_len=400)
           for i in range(2)]
    five = make_signed_txn(rng, nonce0 + 80, nsig=5)
    garbage = [rng.randbytes(90), b"", good[1][:60]]
    first = (good[:6] + [two[0], bytes(forged1), good[2], big[0], garbage[0],
                         bytes(mangled), two[1]] + good[6:9])
    second = ([good[9], good[2], bytes(forged2), five, garbage[1], big[1]]
              + good[10:16] + [two[2], good[4], garbage[2]])
    third = good[16:] + [good[0], two[0]]
    return [first, second, third]


def _drive_bursts(bursts, packed):
    def drive(p):
        out = []
        for b in bursts:
            if packed:
                buf = np.frombuffer(b"".join(b), np.uint8)
                offs = np.zeros(len(b) + 1, np.int64)
                np.cumsum([len(t) for t in b], out=offs[1:])
                out += p.submit_burst(packed=(buf, offs))
            else:
                out += p.submit_burst(b)
        return out + p.flush()
    return drive


@pytest.mark.parametrize("buckets,packed,max_inflight", [
    (((BATCH, MAXLEN),), False, 0),
    (((8, MAXLEN),), True, 2),
    (tuple(LADDER), True, 0),
    (tuple(LADDER), False, 3)],
    ids=["one_bucket", "flush_and_retry", "ladder", "ladder_async"])
def test_submit_burst_matches_jax(jfn, buckets, packed, max_inflight):
    """The port's native submit_burst and the JAX package's, the same
    bursts (as payload lists, or as a flat buffer with offsets): the same
    accepted payloads in the same order and the same counters.  A bucket
    of 8 or 4 lanes runs out mid-burst (flush and parse the rest again);
    on the ladder, messages over 256 bytes reroute through submit() to the
    1232-byte bucket, and a 5-signature txn is wider than the first
    bucket (sig_overflow_drop)."""
    rng = random.Random(20 + len(buckets))
    bursts = _burst_stream(rng, 4000)
    port, ref = _pair(jfn, buckets=buckets, tcache_depth=64,
                      max_inflight=max_inflight)
    got = _same(port, ref, _drive_bursts(bursts, packed))
    m = port.metrics
    assert m.txns_in == sum(len(b) for b in bursts)
    # forged1 and forged2 fail, five repeats drop; the mangled copy fails
    # where good[4]'s verdict was not harvested yet, else it is a repeat
    assert m.parse_fail == 3 and m.verify_fail + m.dedup_drop == 8
    assert m.verify_fail in (2, 3)
    if len(buckets) > 1:
        assert (m.too_long_drop, m.sig_overflow_drop) == (0, 1)
        assert len(got) == 20 + 3 + 2           # good, two, big
    else:
        assert (m.too_long_drop, m.sig_overflow_drop) == (2, 0)
        assert len(got) == 20 + 3 + 1           # good, two, five


def test_submit_burst_is_one_native_parse_a_fill(monkeypatch):
    """The burst path makes one fd_txn_parse_batch_packed call a fill of
    the first bucket and no submit() for txns that fit it: 40 one-lane
    txns into 16 lanes are three calls (16, 16, 8), two flushes."""
    from firedancer_tpu_torch.ballet import txn_native as tn

    calls, scalar = [], []
    parse = tn.parse_packed_bucket

    def counted(*a, **k):
        r = parse(*a, **k)
        calls.append(r.consumed)
        return r

    monkeypatch.setattr(tn, "parse_packed_bucket", counted)
    monkeypatch.setattr(pipe.VerifyPipeline, "submit",
                        lambda self, p, lat=False: scalar.append(p) or [])
    rng = random.Random(30)
    txns = [make_signed_txn(rng, 6000 + i) for i in range(40)]
    p = pipe.VerifyPipeline(SigVerifier(VerifierConfig(BATCH, MAXLEN),
                                        device="cpu"),
                            batch=BATCH, msg_maxlen=MAXLEN)
    out = p.submit_burst(txns) + p.flush()
    assert calls == [16, 16, 8] and scalar == []
    assert [o[0] for o in out] == txns
    assert p.metrics.batches == 3
