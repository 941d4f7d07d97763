"""The port's native host path (firedancer_tpu_torch/native/hostpath.cpp:
fd_hostpath_submit_rows and fd_hostpath_finish_rows, through the port's
VerifyPipeline.submit_packed_rows) on the CPU: the three-way bit identity
of tests/test_hostpath_native.py held against the port.  The port's
native path, the port's NumPy finish (native_hostpath=False), the JAX
package's VerifyPipeline with its native finish, and an independent
per-txn model give the same wires, in the same survivor order, with the
same metrics, over equal-length, ragged, all-dup, all-fail, intra-frag
dup, dead-lane and zero-padded frags; packed egress carries the same
bytes; and a finish whose arena is too small changes nothing until it is
retried with a larger one.  Verdicts are scripted: no verifier runs."""

import ctypes

import numpy as np
import pytest

from firedancer_tpu.disco.pipeline import VerifyPipeline as JVerifyPipeline
from firedancer_tpu_torch import native
from firedancer_tpu_torch.disco.pipeline import PackedVerdicts, VerifyPipeline
from firedancer_tpu_torch.tango.ring import PACKED_ROW_EXTRA, packed_row_ml
from firedancer_tpu_torch.tango.tcache import NativeTCache
from _torch_threads import one_torch_thread  # noqa: F401

ML = packed_row_ml(256)          # 284
STRIDE = ML + PACKED_ROW_EXTRA   # 384


class _VerdictFn:
    """A packed verifier double: row i of dispatch j passes iff
    script[j][i]."""

    mode = "strict"

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def __call__(self, m, ln, s, p):
        return np.ones(m.shape[0], bool)

    def dispatch_blob(self, blob, maxlen=None):
        ok = np.zeros(blob.shape[0], bool)
        want = self.script[self.calls]
        self.calls += 1
        ok[:len(want)] = want
        return ok


def _mk_rows(n, lens, seed, nrows=None, dup_pairs=(), dead=()):
    """Packed rows with seeded payload and sig bytes; dup_pairs=(a, b)
    copies a's tag onto b, dead=i zeroes i's tag (a padding lane)."""
    rng = np.random.default_rng(seed)
    nrows = n if nrows is None else nrows
    rows = np.zeros((nrows, STRIDE), np.uint8)
    for i in range(n):
        L = int(lens[i])
        rows[i, :L] = rng.integers(0, 256, L, dtype=np.uint8)
        rows[i, ML:ML + 64] = rng.integers(0, 256, 64, dtype=np.uint8)
        rows[i, ML:ML + 2] = [(i + 1) & 0xFF, (i + 1) >> 8]
        rows[i, ML + 96:ML + 100] = np.frombuffer(
            L.to_bytes(4, "little"), np.uint8)
    for a, b in dup_pairs:
        rows[b, ML:ML + 8] = rows[a, ML:ML + 8]
    for i in dead:
        rows[i, ML:ML + 8] = 0
    return rows


def _sweep_frags():
    """tests/test_hostpath_native.py's sweep: one frag set with every
    shape class, and a frag whose length column lies (negative, past ml:
    the finish clamps it to the row)."""
    n = 24
    rng = np.random.default_rng(11)
    eq = _mk_rows(n, [100] * n, seed=1)
    ragged = _mk_rows(n, rng.integers(0, ML + 1, n), seed=2)
    mixed = _mk_rows(n, rng.integers(1, ML, n), seed=3,
                     dup_pairs=((0, 5), (1, 9)), dead=(7,))
    padded = _mk_rows(10, [64] * 10, seed=4, nrows=n)
    liar = _mk_rows(6, [10] * 6, seed=5)
    liar[0, ML + 96:] = np.array([-3], np.int32).view(np.uint8)
    liar[1, ML + 96:] = np.array([ML + 50], np.int32).view(np.uint8)
    ok_all = np.ones(n, bool)
    ok_none = np.zeros(n, bool)
    ok_mix = rng.random(n) < 0.7
    return [
        (eq, n, ok_all),                 # equal-length, all pass
        (ragged, n, ok_mix),             # ragged, mixed verdicts
        (ragged, n, ok_all),             # resubmit: all-dup frag
        (mixed, n, ok_mix),              # intra-frag dups + dead lane
        (eq, n, ok_none),                # all-fail, and all dup
        (padded, 10, ok_all),            # n < nrows zero padding
        (padded, 10, ok_none),           # zero-pass resubmit (all dup)
        (liar, 6, np.ones(6, bool)),     # clamped lengths
    ]


def _ref_run(frags):
    """An independent per-txn model: query-only dedup at submit, insert
    on pass, over a set (nothing evicts at these counts)."""
    seen = set()
    wires, m = [], dict(txns_in=0, dedup_drop=0, verify_fail=0,
                        verify_pass=0)
    for rows, n, ok in frags:
        tags = [int.from_bytes(bytes(rows[i, ML:ML + 8]), "little")
                for i in range(n)]
        dup = [t != 0 and t in seen for t in tags]
        m["txns_in"] += n
        m["dedup_drop"] += sum(dup)
        out = []
        for i in range(n):
            if tags[i] == 0 or dup[i]:
                continue
            if not ok[i]:
                m["verify_fail"] += 1
                continue
            if tags[i] in seen:
                m["dedup_drop"] += 1
                continue
            seen.add(tags[i])
            m["verify_pass"] += 1
            L = min(max(int.from_bytes(
                bytes(rows[i, ML + 96:ML + 100]), "little", signed=True),
                0), ML)
            out.append(b"\x01" + bytes(rows[i, ML:ML + 64])
                       + bytes(rows[i, :L]))
        wires.append(out)
    return wires, m


def _pipe_run(frags, cls, native_hostpath, egress_packed=False,
              tamper=None):
    fn = _VerdictFn([ok for _, _, ok in frags])
    pipe = cls(fn, buckets=[(max(r.shape[0] for r, _, _ in frags), ML)],
               tcache_depth=1 << 12, max_inflight=0,
               native_hostpath=native_hostpath, egress_packed=egress_packed)
    assert (pipe._hp is not None) == native_hostpath
    if tamper is not None:
        tamper(pipe)
    wires = []
    for rows, n, _ in frags:
        passed = pipe.submit_packed_rows(rows, n=n)
        if egress_packed:
            out = []
            for pv in passed:
                assert pv.__class__.__name__ == "PackedVerdicts"
                ws = pv.wires()
                assert len(ws) == pv.k == len(pv.tags)
                for w, t in zip(ws, pv.tags):
                    assert int.from_bytes(w[1:9], "little") == int(t)
                out += ws
            wires.append(out)
        else:
            wires.append([w for w, _ in passed])
    s = pipe.metrics.snapshot()
    return wires, {k: s[k] for k in ("txns_in", "dedup_drop",
                                     "verify_fail", "verify_pass")}


def test_bit_identity_native_numpy_jax_and_model():
    frags = _sweep_frags()
    ref = _ref_run(frags)
    assert _pipe_run(frags, VerifyPipeline, True) == ref
    assert _pipe_run(frags, VerifyPipeline, False) == ref
    assert _pipe_run(frags, JVerifyPipeline, True) == ref
    assert sum(len(w) for w in ref[0]) > 40


@pytest.mark.parametrize("native_hostpath", [True, False])
def test_packed_egress_bit_identity(native_hostpath):
    """PackedVerdicts carries the bytes the per-txn egress carries, in
    the same order, with each wire's tag, equal to the JAX package's."""
    frags = _sweep_frags()
    legacy = _pipe_run(frags, VerifyPipeline, native_hostpath)
    packed = _pipe_run(frags, VerifyPipeline, native_hostpath,
                       egress_packed=True)
    jpacked = _pipe_run(frags, JVerifyPipeline, native_hostpath,
                        egress_packed=True)
    assert packed == legacy == jpacked


class _ShortArena:
    """The host library with its first finish given an arena of 0 bytes:
    the C call must return -(needed bytes) and change nothing, and the
    pipeline's retry must then give the same result as an arena sized
    right away."""

    def __init__(self, lib):
        self.lib = lib
        self.short = []

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def fd_hostpath_finish_rows(self, *args):
        if not self.short:
            args = list(args)
            args[9] = 0                       # arena_cap
            rc = self.lib.fd_hostpath_finish_rows(*args)
            self.short.append(rc)
            return rc
        return self.lib.fd_hostpath_finish_rows(*args)


def test_arena_too_small_retries_to_the_same_result():
    frags = _sweep_frags()
    seen = []

    def tamper(pipe):
        pipe._hp = _ShortArena(pipe._hp)
        seen.append(pipe._hp)

    assert _pipe_run(frags, VerifyPipeline, True, tamper=tamper) == \
        _ref_run(frags)
    need = sum(65 + 100 for _ in range(24))   # frag 0: 24 rows of 100 B
    assert seen[0].short == [-need]


def test_finish_rows_contract_direct():
    """fd_hostpath_finish_rows called alone: -(needed bytes) with the
    tcache untouched when the arena is short, then survivors, offsets,
    tags and counts {verify_fail, dup drops, passing} once it fits; a
    tag twice among the passing rows is inserted once."""
    L = native.lib()
    rows = _mk_rows(8, [5, 6, 7, 8, 9, 10, 11, 12], seed=8,
                    dup_pairs=((1, 4),), dead=(6,))
    n = 8
    tc = NativeTCache(64)
    tag = np.empty(n, np.uint64)
    dup = np.empty(n, np.uint8)
    vp = ctypes.c_void_p
    assert L.fd_hostpath_submit_rows(vp(rows.ctypes.data), STRIDE, n, ML,
                                     vp(tc.handle), vp(tag.ctypes.data),
                                     vp(dup.ctypes.data)) == 0
    assert tag[6] == 0 and tag[1] == tag[4] and tag[0] != 0
    ok = np.array([1, 1, 0, 1, 1, 1, 1, 1], np.uint8)
    offs = np.zeros(n + 1, np.int64)
    keep = np.zeros(n, np.uint64)
    cnt = np.zeros(3, np.int64)

    def finish(arena):
        return L.fd_hostpath_finish_rows(
            vp(rows.ctypes.data), STRIDE, n, ML, vp(ok.ctypes.data),
            vp(tag.ctypes.data), vp(dup.ctypes.data), vp(tc.handle),
            vp(arena.ctypes.data), arena.nbytes, vp(offs.ctypes.data),
            vp(keep.ctypes.data), vp(cnt.ctypes.data))

    passing = [0, 1, 3, 4, 5, 7]
    need = sum(65 + 5 + i for i in passing)
    assert finish(np.empty(need - 1, np.uint8)) == -need
    assert not tc.query_batch(tag).any()
    arena = np.empty(need, np.uint8)
    assert finish(arena) == 5
    assert cnt.tolist() == [1, 1, 6]
    assert keep[:5].tolist() == [int(tag[i]) for i in (0, 1, 3, 5, 7)]
    ws = PackedVerdicts(arena[:offs[5]], offs[:6], keep[:5], 5).wires()
    assert ws == [b"\x01" + bytes(rows[i, ML:ML + 64])
                  + bytes(rows[i, :5 + i]) for i in (0, 1, 3, 5, 7)]
    assert tc.query_batch(tag).tolist() == [
        True, True, False, True, True, True, False, True]


def test_no_fallback_when_the_host_library_does_not_build(monkeypatch):
    """The pipeline and the dedup tile hold a NativeTCache, always: a
    host library that does not build raises at construction, where the
    JAX package would fall back to its Python tcache and NumPy path."""
    from firedancer_tpu_torch.disco.tiles import DedupTile

    def broken():
        raise RuntimeError("g++ failed on tango.cpp, txnparse.cpp, "
                           "hostpath.cpp")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken)
    for kw in ({}, {"native_hostpath": False}):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            VerifyPipeline(_VerdictFn([]), batch=4, msg_maxlen=ML, **kw)

    class Ctx:
        cfg = {"tcache_depth": 64}
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        DedupTile().init(Ctx())


def test_loader_keys_every_source(monkeypatch, tmp_path):
    """The host library's build is keyed by all three sources: a changed
    hostpath.cpp builds a new library, which binds the tcache, parser and
    host path symbols; a broken txnparse.cpp raises, naming the sources."""
    srcs = []
    for src in native.SOURCES:
        dst = tmp_path / src.name
        dst.write_bytes(src.read_bytes())
        srcs.append(dst)
    monkeypatch.setattr(native, "SOURCES", tuple(srcs))
    monkeypatch.setattr(native, "BUILD", tmp_path / "_build")
    first = native._so_path()
    with open(srcs[2], "a") as f:
        f.write("\n// changed\n")
    second = native._so_path()
    assert first != second and first.parent.parent == second.parent.parent
    L = native._bind(ctypes.CDLL(native.build()))
    assert native._so_path().exists()
    for name in ("fd_mcache_publish", "fd_tcache_insert_batch_dedup",
                 "fd_txn_parse_batch_packed", "fd_hostpath_finish_rows"):
        assert getattr(L, name).argtypes
    with open(srcs[1], "a") as f:
        f.write("\nthis does not compile\n")
    with pytest.raises(RuntimeError, match="txnparse.cpp"):
        native.build()
