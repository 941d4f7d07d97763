#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's verify paths on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from firedancer_tpu_torch/csrc and holds each one
against its plain torch version on the card.  The strict path, in its
three layouts: the real conformance corpora and the serving buckets
through SigVerifier.dispatch_blob, fused (sha512 and verify_tail
kernels), split (sha512, decompress, reduce_recode and dsm_tail_q) and
unfused (sha512, decompress and double_scalar_mul_base).  The RLC
batch-verify path: clean buckets through SigVerifier(mode="rlc") with
both MSM selects, a batch with one forgery through the strict descent,
and the corpora in rlc mode: through the descent, and each vector that
passes the prechecks alone among m - 1 valid signatures, its batch bit
held against the exact batch equation on Python ints (decompress,
sha512, rlc_recode and msm kernels).  Then the serving layers (phase
13): the engine (SigVerifier.make_ingest over pinned rotating blobs)
against serial dispatch_blob, and the port's VerifyTile at the default
bucket ladder, wire txns of every outcome and packed-row fills, its
accepted set against the host verifier's (sha512 and verify_tail
kernels).  Then the topology runtime (phase 14): the port's Mux runs the
VerifyTile in process on packed-wire frags with the card stalled after
each dispatch (each frag's flow credit held until its verdict, the
drain park and its manifest), then the verify-bench topology (source ->
verify -> dedup -> sink) in spawned processes on wire txns at the
default bucket ladder, and the packed-wire firehose over two verify
tiles on the one card.  Each path runs with the launch counts set to 0
just before it and read just after.  Then it times the kernels, their plain versions, the torch
finishes and the whole calls, and counts launches under torch.profiler.
Every time is printed beside the card's name and power limit.  The
second-to-last line is the {"kernels": [...]} record; the last line is
{"ok": true, "device": {...}}.  Any failed check raises, and the script
then exits non-zero without those lines.  It needs no network and exits
non-zero where there is no CUDA device or no port package beside it.
"""

import collections
import dataclasses
import hashlib
import json
import multiprocessing as mp
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
INT32_LANES_PER_SM = 64       # Hopper: 16 INT32 lanes per SM sub-partition
RUNS = 20
PLAIN_RUNS = 3                # the plain versions and the torch finishes
SHA_LANES, SHA_MAXLEN = 4096, 1232
TAIL_LANES = 528
# the serving buckets: (batch, msg_maxlen, ragged message lengths)
BUCKETS = ((4096, 128, False), (32768, 128, False), (4096, 1232, True))

# 32x32->64 multiply-adds of one field product and one squaring
# (csrc/fe25519.cuh: 10 x 10 and 55 column terms)
MUL_OPS, SQR_OPS = 100, 55
# Field products of one lane of the split and unfused layouts' chain
# (csrc/dsm_chain.cuh): the [0..8]A table 72 M and the 64 windows 1024 S
# + 1728 M, as in the fused tail; then dsm_tail_q's y-compare (1 M) or
# double_scalar_mul_base's identity add (a Niels add, 8 M).
DSM_SQR, DSM_MUL = 1024, 72 + 1728
# The least 32-bit work of the scalar lanes, a lower bound for any
# implementation, counted in radix 2^32 (not from the kernels' own
# code): a 32 x 32 -> 64 word product 2 operations, one carry step a
# word of each intermediate result, one operation an output value (a
# window byte, a limb of z s).  The digest mod L by three folds of 2^252
# = -C mod L (C < 2^125, 4 words): 9 x 4, 5 x 4 and 1 x 4 word products,
# carries of 13, 9 and 8 words and a conditional subtraction of 8 words.
# A product mod L of 8 by 4 words (S or k by z): 8 x 4, 5 x 4 and 1 x 4
# word products, carries of 12, 9 and 8 words, a subtraction of 8.  S <
# L: a subtraction of 8 words.
SC_REDUCE_OPS = 2 * (9 * 4 + 5 * 4 + 1 * 4) + (13 + 9 + 8) + 8
SC_MUL_OPS = 2 * (8 * 4 + 5 * 4 + 1 * 4) + (12 + 9 + 8) + 8
RR_OPS = SC_REDUCE_OPS + 8 + 4 * 64
RLC_OPS = SC_REDUCE_OPS + 8 + 2 * SC_MUL_OPS + 64 + 32 + 22
# Field products of one verify-tail lane (csrc/verify_tail.cu), counted
# from the code: decompression with its square-root chain (pow22523: 251
# squarings, 11 products) 257 S + 18 M; the [0..8](-A) table 72 M; the
# chain, 64 windows of four doublings (16 S + 13 M), a Niels add (8 M)
# and an affine add without T (6 M): 1024 S + 1728 M; the y-compare 1 M.
TAIL_SQR, TAIL_MUL = 257 + 1024, 18 + 72 + 1728 + 1
# 64-bit operations of one SHA-512 block (80 rounds of 26, 64 schedule
# steps of 13), each two 32-bit instructions on this card
SHA_OPS_PER_BLOCK = 2 * (80 * 26 + 64 * 13)
# One decompression (csrc/ge25519.cuh ge_frombytes, then T = x y): the
# square-root chain's pow22523 (251 S, 11 M) and the rest of it (3 S,
# 7 M), y^2 and d y^2 (1 S, 1 M), T (1 M).  The conditional product by
# sqrt(-1) is not counted, so the bound is a lower bound.
DEC_SQR, DEC_MUL = 255, 19
# Field products of the point operations (csrc/ge25519.cuh): a unified
# add 9 M, a Niels add 8 M, a conversion to Niels 1 M, a doubling 4 S and
# 3 M (4 M with T).
GE_ADD, GE_ADD_NIELS, GE_TO_NIELS = 9, 8, 1
# The four-rank chain of all three chain kernels (csrc/dsm_chain.cuh
# g4_dsm_chain: rank q holds coordinate q and makes the products whose
# results it owns), per rank of a lane, counted from the code: the table
# 22 M (seven unified adds of three rounds, the last entry's 2dT) and 29
# shuffles of 10 words; a window 4 S + 8 M (twelve rounds of one
# product) and 28 shuffles (a doubling 5, the Niels add 4, the affine add
# 4); then verify_tail's and dsm_tail_q's y-compare 1 M and 1 shuffle, or
# double_scalar_mul_base's identity add 2 M and 4 shuffles.  Each of
# verify_tail's ranks also decompresses A (DEC_SQR, DEC_MUL).  A shuffled
# word counts as one 32-bit operation; the additions and selects are not
# counted.
G4_TAB_MUL, G4_TAB_SHFL = 22, 290
G4_WIN_SQR, G4_WIN_MUL, G4_WIN_SHFL = 4, 8, 280
G4_YCMP_MUL, G4_YCMP_SHFL = 1, 10
G4_CLOSE_MUL, G4_CLOSE_SHFL = 2, 40
RLC_BUCKETS = ((4096, 128), (32768, 128))
MSM_M = 8
# phase 13's stall on the card, in clock cycles (torch.cuda._sleep):
# ~0.1 s on an H100, longer than the host takes to pack and launch a
# 4096-row dispatch
STALL_CYCLES = 200_000_000


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class _Metrics(dict):
    def set(self, name, val):
        self[name] = val

    def add(self, name, delta=1):
        self[name] = self.get(name, 0) + delta

    def hist_store(self, name, histf):
        self[name] = histf.counts.copy()


class _RecCtx:
    """A recording in-process ctx for the verify tile: cfg, publish,
    publish_burst, out_reserve/out_commit over a NumPy buffer, metrics,
    heartbeat and trace (None)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.metrics = _Metrics()
        self.trace = None
        self.published = []          # (payload, sig) of per-txn frags
        self.frags = []              # (frag bytes, sig, sz), packed
        self.out = np.zeros(1 << 21, np.uint8)
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


class _ReleaseGuard:
    """Holds each return of a rotating blob to its pool against the
    verdict of the dispatch that read it: that verdict must be ready when
    the blob goes back.  `waited` counts returns whose verdict was still
    pending when its harvest began, the returns that put the rule to the
    test."""

    def __init__(self):
        self.verdict = None
        self.returns = 0
        self.waited = 0

    def harvesting(self, verdict):
        self.verdict = verdict
        self.waited += not verdict.is_ready()

    def returned(self):
        if self.verdict is None or not self.verdict.is_ready():
            raise AssertionError("a blob went back to its pool before the "
                                 "verdict of its dispatch was ready")
        self.verdict = None
        self.returns += 1


class _GuardedFree(collections.deque):
    """The engine's free ring, its returns held by a _ReleaseGuard."""

    def __init__(self, items, guard):
        super().__init__(items)
        self.guard = guard

    def append(self, bidx):
        self.guard.returned()
        super().append(bidx)


def _guard_engine(eng, guard):
    harvest = eng._harvest_oldest

    def guarded():
        guard.harvesting(eng._inflight[0][0])
        return harvest()
    eng._harvest_oldest = guarded
    eng._free = _GuardedFree(eng._free, guard)


def _guard_pipeline(pipe, guard):
    finish = pipe._finish

    def guarded_finish(fl):
        if fl.buf is not None:
            guard.harvesting(fl.ok_dev)
        return finish(fl)
    pipe._finish = guarded_finish
    for bk in pipe.buckets + [pipe.lat_bucket] * bool(pipe.lat_bucket):
        def guarded_release(blob, release=bk.release):
            guard.returned()
            release(blob)
        bk.release = guarded_release


def serving_phase(pool, reset_counts, counts, note, device=None,
                  buckets=None, engine_cfg=(4096, 128), n_batches=16,
                  n_small=480, n_two=16, n_mid=48, n_mtu=48, fill_rows=2048,
                  fills=4, fill_valid=256):
    """Phase 13: the serving engine and the verify pipeline, through the
    entry points a user calls.  device None is the card; the sizes are
    the full ones (the engine at the serving VerifierConfig, the tile at
    the JAX package's default bucket ladder).  Raises on any failed
    check."""
    import torch

    from firedancer_tpu_torch.ballet import txn as txn_lib
    from firedancer_tpu_torch.disco import pipeline as pl
    from firedancer_tpu_torch.disco.verify_tile import VerifyTile
    from firedancer_tpu_torch.models import verifier as V
    from firedancer_tpu_torch.ops import ed25519 as ed
    buckets = [list(b) for b in (buckets or pl.DEFAULT_BUCKETS)]
    cuda = device is None

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def host_stats():
        if not cuda:
            return {}
        st = torch.cuda.host_memory_stats()
        return {k: st.get(k) for k in ("num_host_alloc", "num_host_free",
                                       "allocations.current")}

    # ---- (a) the engine: make_ingest(nbuf=3, depth=2) over n_batches
    # batches, a third of them with a quarter of their signatures
    # corrupted and one adversarial, against serial dispatch_blob
    t_phase = time.perf_counter()
    b, ml = engine_cfg
    sv = V.SigVerifier(V.VerifierConfig(b, ml), device=device)
    batches = [V.make_example_batch(b, ml, i % 3 != 0, 1300 + i,
                                    sign_pool=32)
               for i in range(n_batches - 1)]
    batches.append(V.make_adversarial_batch(b, ml, seed=1399)[:4])
    n_invalid = sum(i % 3 == 0 for i in range(n_batches - 1))
    blobs = [V.pack_blob(*x) for x in batches]
    serial = [np.asarray(sv.dispatch_blob(x)) for x in blobs]   # warm
    sync()
    t0 = time.perf_counter()
    serial = [np.asarray(sv.dispatch_blob(x)) for x in blobs]
    t_serial = (time.perf_counter() - t0) * 1e3 / n_batches
    eng = sv.make_ingest(nbuf=3, depth=2)
    if cuda and not all(buf.is_pinned() for buf in eng._bufs):
        raise AssertionError("engine: a rotating blob is not pinned")
    guard = _ReleaseGuard()
    _guard_engine(eng, guard)
    h0 = host_stats()
    reset_counts()
    t0 = time.perf_counter()
    got, pending = [], 0
    for x in batches:
        got += eng.submit(*x)
        pending += not eng._inflight[-1][0].is_ready()
    got += eng.drain()
    t_eng = (time.perf_counter() - t0) * 1e3 / n_batches
    launches = counts()
    h1 = host_stats()
    if len(got) != n_batches or any(
            not np.array_equal(g, s) for g, s in zip(got, serial)):
        raise AssertionError("engine: bits differ from serial dispatch_blob")
    if guard.returns != n_batches:
        raise AssertionError(f"engine: {guard.returns} blob returns for "
                             f"{n_batches} dispatches")
    if not (launches["sha512_ram"] == launches["verify_tail"]
            == eng.dispatches == n_batches):
        raise AssertionError(f"engine: launches {launches} for "
                             f"{eng.dispatches} dispatches")
    if not 0 < sum(int(s.sum()) for s in serial) < n_batches * b:
        raise AssertionError("engine: the batches are not mixed")
    note(f"engine {b}x{ml}, make_ingest(nbuf=3, depth=2): bits == serial "
         f"dispatch_blob on all {n_batches} x {b} rows ({n_invalid} batches "
         f"with corrupted signatures, 1 adversarial); sha512 and "
         f"verify_tail launches {launches['sha512_ram']} and "
         f"{launches['verify_tail']} == dispatches; stats {eng.stats()}")
    if cuda:
        # what syncs the host to the card inside one dispatch: copies
        # from pageable host memory wait for the stream before they start
        from torch.profiler import ProfilerActivity, profile
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            np.asarray(sv.dispatch_blob(eng._bufs[0]))
        names = [e.name for e in prof.events()]
        copies = sorted({n for n in names if "memcpy" in n.lower()})
        note(f"engine: one dispatch of a pinned blob under torch.profiler: "
             f"{sum('Pageable' in n for n in names)} copies from pageable "
             f"memory; copy events {copies}")
        # how far the host runs ahead of the card: a stall on the card
        # before one dispatch, against when dispatch_blob returns
        sync()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        torch.cuda._sleep(STALL_CYCLES)
        e1.record()
        t0 = time.perf_counter()
        v = sv.dispatch_blob(eng._bufs[0])
        t_ret = (time.perf_counter() - t0) * 1e3
        ready = v.is_ready()
        np.asarray(v)
        note(f"engine: the card stalled {e0.elapsed_time(e1):.2f} ms before "
             f"one dispatch: dispatch_blob returned after {t_ret:.2f} ms, "
             f"its verdict ready then: {ready}")
    note(f"engine: {t_eng:.4f} ms a batch wall, serial dispatch_blob "
         f"{t_serial:.4f} ms; verdict still pending right after its submit "
         f"in {pending} of {n_batches}; {guard.returns} blob returns, each "
         f"after its verdict was ready, {guard.waited} of them waited on a "
         f"pending verdict; rotating blobs pinned: "
         f"{all(buf.is_pinned() for buf in eng._bufs)}; pinned host "
         f"allocator over the run {h0} -> {h1}")
    if cuda:
        # the same batches with the card stalled after each dispatch's
        # kernels, before its verdict's copy: the drain then meets pending
        # verdicts, and a blob back on its free ring before its verdict
        # fails the guard
        stalled = sv.make_ingest(nbuf=3, depth=2)
        sguard = _ReleaseGuard()
        _guard_engine(stalled, sguard)

        def stall_dispatch(buf):
            v = sv.dispatch_blob(buf)
            torch.cuda._sleep(STALL_CYCLES)
            return v
        stalled.desc = dataclasses.replace(stalled.desc,
                                           dispatch=stall_dispatch)
        t0 = time.perf_counter()
        got, spend = [], 0
        for x in batches:
            got += stalled.submit(*x)
            spend += not stalled._inflight[-1][0].is_ready()
        got += stalled.drain()
        t_stall = (time.perf_counter() - t0) * 1e3 / n_batches
        if len(got) != n_batches or any(
                not np.array_equal(g, s) for g, s in zip(got, serial)):
            raise AssertionError("engine, card stalled: bits differ from "
                                 "serial dispatch_blob")
        if sguard.returns != n_batches or not sguard.waited:
            raise AssertionError(
                f"engine, card stalled: {sguard.returns} blob returns, "
                f"{sguard.waited} waited on a pending verdict")
        note(f"engine, card stalled {STALL_CYCLES} cycles after each "
             f"dispatch's kernels: bits == serial dispatch_blob; pending "
             f"right after submit in {spend} of {n_batches}; "
             f"{sguard.returns} blob returns, {sguard.waited} waited on a "
             f"pending verdict; "
             f"{t_stall:.4f} ms a batch wall; stats {stalled.stats()}")

    # ---- (b) the pipeline through the port's VerifyTile at the ladder
    rng = np.random.default_rng(1310)
    seeds = [rng.bytes(32) for _ in range(8)]
    pubs = [ed.keypair_from_seed(s)[0] for s in seeds]
    program = rng.bytes(32)

    def message(i, nsig, data_len):
        keys = [(i + j) % len(seeds) for j in range(nsig)]
        msg = txn_lib.build_unsigned(
            [pubs[k] for k in keys], rng.bytes(32),
            [(nsig, bytes(range(nsig)),
              i.to_bytes(8, "little") + rng.bytes(data_len - 8))],
            [program])
        return msg, keys

    def sized(i, payload_len):
        d = 8
        for _ in range(3):       # the data's compact-u16 grows a byte
            msg, keys = message(i, 1, d)
            d += payload_len - (65 + len(msg))
        return msg, keys

    specs = [message(i, 1, int(rng.integers(8, 120)))
             for i in range(n_small)]
    specs += [message(n_small + i, 2, 16) for i in range(n_two)]
    specs += [message(2000 + i, 1, int(rng.integers(260, 640)))
              for i in range(n_mid)]
    specs += [sized(3000 + i, txn_lib.MTU) for i in range(n_mtu)]
    specs.append(sized(4000, txn_lib.MTU + 8))          # over the MTU
    sigs = pool.starmap(ed.sign, [(seeds[k], m) for m, ks in specs
                                  for k in ks])
    wires, at = [], 0
    for m, ks in specs:
        wires.append(txn_lib.assemble(sigs[at:at + len(ks)], m))
        at += len(ks)
    n_distinct = len(wires) - 1
    mtu_wires = wires[n_small + n_two + n_mid:n_distinct]
    if len(wires[-1]) <= txn_lib.MTU or any(
            len(w) != txn_lib.MTU for w in mtu_wires):
        raise AssertionError("phase 13: the MTU txns are mis-sized")

    def flip(w, at):
        w = bytearray(w)
        w[at] ^= 1
        return bytes(w)

    two = range(n_small, n_small + n_two)
    stream = list(wires)
    for i in list(two)[:4]:
        stream[i] = flip(wires[i], 1 + 64 + 7)       # bad second signature
    for i in range(0, 64, 8):
        stream.append(flip(wires[i], 1 + 40))        # tampered, same tag
    stream.append(b"\x01" + rng.bytes(150))          # parse failure
    order = rng.permutation(len(stream))
    stream = [stream[i] for i in order]
    dups = rng.choice(len(stream), 32, replace=False)
    for j in sorted(dups, reverse=True):             # 32 later repeats
        stream.insert(int(rng.integers(j + 1, len(stream) + 1)), stream[j])

    # the host oracle: every signature lane through host_verify_blob
    lanes, owner = [], []
    for t_i, w in enumerate(stream):
        try:
            t = txn_lib.parse(w)
        except txn_lib.TxnParseError:
            continue
        m = t.message(w)
        for s, k in zip(t.signatures(w), t.signer_pubkeys(w)):
            lanes.append((m, s, k))
            owner.append(t_i)
    lb = np.zeros((len(lanes), txn_lib.MTU + ed.PACKED_EXTRA), np.uint8)
    for r, (m, s, k) in enumerate(lanes):
        lb[r, :len(m)] = np.frombuffer(m, np.uint8)
        lb[r, txn_lib.MTU:] = np.frombuffer(
            s + k + np.int32(len(m)).tobytes(), np.uint8)
    ok = np.concatenate([np.asarray(x, bool) for x in pool.map(
        ed.host_verify_blob, np.array_split(lb, 64))])
    lane_ok = {}
    for t_i, o in zip(owner, ok):
        lane_ok[t_i] = lane_ok.get(t_i, True) and bool(o)
    want, seen = set(), set()
    for t_i, w in enumerate(stream):
        tag = int.from_bytes(w[1:9], "little")
        if lane_ok.get(t_i) and tag not in seen:
            seen.add(tag)
            want.add(w)

    # packed-row fills of the first bucket: fill_valid distinct signed
    # rows among rows stamped the way a source tile stamps them (its tag
    # written over R, so they fail)
    rml = buckets[0][1]
    fill_specs = [message(5000 + i, 1, 24) for i in range(fills * fill_valid)]
    fsigs = pool.starmap(ed.sign, [(seeds[ks[0]], m) for m, ks in fill_specs])
    fill_blobs = []
    for f in range(fills):
        rows = np.zeros((fill_rows, rml + ed.PACKED_EXTRA), np.uint8)
        tpl_m, tpl_k = fill_specs[0]
        rows[:, :len(tpl_m)] = np.frombuffer(tpl_m, np.uint8)
        rows[:, rml:] = np.frombuffer(
            fsigs[0] + pubs[tpl_k[0]] + np.int32(len(tpl_m)).tobytes(),
            np.uint8)
        tags = rng.integers(1, 1 << 63, fill_rows, dtype=np.uint64)
        rows[:, rml:rml + 8] = tags.view(np.uint8).reshape(-1, 8)
        rows[:, len(tpl_m) - 8:len(tpl_m)] = np.arange(
            f * fill_rows, (f + 1) * fill_rows,
            dtype=np.uint64).view(np.uint8).reshape(-1, 8)
        for j, r in enumerate(rng.choice(fill_rows, fill_valid,
                                         replace=False)):
            m, ks = fill_specs[f * fill_valid + j]
            rows[r] = 0
            rows[r, :len(m)] = np.frombuffer(m, np.uint8)
            rows[r, rml:] = np.frombuffer(
                fsigs[f * fill_valid + j] + pubs[ks[0]]
                + np.int32(len(m)).tobytes(), np.uint8)
        fill_blobs.append(rows)
    fill_ok = [np.concatenate([np.asarray(x, bool) for x in pool.map(
        ed.host_verify_blob, np.array_split(rows, 32))])
        for rows in fill_blobs]
    want_wires = []
    for rows, fok in zip(fill_blobs, fill_ok):
        if int(fok.sum()) != fill_valid:
            raise AssertionError("phase 13: a stamped row verified")
        for r in np.flatnonzero(fok):
            tag = int(rows[r, rml:rml + 8].view(np.uint64)[0])
            if tag not in seen:
                seen.add(tag)
                n = int(rows[r, rml + 96:].view(np.int32)[0])
                want_wires.append(b"\x01" + rows[r, rml:rml + 64].tobytes()
                                  + rows[r, :n].tobytes())

    cfg = {"buckets": buckets, "egress_packed": 1}
    if not cuda:
        cfg["device"] = device
    tile, ctx = VerifyTile(), _RecCtx(cfg)
    t0 = time.perf_counter()
    tile.init(ctx)
    t_boot = time.perf_counter() - t0
    pguard = _ReleaseGuard()
    _guard_pipeline(tile.pipe, pguard)
    reset_counts()
    t0 = time.perf_counter()
    for lo in range(0, len(stream), 64):
        part = stream[lo:lo + 64]
        offs = np.zeros(len(part) + 1, np.int64)
        np.cumsum([len(w) for w in part], out=offs[1:])
        metas = np.zeros(len(part), dtype=[("sig", np.uint64)])
        tile.on_burst(ctx, 0, metas, np.frombuffer(b"".join(part), np.uint8),
                      offs, len(part))
        tile.after_credit(ctx)
    tile._forward(ctx, tile.pipe.flush())
    sync()
    t_wire = time.perf_counter() - t0
    wire_batches = tile.pipe.metrics.batches
    t0 = time.perf_counter()
    for rows in fill_blobs:
        tile._forward_burst(ctx, tile.pipe.submit_packed_rows(rows))
        tile.after_credit(ctx)
    tile._forward(ctx, tile.pipe.flush())
    sync()
    t_fill = (time.perf_counter() - t0) * 1e3 / fills
    tile._sync_metrics(ctx)
    launches = counts()
    snap = tile.pipe.metrics.snapshot()

    got = [p for p, _ in ctx.published]
    for p, sig in ctx.published:
        if sig != int.from_bytes(p[1:9], "little"):
            raise AssertionError("tile: a published sig is not the low 64 "
                                 "bits of the txn's first signature")
    if len(got) != len(set(got)) or set(got) != want:
        raise AssertionError(
            f"tile: accepted {len(got)} wire txns, the host oracle "
            f"{len(want)}; {len(set(got) - want)} extra, "
            f"{len(want - set(got))} missing")
    got_wires = []
    for frag, sig, k in ctx.frags:
        offs = np.frombuffer(frag[:4 * (k + 1)], np.uint32)
        body = frag[4 * (k + 1):]
        ws = [body[a:c] for a, c in zip(offs[:-1], offs[1:])]
        if sig != int.from_bytes(ws[0][1:9], "little") & (pl.LAT_PRIO_BIT
                                                           - 1):
            raise AssertionError("tile: a packed frag's sig is not its "
                                 "first txn's signature bits")
        got_wires += ws
    if got_wires != want_wires:
        raise AssertionError(f"tile: packed rows accepted {len(got_wires)}, "
                             f"the host oracle {len(want_wires)}")
    n_mtu_ok = sum(len(p) == txn_lib.MTU for p in got)
    if n_mtu_ok != n_mtu:
        raise AssertionError(f"tile: {n_mtu_ok} of {n_mtu} full-MTU txns "
                             f"accepted")
    if not (launches["sha512_ram"] == launches["verify_tail"]
            == snap["batches"]):
        raise AssertionError(f"tile: launches {launches} for "
                             f"{snap['batches']} dispatches")
    if snap["compile_cnt"]:
        raise AssertionError(f"tile: compile_cnt {snap['compile_cnt']} "
                             f"after boot")
    if pguard.returns != wire_batches:
        raise AssertionError(f"tile: {pguard.returns} bucket blob returns "
                             f"for {wire_batches} bucket dispatches")
    blobs = [x for bk in tile.pipe.buckets for x in [bk.blob, *bk._pool]]
    if cuda and not all(x.is_pinned() for x in blobs):
        raise AssertionError("tile: a bucket blob is not pinned")
    note(f"tile at buckets {buckets}: {len(stream)} wire frags ({n_distinct} "
         f"distinct signed txns, {n_mtu} full-MTU, 32 repeats, 8 tampered, "
         f"4 with a bad second signature, 2 parse failures): accepted "
         f"{len(got)} == host oracle, {n_mtu_ok} of them full-MTU (the "
         f"{buckets[-1][0]}x{buckets[-1][1]} bucket); {fills} packed fills "
         f"of {fill_rows} rows ({fill_valid} valid each): {len(got_wires)} "
         f"== host oracle; sha512 and verify_tail launches "
         f"{launches['sha512_ram']} and {launches['verify_tail']} == "
         f"{snap['batches']} dispatches; compile_cnt {snap['compile_cnt']}; "
         f"{pguard.returns} bucket blob returns, each after its verdict was "
         f"ready, {pguard.waited} of them waited on a pending verdict; "
         f"{len(blobs)} bucket blobs, pinned: "
         f"{all(x.is_pinned() for x in blobs)}")
    note(f"tile: boot {t_boot:.3f} s (kernel build and warmup of "
         f"{len(buckets)} shapes); wire txns {len(stream) / t_wire:.1f} "
         f"txns/s over {wire_batches} dispatches (the scalar Python parse "
         f"sets it: the native burst parser is not ported); "
         f"{t_fill:.4f} ms a {fill_rows}-row packed fill wall; pipeline "
         f"batch_ns p50/p99 {snap['batch_ns_p50']:.0f}/"
         f"{snap['batch_ns_p99']:.0f}, coalesce_ns p50 "
         f"{snap['coalesce_ns_p50']:.0f}, e2e_ns p50 {snap['e2e_ns_p50']:.0f},"
         f" lanes {snap['lanes_filled']} filled of "
         f"{snap['lanes_dispatched']} dispatched")
    note(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


class _StalledVerifier:
    """The tile's verifier with its verdicts held back after each
    dispatch: on the card a sleep kernel after the dispatch's kernels,
    before its verdict's copy (torch.cuda._sleep); on the CPU a verdict
    that reads as pending for `stall_s`.  dispatches counts the calls."""

    def __init__(self, fn, stall_s=0.1):
        self.fn = fn
        self.device = fn.device
        self.mode = fn.mode
        self.stall_s = stall_s
        self.dispatches = 0

    def dispatch_blob(self, blob, maxlen=None):
        import torch
        v = self.fn.dispatch_blob(blob, maxlen=maxlen)
        self.dispatches += 1
        if self.device.type == "cuda":
            torch.cuda._sleep(STALL_CYCLES)
            return v
        return _TimedVerdict(v, time.monotonic() + self.stall_s)


class _TimedVerdict:
    def __init__(self, v, ready_at):
        self.v = v
        self.ready_at = ready_at

    def is_ready(self):
        return time.monotonic() >= self.ready_at and self.v.is_ready()

    def copy_to_host_async(self):
        self.v.copy_to_host_async()

    def __array__(self, dtype=None, copy=None):
        time.sleep(max(0.0, self.ready_at - time.monotonic()))
        out = np.asarray(self.v)
        return out if dtype is None else out.astype(dtype)


class _UploadCounter:
    """Wraps a SigVerifier's upload (`_to_device`) to count what each
    dispatch copies to the card: per call the kind of the source (pinned,
    pageable or already on the device) and its bytes.  On the card a
    pageable source is also checked to have been read in full when the
    upload returns, which the packed-wire tile's seq re-check after the
    dispatch relies on: it is uploaded from a private copy that is
    overwritten right after, so a copy still reading it would change the
    verdict bits, which the phase holds against the host verifier."""

    def __init__(self, fn):
        self.fn = fn
        self.orig = fn._to_device
        self.calls = []
        fn._to_device = self

    def __call__(self, x):
        import torch
        cuda = self.fn.device.type == "cuda"
        if isinstance(x, torch.Tensor):
            kind = ("device" if x.device.type != "cpu" else
                    "pinned" if cuda and x.is_pinned() else "pageable")
            self.calls.append((kind, x.numel() * x.element_size()))
            return self.orig(x)
        private = np.array(x, copy=True)
        self.calls.append(("pageable", private.nbytes))
        out = self.orig(private)
        if cuda:
            private.fill(0xFF)
        return out

    def close(self):
        del self.fn._to_device


def _stream_part(seed: int, keys: int, lo: int, hi: int) -> list:
    """Txns lo..hi of source_txn_stream(seed, keys), for a pool worker."""
    from firedancer_tpu_torch.disco.tiles import source_txn_stream
    return list(source_txn_stream(seed, keys, hi, lo))


def _shm_check(need_bytes: int, note):
    """/dev/shm must hold the workspace: print its size and free space,
    and raise with both if it cannot."""
    st = os.statvfs("/dev/shm")
    size, free = st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize
    note(f"/dev/shm: {size / 2**20:.0f} MiB, {free / 2**20:.0f} MiB free; "
         f"the workspace needs {need_bytes / 2**20:.0f} MiB")
    if free < need_bytes:
        raise RuntimeError(f"/dev/shm has {free} bytes free of {size}: "
                           f"the topology's workspace needs {need_bytes}")


def _wait_for(pred, timeout_s, what, run=None):
    """Poll pred until it holds; with a TopoRun, every poll also checks
    that no tile failed."""
    deadline = time.monotonic() + timeout_s
    while not pred():
        if run is not None:
            bad = run.poll()
            if bad is not None:
                raise AssertionError(f"tile {bad} failed while waiting for "
                                     f"{what}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.005)


def topology_phase(pool, reset_counts, counts, note, device=None,
                   rows=2048, n_valid=256, wire_count=2560,
                   firehose_count=65536, buckets=None, workdir=None,
                   flush_age_ns=30_000_000_000):
    """Phase 14: the port's tango fabric and tile runtime with the port's
    VerifyTile on the card.  (a) In process: the port Mux runs the tile
    in a thread on packed-wire frags published by hand, with the card
    stalled after each dispatch: each frag's credit is held while its
    verdict is pending, released after, each row's verdict is the host
    verifier's, and the drain parks with a manifest.  (b) The
    verify-bench topology in processes on wire frags at the default
    bucket ladder: one full first bucket, then the partial rest by the
    age flush.  (c) The packed-wire firehose over two verify tiles
    on the one card.  device None is the card; the sizes are the full
    ones.  Raises on any failed check."""
    import tempfile
    import threading

    from firedancer_tpu_torch.app import config as app_config
    from firedancer_tpu_torch.ballet import txn as txn_lib
    from firedancer_tpu_torch.disco import pipeline as pl
    from firedancer_tpu_torch.disco import topo as topo_mod
    from firedancer_tpu_torch.disco.mux import Mux
    from firedancer_tpu_torch.disco.run import SupervisionPolicy, TopoRun
    from firedancer_tpu_torch.disco.tiles import read_capture
    from firedancer_tpu_torch.disco.topo import InLink, TopoBuilder
    from firedancer_tpu_torch.disco.verify_tile import VerifyTile
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.tango.ring import (PACKED_ROW_EXTRA, Cnc,
                                                 packed_row_ml)
    cuda = device is None
    buckets = [list(b) for b in (buckets or pl.DEFAULT_BUCKETS)]
    tag = f"cs{os.getpid()}"
    t_phase = time.perf_counter()
    workdir = Path(workdir or tempfile.mkdtemp(prefix="fdtpu_phase14_"))
    old_omp = os.environ.get("OMP_NUM_THREADS")
    # spawned tile processes: one intra-op thread each
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        # ---- (a) in process: credits held across a pending verdict
        ml = packed_row_ml(256)
        stride = ml + PACKED_ROW_EXTRA
        spec = (TopoBuilder(f"{tag}a", wksp_mb=64)
                .link("src_v", depth=16, mtu=rows * stride)
                .link("v_s", depth=4096, mtu=1280)
                .tile("src", "sink", outs=["src_v"])
                .tile("v", "verify", ins=["src_v"], outs=["v_s"],
                      device=device, packed_wire=1, buckets=[[rows, ml]],
                      flush_age_ns=10 ** 12,
                      supervision={"drain_manifest_dir": str(workdir)})
                .tile("s", "sink", ins=[InLink("v_s", reliable=False)])
                .build())
        _shm_check(spec.wksp_mb << 20, note)
        rng = np.random.default_rng(1400)
        seeds = [rng.bytes(32) for _ in range(8)]
        pubs = [ed.keypair_from_seed(s)[0] for s in seeds]
        program = rng.bytes(32)
        msgs = [txn_lib.build_unsigned(
            [pubs[i % 8]], rng.bytes(32),
            [(1, b"\x00", i.to_bytes(8, "little"))], [program])
            for i in range(2 * n_valid)]
        sigs = pool.starmap(ed.sign, [(seeds[i % 8], m)
                                      for i, m in enumerate(msgs)])
        frags = []
        for f in range(4):
            blk = np.zeros((rows, stride), np.uint8)
            tpl = msgs[0]
            blk[:, :len(tpl)] = np.frombuffer(tpl, np.uint8)
            blk[:, ml:] = np.frombuffer(
                sigs[0] + pubs[0] + np.int32(len(tpl)).tobytes(), np.uint8)
            # stamped the way the source tile stamps its firehose
            blk[:, ml:ml + 8] = rng.integers(
                1, 1 << 62, rows, dtype=np.uint64).view(np.uint8).reshape(
                -1, 8)
            if f % 2 == 0:
                at = rng.choice(rows, n_valid, replace=False)
                for j, r in enumerate(at):
                    i = (f // 2) * n_valid + j
                    sig = bytearray(sigs[i])
                    if j % 16 == 0:
                        sig[40] ^= 1                  # forged
                    blk[r] = 0
                    blk[r, :len(msgs[i])] = np.frombuffer(msgs[i], np.uint8)
                    blk[r, ml:] = np.frombuffer(
                        bytes(sig) + pubs[i % 8]
                        + np.int32(len(msgs[i])).tobytes(), np.uint8)
            frags.append(blk)
        host = [np.concatenate([np.asarray(x, bool) for x in pool.map(
            ed.host_verify_blob, np.array_split(blk, 32))])
            for blk in frags]
        want = []
        for blk, ok in zip(frags, host):
            for r in np.flatnonzero(ok):
                n = int(blk[r, ml + 96:].view(np.int32)[0])
                w = (b"\x01" + blk[r, ml:ml + 64].tobytes()
                     + blk[r, :n].tobytes())
                want.append((w, int.from_bytes(w[1:9], "little")))
        n_pass = n_valid - n_valid // 16
        if [int(ok.sum()) for ok in host] != [n_pass, 0, n_pass, 0]:
            raise AssertionError(f"phase 14a: host bits {[int(o.sum()) for o in host]}")

        jt = topo_mod.create(spec)
        tile, run_err = VerifyTile(), []
        try:
            mux = Mux(jt, "v", tile)
            mux.HOUSE_NS = 1_000_000
            cnc = jt.cnc["v"]

            def run_mux():
                try:
                    mux.run()
                except BaseException as e:  # re-raised below
                    run_err.append(e)

            th = threading.Thread(target=run_mux, daemon=True)
            t0 = time.perf_counter()
            th.start()
            _wait_for(lambda: cnc.signal_query() == Cnc.SIGNAL_RUN
                      or run_err, 300, "the tile's boot")
            if run_err:
                raise run_err[0]
            t_boot_a = time.perf_counter() - t0
            stalled = _StalledVerifier(tile.pipe.verify_fn)
            tile.pipe.verify_fn = stalled
            uploads = _UploadCounter(stalled.fn)
            lnk, fseq = jt.links["src_v"], jt.fseq[("v", "src_v")]
            reset_counts()
            chunk = 0
            t0 = time.perf_counter()
            for blk in frags:
                view = lnk.dcache.write_view(chunk, blk.nbytes)
                view[:] = blk.ravel()
                last = lnk.mcache.publish(
                    sig=int(blk[0, ml:ml + 8].view(np.uint64)[0]),
                    chunk=chunk, sz=rows)
                chunk = lnk.dcache.advance(chunk, blk.nbytes)
            held_max, behind = 0, 0
            deadline = time.monotonic() + 120
            while tile.pipe.metrics.batches < 4 or tile.credits_held(0):
                if run_err:
                    raise run_err[0]
                h = tile.credits_held(0)
                held_max = max(held_max, h)
                if h and fseq.query() < last + 1:
                    behind += 1
                if time.monotonic() > deadline:
                    raise TimeoutError("phase 14a: verdicts")
                time.sleep(0.001)
            _wait_for(lambda: fseq.query() == last + 1, 10,
                      "the fseq level with the published seq")
            t_a = time.perf_counter() - t0
            launches = counts()
            uploads.close()
            if not (held_max > 0 and behind > 0):
                raise AssertionError(
                    f"phase 14a: no pending verdict held a credit "
                    f"(max held {held_max}, fseq behind {behind} polls)")
            if tile.credits_held(0) != 0:
                raise AssertionError("phase 14a: credits still held")
            _wait_for(lambda: jt.metrics["v"].get("batch_cnt") == 4, 10,
                      "the metrics sync")
            cnc.signal(Cnc.SIGNAL_DRAIN)
            _wait_for(lambda: cnc.signal_query() == Cnc.SIGNAL_DRAINED
                      or run_err, 30, "DRAINED")
            if run_err:
                raise run_err[0]
            man = json.loads((workdir / "v.manifest.json").read_text())
            if man["cursors"] != {"src_v": last + 1}:
                raise AssertionError(f"phase 14a: manifest {man}")
            cnc.signal(Cnc.SIGNAL_HALT)
            th.join(60)
            if th.is_alive() or run_err:
                raise AssertionError(f"phase 14a: the tile did not halt "
                                     f"cleanly: {run_err}")
            lnk_out = jt.links["v_s"]
            got = []
            for seq in range(lnk_out.mcache.seq0(),
                             lnk_out.mcache.seq_query()):
                rc, m = lnk_out.mcache.query(seq)
                if rc:
                    raise AssertionError("phase 14a: the verdict link "
                                         "overran")
                got.append((lnk_out.dcache.read(int(m["chunk"]),
                                                int(m["sz"])),
                            int(m["sig"])))
            if got != want:
                raise AssertionError(f"phase 14a: published {len(got)} "
                                     f"passing rows, the host verifier "
                                     f"{len(want)}")
            snap = jt.metrics["v"].snapshot()
            if (snap["txn_in_cnt"], snap["verify_pass_cnt"],
                    snap["verify_fail_cnt"], snap["torn_drop_cnt"],
                    snap["compile_cnt"]) != (4 * rows, len(want),
                                             4 * rows - len(want), 0, 0):
                raise AssertionError(f"phase 14a: counters {snap}")
            if not (launches["sha512_ram"] == launches["verify_tail"]
                    == stalled.dispatches == 4):
                raise AssertionError(f"phase 14a: launches {launches} for "
                                     f"{stalled.dispatches} dispatches")
            # what each packed frag's dispatch copied to the card: the
            # dcache rows are pageable shared memory, one upload a frag
            kinds = [k for k, _ in uploads.calls]
            if (kinds != ["pageable"] * stalled.dispatches
                    or {n for _, n in uploads.calls} != {rows * stride}):
                raise AssertionError(f"phase 14a: uploads {uploads.calls} "
                                     f"for {stalled.dispatches} dispatches")
            note(f"phase 14a: port Mux + VerifyTile(packed_wire) in process,"
                 f" 4 frags of {rows}x{ml} (2 with {n_valid} signed rows, "
                 f"{n_valid // 16} of them forged; 2 all stamped), the card "
                 f"stalled {STALL_CYCLES} cycles after each dispatch: "
                 f"credits_held up to {held_max}, fseq behind the published "
                 f"seq in {behind} polls while a verdict was pending, then 0 "
                 f"held and fseq {fseq.query()} == published {last + 1}; "
                 f"published {len(got)} == host verifier; counters txn_in "
                 f"{snap['txn_in_cnt']} pass {snap['verify_pass_cnt']} fail "
                 f"{snap['verify_fail_cnt']} torn {snap['torn_drop_cnt']} "
                 f"compile {snap['compile_cnt']}; sha512 and verify_tail "
                 f"launches {launches['sha512_ram']} and "
                 f"{launches['verify_tail']} == {stalled.dispatches} "
                 f"dispatches; DRAINED with manifest cursors {man['cursors']};"
                 f" boot {t_boot_a:.3f} s, 4 frags {t_a:.3f} s")
            note(f"phase 14a: uploads counted at SigVerifier._to_device: "
                 f"{kinds.count('pageable')} from pageable memory of "
                 f"{rows * stride} bytes each, {kinds.count('pinned')} pinned,"
                 f" for {stalled.dispatches} dispatches"
                 + ("; each source overwritten as the upload returned, the "
                    "bits still the host verifier's" if cuda else ""))
            mux = tile = lnk = fseq = lnk_out = None
            import gc
            gc.collect()
        finally:
            jt.close()
            jt.unlink()

        # ---- (b) processes: verify-bench on wire frags at the ladder
        cfg = app_config.load(environ={})
        cfg["name"] = f"{tag}b"
        cfg["tiles"]["verify"]["buckets"] = buckets
        cfg["tiles"]["verify"]["device"] = device or ""
        # the source signs each txn on the host (~160-210 txns/s on an
        # H100 host): an age well past the first bucket's fill lets it
        # fill and dispatch whole, and the age flush then dispatches the
        # partial rest
        cfg["tiles"]["verify"]["flush_age_ns"] = flush_age_ns
        cfg["supervision"]["drain_timeout_s"] = 120.0
        cfg["supervision"]["drain_manifest_dir"] = str(workdir / "b")
        cfg["tiles"]["sink"] = {"capture_path": str(workdir / "sink.cap")}
        cfg["development"]["source_count"] = wire_count
        spec = app_config.build_topology(cfg)
        _shm_check(spec.wksp_mb << 20, note)
        # the oracle: the source's stream regenerated over the pool while
        # the topology runs
        step = -(-wire_count // 16)
        want_b = pool.starmap_async(_stream_part, [
            (cfg["development"]["bench_seed"], 4, lo,
             min(lo + step, wire_count))
            for lo in range(0, wire_count, step)])
        t0 = time.perf_counter()
        run = TopoRun(spec, policy=SupervisionPolicy.from_cfg(cfg))
        try:
            run.wait_ready(timeout=cfg["supervision"]["boot_grace_s"])
            t_boot_b = time.perf_counter() - t0
            t0 = time.perf_counter()
            full = buckets[0][0]
            _wait_for(lambda: run.metrics("sink")["frag_cnt"] >= full,
                      600, f"{full} txns at the sink", run)
            t_full = time.perf_counter() - t0
            _wait_for(lambda: run.metrics("sink")["frag_cnt"] >= wire_count,
                      600, f"{wire_count} txns at the sink", run)
            t_b = time.perf_counter() - t0
            if run.poll() is not None:
                raise AssertionError("phase 14b: a tile failed")
            v, d = run.metrics("verify:0"), run.metrics("dedup")
            if not run.drain():
                raise AssertionError("phase 14b: drain() did not drain "
                                     "every tile")
        finally:
            run.close()
        if set(run.exitcodes.values()) != {0}:
            raise AssertionError(f"phase 14b: exit codes {run.exitcodes}")
        got_b = read_capture(str(workdir / "sink.cap"))
        want_b = [t for part in want_b.get(600) for t in part]
        if sorted(got_b) != sorted(want_b):
            raise AssertionError(f"phase 14b: the sink captured "
                                 f"{len(got_b)} txns, source_txn_stream "
                                 f"{len(want_b)}")
        if (v["verify_pass_cnt"], v["verify_fail_cnt"], v["parse_fail_cnt"],
                v["torn_drop_cnt"], d["uniq_cnt"]) != (
                    wire_count, 0, 0, 0, wire_count):
            raise AssertionError(f"phase 14b: verify {v}, dedup {d}")
        # one full first-bucket dispatch, then the partial rest by age
        part = wire_count - full
        if (v["batch_cnt"], v["lanes_filled_cnt"], v["lanes_dispatched_cnt"],
                v["bucket_fill_pct"]) != (2, wire_count, 2 * full,
                                          100 * part // full):
            raise AssertionError(f"phase 14b: not one full bucket and one "
                                 f"partial: {v}")
        note(f"phase 14b: verify-bench in processes, {wire_count} wire txns"
             f" at buckets {buckets}: verify pass {v['verify_pass_cnt']} "
             f"fail {v['verify_fail_cnt']} parse_fail {v['parse_fail_cnt']} "
             f"torn {v['torn_drop_cnt']} batches {v['batch_cnt']} (one of "
             f"{full} rows, full, and one of {part} by the {flush_age_ns} ns "
             f"age flush) compile {v['compile_cnt']}; dedup uniq "
             f"{d['uniq_cnt']}; the sink capture == source_txn_stream; "
             f"poll() None throughout; drain() True; every tile exited 0; "
             f"boot {t_boot_b:.3f} s; {full / t_full:.1f} wire txns/s at "
             f"the sink over the first {full} ({t_full:.3f} s; the source "
             f"signs each txn on the host), all {wire_count} after "
             f"{t_b:.3f} s with the age wait")

        # ---- (c) processes: the packed-wire firehose, two verify tiles
        cfg = app_config.load(environ={})
        cfg["name"] = f"{tag}c"
        cfg["layout"]["verify_tile_count"] = 2
        cfg["tiles"]["verify"]["batch"] = rows
        cfg["tiles"]["verify"]["msg_maxlen"] = 256
        cfg["tiles"]["verify"]["device"] = device or ""
        cfg["development"]["packed_wire"] = 1
        cfg["development"]["source_count"] = firehose_count
        spec = app_config.build_topology(cfg)
        _shm_check(spec.wksp_mb << 20, note)
        t0 = time.perf_counter()
        run = TopoRun(spec, policy=SupervisionPolicy.from_cfg(cfg))
        try:
            run.wait_ready(timeout=cfg["supervision"]["boot_grace_s"])
            t_boot_c = time.perf_counter() - t0
            t0 = time.perf_counter()

            def verdicted():
                return sum(run.metrics(f"verify:{i}")["verify_fail_cnt"]
                           for i in range(2)) >= firehose_count
            _wait_for(verdicted, 600, f"{firehose_count} packed rows", run)
            t_c = time.perf_counter() - t0
            if run.poll() is not None:
                raise AssertionError("phase 14c: a tile failed")
            ms = [run.metrics(f"verify:{i}") for i in range(2)]
        finally:
            run.close()
        if set(run.exitcodes.values()) != {0}:
            raise AssertionError(f"phase 14c: exit codes {run.exitcodes}")
        if (sum(m["txn_in_cnt"] for m in ms) != firehose_count
                or not all(m["txn_in_cnt"] > 0 for m in ms)
                or any(m["torn_drop_cnt"] for m in ms)
                or any(m["verify_fail_cnt"] != m["txn_in_cnt"] for m in ms)):
            raise AssertionError(f"phase 14c: verify tiles {ms}")
        note(f"phase 14c: packed-wire firehose, 2 verify tiles on one card,"
             f" {firehose_count} rows in frags of {rows}x{packed_row_ml(256)}:"
             f" txn_in {[m['txn_in_cnt'] for m in ms]}, batches "
             f"{[m['batch_cnt'] for m in ms]}, torn "
             f"{[m['torn_drop_cnt'] for m in ms]}, every stamped row "
             f"failed; poll() None throughout; every tile exited 0; boot "
             f"{t_boot_c:.3f} s; "
             f"{firehose_count / t_c:.1f} rows/s ({t_c:.3f} s)")
    finally:
        if old_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_omp
    note(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from firedancer_tpu_torch.kernels import build
        from firedancer_tpu_torch.models import verifier as V
        from firedancer_tpu_torch.ops import curve25519 as cv
        from firedancer_tpu_torch.ops import decompress as dc
        from firedancer_tpu_torch.ops import dsm
        from firedancer_tpu_torch.ops import ed25519 as ed
        from firedancer_tpu_torch.ops import f25519 as fe
        from firedancer_tpu_torch.ops import msm as ms
        from firedancer_tpu_torch.ops import reduce_recode as rr
        from firedancer_tpu_torch.ops import rlc_recode as rl
        from firedancer_tpu_torch.ops import scalar25519 as sc
        from firedancer_tpu_torch.ops import sha512_kernel as sk
        from firedancer_tpu_torch.ops import verify_tail as vt
        from firedancer_tpu_torch.tools.kernel_time import device_ms
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    int_ops_per_s = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {sms} SMs, max SM clock "
          f"{clock_mhz:.0f} MHz")

    def note(msg: str):
        print(f"{msg}  [{card}]", flush=True)

    def cuda_ms(fn, runs: int = RUNS, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def dev_ms(fn, entry: str) -> float:
        """The kernel entry's device ms a call (torch.profiler over RUNS
        calls: tools/kernel_time.py device_ms); CUDA events around RUNS
        back-to-back calls where three traces held none of its launches."""
        ms, _, _, how = device_ms(torch, fn, entry, RUNS)
        if how != "profiler":
            note(f"{entry}: three profiler traces held none of its launches;"
                 f" its device ms {ms:.5f} is by CUDA events around {RUNS} "
                 f"back-to-back calls")
        if not ms > 0:
            raise AssertionError(f"{entry}: device time {ms} ms")
        return ms

    def wall_ms(fn, runs: int = RUNS) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def cols(blob, ml):
        """(msgs, r, s, pub, len4) row views of a packed blob."""
        return (blob[:, :ml], blob[:, ml:ml + 32], blob[:, ml + 32:ml + 64],
                blob[:, ml + 64:ml + 96], blob[:, ml + 96:ml + 100])

    def sha(blob, ml):
        m, r, _, a, ln = cols(blob, ml)
        return sk.sha512_ram(m, r, a, ln)

    def tail_args(blob, ml):
        m, r, s, a, ln = cols(blob, ml)
        return a, s, sk.sha512_ram(m, r, a, ln), r

    def hold_sha(blob, ml) -> int:
        """Kernel 1 vs its plain version on one blob: digests equal."""
        m, r, _, a, ln = cols(blob, ml)
        got = sha(blob, ml)
        want = sk.sha512_ram_plain(m, r, a, ln)
        if not torch.equal(got, want):
            raise AssertionError(f"sha512 {tuple(blob.shape)}: "
                                 f"{int((got != want).any(1).sum())} lanes "
                                 f"differ from plain")
        return int((got.to(torch.int16) - want).abs().max())

    def hold_tail(args):
        """Kernel 2 vs its plain version on the same inputs: equal ok
        bits and equal canonical X and Z.  Returns (max error, kernel
        outputs, plain outputs)."""
        got, want = vt.verify_tail(*args), vt.verify_tail_plain(*args)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(
                f"verify_tail {len(got[0])} lanes: "
                f"{int((got[0] != want[0]).sum())} ok bits differ from plain")
        err = max(int((fe.canonical(k) - fe.canonical(p)).abs().max())
                  for k, p in zip(got[1:], want[1:]))
        if err:
            raise AssertionError(f"verify_tail {len(got[0])} lanes: X/Z "
                                 f"differ from plain, max {err}")
        return err, got, want

    def hold(name: str, got, want) -> int:
        """A kernel's outputs against its plain version's, output by
        output: field planes ((10, n) int64) as canonical limbs, all else
        (bits, windows, scalar limbs) as they are.  Returns the max
        error, which must be 0."""
        err = 0
        for i, (k, q) in enumerate(zip(got, want)):
            if k.shape != q.shape:
                raise AssertionError(f"{name}: output {i} shape "
                                     f"{tuple(k.shape)} != {tuple(q.shape)}")
            if k.dtype == torch.int64 and k.shape[0] == fe.NLIMB:
                k, q = fe.canonical(k), fe.canonical(q)
            if k.numel():
                err = max(err, int((k.long() - q.long()).abs().max()))
        if err:
            raise AssertionError(f"{name} {got[0].shape[-1]} lanes: differs "
                                 f"from plain, max {err}")
        return err

    # ---- phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(sorted(logs))}")
    for name, log in sorted(logs.items()):
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line:
                print(f"  {name}.cu {entry} ptxas: "
                      f"{line.split(':', 1)[1].strip()}")

    # ---- phase 2: SHA-512 kernel vs plain vs hashlib, ragged 0..1232
    rng = np.random.default_rng(2024)
    n, ml = SHA_LANES, SHA_MAXLEN
    edge = [0, 1, 46, 47, 48, 49, 111, 112, 174, 175, 176, 177, 1232]
    lens = rng.integers(0, ml + 1, n).astype(np.int32)
    lens[:len(edge)] = edge
    msgs = rng.integers(0, 256, (n, ml), np.uint8)
    sigs = rng.integers(0, 256, (n, 64), np.uint8)
    pubs = rng.integers(0, 256, (n, 32), np.uint8)
    blob = torch.from_numpy(V.pack_blob(msgs, lens, sigs, pubs)).to(dev)
    got = sha(blob, ml).cpu().numpy()
    plain = sk.sha512_ram_plain(*[c for i, c in enumerate(cols(blob, ml))
                                  if i != 2]).cpu().numpy()
    want = np.array([list(hashlib.sha512(
        bytes(sigs[i, :32]) + bytes(pubs[i]) + bytes(msgs[i, :lens[i]])
    ).digest()) for i in range(n)], np.uint8)
    if not (np.array_equal(got, want) and np.array_equal(plain, want)):
        bad = np.flatnonzero((got != want).any(1) | (plain != want).any(1))
        raise AssertionError(f"sha512: {len(bad)} lanes differ, "
                             f"first lens {lens[bad[:8]].tolist()}")
    sha_err = int(np.abs(got.astype(np.int64) - plain).max())
    print(f"sha512: kernel == plain == hashlib on {n} lanes, lengths "
          f"0..{ml} incl. {edge}")
    # the kernel's warps of 32 lanes: 1, 31, 33 and 4097 lanes (a partial
    # warp alone, a partial last warp) on these rows, and on a packed blob
    # of ml 127, whose rows (227 bytes apart) it stages by byte loads
    odd_np = V.pack_blob(msgs[:, :127], lens.clip(0, 127), sigs, pubs)
    for rows_np, rml in ((V.pack_blob(msgs, lens, sigs, pubs), ml),
                         (odd_np, 127)):
        rows = torch.from_numpy(np.concatenate([rows_np, rows_np[:1]])).to(dev)
        for k in (1, 31, 33, 4097):
            sha_err = max(sha_err, hold_sha(rows[:k], rml))
    print(f"sha512: kernel == plain at 1, 31, 33 and 4097 lanes of ml {ml} "
          f"and of ml 127 (rows 227 bytes apart, byte-load staging)")

    # ---- phase 3: verify tail kernel vs plain on adversarial lanes
    msgs, lens, sigs, pubs, kinds = V.make_adversarial_batch(TAIL_LANES, 128)
    ablob = torch.from_numpy(V.pack_blob(msgs, lens, sigs, pubs)).to(dev)
    tail_err, (_, x_k, z_k), (_, x_p, z_p) = hold_tail(
        tail_args(ablob, 128))
    xs_k, zs_k = fe.to_ints(x_k), fe.to_ints(z_k)
    xs_p, zs_p = fe.to_ints(x_p), fe.to_ints(z_p)
    aff = [(x * pow(z, fe.P - 2, fe.P) % fe.P, u * pow(w, fe.P - 2, fe.P)
            % fe.P) for x, z, u, w in zip(xs_k, zs_k, xs_p, zs_p) if z]
    if any(a != b for a, b in aff):
        raise AssertionError("verify_tail: affine x differs from plain")
    host = ed.host_verify_blob(V.pack_blob(msgs, lens, sigs, pubs))
    for tail in ed.TAILS:
        bits = ed.verify_blob(ablob, tail=tail).cpu().tolist()
        if bits != host or [k for k, b in zip(kinds, bits) if b] != [
                "valid"] * kinds.count("valid"):
            raise AssertionError(f"verify_blob tail={tail} disagrees with "
                                 f"the host verifier on the adversarial lanes")
    print(f"verify_tail: kernel == plain on {len(kinds)} lanes "
          f"({', '.join(V.ADVERSARIAL_KINDS)}): ok bits, canonical X and Z, "
          f"affine x; verify_blob == host verifier in the "
          f"{', '.join(ed.TAILS)} layouts")

    # ---- phase 4: the real conformance corpora through dispatch_blob
    vecs = []
    for name in ("wycheproof", "cctv", "malleability"):
        with open(ROOT / "tests" / "golden" / f"{name}_ed25519.json") as f:
            vecs += json.load(f)
    cml = 1232
    cmsgs = np.zeros((len(vecs), cml), np.uint8)
    clens = np.zeros(len(vecs), np.int32)
    csigs = np.zeros((len(vecs), 64), np.uint8)
    cpubs = np.zeros((len(vecs), 32), np.uint8)
    for i, v in enumerate(vecs):
        m = bytes.fromhex(v["msg"])
        cmsgs[i, :len(m)] = np.frombuffer(m, np.uint8)
        clens[i] = len(m)
        csigs[i] = np.frombuffer(bytes.fromhex(v["sig"]), np.uint8)
        cpubs[i] = np.frombuffer(bytes.fromhex(v["pub"]), np.uint8)
    golden = np.array([v["ok"] for v in vecs])
    for tail in ed.TAILS:
        cver = V.SigVerifier(V.VerifierConfig(len(vecs), cml),
                             strict_tail=tail)
        cbits = np.asarray(cver.dispatch_blob(
            V.pack_blob(cmsgs, clens, csigs, cpubs)))
        if not np.array_equal(cbits, golden):
            raise AssertionError(f"corpus, tail={tail}: "
                                 f"{int((cbits != golden).sum())} of "
                                 f"{len(vecs)} vectors differ from golden")
    print(f"corpus: {len(vecs)} wycheproof/cctv/malleability vectors == "
          f"golden ({int(golden.sum())} accept) in the "
          f"{', '.join(ed.TAILS)} layouts")

    # ---- phase 5: the main path, SigVerifier.dispatch_blob
    buckets, clean = [], {}
    for batch, bml, ragged in BUCKETS:
        r = np.random.default_rng(batch + bml)
        blens = r.integers(0, bml + 1, batch) if ragged else None
        bm, bl, bs, bp = V.make_example_batch(batch, bml, True, batch + bml,
                                              sign_pool=256, lens=blens)
        clean[(batch, bml)] = (bm, bl, bs.copy(), bp)
        bad = r.choice(batch, batch // 4, replace=False)
        bs[bad, 32 + r.integers(0, 31, len(bad))] ^= 1   # corrupt S
        expect = np.ones(batch, bool)
        expect[bad] = False
        buckets.append((batch, bml, V.pack_blob(bm, bl, bs, bp), expect,
                        int(((bl.astype(np.int64) + 64 + 17 + 127)
                             // 128).sum()), int(bl.sum())))
    verifiers = {(b, m): V.SigVerifier(V.VerifierConfig(b, m))
                 for b, m, *_ in buckets}
    counted = {"sha512_ram": sk.sha512_ram, "verify_tail": vt.verify_tail,
               "decompress": dc.decompress,
               "reduce_recode": rr.reduce_recode,
               "dsm_tail_q": dsm.dsm_tail_q,
               "double_scalar_mul_base": dsm.double_scalar_mul_base,
               "rlc_recode": rl.rlc_recode}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0
        for sel in ms.SELECTS:
            ms.msm_lanes.launches[sel] = 0

    def counts() -> dict:
        return {**{k: fn.launches for k, fn in counted.items()},
                **{f"msm_{sel}": ms.msm_lanes.launches[sel]
                   for sel in ms.SELECTS}}

    reset_counts()
    verdicts = [verifiers[(b, m)].dispatch_blob(blob_np)
                for b, m, blob_np, *_ in buckets]
    results = [np.asarray(v) for v in verdicts]
    launches = counts()
    for (batch, bml, _, expect, *_), res in zip(buckets, results):
        if res.shape != (batch,) or not np.array_equal(res, expect):
            raise AssertionError(f"dispatch_blob {batch}x{bml}: "
                                 f"{int((res != expect).sum())} bits wrong")
        print(f"dispatch_blob {batch}x{bml}: {int(res.sum())} accept, "
              f"{batch - int(res.sum())} reject, as constructed")
    if min(launches["sha512_ram"], launches["verify_tail"]) < 1:
        raise AssertionError(f"a kernel did not carry the path: {launches}")
    print(f"launches on the strict path: {launches}")
    # each kernel against its plain version at every shape the path gave it
    for batch, bml, blob_np, *_ in buckets:
        blob = torch.from_numpy(blob_np).to(dev)
        sha_err = max(sha_err, hold_sha(blob, bml))
        tail_err = max(tail_err, hold_tail(tail_args(blob, bml))[0])
        print(f"{batch}x{bml}: sha512 and verify_tail kernels == plain "
              f"(digests; ok bits, canonical X and Z)")

    # ---- phase 5b: the main path in the split and unfused layouts,
    # SigVerifier(strict_tail=...).dispatch_blob at every bucket: bits
    # equal the fused layout's, as constructed, and the host verifier's
    # on every row (each distinct row verified once, over the host's
    # cores)
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        host_bits = []
        for _, _, blob_np, *_ in buckets:
            uniq, inv = np.unique(blob_np, axis=0, return_inverse=True)
            parts = pool.map(ed.host_verify_blob, np.array_split(uniq, 64))
            host_bits.append(np.concatenate(
                [np.asarray(b, bool) for b in parts])[inv.reshape(-1)])
    for (batch, bml, _, expect, *_), host, fused in zip(buckets, host_bits,
                                                         results):
        if not (np.array_equal(host, expect) and np.array_equal(host, fused)):
            raise AssertionError(f"{batch}x{bml}: the host verifier's bits "
                                 f"differ from the fused layout's")
    print(f"host verifier: every row of the buckets == fused == as "
          f"constructed ({time.perf_counter() - t0:.1f} s)")
    layout_launches, layout_vers = {}, {}
    want_kernels = {"split": ("sha512_ram", "decompress", "reduce_recode",
                              "dsm_tail_q"),
                    "unfused": ("sha512_ram", "decompress",
                                "double_scalar_mul_base")}
    for tail, kerns in want_kernels.items():
        vers = {(b, m): V.SigVerifier(V.VerifierConfig(b, m),
                                      strict_tail=tail)
                for b, m, *_ in buckets}
        layout_vers[tail] = vers
        reset_counts()
        res_t = [np.asarray(vers[(b, m)].dispatch_blob(blob_np))
                 for b, m, blob_np, *_ in buckets]
        got = counts()
        layout_launches[tail] = got
        want = {k: len(buckets) if k in kerns else 0 for k in got}
        if got != want:
            raise AssertionError(f"tail={tail}: launches {got}, expected "
                                 f"{want}")
        for (batch, bml, *_), res, fused in zip(buckets, res_t, results):
            if not np.array_equal(res, fused):
                raise AssertionError(f"tail={tail} {batch}x{bml}: "
                                     f"{int((res != fused).sum())} bits "
                                     f"differ from the fused layout and the "
                                     f"host verifier")
        print(f"dispatch_blob tail={tail}: bits == fused == host verifier "
              f"at {', '.join(f'{b}x{m}' for b, m, *_ in buckets)}; "
              f"launches {got}")

    # each new kernel against its plain version at every bucket and at
    # one lane: the buckets' rows with the adversarial lanes of
    # phase 3 written over the first 528, S = L - 1, L and 2^256 - 1 in the
    # next three, z = 0 and 2^128 - 1 in the first two; A decompressed
    # from the keys and scaled by a random lambda (Z != 1)
    L = sc.L
    adv_np = {ml: V.pack_blob(np.pad(msgs, ((0, 0), (0, ml - 128))), lens,
                              sigs, pubs) for ml in {b[1] for b in buckets}}

    def hold_rows(blob_np, ml, n):
        rows = blob_np[:n].copy()
        k = min(n, len(adv_np[ml]))
        rows[:k] = adv_np[ml][:k]
        for i, v in enumerate((L - 1, L, 2**256 - 1)):
            if k + i < n:
                rows[k + i, ml + 32:ml + 64] = np.frombuffer(
                    v.to_bytes(32, "little"), np.uint8)
        return torch.from_numpy(rows).to(dev)

    # the scalar kernels' edge rows, written from row edges_at on (as many
    # as fit): S whose nibbles are all 8 (no carry) and 9, 8, 8, ... (a
    # carry through all 64 windows); digests 0, m L and m L + L - 1 for m
    # near 2^259, L - 1 and 2^512 - 1 (k = 0, 0, L - 1, L - 1 and (2^512 -
    # 1) mod L)
    s_edges = [bytes([0x88] * 32), bytes([0x89] + [0x88] * 31)]
    m_l = 2**259 + 12345
    d_edges = [v.to_bytes(64, "little")
               for v in (0, m_l * L, m_l * L + L - 1, L - 1, 2**512 - 1)]

    def hold_inputs(blob_np, ml, n, seed, edges_at=len(adv_np[128]) + 3):
        blob = hold_rows(blob_np, ml, n)
        for i, v in enumerate(s_edges[:max(0, n - edges_at)]):
            blob[edges_at + i, ml + 32:ml + 64] = torch.tensor(
                list(v), dtype=torch.uint8)
        m_, r_, s_, a_, ln_ = cols(blob, ml)
        rng = np.random.default_rng(seed)
        z = rng.integers(0, 256, (n, 16), np.uint8)
        z[0] = 0
        z[1:2] = 0xFF
        z_d = torch.from_numpy(z).to(dev)
        _, a_pt = ed._decompress_checked(a_)
        lam = fe.from_ints([int.from_bytes(rng.bytes(32), "little") % fe.P
                            for _ in range(n)], dev)
        a_pt = cv.Point(*(fe.mul(c, lam) for c in a_pt))
        digest = sk.sha512_ram(m_, r_, a_, ln_)
        for i, v in enumerate(d_edges[:max(0, n - edges_at)]):
            digest[edges_at + i] = torch.tensor(list(v), dtype=torch.uint8)
        y_r = ed._parse_r_bytes(r_)[0]
        return s_, digest, z_d, a_pt, y_r

    new_err = dict.fromkeys(("reduce_recode", "dsm_tail_q",
                             "double_scalar_mul_base", "rlc_recode"), 0)
    hold_shapes = [(4096, 128, 4096), (32768, 128, 32768), (4096, 1232, 4096),
                   (4096, 128, 1)]
    for batch, bml, n in hold_shapes:
        blob_np = next(b[2] for b in buckets if b[:2] == (batch, bml))
        s_, digest, z_d, a_pt, y_r = hold_inputs(blob_np, bml, n, n)
        ok_s, wins = rr.reduce_recode(s_, digest)
        new_err["reduce_recode"] = max(new_err["reduce_recode"], hold(
            "reduce_recode", (ok_s, *wins),
            (lambda o: (o[0], *o[1]))(rr.reduce_recode_plain(s_, digest))))
        new_err["dsm_tail_q"] = max(new_err["dsm_tail_q"], hold(
            "dsm_tail_q", dsm.dsm_tail_q(wins, a_pt, y_r),
            dsm.dsm_tail_q_plain(wins, a_pt, y_r)))
        s_win = sc.scalar_windows(s_)
        k_win = sc.limbs_to_windows(sc.reduce_512(digest))
        new_err["double_scalar_mul_base"] = max(
            new_err["double_scalar_mul_base"], hold(
                "double_scalar_mul_base",
                dsm.double_scalar_mul_base(s_win, k_win, a_pt),
                dsm.double_scalar_mul_base_plain(s_win, k_win, a_pt)))
        new_err["rlc_recode"] = max(new_err["rlc_recode"], hold(
            "rlc_recode", rl.rlc_recode(s_, digest, z_d),
            rl.rlc_recode_plain(s_, digest, z_d)))
        print(f"{n} lanes of {batch}x{bml}: reduce_recode, dsm_tail_q, "
              f"double_scalar_mul_base and rlc_recode kernels == plain "
              f"(bits, windows, canonical X, Y, Z, T, z s limbs), max "
              f"error {max(new_err.values())}")
    # the two scalar kernels (blocks of 32 lanes a role) at lane counts
    # around a block, on the edge rows first
    scalar_counts = (1, 31, 4095, 4097)
    blob_np = next(b[2] for b in buckets if b[:2] == (32768, 128))
    for n in scalar_counts:
        s_, digest, z_d, _, _ = hold_inputs(blob_np, 128, n, n, edges_at=0)
        ok_s, wins = rr.reduce_recode(s_, digest)
        got_rl = rl.rlc_recode(s_, digest, z_d)
        if not ok_s.dtype == got_rl[0].dtype == torch.bool:
            raise AssertionError("reduce_recode, rlc_recode: ok_s is not "
                                 "the bool tensor the kernel writes")
        new_err["reduce_recode"] = max(new_err["reduce_recode"], hold(
            "reduce_recode", (ok_s, *wins),
            (lambda o: (o[0], *o[1]))(rr.reduce_recode_plain(s_, digest))))
        new_err["rlc_recode"] = max(new_err["rlc_recode"], hold(
            "rlc_recode", got_rl, rl.rlc_recode_plain(s_, digest, z_d)))
    print(f"reduce_recode and rlc_recode kernels == plain at "
          f"{', '.join(map(str, scalar_counts))} lanes (edge rows: S of "
          f"nibbles 8 and 9, 8, ...; digests = 0, m L, m L + L - 1, L - 1, "
          f"2^512 - 1 mod L), max error "
          f"{max(new_err['reduce_recode'], new_err['rlc_recode'])}")

    # the three four-rank chain kernels (blocks of 8 lanes) at lane counts
    # that leave a partial block alone (1, 7), a whole one (8) and a
    # partial last block (4095, 4097), on the rows above;
    # double_scalar_mul_base also on windows whose recode carries out of
    # the top window (every other lane's s, the rest's k)
    blob_np = next(b[2] for b in buckets if b[:2] == (32768, 128))
    chain_counts = (1, 7, 8, 4095, 4097)
    chain_err = 0
    for n in chain_counts:
        tail_err = max(tail_err, hold_tail(tail_args(
            hold_rows(blob_np, 128, n), 128))[0])
        s_, digest, _, a_pt, y_r = hold_inputs(blob_np, 128, n, n)
        _, wins = rr.reduce_recode(s_, digest)
        new_err["dsm_tail_q"] = max(new_err["dsm_tail_q"], hold(
            "dsm_tail_q", dsm.dsm_tail_q(wins, a_pt, y_r),
            dsm.dsm_tail_q_plain(wins, a_pt, y_r)))
        s_win = sc.scalar_windows(s_).clone()
        k_win = sc.limbs_to_windows(sc.reduce_512(digest)).clone()
        s_win[63, ::2] = 15
        k_win[63, 1::2] = 15
        new_err["double_scalar_mul_base"] = max(
            new_err["double_scalar_mul_base"], hold(
                "double_scalar_mul_base",
                dsm.double_scalar_mul_base(s_win, k_win, a_pt),
                dsm.double_scalar_mul_base_plain(s_win, k_win, a_pt)))
        chain_err = max(chain_err, tail_err, new_err["dsm_tail_q"],
                        new_err["double_scalar_mul_base"])
    print(f"verify_tail, dsm_tail_q and double_scalar_mul_base kernels == "
          f"plain at {', '.join(map(str, chain_counts))} lanes (ok bits, "
          f"canonical X, Y, Z, T; top windows that carry out), max error "
          f"{chain_err}")

    # ---- phase 6: decompress kernel vs plain, one view a launch and the
    # RLC pair (A and R in one launch), on adversarial encodings and on
    # the A and R columns of the RLC buckets, at lane counts that leave a
    # partial block (16 lanes of two threads) alone (1, 7, 8) or last
    # (4095, 4097)
    def same_dec(name, got, want) -> int:
        (ok_k, sm_k, p_k), (ok_p, sm_p, p_p) = got, want
        if not (ok_k.dtype == sm_k.dtype == torch.bool
                and torch.equal(ok_k, ok_p) and torch.equal(sm_k, sm_p)):
            raise AssertionError(f"{name}: ok or small bits differ from "
                                 f"plain")
        err = max(int((fe.canonical(k) - fe.canonical(q)).abs().max())
                  for k, q in zip(p_k, p_p))
        if err:
            raise AssertionError(f"{name}: X/Y/Z/T differ from plain, max "
                                 f"{err}")
        return err

    def hold_dec(b) -> int:
        return same_dec(f"decompress {len(b)} lanes", dc.decompress(b),
                        dc.decompress_plain(b))

    def hold_pair(a, r) -> int:
        before = dc.decompress.launches
        got = dc.decompress_pair(a, r)
        if dc.decompress.launches != before + 1:
            raise AssertionError("decompress_pair: not one launch")
        return max(same_dec(f"decompress_pair {len(a)} lanes, {w}", g,
                            dc.decompress_plain(b))
                   for w, g, b in zip("AR", got, (a, r)))

    adv = torch.from_numpy(np.concatenate([pubs, sigs[:, :32]])).to(dev)
    dec_err = max(hold_dec(adv[:-1]), hold_pair(adv[:len(pubs)],
                                                adv[len(pubs):]))
    rlc_dev = {}
    for batch, bml in RLC_BUCKETS:
        args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in clean[(batch, bml)])
        rlc_dev[(batch, bml)] = args
    dec_counts = (1, 7, 8, 4095, 4096, 4097, 32768)
    for k in dec_counts:
        args = rlc_dev[(4096 if k == 4096 else 32768, 128)]
        a_col, r_col = args[3][:k], args[2][:k, :32]
        dec_err = max(dec_err, hold_dec(a_col), hold_dec(r_col),
                      hold_pair(a_col, r_col))
    print(f"decompress: kernel == plain, one view a launch and the A, R "
          f"pair in one launch, on {len(adv) - 1} adversarial encodings "
          f"(the pair on {len(pubs)} keys and R values) and the A and R "
          f"columns of the RLC buckets at {', '.join(map(str, dec_counts))} "
          f"lanes: ok and small bits (bool), canonical X, Y, Z, T, max "
          f"error {dec_err}")

    # ---- phase 7: msm kernel vs plain per lane, both selects, on the
    # RLC path's own inputs at 32768 x 128
    def msm_inputs(args, seed):
        """((w windows, -A, 64), (z windows, -R, 32)), the windows of c,
        and the scalar chain's inputs, as verify_batch_rlc makes them."""
        msgs, lens, sigs_d, pubs_d = args
        z = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, (len(pubs_d), 16), np.uint8)).to(dev)
        r_b = sigs_d[:, :32]
        _, a_pt = ed._decompress_checked(pubs_d)
        _, r_pt = ed._decompress_checked(r_b)
        digest = sk.sha512_ram(msgs, r_b, pubs_d, sk.lens_to_bytes(lens))
        _, w_win, z_win, c_win = ed._rlc_scalars(digest, sigs_d[:, 32:], z)
        return (((w_win, cv.neg(a_pt), 64), (z_win, cv.neg(r_pt), 32)),
                c_win, (digest, sigs_d[:, 32:], z))

    def hold_msm(win, pts, nwin, select, m=MSM_M):
        """Kernel vs plain per lane: canonical X, Y, Z, T equal.  Returns
        (max error, kernel lanes)."""
        got = ms.msm_lanes(win, pts, m, nwin, select)
        want = cv.msm_lanes(win, pts, m, nwin, select)
        err = max(int((fe.canonical(k) - fe.canonical(q)).abs().max())
                  for k, q in zip(got, want))
        if err:
            raise AssertionError(f"msm {select} m {m} nwin {nwin}: "
                                 f"{win.shape[1]} points, lanes differ from "
                                 f"plain, max {err}")
        return err, got

    msm_err = 0
    for batch, bml in RLC_BUCKETS:
        msm_in, c_win, _ = msm_inputs(rlc_dev[(batch, bml)], 7 + batch)
        folded = {sel: [] for sel in ms.SELECTS}
        for sel in ms.SELECTS:
            for win, pts, nwin in msm_in:
                # every point, m fewer (a lane count that leaves a partial
                # block) and one lane (the per-vector batches of phase 10)
                for k in (batch, batch - MSM_M, MSM_M):
                    err, got = hold_msm(win[:, :k], cv.Point(*(
                        t[:, :k] for t in pts)), nwin, sel)
                    msm_err = max(msm_err, err)
                    if k == batch:
                        folded[sel].append(cv.fold_lanes(got))
        for a, b in zip(*folded.values()):
            same = fe.eq(fe.mul(a.X, b.Z), fe.mul(b.X, a.Z)) & fe.eq(
                fe.mul(a.Y, b.Z), fe.mul(b.Y, a.Z))
            if not bool(same.all()):
                raise AssertionError(f"msm {batch}: the selects' folded sums "
                                     f"differ")
        for sel in ms.SELECTS:
            if not bool(ed._rlc_finish(*folded[sel], c_win)):
                raise AssertionError(f"msm {sel} {batch}: the clean batch's "
                                     f"RLC equation does not hold")
        print(f"msm: kernel == plain per lane at {batch}x{bml} (m {MSM_M}, "
              f"nwin 64 and 32; {batch // MSM_M}, {batch // MSM_M - 1} and 1 "
              f"lanes), both selects: canonical X, Y, Z, T, max error "
              f"{msm_err}; legacy and p16 fold to the same points; [c]B - "
              f"sum = identity")
    # a lane tree with an odd partial, and a partial last block: m 3 on
    # the first 4,095 points of the 32768 bucket (1,365 lanes)
    win, pts, nwin = msm_in[0]
    for sel in ms.SELECTS:
        msm_err = max(msm_err, hold_msm(win[:, :4095], cv.Point(*(
            t[:, :4095] for t in pts)), nwin, sel, m=3)[0])
    print(f"msm: kernel == plain per lane at m 3 on 4095 points (1365 "
          f"lanes, nwin {nwin}), both selects: canonical X, Y, Z, T, max "
          f"error {msm_err}")
    # m 2, 5, 6 and 7 (0, 2, 2 and 4 threads of a warp without a point):
    # 1001 lanes leave a partial last block at each
    for m in (2, 5, 6, 7):
        k = 1001 * m
        for sel in ms.SELECTS:
            msm_err = max(msm_err, hold_msm(win[:, :k], cv.Point(*(
                t[:, :k] for t in pts)), nwin, sel, m=m)[0])
    print(f"msm: kernel == plain per lane at m 2, 5, 6 and 7 on 1001 lanes "
          f"each (nwin {nwin}), both selects: canonical X, Y, Z, T, max "
          f"error {msm_err}")

    # ---- phase 8: the RLC path, SigVerifier(mode="rlc").__call__, clean
    # buckets with both selects; per call 1 decompress (A and R), 2 msm,
    # 1 sha512, 1 rlc_recode
    rlc_runs = [(4096, 128, "legacy"), (32768, 128, "legacy"),
                (32768, 128, "p16")]
    rlc_vers = {(b, m, sel): V.SigVerifier(V.VerifierConfig(b, m),
                                           mode="rlc", msm_m=MSM_M,
                                           rlc_select=sel)
                for b, m, sel in rlc_runs}
    reset_counts()
    for batch, bml, sel in rlc_runs:
        before = counts()
        res = np.asarray(rlc_vers[(batch, bml, sel)](*clean[(batch, bml)]))
        delta = {k: v - before[k] for k, v in counts().items()}
        want = {**dict.fromkeys(counted, 0), "sha512_ram": 1,
                "decompress": 1, "rlc_recode": 1,
                **{f"msm_{s}": 2 * (s == sel) for s in ms.SELECTS}}
        if delta != want:
            raise AssertionError(f"rlc {batch}x{bml} {sel}: launches "
                                 f"{delta}, expected {want}")
        if res.shape != (batch,) or not res.all():
            raise AssertionError(f"rlc {batch}x{bml} {sel}: "
                                 f"{int((~res).sum())} lanes rejected")
        print(f"rlc {batch}x{bml} {sel}: all {batch} accept; launches "
              f"{delta}")
    rlc_launches = counts()
    print(f"launches on the RLC path: {rlc_launches}")

    # ---- phase 9: one forged S in 32768: the descent's bits
    bm, bl, bs, bp = clean[(32768, 128)]
    bs = bs.copy()
    bs[20000, 40] ^= 1
    expect = np.ones(32768, bool)
    expect[20000] = False
    t0 = time.perf_counter()
    res = np.asarray(rlc_vers[(32768, 128, "legacy")](bm, bl, bs, bp))
    t_descent = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(res, expect):
        raise AssertionError(f"rlc dirty 32768: {int((res != expect).sum())} "
                             f"bits wrong")
    note(f"rlc dirty 32768x128 (one forged S): bits as constructed through "
         f"the descent, {t_descent:.4f} ms")

    # ---- phase 10: the corpora in rlc mode.  (a) SigVerifier over the
    # corpora padded to a multiple of m: the batch fails, and the descent's
    # strict bits must be golden's.
    npad = -len(vecs) % MSM_M
    gver = V.SigVerifier(V.VerifierConfig(len(vecs) + npad, cml),
                         mode="rlc", msm_m=MSM_M)

    def padded(a):
        return np.concatenate([a, np.zeros((npad,) + a.shape[1:], a.dtype)])

    garrs = tuple(map(padded, (cmsgs, clens, csigs, cpubs)))
    gbits = np.asarray(gver(*garrs))
    if not (np.array_equal(gbits[:len(vecs)], golden)
            and not gbits[len(vecs):].any()):
        raise AssertionError("rlc corpus: bits differ from golden")
    print(f"rlc corpus: {len(vecs)} vectors == golden through the descent, "
          f"{npad} zero pads reject")
    # (b) the batch check's prechecks, lane by lane, against the host's
    zrng = np.random.default_rng(10)
    gz = torch.from_numpy(zrng.integers(0, 256, (len(vecs) + npad, 16),
                                        np.uint8)).to(dev)
    g_ok, g_pre = ed.verify_batch_rlc(
        *(torch.from_numpy(a).to(dev) for a in garrs), gz, m=MSM_M)
    rows = [(bytes(csigs[i]), bytes(cmsgs[i, :clens[i]]), bytes(cpubs[i]))
            for i in range(len(vecs))]
    decoded = [ed.prechecks_host(sg, pb) for sg, _, pb in rows]
    want_pre = [d is not None for d in decoded] + [False] * npad
    if bool(g_ok) or g_pre.cpu().tolist() != want_pre:
        raise AssertionError("rlc corpus: prechecks differ from the host's")
    # (c) each vector that passes them alone among m - 1 valid signatures:
    # the batch bit against the exact batch equation on Python ints, for
    # one draw of z, and where A or R has a part of small order (which
    # the cofactorless equation does not see for 1 in ord draws) a second
    # draw with z = 0 mod 8
    pm, pl, ps, pp = V.make_example_batch(MSM_M - 1, cml, True, 11)
    pads = [(bytes(s_), bytes(m_[:n_]), bytes(p_))
            for m_, n_, s_, p_ in zip(pm, pl, ps, pp)]
    pads_d = [torch.from_numpy(a).to(dev) for a in (pm, pl, ps, pp)]
    alone = {"calls": 0, "vectors": 0, "torsion": 0,
             "accept_strict_rejects": 0, "reject_strict_accepts": 0}
    t0 = time.perf_counter()
    for i, dec in enumerate(decoded):
        if dec is None:
            continue
        _, a_pt, r_pt = dec
        torsion = ed.has_torsion_host(a_pt) or ed.has_torsion_host(r_pt)
        alone["vectors"] += 1
        alone["torsion"] += torsion
        row_d = [torch.from_numpy(a[i:i + 1]).to(dev)
                 for a in (cmsgs, clens, csigs, cpubs)]
        args = tuple(torch.cat([r, q]) for r, q in zip(row_d, pads_d))
        zs = [int.from_bytes(zrng.bytes(16), "little") for _ in range(MSM_M)]
        for zv in ([zs[0], zs[0] & ~7] if torsion else [zs[0]]):
            zs[0] = zv
            zb = torch.from_numpy(np.array(
                [list(v.to_bytes(16, "little")) for v in zs], np.uint8))
            bit = bool(ed.verify_batch_rlc(*args, zb.to(dev), m=MSM_M)[0])
            host = ed.rlc_batch_host(*zip(*([rows[i]] + pads)), zs)
            alone["calls"] += 1
            if bit != host or (not torsion and bit != golden[i]):
                raise AssertionError(
                    f"rlc vector {i} alone, z mod 8 = {zv % 8}: bit {bit}, "
                    f"exact equation {host}, golden {golden[i]}")
            alone["accept_strict_rejects"] += bit and not golden[i]
            alone["reject_strict_accepts"] += golden[i] and not bit
    print(f"rlc corpus: prechecks == host on {len(want_pre)} lanes; each of "
          f"the {alone['vectors']} vectors that pass them alone among "
          f"{MSM_M - 1} valid signatures: batch bit == the exact equation "
          f"on Python ints in {alone['calls']} calls "
          f"({time.perf_counter() - t0:.1f} s), == golden where A and R have "
          f"no small-order part; where one has ({alone['torsion']} "
          f"vectors), the batch bit accepted a vector strict rejects "
          f"{alone['accept_strict_rejects']} times and rejected one strict "
          f"accepts {alone['reject_strict_accepts']} times")

    # ---- what the profiler sees of one dispatch and of the torch finish
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        """(runtime launch calls, device kernels, device busy ms, wall
        ms) of one call under torch.profiler."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = prof.events()
        calls = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
                    for e in ev)
        kern = [e for e in ev if str(e.device_type).endswith("CUDA")]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        return calls, len(kern), busy, wall

    # ---- phase 11: timings (CUDA events; median of RUNS after warmup)
    def bound(nbytes: float, nops: float):
        """(least ms, what bounds it): bytes over HBM, ops over int32."""
        tb, to = nbytes / HBM_BYTES_PER_S, nops / int_ops_per_s
        return max(tb, to) * 1e3, "bytes" if tb > to else "operations"

    def sha_bound(batch, nblocks, msg_bytes):
        # reads M, R, A and the length once, writes the digest once
        return bound(msg_bytes + (68 + 64) * batch,
                     nblocks * SHA_OPS_PER_BLOCK)

    def tail_bound(batch):
        # reads A, S, the digest and R, writes ok, X and Z (int64 planes)
        return bound(batch * (32 + 32 + 64 + 32 + 1 + 160),
                     batch * (TAIL_MUL * MUL_OPS + TAIL_SQR * SQR_OPS))

    def chain4_ops(n, decompress: bool, close=(G4_YCMP_MUL, G4_YCMP_SHFL)):
        """32-bit operations of the four-rank chain's own design for n
        lanes (its products and shuffles; the bound counts the one-thread
        chain's products); close: the step after the chain, the
        y-compare or the identity add, as (products, shuffled words)."""
        sqr = 64 * G4_WIN_SQR + DEC_SQR * decompress
        mul = G4_TAB_MUL + 64 * G4_WIN_MUL + close[0] + DEC_MUL * decompress
        return 4 * n * (sqr * SQR_OPS + mul * MUL_OPS + G4_TAB_SHFL
                        + 64 * G4_WIN_SHFL + close[1])

    def design_note(own, t_k, b_):
        return (f"the kernel's own design does {own} 32-bit operations, "
                f"{own / (b_[0] * 1e-3 * int_ops_per_s):.4f}x the bound's, "
                f"{own / (t_k * 1e-3 * int_ops_per_s):.4f} of the card's "
                f"int32 rate")

    timing = {}
    for batch, bml, blob_np, _, nblocks, msg_bytes in buckets:
        blob = torch.from_numpy(blob_np).to(dev)
        t_sha = cuda_ms(lambda: sha(blob, bml))
        d_sha = dev_ms(lambda: sha(blob, bml), "sha512_ram_kernel")
        args = tail_args(blob, bml)
        t_tail = cuda_ms(lambda: vt.verify_tail(*args))
        d_tail = dev_ms(lambda: vt.verify_tail(*args), "verify_tail_kernel")
        # a warp runs to its longest lane: its 32 lanes' most blocks over
        # their blocks, summed over the warps
        nb = (clean[(batch, bml)][1].astype(np.int64) + 64 + 17 + 127) // 128
        nb_w = np.pad(nb, (0, -len(nb) % 32)).reshape(-1, 32)
        ragged = nb_w.max(1).sum() * 32 / nb.sum()
        ok_t, qx, qz = vt.verify_tail(*args)
        r_bytes = args[3]
        t_r = cuda_ms(lambda: ed._compressed_r_check(qx, qz, r_bytes, ok_t))
        ver = verifiers[(batch, bml)]
        t_e2e = wall_ms(lambda: np.asarray(ver.dispatch_blob(blob_np)))
        sb, tb = sha_bound(batch, nblocks, msg_bytes), tail_bound(batch)
        timing[(batch, bml)] = (t_sha, t_tail, sb, tb, d_sha, d_tail)
        note(f"{batch}x{bml}: sha512 kernel call {t_sha:.5f} ms, device "
             f"{d_sha:.5f} ms (bound {sb[0]:.5f} ms, {sb[1]}; a warp's most "
             f"blocks over its blocks {ragged:.4f}), verify_tail kernel call "
             f"{t_tail:.5f} ms, device {d_tail:.5f} ms (bound {tb[0]:.5f} "
             f"ms, {tb[1]}), _compressed_r_check "
             f"{t_r:.5f} ms, dispatch_blob end to end {t_e2e:.4f} ms = "
             f"{batch / t_e2e * 1e3:.1f} verifies/s; verify_tail: "
             f"{design_note(chain4_ops(batch, True), d_tail, tb)}")
        for what, fn in (
                ("_compressed_r_check",
                 lambda: ed._compressed_r_check(qx, qz, r_bytes, ok_t)),
                ("dispatch_blob",
                 lambda: np.asarray(ver.dispatch_blob(blob_np)))):
            calls, nk, busy, wall = profiled(fn)
            note(f"{batch}x{bml}: {what} under torch.profiler: {calls} "
                 f"kernel launch calls, {nk} device ops busy {busy:.4f} ms "
                 f"of {wall:.4f} ms wall (device idle "
                 f"{max(0.0, 1 - busy / wall):.4f})")
    batch, bml, blob_np = buckets[0][:3]
    blob = torch.from_numpy(blob_np).to(dev)
    m_, r_, _, a_, ln_ = cols(blob, bml)
    plain_sha = cuda_ms(lambda: sk.sha512_ram_plain(m_, r_, a_, ln_),
                        PLAIN_RUNS, 1)
    args = tail_args(blob, bml)
    plain_tail = cuda_ms(lambda: vt.verify_tail_plain(*args), PLAIN_RUNS, 1)
    note(f"{batch}x{bml}: plain sha512 {plain_sha:.4f} ms, plain "
         f"verify_tail {plain_tail:.4f} ms")

    # ---- phase 11b: the split and unfused layouts' kernels at the two
    # 128-byte buckets on the path's own inputs (plain versions at 4096
    # only), and their dispatches at 4096 x 128
    def field_bound(n, sqr, mul, nbytes, extra_ops=0):
        return bound(n * nbytes, n * (sqr * SQR_OPS + mul * MUL_OPS
                                      + extra_ops))

    new_bounds = {
        # reads s and the digest, writes ok_s and four uint8 window planes
        "reduce_recode": lambda n: bound(n * (96 + 1 + 4 * 64), n * RR_OPS),
        # reads four window planes, A's four int64 planes and y_R, writes
        # ok_y, X and Z
        "dsm_tail_q": lambda n: field_bound(n, DSM_SQR, DSM_MUL + 1,
                                            4 * 64 + 5 * 80 + 1 + 160),
        # reads two window planes and A, writes X, Y, Z and T
        "double_scalar_mul_base": lambda n: field_bound(
            n, DSM_SQR, DSM_MUL + GE_ADD_NIELS, 2 * 64 + 4 * 80 + 4 * 80),
        # reads s, the digest and z, writes ok_s, the w and z windows and
        # the z s limbs
        "rlc_recode": lambda n: bound(n * (112 + 1 + 64 + 32 + 22 * 8),
                                      n * RLC_OPS)}
    new_ms, new_plain = {}, {}
    for batch, bml, blob_np, *_ in buckets[:2]:
        blob = torch.from_numpy(blob_np).to(dev)
        m_, r_, s_, a_, ln_ = cols(blob, bml)
        digest = sk.sha512_ram(m_, r_, a_, ln_)
        z_d = torch.from_numpy(np.random.default_rng(batch).integers(
            0, 256, (batch, 16), np.uint8)).to(dev)
        _, a_pt = ed._decompress_checked(a_)
        y_r = ed._parse_r_bytes(r_)[0]
        _, wins = rr.reduce_recode(s_, digest)
        neg_a = cv.neg(a_pt)
        s_win = sc.scalar_windows(s_)
        k_win = sc.limbs_to_windows(sc.reduce_512(digest))
        calls = {
            "reduce_recode": (lambda: rr.reduce_recode(s_, digest),
                              lambda: rr.reduce_recode_plain(s_, digest)),
            "dsm_tail_q": (lambda: dsm.dsm_tail_q(wins, a_pt, y_r),
                           lambda: dsm.dsm_tail_q_plain(wins, a_pt, y_r)),
            "double_scalar_mul_base": (
                lambda: dsm.double_scalar_mul_base(s_win, k_win, neg_a),
                lambda: dsm.double_scalar_mul_base_plain(s_win, k_win,
                                                         neg_a)),
            "rlc_recode": (lambda: rl.rlc_recode(s_, digest, z_d),
                           lambda: rl.rlc_recode_plain(s_, digest, z_d))}
        entries = {"reduce_recode": "reduce_recode_kernel",
                   "dsm_tail_q": "dsm_tail_q_kernel",
                   "double_scalar_mul_base": "dsm_base_kernel",
                   "rlc_recode": "rlc_recode_kernel"}
        for name, (kern, plain) in calls.items():
            t_k = cuda_ms(kern)
            d_k = dev_ms(kern, entries[name])
            b_ = new_bounds[name](batch)
            new_ms[(name, batch)] = (t_k, b_, d_k)
            line = (f"{batch}x{bml}: {name} kernel call {t_k:.5f} ms, "
                    f"device {d_k:.5f} ms (bound {b_[0]:.5f} ms, {b_[1]})")
            if name == "dsm_tail_q":
                line += "; " + design_note(chain4_ops(batch, False), d_k, b_)
            elif name == "double_scalar_mul_base":
                line += "; " + design_note(chain4_ops(
                    batch, False, (G4_CLOSE_MUL, G4_CLOSE_SHFL)), d_k, b_)
            if batch == buckets[0][0]:
                new_plain[name] = cuda_ms(plain, PLAIN_RUNS, 1)
                line += f", plain {new_plain[name]:.4f} ms"
            note(line)
    batch, bml, blob_np = buckets[0][:3]
    for tail in ("fused", "split", "unfused"):
        ver = (verifiers if tail == "fused" else layout_vers[tail])[
            (batch, bml)]
        t_e2e = wall_ms(lambda: np.asarray(ver.dispatch_blob(blob_np)))
        calls, nk, busy, wall = profiled(
            lambda: np.asarray(ver.dispatch_blob(blob_np)))
        note(f"{batch}x{bml}: dispatch_blob tail={tail} end to end "
             f"{t_e2e:.4f} ms = {batch / t_e2e * 1e3:.1f} verifies/s; under "
             f"torch.profiler {calls} kernel launch calls, {nk} device ops "
             f"busy {busy:.4f} ms of {wall:.4f} ms wall")

    # ---- phase 12: the RLC path's times and launches
    def dec_bound(n):
        # reads 32 bytes, writes ok, small and the X, Y, Z, T int64 planes
        return bound(n * (32 + 2 + 4 * 80),
                     n * (DEC_SQR * SQR_OPS + DEC_MUL * MUL_OPS))

    def msm_bound(n, nwin, select):
        # reads the uint8 windows and four int64 planes per point, writes
        # four per lane; per lane m tables (NT - 2 unified adds, NT
        # conversions), and per window four doublings (16 S, 13 M, T on
        # the last only) and m Niels adds
        lanes = n // MSM_M
        nt, nw = (16, nwin) if select == "legacy" else (9, nwin + 1)
        muls = (MSM_M * ((nt - 2) * GE_ADD + nt * GE_TO_NIELS)
                + nw * (13 + MSM_M * GE_ADD_NIELS))
        return bound(n * (nwin + 4 * 80) + lanes * 4 * 80,
                     lanes * (muls * MUL_OPS + nw * 16 * SQR_OPS))

    def msm_design_ops(n, nwin, select):
        """32-bit operations of the kernel's own design (csrc/msm.cu), in
        place of the shared chain that msm_bound counts: per point its
        table and its own chain (four doublings and one Niels add per
        window), per lane m - 1 unified adds of the tree."""
        nt, nw = (16, nwin) if select == "legacy" else (9, nwin + 1)
        muls = (n * ((nt - 2) * GE_ADD + nt * GE_TO_NIELS
                     + nw * (13 + GE_ADD_NIELS))
                + n // MSM_M * (MSM_M - 1) * GE_ADD)
        return muls * MUL_OPS + n * nw * 16 * SQR_OPS

    def torch_chain(digest, s_bytes, z_bytes):
        """_rlc_scalars with rlc_recode's plain version in the kernel's
        place: the chain as it ran before the kernel."""
        ok_s, w_win, z_win, zs = rl.rlc_recode_plain(s_bytes, digest,
                                                     z_bytes)
        return (ok_s, w_win, z_win,
                sc.limbs_to_windows(sc.sum_mod_l(zs, axis=0))[:, None])

    rlc_kern = {}
    for batch, bml in RLC_BUCKETS:
        args = rlc_dev[(batch, bml)]
        pubs_d, r_d = args[3], args[2][:, :32]
        t_dec = cuda_ms(lambda: dc.decompress(pubs_d))
        d_dec = dev_ms(lambda: dc.decompress(pubs_d), "decompress_kernel")
        t_pair = cuda_ms(lambda: dc.decompress_pair(pubs_d, r_d))
        d_pair = dev_ms(lambda: dc.decompress_pair(pubs_d, r_d),
                        "decompress_kernel")
        db, pb = dec_bound(batch), dec_bound(2 * batch)
        rlc_kern[("decompress", batch)] = (t_dec, db, d_dec, t_pair, d_pair,
                                           pb)
        note(f"{batch}x{bml}: decompress kernel call {t_dec:.5f} ms, device "
             f"{d_dec:.5f} ms (bound {db[0]:.5f} ms, {db[1]}); the A, R pair "
             f"(one launch a RLC call) call {t_pair:.5f} ms, device "
             f"{d_pair:.5f} ms (bound {pb[0]:.5f} ms)")
        msm_in, c_win, scal_in = msm_inputs(args, batch)
        for sel in ms.SELECTS:
            for win, pts, nwin in msm_in:
                t_m = cuda_ms(lambda: ms.msm_lanes(win, pts, MSM_M, nwin, sel))
                d_m = dev_ms(lambda: ms.msm_lanes(win, pts, MSM_M, nwin, sel),
                             "msm_kernel")
                mb = msm_bound(batch, nwin, sel)
                rlc_kern[(f"msm_{sel}", batch, nwin)] = (t_m, mb, d_m)
                own = msm_design_ops(batch, nwin, sel)
                note(f"{batch}x{bml}: msm {sel} kernel nwin {nwin}, "
                     f"{batch // MSM_M} lanes: call {t_m:.5f} ms, device "
                     f"{d_m:.5f} ms (bound {mb[0]:.5f} ms, {mb[1]}); "
                     f"{design_note(own, d_m, mb)}")
        # the torch finish: the scalar chain, the two folds, [c]B and the
        # identity test
        lanes_ar = [ms.msm_lanes(win, pts, MSM_M, nwin, "legacy")
                    for win, pts, nwin in msm_in]
        accs = [cv.fold_lanes(p) for p in lanes_ar]
        for what, fn in (
                ("scalar chain (rlc_recode kernel, sum in torch)",
                 lambda: ed._rlc_scalars(*scal_in)),
                ("scalar chain, all torch (before the kernel)",
                 lambda: torch_chain(*scal_in)),
                ("lane folds", lambda: [cv.fold_lanes(p) for p in lanes_ar]),
                ("[c]B and identity test",
                 lambda: ed._rlc_finish(*accs, c_win))):
            t_f = cuda_ms(fn, PLAIN_RUNS, 1)
            calls, nk, busy, wall = profiled(fn)
            note(f"{batch}x{bml}: torch finish, {what}: {t_f:.4f} ms; under "
                 f"torch.profiler {calls} kernel launch calls, {nk} device "
                 f"ops busy {busy:.4f} ms of {wall:.4f} ms wall")
    zb = torch.from_numpy(np.random.default_rng(12).integers(
        0, 256, (4096, 16), np.uint8)).to(dev)
    # three calls: a trace can miss the event at its edge
    _, dec_calls, _, _ = device_ms(
        torch, lambda: ed.verify_batch_rlc(*rlc_dev[(4096, 128)], zb,
                                           m=MSM_M), "decompress_kernel", 3, 1)
    if dec_calls != 1:
        raise AssertionError(f"an RLC call made {dec_calls} decompress "
                             f"launches under torch.profiler")
    note("verify_batch_rlc 4096x128 under torch.profiler: 1 decompress "
         "launch a call (A and R)")
    for batch, bml, sel in rlc_runs:
        ver, arrs = rlc_vers[(batch, bml, sel)], clean[(batch, bml)]
        t_e2e = wall_ms(lambda: np.asarray(ver(*arrs)))
        calls, nk, busy, wall = profiled(lambda: np.asarray(ver(*arrs)))
        note(f"rlc {batch}x{bml} {sel}: SigVerifier call end to end "
             f"{t_e2e:.4f} ms = {batch / t_e2e * 1e3:.1f} verifies/s; under "
             f"torch.profiler {calls} kernel launch calls, {nk} device ops "
             f"busy {busy:.4f} ms of {wall:.4f} ms wall (device idle "
             f"{max(0.0, 1 - busy / wall):.4f})")
        if sel != "legacy":
            continue
        # the same call with the scalar chain all in torch, as it ran
        # before the rlc_recode kernel (its plain version in its place)
        ed.rlc_recode = rl.rlc_recode_plain
        try:
            t_b = wall_ms(lambda: np.asarray(ver(*arrs)))
            calls, nk, busy, wall = profiled(lambda: np.asarray(ver(*arrs)))
        finally:
            ed.rlc_recode = rl.rlc_recode
        note(f"rlc {batch}x{bml} {sel}, scalar chain all in torch (before "
             f"the kernel): SigVerifier call end to end {t_b:.4f} ms = "
             f"{batch / t_b * 1e3:.1f} verifies/s; under torch.profiler "
             f"{calls} kernel launch calls, {nk} device ops busy "
             f"{busy:.4f} ms of {wall:.4f} ms wall")
    # plain versions at the headline bucket, A side (nwin 64)
    pubs_d = rlc_dev[(32768, 128)][3]
    plain_dec = cuda_ms(lambda: dc.decompress_plain(pubs_d), PLAIN_RUNS, 1)
    msm_in, _, _ = msm_inputs(rlc_dev[(32768, 128)], 32768)
    win, pts, nwin = msm_in[0]
    plain_msm = {sel: cuda_ms(lambda: cv.msm_lanes(win, pts, MSM_M, nwin,
                                                   sel), PLAIN_RUNS, 1)
                 for sel in ms.SELECTS}
    note(f"32768x128: plain decompress {plain_dec:.4f} ms, plain msm lanes "
         f"nwin 64 {', '.join(f'{k} {v:.4f} ms' for k, v in plain_msm.items())}")

    # ---- phase 13: the serving engine and the verify pipeline on the
    # card, each with the launch counts set to 0 just before it
    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        serving_phase(pool, reset_counts, counts, note)
        # ---- phase 14: the tango fabric and the tile runtime: the port's
        # VerifyTile under the port's Mux in process, then the
        # verify-bench topology in processes, wire and packed-wire
        topology_phase(pool, reset_counts, counts, note)

    # ---- the kernels record: the strict kernels at the serving bucket
    # (the first, where their plain versions were timed), the RLC kernels
    # at 32768 x 128 (the A side for msm); launches from each path's run
    # above
    t_sha, t_tail, sb, tb, d_sha, d_tail = timing[BUCKETS[0][:2]]
    t_dec, db, d_dec, t_pair, d_pair, pb = rlc_kern[("decompress", 32768)]
    rlc_rows = [
        {"name": "decompress", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/decompress.cu",
         "replaces": "firedancer_tpu/ops/curve_pallas.py:649",
         "launches": rlc_launches["decompress"], "max_abs_err": dec_err,
         "ms": t_dec, "device_ms": d_dec, "plain_ms": plain_dec,
         "bound_ms": db[0], "bound_by": db[1], "library_ms": None,
         "shape": "32768x32", "pair_ms": t_pair, "pair_device_ms": d_pair,
         "pair_bound_ms": pb[0]}]
    for sel, line in (("legacy", 1255), ("p16", 1243)):
        t_m, mb, d_m = rlc_kern[(f"msm_{sel}", 32768, 64)]
        rlc_rows.append(
            {"name": f"msm_{sel}", "route": "cuda",
             "source": "firedancer_tpu_torch/csrc/msm.cu",
             "replaces": f"firedancer_tpu/ops/curve_pallas.py:{line}",
             "launches": rlc_launches[f"msm_{sel}"], "max_abs_err": msm_err,
             "ms": t_m, "device_ms": d_m, "plain_ms": plain_msm[sel],
             "bound_ms": mb[0], "bound_by": mb[1], "library_ms": None,
             "shape": f"32768 points, m {MSM_M}, nwin 64"})
    kernels = [
        {"name": "sha512_ram", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/sha512.cu",
         "replaces": "firedancer_tpu/ops/sha512_pallas.py:118",
         "launches": launches["sha512_ram"], "max_abs_err": sha_err,
         "ms": t_sha, "device_ms": d_sha, "plain_ms": plain_sha,
         "bound_ms": sb[0], "bound_by": sb[1], "library_ms": None},
        {"name": "verify_tail", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/verify_tail.cu",
         "replaces": "firedancer_tpu/ops/curve_pallas.py:1039",
         "launches": launches["verify_tail"], "max_abs_err": tail_err,
         "ms": t_tail, "device_ms": d_tail, "plain_ms": plain_tail,
         "bound_ms": tb[0], "bound_by": tb[1], "library_ms": None},
    ] + rlc_rows
    # the kernels of the split and unfused layouts and of the RLC scalar
    # chain, at 4096 x 128 (where their plain versions were timed);
    # launches from the split, unfused and RLC runs above
    for name, line, launched in (
            ("reduce_recode", 810, layout_launches["split"]),
            ("dsm_tail_q", 472, layout_launches["split"]),
            ("double_scalar_mul_base", 499, layout_launches["unfused"]),
            ("rlc_recode", 921, rlc_launches)):
        t_k, b_, d_k = new_ms[(name, buckets[0][0])]
        src = "dsm" if name.startswith("d") else name
        kernels.append(
            {"name": name, "route": "cuda",
             "source": f"firedancer_tpu_torch/csrc/{src}.cu",
             "replaces": f"firedancer_tpu/ops/curve_pallas.py:{line}",
             "launches": launched[name], "max_abs_err": new_err[name],
             "ms": t_k, "device_ms": d_k, "plain_ms": new_plain[name],
             "bound_ms": b_[0],
             "bound_by": b_[1], "library_ms": None,
             "shape": f"{buckets[0][0]}x{buckets[0][1]}"})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
