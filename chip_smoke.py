#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's verify paths on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from firedancer_tpu_torch/csrc and holds each one
against its plain torch version on the card.  The strict path, in its
three layouts: the real conformance corpora and the serving buckets
through SigVerifier.dispatch_blob, fused (sha512 and verify_tail
kernels), split (sha512, decompress, reduce_recode and dsm_tail_q) and
unfused (sha512, decompress and double_scalar_mul_base), each ending
with the r_check kernel (the finish), which is also held against its
plain version on its edge lanes at 1, 4096, 4097 and 32768 lanes.  The RLC
batch-verify path: clean buckets through SigVerifier(mode="rlc") with
both MSM selects, a batch with one forgery through the strict descent,
and the corpora in rlc mode: through the descent, and each vector that
passes the prechecks alone among m - 1 valid signatures, its batch bit
held against the exact batch equation on Python ints (decompress,
sha512, rlc_recode and msm kernels).  Then the serving layers (phase
13): the engine (SigVerifier.make_ingest over pinned rotating blobs)
against serial dispatch_blob, and the port's VerifyTile at the default
bucket ladder, wire txns of every outcome through the native burst parse
and packed-row fills, its accepted set against the host verifier's, once
with [ingest] native_hostpath 1 (the packed rows through the C host path)
and once with 0 (the NumPy finish) (sha512, verify_tail and r_check
kernels), the engine also with the card stalled before and after each
dispatch.
Then the topology runtime (phase 14): the port's Mux runs the
VerifyTile in process on packed-wire frags with the card stalled after
each dispatch (each frag's flow credit held until its verdict, the
drain park and its manifest), then the verify-bench topology (source ->
verify -> dedup -> sink) in spawned processes on wire txns at the
default bucket ladder, the packed-wire firehose over two verify tiles
on the one card, and the wire firehose through one verify tile's native
burst parse for a fixed window.  Then the leader lane (phase 15): the
PoH spans kernel (the span engine, the poh_dev tile's window and splice
geometry, verify_entries, and edge rows at lane counts around its pairs
of warps, lanes of one pair diverging) and the mixin-tree kernel
against their plain versions and the host chain, one lane through a
whole slot at the Solana clock defaults with its entries re-checked,
leader-bench (source -> verify -> leader_pack -> poh_dev -> sink) in
spawned processes with forged txns injected, and the poh_dev tile at
the clock defaults under the port's Mux, with the chain-lane hashes its
dispatches ran by the slot's close.  Then the shred lane (phase 16), the
supervised run (phase 17) and the antipa mode (phase 18): the
antipa_tail kernel against its plain version and the host on edge lanes
fed digests directly, SigVerifier(mode="antipa") at the serving
buckets against strict and the host twin (sha512 and antipa_tail
kernels), the engine, and a verify tile with FDTPU_VERIFY_MODE=antipa
on wire txns and torsion forgeries.  Then the leader's tail (phase 19):
leader-bench with two fee-payer pack shards and the merge tile, poh_dev
at the clock defaults, the shred tile's leader role cutting signed 32:32
FEC sets (the sign tile holding the key, the parity on the GF(2)
kernel) into a store, and a follower shred tile admitting every shred on
the card into shred_recover and its own store, in spawned processes
(launches read from the tiles' drain manifests).  Each path runs with the launch counts set to 0
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
import functools
import hashlib
import json
import math
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
# Field products of one lane of the finish with a Fermat inverse (254
# squarings and 11 products, and x = X / Z, 1 M): the count of the design
# the division replaced, printed beside the new one.
RC_SQR, RC_MUL = 254, 12
# The finish (csrc/r_check.cu; its division fe_div_canon in
# csrc/fe25519.cuh), counted from the code as the least 32-bit operations
# of a lane: a batch of 30 divsteps applies its matrix to f and g (36
# products, 16 carries of a shift and a mask), to d and e (36 products,
# 4 for md and me, 4 by p's two nonzero limbs, 16 carries) and tests g
# (9): RC_BATCH_OPS; a step of the divsteps loop finds g's zeros (1),
# shifts g, u and v (3), counts eta and i (2), makes w (3) and the three
# multiply-adds (3): RC_STEP_OPS.  The canonical reductions, conversions
# and the byte unpacking are not counted, so it is a lower bound.  A
# lane's critical path: a step's chain (zeros, shift, product, mask,
# multiply-add) and a batch's from its matrix to the next low words (two
# multiply-adds, a shift, two more and a mask), a cycle each.  The
# batches and steps a lane runs depend on its Z (rc_steps).
RC_BATCH_OPS, RC_STEP_OPS = 36 + 32 + 36 + 8 + 32 + 9, 12
RC_STEP_DEPTH, RC_BATCH_DEPTH = 5, 6
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


def _compress_ops(state_var: bool, w_var, wk_table: bool = False):
    """The least 32-bit operations of one SHA-256 compression on this
    card, with what is constant folded, as (integer-pipe-only, adds): a
    rotation is one funnel shift, a shift one, three-input logic (a
    three-way xor, ch, maj) one LOP3 -- these run only on the integer
    pipe; a sum of n operands (its constants folded into one immediate)
    takes n // 2 three-input adds (IADD3), which the integer pipe runs
    or, as IMAD, the FMA pipe.  A round on variable words is 10 + 4 (two
    Sigmas of 3 shifts and a LOP3, ch, maj; t1 2 adds, new e 1, new a 1),
    a schedule word 8 + 2.  state_var: the input state is variable (else
    the initial H0); w_var: which of the block's 16 message words are
    variable; wk_table: the whole schedule plus K is one constant table.
    Byte order conversions at the edges are not counted."""
    alu = adds = 0

    def rot(x):
        nonlocal alu
        alu += x
        return x

    def lop(*xs):
        nonlocal alu
        alu += any(xs)
        return any(xs)

    def add(*xs):
        nonlocal adds
        nv = sum(xs)
        if nv:
            adds += (nv + (not all(xs))) // 2
        return nv > 0

    w = [False] * 16 if wk_table else list(w_var)
    st = [state_var] * 8
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        if t >= 16 and not wk_table:
            x15, x2 = w[(t + 1) & 15], w[(t + 14) & 15]
            w[t & 15] = add(w[t & 15], lop(rot(x15), rot(x15), rot(x15)),
                            w[(t + 9) & 15], lop(rot(x2), rot(x2), rot(x2)))
        s1, ch = lop(rot(e), rot(e), rot(e)), lop(e, f, g)
        s0, maj = lop(rot(a), rot(a), rot(a)), lop(a, b, c)
        t1 = add(h, s1, ch, False, w[t & 15])
        a, b, c, d, e, f, g, h = add(t1, s0, maj), a, b, c, add(d, t1), e, f, g
    for x, y in zip(st, (a, b, c, d, e, f, g, h)):
        add(x, y)
    return alu, adds


def _ops_sum(*parts):
    return tuple(map(sum, zip(*parts)))


# SHA-256's 32-bit operations by _compress_ops, (integer-pipe-only,
# adds): a PoH append (a 32-byte message: H0, 8 variable words and the
# constant tail); a mixin (a 64-byte message, then the constant pad block
# from one table); a merkle node (0x00 or 0x01 before 64 bytes: 16
# funnel shifts to align the words, a full block, 1 op for the second
# block's first word, then that block with 15 constant words).
SHA256_APPEND_OPS = _compress_ops(False, [True] * 8 + [False] * 8)
SHA256_MIXIN_OPS = _ops_sum(_compress_ops(False, [True] * 16),
                            _compress_ops(True, None, wk_table=True))
SHA256_NODE_OPS = _ops_sum((17, 0), _compress_ops(False, [True] * 16),
                           _compress_ops(True, [True] + [False] * 15))
# an SM dispatches one warp instruction a cycle on each of its 4
# sub-partitions: 128 lanes of any type a cycle, twice INT32_LANES_PER_SM
DISPATCH_LANES_PER_SM = 128


def _sha256_bound_ms(ops, int_ops_per_s) -> float:
    """The least ms of SHA-256's (integer-pipe-only, adds) operations:
    each is at least one instruction, at the SMs' dispatch rate.  Not
    the INT32 rate: the adds may run as IMAD on the FMA pipe beside the
    integer pipe, and a shift as a multiply."""
    per_s = int_ops_per_s * DISPATCH_LANES_PER_SM / INT32_LANES_PER_SM
    return sum(ops) / per_s * 1e3


# The critical path of a compression's rounds: a round's new e and new a
# are each three dependent operations from the last (the Sigma's
# rotations, their three-way xor, one three-input add; ch, maj and
# h + K + w off the path), counted at one cycle each at the max SM clock:
# a lower bound, the card's dependent-issue latency is several cycles.
SHA256_ROUND_DEPTH = 3
AGAVE_SLOT_MS = 400.0         # Solana's slot (DEFAULT_MS_PER_SLOT)
# phase 15: the Solana SDK clock defaults (DEFAULT_HASHES_PER_TICK,
# DEFAULT_TICKS_PER_SLOT)
POH_HASHES_PER_TICK, POH_TICKS_PER_SLOT = 12_500, 64
# phase 15a's edge rows: lane counts around the PoH kernel's pair of
# warps (32 lanes a block), the last one pair on each of the H100's SMs
POH_EDGE_LANES = (1, 31, 33, 64, 512, 4224)
RLC_BUCKETS = ((4096, 128), (32768, 128))
MSM_M = 8
# phase 13's stall on the card, in clock cycles (torch.cuda._sleep):
# ~0.1 s on an H100, longer than the host takes to pack and launch a
# 4096-row dispatch
STALL_CYCLES = 200_000_000


def r_check_edges(seed: int = 41) -> list:
    """The finish's edge lanes (csrc/r_check.cu), each ((qx, qz, qy) raw
    limbs, ok_y, R as an int), with both ok_y values: Z = 0; Z's limbs
    those of p (zero mod p, limbs not); R's y >= p, with the right and
    the wrong sign bit (accepted mod p with the right one); R's y with
    no point (off the curve); each of the five small-order y values {0,
    1, -1, y8_0, y8_1} with either sign bit (x = 0 with the sign bit set
    among them, y = +-1); the largest TIGHT limbs (even limbs 2^26 - 1,
    odd 2^25 + 2^15 - 1) and the limbs of p in X, Y and Z.  Q is a
    point scaled by a random lambda (Z != 1) where it is one."""
    from firedancer_tpu_torch.ops import curve25519 as cv
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import f25519 as fe
    p = fe.P
    p_limbs = [(p >> o) & ((1 << w) - 1) for o, w in zip(fe.OFFS, fe.WIDTHS)]
    max_tight = [(1 << 26) - 1 if i % 2 == 0 else (1 << 25) + (1 << 15) - 1
                 for i in range(fe.NLIMB)]
    rng = np.random.default_rng(seed)

    def affine(y: int):
        pt = ed._decompress_host(y.to_bytes(32, "little"))
        if pt is None:
            return None
        zi = pow(pt[2], p - 2, p)
        return pt[0] * zi % p, pt[1] * zi % p

    def scaled(x: int, y: int) -> list:
        lam = int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1
        return [fe.int_to_limbs(v * lam % p) for v in (x, 1, y)]

    y0 = next(y for y in range(2, 64) if affine(y) is not None)
    off = next(y for y in range(2, 64) if affine(y) is None)
    x0 = affine(y0)[0]
    sign = (x0 & 1) << 255
    good = scaled(x0, y0)
    rows = []
    for ok_y in (True, False):
        rows += [([good[0], [0] * 10, good[2]], ok_y, y0 | sign),
                 ([good[0], p_limbs, good[2]], ok_y, y0 | sign),
                 (good, ok_y, (p + y0) | sign),
                 (good, ok_y, (p + y0) | (sign ^ 1 << 255)),
                 (good, ok_y, y0 | sign),
                 (good, ok_y, off | sign),
                 ([max_tight] * 3, ok_y, y0 | sign),
                 ([max_tight, p_limbs, max_tight], ok_y, y0),
                 ([p_limbs, max_tight, p_limbs], ok_y, p)]
        for yv in (0, 1, p - 1, cv.ORDER8_Y0, cv.ORDER8_Y1):
            for sgn in (0, 1 << 255):
                rows.append((scaled(affine(yv)[0], yv), ok_y, yv | sgn))
    return rows


def rc_divsteps(z: int) -> int:
    """Bernstein and Yang's divsteps (delta = 1 at the start) from f = p,
    g = z mod p until g = 0: the work of the strict finish's division
    (csrc/fe25519.cuh fe_div_canon) depends on its denominator alone."""
    p = 2 ** 255 - 19
    delta, f, g, n = 1, p, z % p, 0
    while g:
        if delta > 0 and g & 1:
            delta, f, g = 1 - delta, g, (g - f) >> 1
        elif g & 1:
            delta, g = 1 + delta, (g + f) >> 1
        else:
            delta, g = 1 + delta, g >> 1
        n += 1
    return n


def rc_steps(z: int) -> tuple:
    """(batches, steps) of fe_div_canon dividing by z mod p, its loop run
    on Python ints: a batch is 30 divsteps, after which the lane stops if
    g = 0; a step skips g's run of zero bits, then cancels up to 6 bits
    of g with one multiple of f (fe_divsteps30)."""
    p = 2 ** 255 - 19
    eta, f, g = -1, p, z % p
    batches = steps = 0
    while True:
        batches += 1
        i = 30
        while True:
            low = g & ((1 << i) - 1)
            zeros = (low & -low).bit_length() - 1 if low else i
            g >>= zeros
            eta -= zeros
            i -= zeros
            if i == 0:
                break
            steps += 1
            if eta < 0:
                eta, f, g = -eta, g, -f
            limit = min(eta + 1, i, 6)
            g += f * (g * f * (f * f - 2) % (1 << limit))
        if g == 0:
            return batches, steps


def _rc_steps_of(zs: list) -> list:
    """rc_steps of each z (a pool worker's share)."""
    return [rc_steps(z) for z in zs]


@functools.lru_cache(maxsize=None)
def r_check_long_zs(seed: int = 43, n: int = 8192, k: int = 8) -> tuple:
    """Of n seeded values in [1, p), the k whose division (fe_div_canon)
    runs the most divsteps, most first."""
    p = 2 ** 255 - 19
    rng = np.random.default_rng(seed)
    zs = [int.from_bytes(rng.bytes(32), "little") % (p - 1) + 1
          for _ in range(n)]
    return tuple(sorted(zs, key=rc_divsteps, reverse=True)[:k])


def r_check_long_lanes(seed: int = 44) -> list:
    """Finish lanes as r_check_edges gives them, with Z the values of
    r_check_long_zs: a point on the curve scaled by each (Q.Z = z), with
    R its encoding, each with both ok_y values."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import f25519 as fe
    p = fe.P
    rng = np.random.default_rng(seed)
    rows = []
    for z in r_check_long_zs():
        while True:
            y = int.from_bytes(rng.bytes(32), "little") % p
            pt = ed._decompress_host(y.to_bytes(32, "little"))
            if pt is not None:
                break
        zi = pow(pt[2], p - 2, p)
        x = pt[0] * zi % p
        q = [fe.int_to_limbs(v * z % p) for v in (x, 1, y)]
        for ok_y in (True, False):
            rows.append((q, ok_y, y | (x & 1) << 255))
    return rows


def write_r_edges(qx, qz, qy, ok_y, r) -> int:
    """Writes r_check_edges(), then r_check_long_lanes(), over the first
    lanes of the finish's inputs (Q's (10, n) planes, ok_y (n,), R's (n,
    32) rows), in place, as many as there are lanes.  Returns how many."""
    import torch
    edges = (r_check_edges() + r_check_long_lanes())[:r.shape[0]]
    k = len(edges)
    for j, plane in enumerate((qx, qz, qy)):
        plane[:, :k] = torch.tensor([[int(v) for v in e[0][j]]
                                     for e in edges]).T.to(plane.device)
    ok_y[:k] = torch.tensor([e[1] for e in edges]).to(ok_y)
    r[:k] = torch.tensor([list(e[2].to_bytes(32, "little"))
                          for e in edges], dtype=torch.uint8).to(r.device)
    return k


# the verify tile's guard (disco/pipeline.py GuardedVerifier): in a phase
# without an injected fault these read 0 on every verify tile
GUARD_SLOTS = ("device_fail_cnt", "fallback_lane_cnt", "degraded_mode")


def guard_clean(m, where: str):
    """Raise unless a verify tile's metrics show it served every verdict
    on the device: no failed dispatch, no host-fallback lane, not
    degraded."""
    got = {k: m[k] for k in GUARD_SLOTS}
    if any(got.values()):
        raise AssertionError(f"{where}: the verify tile's guard fell back "
                             f"to the host: {got}")


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
            == launches["r_check"] == eng.dispatches == n_batches):
        raise AssertionError(f"engine: launches {launches} for "
                             f"{eng.dispatches} dispatches")
    if not 0 < sum(int(s.sum()) for s in serial) < n_batches * b:
        raise AssertionError("engine: the batches are not mixed")
    note(f"engine {b}x{ml}, make_ingest(nbuf=3, depth=2): bits == serial "
         f"dispatch_blob on all {n_batches} x {b} rows ({n_invalid} batches "
         f"with corrupted signatures, 1 adversarial); sha512, "
         f"verify_tail and r_check launches {launches['sha512_ram']}, "
         f"{launches['verify_tail']} and {launches['r_check']} == "
         f"dispatches; stats {eng.stats()}")
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

    if cuda:
        # the same batches with the card stalled before each dispatch: the
        # host returns from dispatch_blob while the blob's upload still
        # waits behind the stall (one launch a stage, none of which
        # blocks), so only the rule that a blob goes back to the free
        # ring once its verdict is on the host keeps the next fill from
        # overwriting rows the card has not read
        ahead = sv.make_ingest(nbuf=3, depth=2)
        aguard = _ReleaseGuard()
        _guard_engine(ahead, aguard)

        t_ret = []

        def stall_first(buf):
            torch.cuda._sleep(STALL_CYCLES)
            t1 = time.perf_counter()
            v = sv.dispatch_blob(buf)
            t_ret.append((time.perf_counter() - t1) * 1e3)
            return v
        ahead.desc = dataclasses.replace(ahead.desc, dispatch=stall_first)
        reset_counts()
        t0 = time.perf_counter()
        got, apend = [], 0
        for x in batches:
            got += ahead.submit(*x)
            apend += not ahead._inflight[-1][0].is_ready()
        got += ahead.drain()
        t_ahead = (time.perf_counter() - t0) * 1e3 / n_batches
        launches = counts()
        if len(got) != n_batches or any(
                not np.array_equal(g, s) for g, s in zip(got, serial)):
            raise AssertionError("engine, card stalled before each "
                                 "dispatch: bits differ from serial "
                                 "dispatch_blob")
        if aguard.returns != n_batches or not aguard.waited:
            raise AssertionError(
                f"engine, card stalled before each dispatch: "
                f"{aguard.returns} blob returns, {aguard.waited} waited on "
                f"a pending verdict")
        if not (launches["sha512_ram"] == launches["verify_tail"]
                == launches["r_check"] == ahead.dispatches == n_batches):
            raise AssertionError(f"engine, card stalled before each "
                                 f"dispatch: launches {launches} for "
                                 f"{ahead.dispatches} dispatches")
        note(f"engine, card stalled {STALL_CYCLES} cycles before each "
             f"dispatch: bits == serial dispatch_blob; pending right after "
             f"submit in {apend} of {n_batches}; dispatch_blob returned "
             f"after {statistics.median(t_ret):.3f} ms (median; max "
             f"{max(t_ret):.3f} ms), its upload still queued behind the "
             f"stall; {aguard.returns} blob returns, "
             f"{aguard.waited} waited on a pending verdict; sha512, "
             f"verify_tail and r_check launches == {n_batches} dispatches; "
             f"{t_ahead:.4f} ms a batch wall; stats {ahead.stats()}")

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

    # the txns the burst path reroutes through submit(): those that parse
    # with a message longer than the first bucket's
    n_long = 0
    for w in stream:
        try:
            n_long += len(txn_lib.parse(w).message(w)) > buckets[0][1]
        except txn_lib.TxnParseError:
            pass
    n_bursts = -(-len(stream) // 64)
    # the tile twice: at the default [ingest] native_hostpath 1 (packed
    # rows through fd_hostpath_*), then at 0 (the NumPy finish); the wire
    # bursts go through the native burst parser either way
    runs = {native: _tile_run(native, buckets, device, stream, fill_blobs,
                              fills, fill_rows, reset_counts, counts, sync)
            for native in (1, 0)}
    for native, r in runs.items():
        got, snap, launches = r["got"], r["snap"], r["launches"]
        tag_ = f"tile (native_hostpath {native})"
        if len(got) != len(set(got)) or set(got) != want:
            raise AssertionError(
                f"{tag_}: accepted {len(got)} wire txns, the host oracle "
                f"{len(want)}; {len(set(got) - want)} extra, "
                f"{len(want - set(got))} missing")
        if r["got_wires"] != want_wires:
            raise AssertionError(f"{tag_}: packed rows accepted "
                                 f"{len(r['got_wires'])}, the host oracle "
                                 f"{len(want_wires)}")
        n_mtu_ok = sum(len(p) == txn_lib.MTU for p in got)
        if n_mtu_ok != n_mtu:
            raise AssertionError(f"{tag_}: {n_mtu_ok} of {n_mtu} full-MTU "
                                 f"txns accepted")
        if not (launches["sha512_ram"] == launches["verify_tail"]
                == launches["r_check"] == snap["batches"]):
            raise AssertionError(f"{tag_}: launches {launches} for "
                                 f"{snap['batches']} dispatches")
        if snap["compile_cnt"]:
            raise AssertionError(f"{tag_}: compile_cnt "
                                 f"{snap['compile_cnt']} after boot")
        if r["returns"] != r["wire_batches"]:
            raise AssertionError(f"{tag_}: {r['returns']} bucket blob "
                                 f"returns for {r['wire_batches']} bucket "
                                 f"dispatches")
        if cuda and not r["pinned"]:
            raise AssertionError(f"{tag_}: a bucket blob is not pinned")
        # the burst path: one native parse a fill of the first bucket, and
        # submit() only for the txns rerouted past it; the packed fills
        # through one fd_hostpath_* call a frag each way, or none at 0
        if not (0 < r["parses"] <= n_bursts + r["wire_batches"]
                and r["scalar"] == n_long):
            raise AssertionError(f"{tag_}: {r['parses']} native parses, "
                                 f"{r['scalar']} scalar submits")
        hp_want = ({"fd_hostpath_submit_rows": fills,
                    "fd_hostpath_finish_rows": fills} if native else {})
        if r["hp_calls"] != hp_want:
            raise AssertionError(f"{tag_}: host path calls {r['hp_calls']}")
        note(f"{tag_} at buckets {buckets}: {len(stream)} wire frags "
             f"({n_distinct} distinct signed txns, {n_mtu} full-MTU, 32 "
             f"repeats, 8 tampered, 4 with a bad second signature, 2 parse "
             f"failures): accepted {len(got)} == host oracle, {n_mtu_ok} of "
             f"them full-MTU (the {buckets[-1][0]}x{buckets[-1][1]} "
             f"bucket), {r['parses']} native burst parses, {r['scalar']} "
             f"txns rerouted through submit(); {fills} packed fills of "
             f"{fill_rows} rows ({fill_valid} valid each): "
             f"{len(r['got_wires'])} == host oracle, host path calls "
             f"{r['hp_calls'] or 'none (NumPy finish)'}; sha512, "
             f"verify_tail and r_check launches {launches['sha512_ram']}, "
             f"{launches['verify_tail']} and {launches['r_check']} == "
             f"{snap['batches']} dispatches; "
             f"compile_cnt {snap['compile_cnt']}; {r['returns']} bucket "
             f"blob returns, each after its verdict was ready, "
             f"{r['waited']} of them waited on a pending verdict; "
             f"{r['n_blobs']} bucket blobs, pinned: {r['pinned']}")
        note(f"{tag_}: boot {r['t_boot']:.3f} s (kernel build and warmup "
             f"of {len(buckets)} shapes); wire txns "
             f"{len(stream) / r['t_wire']:.1f} txns/s over "
             f"{r['wire_batches']} dispatches ({r['t_wire'] * 1e3:.1f} ms: "
             f"{r['t_parse'] * 1e3:.1f} ms in {r['parses']} native burst "
             f"parses, {r['t_dispatch'] * 1e3:.1f} ms in dispatch_blob, "
             f"{r['t_finish'] * 1e3:.1f} ms in the harvests (the wait for "
             f"a verdict included), the rest host glue; "
             f"{r['t_scalar'] * 1e3:.1f} ms in the {r['scalar']} rerouted "
             f"submit()s, what they dispatched and harvested included; "
             f"{r['t_flush'] * 1e3:.1f} ms in the last flush and its "
             f"verdicts); {r['t_fill']:.4f} ms a {fill_rows}-row packed "
             f"fill wall, of it {r['rows_finish_ms']:.4f} ms the finish "
             f"(verdict masking, tcache inserts, wire arena); pipeline "
             f"batch_ns p50/p99 "
             f"{snap['batch_ns_p50']:.0f}/{snap['batch_ns_p99']:.0f}, "
             f"coalesce_ns p50 {snap['coalesce_ns_p50']:.0f}, e2e_ns p50 "
             f"{snap['e2e_ns_p50']:.0f}, lanes {snap['lanes_filled']} "
             f"filled of {snap['lanes_dispatched']} dispatched")
    if (runs[1]["got"] != runs[0]["got"]
            or runs[1]["got_wires"] != runs[0]["got_wires"]):
        raise AssertionError("tile: native_hostpath 1 and 0 accepted "
                             "different txns")
    note("tile: native_hostpath 1 and 0 accepted the same wire txns in the "
         "same order and the same packed-row wires")
    note(f"phase 13: {time.perf_counter() - t_phase:.1f} s")


class _CountingLib:
    """The host library with its fd_hostpath_* calls counted."""

    def __init__(self, lib):
        self.lib = lib
        self.calls = collections.Counter()

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("fd_hostpath_"):
            return fn

        def counted(*args):
            self.calls[name] += 1
            return fn(*args)
        return counted


def _tile_run(native, buckets, device, stream, fill_blobs, fills, fill_rows,
              reset_counts, counts, sync):
    """Phase 13b once: the port's VerifyTile at `buckets` with
    [ingest] native_hostpath = native, the wire stream as rx bursts of 64
    frags, then the packed-row fills.  Returns what was published, the
    counts and the times; the checks are the caller's."""
    from firedancer_tpu_torch.disco import pipeline as pl
    from firedancer_tpu_torch.disco.verify_tile import VerifyTile
    cfg = {"buckets": buckets, "egress_packed": 1, "native_hostpath": native}
    if device is not None:
        cfg["device"] = device
    tile, ctx = VerifyTile(), _RecCtx(cfg)
    t0 = time.perf_counter()
    tile.init(ctx)
    t_boot = time.perf_counter() - t0
    pipe = tile.pipe
    pguard = _ReleaseGuard()
    _guard_pipeline(pipe, pguard)
    hp = None
    if pipe._hp is not None:
        hp = pipe._hp = _CountingLib(pipe._hp)
    # the burst path's native parses, its rerouted scalar submits, the
    # dispatches and the harvests, counted and timed on this pipeline
    # alone (the dispatches and harvests inside a rerouted submit too)
    t_in = dict.fromkeys(("parse", "scalar", "dispatch", "finish",
                          "rows_finish"), 0.0)
    n_in = dict.fromkeys(t_in, 0)
    parse, submit = pl.tn.parse_packed_bucket, pipe.submit
    fn, finish = pipe.verify_fn, pipe._finish
    dispatch = fn.dispatch_blob

    def timed(key, fn):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t_in[key] += time.perf_counter() - t
                n_in[key] += 1
        return call

    pl.tn.parse_packed_bucket = timed("parse", parse)
    pipe.submit = timed("scalar", submit)
    fn.dispatch_blob = timed("dispatch", dispatch)
    pipe._finish = timed("finish", finish)
    try:
        reset_counts()
        t0 = time.perf_counter()
        for lo in range(0, len(stream), 64):
            part = stream[lo:lo + 64]
            offs = np.zeros(len(part) + 1, np.int64)
            np.cumsum([len(w) for w in part], out=offs[1:])
            metas = np.zeros(len(part), dtype=[("sig", np.uint64)])
            tile.on_burst(ctx, 0, metas,
                          np.frombuffer(b"".join(part), np.uint8), offs,
                          len(part))
            tile.after_credit(ctx)
        t1 = time.perf_counter()
        tile._forward(ctx, pipe.flush())
        sync()
        t_wire = time.perf_counter() - t0
        t_flush = time.perf_counter() - t1
    finally:
        pl.tn.parse_packed_bucket = parse
        del pipe.submit
        fn.dispatch_blob = dispatch
        pipe._finish = finish
    wire_batches = pipe.metrics.batches
    # the packed fills: a frag's finish (_finish_rows, once its verdict
    # is on the host), which native_hostpath moves between C and NumPy
    finish_rows = pipe._finish_rows
    pipe._finish_rows = timed("rows_finish", finish_rows)
    try:
        t0 = time.perf_counter()
        for rows in fill_blobs:
            tile._forward_burst(ctx, pipe.submit_packed_rows(rows))
            tile.after_credit(ctx)
        tile._forward(ctx, pipe.flush())
        sync()
        t_fill = (time.perf_counter() - t0) * 1e3 / fills
    finally:
        del pipe._finish_rows
    tile._sync_metrics(ctx)
    guard_clean(ctx.metrics, "phase 13b")
    launches = counts()
    snap = pipe.metrics.snapshot()
    got = [p for p, _ in ctx.published]
    for p, sig in ctx.published:
        if sig != int.from_bytes(p[1:9], "little"):
            raise AssertionError("tile: a published sig is not the low 64 "
                                 "bits of the txn's first signature")
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
    blobs = [x for bk in pipe.buckets for x in [bk.blob, *bk._pool]]
    return {"got": got, "got_wires": got_wires, "snap": snap,
            "launches": launches, "t_boot": t_boot, "t_wire": t_wire,
            "t_flush": t_flush, "t_parse": t_in["parse"],
            "t_scalar": t_in["scalar"], "t_dispatch": t_in["dispatch"],
            "t_finish": t_in["finish"], "parses": n_in["parse"],
            "rows_finish_ms": t_in["rows_finish"] * 1e3 / fills,
            "scalar": n_in["scalar"], "t_fill": t_fill,
            "wire_batches": wire_batches, "returns": pguard.returns,
            "waited": pguard.waited,
            "hp_calls": dict(hp.calls) if hp is not None else {},
            "n_blobs": len(blobs),
            "pinned": all(x.is_pinned() for x in blobs)}


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
                   flush_age_ns=30_000_000_000, wire_window_s=15.0,
                   burst_n=512):
    """Phase 14: the port's tango fabric and tile runtime with the port's
    VerifyTile on the card.  (a) In process: the port Mux runs the tile
    in a thread on packed-wire frags published by hand, with the card
    stalled after each dispatch: each frag's credit is held while its
    verdict is pending, released after, each row's verdict is the host
    verifier's, and the drain parks with a manifest.  (b) The
    verify-bench topology in processes on wire frags at the default
    bucket ladder: one full first bucket, then the partial rest by the
    age flush.  (c) The packed-wire firehose over two verify tiles
    on the one card.  (d) The wire firehose: verify-bench with one verify
    tile at the default ladder and config (the native burst parse), the
    source stamping `burst_n` txns a loop for `wire_window_s`, then a
    drain.  device None is the card; the sizes are the full ones.  Raises
    on any failed check."""
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
            # the stall goes under the tile's guard, in the device's place
            stalled = _StalledVerifier(tile.guard.fn)
            tile.guard.fn = stalled
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
            guard_clean(snap, "phase 14a")
            if (snap["txn_in_cnt"], snap["verify_pass_cnt"],
                    snap["verify_fail_cnt"], snap["torn_drop_cnt"],
                    snap["compile_cnt"]) != (4 * rows, len(want),
                                             4 * rows - len(want), 0, 0):
                raise AssertionError(f"phase 14a: counters {snap}")
            if not (launches["sha512_ram"] == launches["verify_tail"]
                    == launches["r_check"] == stalled.dispatches == 4):
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
                 f"compile {snap['compile_cnt']}; sha512, verify_tail and "
                 f"r_check launches {launches['sha512_ram']}, "
                 f"{launches['verify_tail']} and {launches['r_check']} == "
                 f"{stalled.dispatches} "
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
            guard_clean(v, "phase 14b")
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
            for m in ms:
                guard_clean(m, "phase 14c")
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

        # ---- (d) processes: the wire firehose through the native burst
        # parse, one verify tile at the default ladder and config
        cfg = app_config.load(environ={})
        cfg["name"] = f"{tag}d"
        cfg["tiles"]["verify"]["buckets"] = buckets
        cfg["tiles"]["verify"]["device"] = device or ""
        cfg["supervision"]["drain_timeout_s"] = 120.0
        cfg["development"]["source_burst_n"] = burst_n
        spec = app_config.build_topology(cfg)
        (vcfg,) = [t.cfg for t in spec.tiles if t.kind == "verify"]
        if vcfg["native_hostpath"] != 1:
            raise AssertionError(f"phase 14d: verify cfg {vcfg}")
        _shm_check(spec.wksp_mb << 20, note)
        t0 = time.perf_counter()
        run = TopoRun(spec, policy=SupervisionPolicy.from_cfg(cfg))
        try:
            run.wait_ready(timeout=cfg["supervision"]["boot_grace_s"])
            t_boot_d = time.perf_counter() - t0
            # the window opens at the verify tile's first dispatch, so the
            # boot and the first fill are not in it
            _wait_for(lambda: run.metrics("verify:0")["batch_cnt"] > 0,
                      120, "the first dispatch", run)
            v0 = run.metrics("verify:0")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < wire_window_s:
                if run.poll() is not None:
                    raise AssertionError("phase 14d: a tile failed")
                time.sleep(0.05)
            v1 = run.metrics("verify:0")
            t_d = time.perf_counter() - t0
            if run.poll() is not None:
                raise AssertionError("phase 14d: a tile failed")
            if not run.drain():
                raise AssertionError("phase 14d: drain() did not drain "
                                     "every tile")
            src, v = run.metrics("source"), run.metrics("verify:0")
            guard_clean(v, "phase 14d")
            d, sink = run.metrics("dedup"), run.metrics("sink")
        finally:
            run.close()
        if set(run.exitcodes.values()) != {0}:
            raise AssertionError(f"phase 14d: exit codes {run.exitcodes}")
        # stamping writes each txn's tag over R: every signature fails
        if not (v["txn_in_cnt"] == src["txn_gen_cnt"] > 0
                and v["verify_fail_cnt"] == v["txn_in_cnt"]
                and v["verify_pass_cnt"] == 0
                and v["parse_fail_cnt"] == v["torn_drop_cnt"] == 0
                and v.get("in_ovrn_cnt", 0) == 0
                and v["compile_cnt"] == 0
                and d.get("uniq_cnt", 0) == 0
                and sink.get("frag_cnt", 0) == 0):
            raise AssertionError(f"phase 14d: source {src}, verify {v}, "
                                 f"dedup {d}, sink {sink}")
        n_d = v1["txn_in_cnt"] - v0["txn_in_cnt"]
        b_d = v1["batch_cnt"] - v0["batch_cnt"]
        fill = (v1["lanes_filled_cnt"] - v0["lanes_filled_cnt"]) / max(
            1, v1["lanes_dispatched_cnt"] - v0["lanes_dispatched_cnt"])
        note(f"phase 14d: wire firehose, verify-bench with one verify tile "
             f"at buckets {buckets}, native_hostpath {vcfg['native_hostpath']}"
             f", the source stamping {burst_n} txns a loop: "
             f"{n_d / t_d:.1f} wire txns/s at the verify tile over "
             f"{t_d:.3f} s ({n_d} txns, {b_d} dispatches, "
             f"{n_d / max(1, b_d):.1f} txns and {100 * fill:.1f}% of the "
             f"lanes a dispatch); after drain(): txn_gen {src['txn_gen_cnt']}"
             f" == txn_in {v['txn_in_cnt']} == verify_fail "
             f"{v['verify_fail_cnt']}, parse_fail {v['parse_fail_cnt']}, torn "
             f"{v['torn_drop_cnt']}, overrun {v.get('in_ovrn_cnt', 0)}, "
             f"batches {v['batch_cnt']}, compile {v['compile_cnt']}; the "
             f"sink captured nothing; every tile exited 0; boot "
             f"{t_boot_d:.3f} s")
    finally:
        if old_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_omp
    note(f"phase 14: {time.perf_counter() - t_phase:.1f} s")


def _host_span_row(row, steps: int, caps) -> bytes:
    """One span row on the host (hashlib): every step's end state, with
    the kernel's and the JAX scan's rule, min(n - 1, cap) appends then the
    last hash; n <= 0 and an inactive step pass through."""
    h = bytes(row[:32])
    out = []
    for s in range(steps):
        b = 32 + 38 * s
        n = int.from_bytes(bytes(row[b + 32:b + 36]), "little", signed=True)
        if row[b + 37] and n > 0:
            for _ in range(min(n - 1, caps[s])):
                h = hashlib.sha256(h).digest()
            h = hashlib.sha256(h + bytes(row[b:b + 32]) if row[b + 36]
                               else h).digest()
        out.append(h)
    return b"".join(out)


def _fake_txns(rng, w: int) -> list:
    """w wire-shaped txns: one signature (the merkle leaf) and a body;
    pack and the mixin read nothing else."""
    return [b"\x01" + rng.bytes(64) + rng.bytes(24) for _ in range(w)]


class _LaunchTimer:
    """Brackets every launch of the given wrapper modules' kernels with
    CUDA events on the launching stream, by wrapping each module's ctypes
    entry (its _fn) until restore(); device_ms(t0, t1) sums, by name,
    (ms, launches) over the launches made between host times t0 and t1.
    The events run beside a wrapper's own launch count and change it
    nowhere."""

    def __init__(self, torch, mods: dict):
        self.torch, self.mods, self.log = torch, mods, []
        self.saved = {name: m._fn for name, m in mods.items()}
        for name, m in mods.items():
            m._fn = self._wrap(name, self.saved[name])

    def _wrap(self, name, entry):
        torch, log = self.torch, self.log

        def call(*args):
            stream = torch.cuda.current_stream()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(stream)
            rc = entry()(*args)
            e1.record(stream)
            log.append((name, time.perf_counter(), e0, e1))
            return rc

        return lambda: call

    def restore(self):
        for name, m in self.mods.items():
            m._fn = self.saved[name]

    def device_ms(self, t0: float, t1: float) -> dict:
        out = {name: [0.0, 0] for name in self.mods}
        for name, t, e0, e1 in list(self.log):
            if t0 <= t <= t1:
                out[name][0] += e0.elapsed_time(e1)
                out[name][1] += 1
        return {name: tuple(v) for name, v in out.items()}


def _launch_ms(torch, mod, name: str, fn, runs: int = RUNS):
    """A kernel's own device ms a launch: CUDA events around each launch
    of mod's kernel (_LaunchTimer) over runs calls of fn, after three
    warm-ups.  None where fn launched nothing (CPU tensors run the plain
    version)."""
    for _ in range(3):
        fn()
    timer = _LaunchTimer(torch, {name: mod})
    try:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        t1 = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        ms, n = timer.device_ms(t0, t1)[name]
    finally:
        timer.restore()
    return ms / n if n else None


def _ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def _sha256_ops(nums, has) -> tuple:
    """32-bit operations of a batch of PoH segments, (integer-pipe-only,
    adds): n - 1 appends and the last hash, a mixin or an append."""
    nums = np.asarray(nums, np.int64)
    has = np.asarray(has, bool)
    live = nums > 0
    appends = int(np.maximum(nums - 1, 0).sum() + (live & ~has).sum())
    mixins = int((live & has).sum())
    return tuple(appends * x + mixins * y
                 for x, y in zip(SHA256_APPEND_OPS, SHA256_MIXIN_OPS))


def _tree_hashes(widths) -> int:
    """Hashes one merkle tree a width needs under _mixin_roots' rule:
    the leaves, then ceil(w / 2) nodes a level until one is left."""
    n = 0
    for w in widths:
        n += w
        while w > 1:
            w = (w + 1) // 2
            n += w
    return n


def leader_phase(pool, reset_counts, counts, note, cuda_ms, dev_ms,
                 int_ops_per_s, clock_hz, device=None, hpt=12_500, tps=64,
                 n_src=256, n_foreign=16, n_forged=24, e_mbs=192,
                 workdir=None):
    """Phase 15: the leader lane on the card.  (a) The PoH spans kernel
    against its plain version and the host chain at the span engine's
    bench shape, at the poh_dev tile's window and splice geometry of the
    [leader] defaults at every mixin offset, and on rows with n == 0,
    inactive steps and n past a cap, also at POH_EDGE_LANES lanes with
    the lanes of one pair diverging.  (b) At the Solana clock defaults
    (hpt hashes a tick, tps ticks a slot): one lane extends a chain
    through a whole slot of 7 mixin entries and one tick entry a tick,
    and verify_entries re-checks its entries, one of them corrupted.
    (c) The mixin-tree kernel against its plain version and txn_mixin at
    widths 1-33 and at the tile's 8 x 31, and against its plain version
    at 2 x 1,024 and at widths past the half and past W at W 1,024.
    (d) leader-bench in spawned processes at the [leader] defaults, with
    forged txns injected beside the source's.  (e) The poh_dev tile at hpt x tps in process under
    the port's Mux, fed e_mbs microblocks for one slot, and the chain
    lane's hashes by the slot's close against the slot's.  Each path runs
    with the launch counts set to 0 just before it.  device None is the
    card.  Returns the numbers of the kernels record.  Raises on any
    failed check."""
    import dataclasses as dc_
    import tempfile
    import threading

    import torch

    from firedancer_tpu_torch.app import config as app_config
    from firedancer_tpu_torch.ballet import entry as entry_lib
    from firedancer_tpu_torch.ballet import poh as poh_lib
    from firedancer_tpu_torch.ballet import poh_engine as pe
    from firedancer_tpu_torch.ballet import txn as txn_lib
    from firedancer_tpu_torch.disco import topo as topo_mod
    from firedancer_tpu_torch.disco.leader_tiles import PohDevTile
    from firedancer_tpu_torch.disco.mux import Mux
    from firedancer_tpu_torch.disco.run import SupervisionPolicy, TopoRun
    from firedancer_tpu_torch.disco.tiles import read_capture
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import mixin_tree as mt
    from firedancer_tpu_torch.ops import poh_spans as ps
    from firedancer_tpu_torch.tango.ring import Cnc, tx_burst

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    tag = f"cs{os.getpid()}"
    t_phase = time.perf_counter()
    workdir = Path(workdir or tempfile.mkdtemp(prefix="fdtpu_phase15_"))
    rng = np.random.default_rng(1500)
    out = {}

    def hold_poh(blob, steps, caps, what) -> int:
        """Kernel A vs its plain version on one device blob; both against
        the host chain row by row.  Returns the max error, 0."""
        got = ps.poh_spans(blob, steps, caps)
        want = ps.poh_spans_plain(blob, steps, caps)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 15a {what}: "
                                 f"{int((got != want).any(1).sum())} lanes "
                                 f"differ from plain")
        rows = blob.cpu().numpy()
        g = got.cpu().numpy()
        for i in range(len(rows)):
            if bytes(g[i]) != _host_span_row(rows[i], steps, caps):
                raise AssertionError(f"phase 15a {what}: lane {i} differs "
                                     f"from the host chain")
        return int((got.to(torch.int16) - want).abs().max())

    def engine_run(eng, specs):
        planes = [eng.split_verdict(v) for v in eng.submit_lanes(specs)]
        planes += [eng.split_verdict(v) for v in eng.drain()]
        return planes[-1]

    # ---- (a) kernel A at the bench shape, the tile's geometry and edges
    def hb(i):
        return hashlib.sha256(i.to_bytes(8, "little")).digest()

    specs = [(hb(8 + i), [(1, hb(8 + i + 104729)), (63, None)])
             for i in range(8)]
    eng = pe.PohEngine(lanes=8, steps=2, max_hashes=64, device=device)
    eng.warm()
    reset_counts()
    planes = engine_run(eng, specs)
    got = counts()
    if not np.array_equal(planes, pe.host_spans(specs, 2)):
        raise AssertionError("phase 15a: the span engine differs from "
                             "host_spans")
    if got["poh_spans"] != 1 or got["mixin_tree"] != 0:
        raise AssertionError(f"phase 15a: launches {got}")
    bench_blob = np.zeros((8, pe.row_bytes(2)), np.uint8)
    pe.stamp_lanes(bench_blob, specs)
    bench_dev = torch.from_numpy(bench_blob).to(dev)
    err = hold_poh(bench_dev, 2, (64, 64), "8 lanes x 2 steps x 64")
    plain_ms = cuda_ms(lambda: ps.poh_spans_plain(bench_dev, 2, (64, 64)),
                       1, 0)
    bench_ms = cuda_ms(lambda: ps.poh_spans(bench_dev, 2, (64, 64)))
    note(f"phase 15a: span engine 8 lanes x [(1, mixin), (63, None)] == "
         f"host_spans, launches {got['poh_spans']}; kernel == plain == host "
         f"chain; kernel {bench_ms:.5f} ms, plain {plain_ms:.4f} ms a call")
    # the poh_dev tile at the [leader] defaults: hashes_per_tick 16,
    # mb_per_tick 8, spec_ticks 4, spec_spans 3
    d_hpt, mb_cap, K = 16, 8, 4
    P, tail = d_hpt - mb_cap - 1, mb_cap + 1
    win_caps = (d_hpt, tail) + (P, tail) * (K - 1)
    win = pe.PohEngine(lanes=3, steps=2 * K, max_hashes=d_hpt,
                       step_caps=win_caps, device=device)
    seng = pe.PohEngine(lanes=1, steps=tail, max_hashes=tail,
                        step_caps=(1,) * mb_cap + (tail,), device=device)
    head = rng.bytes(32)
    wspecs = [(head, [(P, None), (tail, None)] * K),
              (rng.bytes(32), [(d_hpt, None)]),
              (rng.bytes(32), [(P + 1, rng.bytes(32))])]
    if not np.array_equal(engine_run(win, wspecs),
                          pe.host_spans(wspecs, 2 * K)):
        raise AssertionError("phase 15a: the window geometry differs from "
                             "host_spans")
    wb = np.zeros((3, pe.row_bytes(2 * K)), np.uint8)
    pe.stamp_lanes(wb, wspecs)
    err = max(err, hold_poh(torch.from_numpy(wb).to(dev), 2 * K, win_caps,
                            "window"))
    for j in range(4):
        mixes = [rng.bytes(32) for _ in range(j)]
        sspec = ([(1, m) for m in mixes] + [(0, None)] * (mb_cap - j)
                 + [(tail - j, None)])
        mid = rng.bytes(32)
        if not np.array_equal(engine_run(seng, [(mid, sspec)]),
                              pe.host_spans([(mid, sspec)], tail)):
            raise AssertionError(f"phase 15a: the splice at j={j} differs "
                                 f"from host_spans")
        sb = np.zeros((1, pe.row_bytes(tail)), np.uint8)
        pe.stamp_lanes(sb, [(mid, sspec)])
        err = max(err, hold_poh(torch.from_numpy(sb).to(dev), tail,
                                (1,) * mb_cap + (tail,), f"splice j={j}"))
    # n == 0, inactive steps, n past a cap, a negative n
    steps, caps = 4, (0, 1, 6, 9)
    edge = np.zeros((40, pe.row_bytes(steps)), np.uint8)
    edge[:, :32] = rng.integers(0, 256, (40, 32))
    for s in range(steps):
        b = 32 + 38 * s
        edge[:, b:b + 32] = rng.integers(0, 256, (40, 32))
        n = rng.integers(0, 13, 40).astype("<u4")
        n[:4] = (0, 1, 2**32 - 3, caps[s] + 5)
        edge[:, b + 32:b + 36] = n.view(np.uint8).reshape(40, 4)
        edge[:, b + 36] = rng.integers(0, 2, 40)
        edge[:, b + 37] = rng.integers(0, 4, 40) > 0
    err = max(err, hold_poh(torch.from_numpy(edge).to(dev), steps, caps,
                            "edges"))
    # the kernel's pairs of warps at lane counts that fill a pair in part,
    # in whole, a lane over, two pairs, 16 pairs and one pair an SM: warp
    # 0's lanes diverge (n, the step a cap ends, mixins, inactive steps),
    # warp 1 has only its lane 0 active, each step also ends exactly at its
    # cap; plain and the host chain once, on all the rows
    erng = np.random.default_rng(1501)
    rows = POH_EDGE_LANES[-1]
    div = np.zeros((rows, pe.row_bytes(steps)), np.uint8)
    div[:, :32] = erng.integers(0, 256, (rows, 32))
    lane = np.arange(rows)
    for s_ in range(steps):
        b = 32 + 38 * s_
        div[:, b:b + 32] = erng.integers(0, 256, (rows, 32))
        n = erng.integers(0, 13, rows).astype("<u4")
        n[:32] = (lane[:32] + 3 * s_) % 13
        n[1], n[2], n[3] = caps[s_] + 1, caps[s_] + 2, 2**32 - 3
        n[32] = caps[s_] + 1
        n[64::7] = caps[s_] + 1
        div[:, b + 32:b + 36] = n.view(np.uint8).reshape(rows, 4)
        div[:, b + 36] = erng.integers(0, 2, rows)
        div[:32, b + 36] = (lane[:32] + s_) % 2
        div[:, b + 37] = erng.integers(0, 4, rows) > 0
        div[:32, b + 37] = lane[:32] % 7 != 3
        div[32:64, b + 37] = lane[32:64] == 32
    div_dev = torch.from_numpy(div).to(dev)
    div_want = ps.poh_spans_plain(div_dev, steps, caps)
    g = div_want.cpu().numpy()
    for i in range(rows):
        if bytes(g[i]) != _host_span_row(div[i], steps, caps):
            raise AssertionError(f"phase 15a: the plain version differs from "
                                 f"the host chain on edge lane {i}")
    for n_l in POH_EDGE_LANES:
        got = ps.poh_spans(div_dev[:n_l], steps, caps)
        if not torch.equal(got, div_want[:n_l]):
            raise AssertionError(
                f"phase 15a: {n_l} edge lanes: "
                f"{int((got != div_want[:n_l]).any(1).sum())} lanes differ "
                f"from plain")
        err = max(err, int((got.to(torch.int16) - div_want[:n_l]).abs().max()))
    note(f"phase 15a: the poh_dev window (3 lanes x {2 * K} steps, caps "
         f"{win_caps}) and splice (j = 0..3 of {mb_cap}) geometry == "
         f"host_spans; kernel == plain == host chain there and on 40 rows "
         f"of n == 0, inactive steps, n past the cap; and at "
         f"{', '.join(map(str, POH_EDGE_LANES))} lanes (a pair of warps "
         f"whose lanes diverge, one with only lane 0 active, steps that "
         f"end exactly at their cap); max error {err}")
    out["poh_err"], out["poh_plain_ms"] = err, plain_ms

    # ---- (b) a whole slot at the Solana clock defaults
    n_mix = 7
    n_m = hpt // (n_mix + 1)
    n_t = hpt - n_mix * n_m
    mbs = [_fake_txns(rng, int(w))
           for w in rng.integers(1, 32, tps * n_mix)]
    reset_counts()
    mixins = entry_lib.txn_mixins_device(mbs, pad_width=32, device=device)
    got_b = counts()
    if got_b["mixin_tree"] != 1:
        raise AssertionError(f"phase 15b: mixin launches {got_b}")
    for i, ts in enumerate(mbs):
        if bytes(mixins[i]) != entry_lib.txn_mixin(ts):
            raise AssertionError(f"phase 15b: mixin {i} differs from "
                                 f"txn_mixin")
    sspec, txns_of = [], []
    for t in range(tps):
        for k in range(n_mix):
            sspec.append((n_m, bytes(mixins[t * n_mix + k])))
            txns_of.append(mbs[t * n_mix + k])
        sspec.append((n_t, None))
        txns_of.append([])
    steps_b = len(sspec)
    start = rng.bytes(32)
    caps_b = tuple(n for n, _ in sspec)
    cb = np.zeros((1, pe.row_bytes(steps_b)), np.uint8)
    pe.stamp_lanes(cb, [(start, sspec)])
    chain_dev = torch.from_numpy(cb).to(dev)
    reset_counts()
    ends = ps.poh_spans(chain_dev, steps_b, caps_b).cpu().numpy().reshape(
        steps_b, 32)
    got_b = counts()
    if got_b["poh_spans"] != 1:
        raise AssertionError(f"phase 15b: launches {got_b}")
    entries = [entry_lib.Entry(n, bytes(ends[i]), txns_of[i])
               for i, (n, _) in enumerate(sspec)]
    t0 = time.perf_counter()
    if not entry_lib.verify_chain(start, entries):
        raise AssertionError("phase 15b: the slot's chain does not "
                             "re-verify on the host")
    t_host = time.perf_counter() - t0
    chain_ms = cuda_ms(lambda: ps.poh_spans(chain_dev, steps_b, caps_b),
                       3, 0)
    n_hashes = tps * hpt
    # the re-check of the slot's entries, one corrupted
    starts = np.stack([np.frombuffer(start, np.uint8)]
                      + [ends[i] for i in range(steps_b - 1)])
    nums = np.array(caps_b, np.int32)
    has = np.array([m is not None for _, m in sspec])
    mixarr = np.zeros((steps_b, 32), np.uint8)
    for i, (_, m) in enumerate(sspec):
        if m is not None:
            mixarr[i] = np.frombuffer(m, np.uint8)
    bad = 3 * (n_mix + 1) + 2                  # a mixin entry of tick 3
    txns_bad = [bytearray(t) for t in txns_of[bad]]
    txns_bad[0][5] ^= 1
    mix_bad = mixarr.copy()
    mix_bad[bad] = np.frombuffer(
        entry_lib.txn_mixin([bytes(t) for t in txns_bad]), np.uint8)
    args = [torch.from_numpy(a).to(dev)
            for a in (starts, nums, mixarr, has, ends)]
    args_bad = list(args)
    args_bad[2] = torch.from_numpy(mix_bad).to(dev)
    reset_counts()
    re_ok = poh_lib.entry_verify(*args[:4], args[4], hpt).cpu().numpy()
    re_bad = poh_lib.entry_verify(*args_bad[:4], args_bad[4],
                                  hpt).cpu().numpy()
    got_b = counts()
    bad_entries = list(entries)
    bad_entries[bad] = entry_lib.Entry(entries[bad].num_hashes,
                                       entries[bad].hash,
                                       [bytes(t) for t in txns_bad])
    if not (re_ok.all() and np.flatnonzero(~re_bad).tolist() == [bad]
            and not entry_lib.verify_chain(start, bad_entries)
            and got_b["poh_spans"] == 2):
        raise AssertionError(f"phase 15b: re-check {int(re_ok.sum())} of "
                             f"{steps_b} pass; corrupted: fails at "
                             f"{np.flatnonzero(~re_bad).tolist()}, want "
                             f"[{bad}]; launches {got_b}")
    rc_blob = torch.cat([args[0], args[2],
                         args[1].reshape(-1, 1).view(torch.uint8),
                         args[3].to(torch.uint8).reshape(-1, 1),
                         torch.ones_like(args[3], dtype=torch.uint8
                                         ).reshape(-1, 1)], 1).contiguous()
    rc_ms = cuda_ms(lambda: ps.poh_spans(rc_blob, 1, (hpt,)))
    rc_dev = dev_ms(lambda: ps.poh_spans(rc_blob, 1, (hpt,)),
                    "poh_spans_kernel")
    ve_ms = cuda_ms(lambda: poh_lib.verify_entries(*args[:4], hpt))
    rc_ops = _sha256_ops(nums, has)
    rc_bytes = rc_blob.numel() + steps_b * 32
    # each entry's compressions: n - 1 appends and the last hash, two for
    # a mixin; one lane's are one dependent chain
    comps = np.maximum(nums - 1, 0) + np.where(has, 2, 1)
    rc_cp_ms = int(comps.max()) * 64 * SHA256_ROUND_DEPTH / clock_hz * 1e3
    rc_issue_ms = _sha256_bound_ms(rc_ops, int_ops_per_s)
    # the least time is the larger of the issue bound and the critical
    # path of the longest entry (both count operations); rc_term says
    # which of the two sets it
    rc_bound = max((rc_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                   (max(rc_issue_ms, rc_cp_ms), "operations"))
    rc_term = ("bytes" if rc_bound[1] == "bytes" else
               "critical path" if rc_cp_ms >= rc_issue_ms else "issue")
    # the one-lane chain: its dependent operations at the max SM clock
    n_comp = int(comps.sum())
    cp_ms = n_comp * 64 * SHA256_ROUND_DEPTH / clock_hz * 1e3
    note(f"phase 15b: one lane, a {tps} x {hpt} slot ({n_hashes} hashes, "
         f"{steps_b} entries: {n_mix} mixin entries of {n_m} and a tick "
         f"entry of {n_t} a tick, {len(mbs)} mixins by one mixin-tree "
         f"launch == txn_mixin): verify_chain (hashlib) True in "
         f"{t_host:.3f} s; kernel {chain_ms:.3f} ms = "
         f"{n_hashes / chain_ms * 1e3:.1f} hashes/s "
         f"({clock_hz * chain_ms / 1e3 / n_hashes:.0f} cycles a hash at "
         f"{clock_hz / 1e6:.0f} MHz), the slot "
         f"{chain_ms:.3f} ms against Agave's {AGAVE_SLOT_MS:.0f} ms "
         f"({'fits' if chain_ms <= AGAVE_SLOT_MS else 'does not fit'}); "
         f"critical-path bound {cp_ms:.3f} ms ({n_comp} compressions x 64 "
         f"rounds x {SHA256_ROUND_DEPTH} dependent operations at "
         f"{clock_hz / 1e6:.0f} MHz); an append's least work "
         f"{SHA256_APPEND_OPS[0]} integer-pipe-only and "
         f"{SHA256_APPEND_OPS[1]} add operations, {2 * SHA256_APPEND_OPS[0]}"
         f" cycles a hash at a sub-partition's 16 INT32 lanes")
    note(f"phase 15b: verify_entries re-check of the {steps_b} entries: all "
         f"pass; entry {bad} with one txn byte changed fails alone (and "
         f"verify_chain fails); call {ve_ms:.4f} ms = "
         f"{steps_b / ve_ms * 1e3:.1f} entries/s; the kernel on the built "
         f"blob {rc_ms:.4f} ms, device {rc_dev:.4f} ms, bound "
         f"{rc_bound[0]:.5f} ms ({rc_bound[1]}, set by the {rc_term}: the "
         f"larger of the issue "
         f"bound {rc_issue_ms:.5f} ms, {rc_ops[0]} integer-pipe and "
         f"{rc_ops[1]} add operations, and the critical path "
         f"{rc_cp_ms:.5f} ms, the longest entry's {int(comps.max())} "
         f"compressions x 64 rounds x {SHA256_ROUND_DEPTH} dependent "
         f"operations at {clock_hz / 1e6:.0f} MHz; {rc_bytes} bytes)")
    out.update(chain_ms=chain_ms, chain_hps=n_hashes / chain_ms * 1e3,
               chain_cp_ms=cp_ms, rc_ms=rc_ms, rc_dev=rc_dev,
               rc_bound=rc_bound, rc_term=rc_term, ve_ms=ve_ms,
               rc_entries=steps_b)

    # ---- (c) kernel B against its plain version and txn_mixin
    merr = 0
    batches = [_fake_txns(rng, w) for w in range(1, 34)]
    reset_counts()
    mix33 = entry_lib.txn_mixins_device(batches, pad_batch=40, pad_width=64,
                                        device=device)
    got_c = counts()
    if got_c["mixin_tree"] != 1 or any(
            bytes(mix33[i]) != entry_lib.txn_mixin(ts)
            for i, ts in enumerate(batches)):
        raise AssertionError(f"phase 15c: widths 1-33 differ from "
                             f"txn_mixin (launches {got_c})")

    def sig_planes(bs, B, W):
        sigs = np.zeros((B, W, 64), np.uint8)
        for i, ts in enumerate(bs):
            for j, t in enumerate(ts):
                sigs[i, j] = np.frombuffer(t[1:65], np.uint8)
        w = np.ones(B, np.int32)
        w[:len(bs)] = [len(ts) for ts in bs]
        return torch.from_numpy(sigs).to(dev), torch.from_numpy(w).to(dev)

    tile_mbs = [_fake_txns(rng, 31) for _ in range(8)]
    for bs, B, W in ((batches, 40, 64), (tile_mbs, 8, 32)):
        s_d, w_d = sig_planes(bs, B, W)
        k, p = mt.mixin_tree(s_d, w_d), mt.mixin_tree_plain(s_d, w_d)
        if not torch.equal(k, p):
            raise AssertionError(f"phase 15c: {B} x {W}: kernel differs "
                                 f"from plain")
        merr = max(merr, int((k.to(torch.int16) - p).abs().max()))
    if [bytes(r) for r in k.cpu().numpy()] != [entry_lib.txn_mixin(ts)
                                               for ts in tile_mbs]:
        raise AssertionError("phase 15c: 8 x 31 differs from txn_mixin")
    # W 1,024: two full trees, then widths past the half and past W
    for ws in ([1024, 1024], [513, 777, 1023, 2000]):
        s_w = torch.from_numpy(rng.integers(0, 256, (len(ws), 1024, 64),
                                            np.uint8)).to(dev)
        w_w = torch.tensor(ws, dtype=torch.int32, device=dev)
        k_w, p_w = mt.mixin_tree(s_w, w_w), mt.mixin_tree_plain(s_w, w_w)
        if not torch.equal(k_w, p_w):
            raise AssertionError(f"phase 15c: W 1024, widths {ws}: kernel "
                                 f"differs from plain")
        merr = max(merr, int((k_w.to(torch.int16) - p_w).abs().max()))
    m_ms = cuda_ms(lambda: mt.mixin_tree(s_d, w_d))
    m_dev = dev_ms(lambda: mt.mixin_tree(s_d, w_d), "mixin_tree_kernel")
    m_plain = cuda_ms(lambda: mt.mixin_tree_plain(s_d, w_d), PLAIN_RUNS, 1)
    m_ops = tuple(x * _tree_hashes([31] * 8) for x in SHA256_NODE_OPS)
    m_bytes = 8 * 32 * 64 + 8 * 4 + 8 * 32
    # a tree of 31 leaves is 6 nodes in series, each two compressions
    m_levels = 1 + math.ceil(math.log2(31))
    m_cp = m_levels * 2 * 64 * SHA256_ROUND_DEPTH / clock_hz * 1e3
    m_bound = max((m_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                  (_sha256_bound_ms(m_ops, int_ops_per_s), "operations"),
                  (m_cp, "operations"))
    note(f"phase 15c: mixin tree: widths 1-33 (padded to 40 x 64) == "
         f"txn_mixin in one launch; kernel == plain at 40 x 64, at 2 x "
         f"1024, at widths 513, 777, 1023 and 2000 of W 1024 and at the "
         f"tile's 8 x 31 (W 32), == txn_mixin; 8 x 31: kernel "
         f"{m_ms:.5f} ms, device {m_dev:.5f} ms, plain {m_plain:.4f} ms, "
         f"bound {m_bound[0]:.6f} ms (the largest of bytes "
         f"{m_bytes / HBM_BYTES_PER_S * 1e3:.6f}, issue "
         f"{_sha256_bound_ms(m_ops, int_ops_per_s):.6f} and the critical "
         f"path, {m_levels} nodes x 2 compressions x 64 rounds x "
         f"{SHA256_ROUND_DEPTH} dependent operations at "
         f"{clock_hz / 1e6:.0f} MHz, {m_cp:.6f}); max error {merr}")
    out.update(m_err=merr, m_ms=m_ms, m_dev=m_dev, m_plain=m_plain,
               m_bound=m_bound)

    old_env = {k: os.environ.get(k)
               for k in ("OMP_NUM_THREADS", "FDTPU_DRAIN_DIR")}
    os.environ["OMP_NUM_THREADS"] = "1"
    # each tile's drain manifest; poh_dev's records its kernel launches
    # since its boot ended
    os.environ["FDTPU_DRAIN_DIR"] = str(workdir / "drain")
    try:
        # ---- (d) leader-bench in processes at the [leader] defaults
        cfg = app_config.load(environ={})
        cfg["name"] = f"{tag}l"
        cfg["topology"] = "leader-bench"
        cfg["development"]["source_count"] = n_src
        cfg["tiles"]["verify"]["device"] = device or ""
        cfg["leader"]["device"] = device or ""
        cfg["leader"]["capture_path"] = str(workdir / "entries.cap")
        cfg["supervision"]["drain_timeout_s"] = 120.0
        spec = app_config.build_topology(cfg)
        # a second in-link into the verify tile, written by hand: valid
        # txns of another stream and forged ones (a signature bit flipped)
        spec = dc_.replace(
            spec, links=spec.links + (topo_mod.LinkSpec("inj_verify", 256,
                                                        1280),),
            tiles=(topo_mod.TileSpec("inj", "sink", (), ("inj_verify",),
                                     {}),)
            + tuple(dc_.replace(t, in_links=t.in_links
                                + (topo_mod.InLink("inj_verify"),))
                    if t.kind == "verify" else t
                    for t in spec.tiles)).validate()
        _shm_check(spec.wksp_mb << 20, note)
        seed = cfg["development"]["bench_seed"]
        step = -(-n_src // 16)
        src_w = pool.starmap_async(_stream_part, [
            (seed, 4, lo, min(lo + step, n_src))
            for lo in range(0, n_src, step)])
        foreign = [w for _, w in _stream_part(7, 4, 0, n_foreign)]
        forged = []
        for _, w in _stream_part(8, 4, 0, n_forged):
            b = bytearray(w)
            b[1 + 40] ^= 1
            forged.append(bytes(b))
        inj = foreign + forged
        inj = [inj[i] for i in rng.permutation(len(inj))]
        t0 = time.perf_counter()
        run = TopoRun(spec, policy=SupervisionPolicy.from_cfg(cfg))
        try:
            run.wait_ready(timeout=cfg["supervision"]["boot_grace_s"])
            t_boot = time.perf_counter() - t0
            lnk = run.jt.links["inj_verify"]
            lens = np.array([len(w) for w in inj], np.int32)
            offs = np.zeros(len(inj), np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            sigs = np.array([int.from_bytes(w[1:9], "little")
                             & ((1 << 63) - 1) for w in inj], np.uint64)
            tx_burst(lnk.mcache, lnk.dcache, lnk.dcache.chunk0,
                     b"".join(inj), offs, lens, sigs)
            lnk = None
            want = sorted([w for part in src_w.get(600) for _, w in part]
                          + foreign)
            t0 = time.perf_counter()

            def mixed():
                pm, dm = run.metrics("leader_pack"), run.metrics("poh_dev")
                return (pm["sched_txn_cnt"] == len(want)
                        and dm["mixin_cnt"] == pm["microblock_cnt"])

            _wait_for(mixed, 600, "every valid txn mixed into the chain", run)
            t_d = time.perf_counter() - t0
            if not run.drain():
                raise AssertionError("phase 15d: drain() did not drain "
                                     "every tile")
            v, pm = run.metrics("verify:0"), run.metrics("leader_pack")
            guard_clean(v, "phase 15d")
            pd = run.metrics("poh_dev")
            # the tile's launches and dispatches when it ran dry (the
            # halt's fini dispatches after it)
            st_d = run._load_drain_manifest("poh_dev")["tile_state"]
            got_d = st_d["launches"]
        finally:
            run.close()
        if set(run.exitcodes.values()) != {0}:
            raise AssertionError(f"phase 15d: exit codes {run.exitcodes}")
        recs = read_capture(str(workdir / "entries.cap"))
        ents = [entry_lib.Entry.deserialize(p)[0] for _, p in recs]
        got_txns = sorted(t for e in ents for t in e.txns)
        done_bit = PohDevTile.SLOT_DONE_BIT
        slots = [s & ~done_bit for s, _ in recs]
        # the done bit marks each slot's last entry; the sink may halt
        # before the slot that fini closes reaches it
        done_ok = all(bool(s & done_bit) == (slots[i + 1] != slots[i])
                      for i, (s, _) in enumerate(recs[:-1]))
        host_ok = []
        for w in inj:
            t = txn_lib.parse(w)
            host_ok.append(all(
                ed.verify_one_host(s, t.message(w), k)
                for s, k in zip(t.signatures(w), t.signer_pubkeys(w))))
        if not (entry_lib.verify_chain(bytes(32), ents)
                and got_txns == want and done_ok
                and sum(host_ok) == n_foreign
                and pd["recheck_fail_cnt"] == 0 and pd["recheck_ok_cnt"] > 0
                and pd["parse_fail_cnt"] == 0 and v["torn_drop_cnt"] == 0
                and v["compile_cnt"] == 0
                and v["verify_fail_cnt"] == n_forged
                and st_d["splice_dispatch_cnt"] > 0
                and got_d["poh_spans"] == (st_d["dispatch_cnt"]
                                           + st_d["splice_dispatch_cnt"])
                and got_d["mixin_tree"] == st_d["splice_dispatch_cnt"]):
            raise AssertionError(
                f"phase 15d: chain {entry_lib.verify_chain(bytes(32), ents)}"
                f", {len(got_txns)} txns in the entries of {len(want)} "
                f"valid, slot_done {done_ok}, host {sum(host_ok)}, verify "
                f"{v}, poh_dev {pd}, at the drain {st_d}")
        note(f"phase 15d: leader-bench in processes at the [leader] "
             f"defaults: {n_src} source txns + {n_foreign} valid and "
             f"{n_forged} forged injected; {len(ents)} entries re-verify "
             f"from the seed (verify_chain), each of the {len(want)} valid "
             f"txns once in {pm['microblock_cnt']} microblocks, no forged "
             f"one (verify_fail {v['verify_fail_cnt']}); SLOT_DONE_BIT on "
             f"each slot's last entry; torn {v['torn_drop_cnt']}, compile "
             f"{v['compile_cnt']}, recheck ok {pd['recheck_ok_cnt']} fail "
             f"{pd['recheck_fail_cnt']}; spec_hit {pd['spec_hit_cnt']}, "
             f"spec_miss {pd['spec_miss_cnt']}, rehash {pd['rehash_cnt']}, "
             f"dispatch {pd['dispatch_cnt']}, splice "
             f"{pd['splice_dispatch_cnt']}; launches from boot to the "
             f"drain in the tile's process (its drain manifest) "
             f"{{poh_spans: {got_d['poh_spans']}, mixin_tree: "
             f"{got_d['mixin_tree']}}} == dispatch + splice "
             f"({st_d['dispatch_cnt']} + {st_d['splice_dispatch_cnt']}) and "
             f"splice then; "
             f"drain() True; every tile exited 0; boot {t_boot:.3f} s; "
             f"{len(want) / t_d:.1f} txns/s into the chain ({t_d:.3f} s, "
             f"the source signs on the host)")

        # ---- (e) the poh_dev tile at hpt x tps in process under the Mux
        mtu_mb = 4 + 31 * (4 + 1280)
        mtu_e = 48 + 32 * (4 + 1280)
        spec = (topo_mod.TopoBuilder(f"{tag}e", wksp_mb=64)
                .link("p_d", depth=256, mtu=mtu_mb)
                .link("d_s", depth=1024, mtu=mtu_e)
                .tile("src", "sink", outs=["p_d"])
                .tile("poh", "poh_dev", ins=["p_d"], outs=["d_s"],
                      hashes_per_tick=hpt, ticks_per_slot=tps,
                      device=device)
                .tile("s", "sink", ins=[topo_mod.InLink("d_s",
                                                       reliable=False)])
                .build())
        _shm_check(spec.wksp_mb << 20, note)
        e_in = [_fake_txns(rng, int(w)) for w in rng.integers(1, 32, e_mbs)]
        jt = topo_mod.create(spec)
        tile, run_err, timed = PohDevTile(), [], None
        try:
            lnk = jt.links["p_d"]
            chunk = lnk.dcache.chunk0
            for ts in e_in:
                f = entry_lib.serialize_txn_batch(ts)
                nxt = lnk.dcache.write(chunk, f)
                lnk.mcache.publish(0, chunk, len(f))
                chunk = nxt
            lnk = None
            mux = Mux(jt, "poh", tile)
            mux.HOUSE_NS = 1_000_000

            def run_mux():
                try:
                    mux.run()
                except BaseException as e:  # re-raised below
                    run_err.append(e)

            th = threading.Thread(target=run_mux, daemon=True)
            timed = _LaunchTimer(torch, {"poh_spans": ps,
                                         "mixin_tree": mt})
            reset_counts()
            th.start()
            cnc = jt.cnc["poh"]
            _wait_for(lambda: cnc.signal_query() == Cnc.SIGNAL_RUN
                      or run_err, 300, "the poh_dev tile's boot")
            t0 = time.perf_counter()
            _wait_for(lambda: tile.slot > 1 or run_err, 600,
                      "the first slot")
            t_close = time.perf_counter()
            t_slot = t_close - t0
            # the dispatches by the slot's close (read within the wait's
            # poll; the halt and fini dispatch again)
            at_close = jt.metrics["poh"].snapshot()
            cnc.signal(Cnc.SIGNAL_HALT)
            th.join(120)
            if th.is_alive() or run_err:
                raise AssertionError(f"phase 15e: the tile did not halt "
                                     f"cleanly: {run_err}")
            got_e = counts()
            torch.cuda.synchronize(dev)
            slot_dev = timed.device_ms(t0, t_close)
            lnk = jt.links["d_s"]
            recs = []
            for seq in range(lnk.mcache.seq0(), lnk.mcache.seq_query()):
                rc, m = lnk.mcache.query(seq)
                if rc != 0:
                    raise AssertionError("phase 15e: an entry frag was "
                                         "overrun before it was read")
                recs.append((int(m["sig"]), lnk.dcache.read(
                    int(m["chunk"]), int(m["sz"]))))
            lnk = None
            snap = jt.metrics["poh"].snapshot()
            mux = None
            import gc
            gc.collect()
        finally:
            if timed is not None:
                timed.restore()
            jt.close()
            jt.unlink()
        ents = [entry_lib.Entry.deserialize(p)[0] for _, p in recs]
        t0 = time.perf_counter()
        chain_ok = entry_lib.verify_chain(bytes(32), ents)
        t_ver = time.perf_counter() - t0
        slot1 = [e for (s, _), e in zip(recs, ents)
                 if s & ~PohDevTile.SLOT_DONE_BIT == 1]
        mixed_e = [e.txns for e in ents if e.txns]
        if not (chain_ok and mixed_e == e_in
                and sum(e.num_hashes for e in slot1) == hpt * tps
                and recs[len(slot1) - 1][0] & PohDevTile.SLOT_DONE_BIT
                and snap["recheck_fail_cnt"] == 0
                and got_e["poh_spans"] >= 1 and got_e["mixin_tree"] >= 1):
            raise AssertionError(
                f"phase 15e: chain {chain_ok}, {len(mixed_e)} of {e_mbs} "
                f"microblocks in order {mixed_e == e_in}, slot 1 "
                f"{sum(e.num_hashes for e in slot1)} hashes, metrics {snap},"
                f" launches {got_e}")
        # what the slot cost the chain lane: each window dispatch
        # pre-hashes K whole ticks, each splice re-hashes a tick's mixin
        # region (mb_cap + 1 hashes); and the device time of the kernels
        # launched from RUN to the slot's close, by CUDA events around
        # each launch on its stream
        chain_hashes = (at_close["dispatch_cnt"] * tile.K * hpt
                        + at_close["splice_dispatch_cnt"] * (tile.mb_cap + 1))
        kern_ms = sum(ms for ms, _ in slot_dev.values())
        share = kern_ms / (t_slot * 1e3)
        note(f"phase 15e: poh_dev at {hpt} x {tps} under the port's Mux in "
             f"process (house every 1 ms), {e_mbs} microblocks fed before "
             f"RUN: slot 1 closed {t_slot:.3f} s after RUN "
             f"({len(slot1)} entries, {hpt * tps} hashes; Agave's slot "
             f"{AGAVE_SLOT_MS:.0f} ms; a finding, not a gate); by then "
             f"{at_close['dispatch_cnt']} windows x K {tile.K} x {hpt} + "
             f"{at_close['splice_dispatch_cnt']} splices x "
             f"{tile.mb_cap + 1} = {chain_hashes} chain-lane hashes, "
             f"{chain_hashes / (hpt * tps):.3f}x the slot's {hpt * tps}; "
             f"device time from RUN to the close (CUDA events around each "
             f"launch): poh_spans {slot_dev['poh_spans'][0]:.3f} ms in "
             f"{slot_dev['poh_spans'][1]} launches "
             f"({chain_hashes / slot_dev['poh_spans'][0] * 1e3:.1f} "
             f"chain-lane hashes a second of it, 15b's one lane "
             f"{out['chain_hps']:.1f}), mixin_tree "
             f"{slot_dev['mixin_tree'][0]:.3f} ms in "
             f"{slot_dev['mixin_tree'][1]}, together {share:.4f} of the "
             f"slot's wall time (a measurement, not a gate); "
             f"{len(ents)} entries re-verify (verify_chain, {t_ver:.3f} s), "
             f"the microblocks in order; spec_hit {snap['spec_hit_cnt']}, "
             f"spec_miss {snap['spec_miss_cnt']}, rehash "
             f"{snap['rehash_cnt']}, dispatch {snap['dispatch_cnt']}, "
             f"splice {snap['splice_dispatch_cnt']}, recheck ok "
             f"{snap['recheck_ok_cnt']} fail {snap['recheck_fail_cnt']}; "
             f"launches {{poh_spans: {got_e['poh_spans']}, mixin_tree: "
             f"{got_e['mixin_tree']}}}")
        out.update(launches=got_e, t_slot=t_slot, slot_hashes=chain_hashes,
                   slot_kernel_ms=kern_ms, slot_kernel_share=share)
    finally:
        for k, val in old_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    note(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---- phase 16: the turbine shred lane ---------------------------------

# the JAX defaults: [tiles.shred] sig_batch, [tiles.shred_recover] 32 data
# + 32 code shreds a set and 8 sets a dispatch; a 32:32 set's proof is 6
# nodes, so its protected span is 1139 - 20 * 6 bytes
SHRED_K, SHRED_SZ, SHRED_BATCH_SETS, SIG_BATCH = 32, 1019, 8, 32
LEAF_MAXLEN, PROOF_DEPTH = 1228 - 64, 15
INT8_TENSOR_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core peak
LEADER_SEED = bytes(range(32))
OTHER_SEED = bytes(range(1, 33))
# leaf lengths whose 26 + len sit on each SHA-256 padding edge (mod 64 =
# 55, 56, 63, 0), the empty leaf and the longest
WALK_EDGE_LENS = (0, 1, 29, 30, 37, 38, 93, 94, 101, 102, LEAF_MAXLEN)


def shred_keys() -> dict:
    """The lane's identities: the slot leader (the one staked node), this
    validator and one turbine child (both unstaked)."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    return {"leader": ed.keypair_from_seed(LEADER_SEED)[0],
            "other": ed.keypair_from_seed(OTHER_SEED)[0],
            "me": ed.keypair_from_seed(bytes([7]) * 32)[0],
            "child": ed.keypair_from_seed(bytes([9]) * 32)[0]}


def fec_set(entry, slot, fec_idx, k, done=False, device=None):
    """One signed k:k merkle FEC set of the leader (make_fec_set; its
    parity on the GF(2) kernel on `device`)."""
    from firedancer_tpu_torch.ballet import shred as sl
    from firedancer_tpu_torch.ops import ed25519 as ed
    return sl.make_fec_set(entry, slot, 1, 1, fec_idx,
                           lambda root: ed.sign(LEADER_SEED, root),
                           data_cnt=k, code_cnt=k, slot_complete=done,
                           torch_device=device)


def corrupt_set(entry, slot, fec_idx, k, device=None) -> list:
    """A leader-signed set whose parity disagrees with its data: code
    shred 0 has a parity byte flipped and the last data shred carries no
    DATA_COMPLETE flag, so all k data shreds and code shred 0 are present
    when a resolver first finds the set ready, and its survivors
    disagree.  Returns the 2k raw shreds."""
    from firedancer_tpu_torch.ballet import bmtree
    from firedancer_tpu_torch.ballet import shred as sl
    from firedancer_tpu_torch.ops import ed25519 as ed
    fs = fec_set(entry, slot, fec_idx, k, device=device)
    plen = sl.parse(fs.data_shreds[0]).merkle_proof_len
    bodies = [bytearray(r[64:len(r) - 20 * plen])
              for r in fs.data_shreds + fs.code_shreds]
    bodies[k - 1][0x55 - 64] &= ~(sl.FLAG_DATA_COMPLETE
                                  | sl.FLAG_SLOT_COMPLETE) & 0xFF
    bodies[k][sl.CODE_HEADER_SZ - 64 + 10] ^= 0x5A
    leaves = [bytes(b) for b in bodies]
    levels = bmtree.np_tree(leaves, node_sz=20,
                            leaf_prefix=bmtree.LEAF_PREFIX_LONG,
                            node_prefix=bmtree.NODE_PREFIX_LONG)
    sig = ed.sign(LEADER_SEED, sl.walk_merkle_root(
        leaves[0], 0, bmtree.np_proof(levels, 0)))
    return [sig + b + b"".join(bmtree.np_proof(levels, i))
            for i, b in enumerate(leaves)]


def forge(raw: bytes) -> bytes:
    """A shred with one signature bit flipped."""
    b = bytearray(raw)
    b[10] ^= 1
    return bytes(b)


def legacy_shred(slot: int) -> bytes:
    """A legacy data shred: it parses and has no merkle root."""
    from firedancer_tpu_torch.ballet import shred as sl
    b = bytearray(sl.DATA_HEADER_SZ + 16)
    b[0x40] = sl.TYPE_LEGACY_DATA | 0x05
    b[0x41:0x49] = slot.to_bytes(8, "little")
    b[0x53:0x55] = (1).to_bytes(2, "little")
    b[0x56:0x58] = len(b).to_bytes(2, "little")
    return bytes(b)


def lane_stream(slot, nsets, k, n_forged, burst, seed, device=None,
                live_corrupt=False):
    """A slot as turbine delivers it: nsets signed k:k sets (the last
    with SLOT_COMPLETE), set i with 1 + 3i mod (k - 1) data shreds erased
    (never the last, which carries DATA_COMPLETE) and delivered data
    first, then code; a corrupt set (corrupt_set) of the slot before,
    delivered after them (data, then code shred 0); with live_corrupt,
    one more of the slot after, delivered the same way, which a store
    keeping one slot takes in; then at least n_forged forged copies of
    shreds that were not delivered (a forged copy of a delivered shred
    would be dropped as a duplicate unverified), as many as make the
    count a multiple of burst.  Returns (frags, the entry batches, the
    delivered valid shreds, the forged count)."""
    rng = np.random.default_rng(seed)
    frags, entries, spare = [], [], []
    for i in range(nsets):
        entry = rng.integers(0, 256, 950 * k + 97 * i, np.uint8).tobytes()
        entries.append(entry)
        fs = fec_set(entry, slot, i * k, k, done=i == nsets - 1,
                     device=device)
        erased = set(rng.choice(k - 1, 1 + (3 * i) % (k - 1),
                                replace=False).tolist())
        frags += [r for j, r in enumerate(fs.data_shreds)
                  if j not in erased] + fs.code_shreds
        spare += [fs.data_shreds[j] for j in sorted(erased)]
    for bad_slot in (slot - 1, slot + 1)[:1 + live_corrupt]:
        bad = corrupt_set(b"c" * 900 * k, bad_slot, 0, k, device=device)
        frags += bad[:k + 1]
        spare += bad[k + 1:]
    valid = list(frags)
    n_forged += -(len(frags) + n_forged) % burst
    frags += [forge(spare[int(j)]) for j in
              rng.choice(len(spare), n_forged, replace=False)]
    return frags, entries, valid, n_forged


def turbine_cfg(keys: dict, child_port: int, spe: int = 432_000) -> dict:
    """The shred tile's [turbine] table: the leader staked, this node
    and a child unstaked, the child's contact on the loopback."""
    return {"identity": keys["me"].hex(), "fanout": 200, "port": 0,
            "slots_per_epoch": spe,
            "stakes": {keys["leader"].hex(): [1000, "", 0],
                       keys["me"].hex(): [0, "", 0],
                       keys["child"].hex(): [0, "127.0.0.1", child_port]}}


def _recover_gfmat(k: int, n: int, use: tuple) -> bytes:
    """A pattern's reconstruction matrix, N x K bytes (pool worker)."""
    from firedancer_tpu_torch.ballet import reedsol as rs
    return rs._recover_matrices(k, n, use)


def _walk_rows(shreds):
    """batch_walk_roots' inputs for parsed shreds, as the batcher builds
    them."""
    B = len(shreds)
    leaf = np.zeros((B, LEAF_MAXLEN), np.uint8)
    proofs = np.zeros((B, PROOF_DEPTH, 20), np.uint8)
    lens, idxs, depths = (np.zeros(B, np.int32) for _ in range(3))
    for j, s in enumerate(shreds):
        ld = s.merkle_leaf_data()
        leaf[j, :len(ld)] = np.frombuffer(ld, np.uint8)
        lens[j], idxs[j], depths[j] = len(ld), s.tree_index(), \
            s.merkle_proof_len
        for d, node in enumerate(s.proof_nodes()):
            proofs[j, d] = np.frombuffer(node, np.uint8)
    return leaf, lens, idxs, proofs, depths


def _walk_ops(lens, depths) -> tuple:
    """32-bit operations (integer-pipe-only, adds) of merkle walks by
    _compress_ops, and the longest lane's compressions: a leaf's blocks
    (the first from H0, its 6 prefix words constant; the last with a
    constant bit length), then each level's two blocks (the node prefix
    constant; the second block's first word variable)."""
    node = _ops_sum((10, 0), _compress_ops(False, [False] * 6 + [True] * 10),
                    _compress_ops(True, [True] + [False] * 15))
    ops, longest = (0, 0), 0
    for ln, d in zip(lens, depths):
        nb = (26 + int(ln) + 9 + 63) // 64
        for blk in range(nb):
            w = [True] * 16
            if blk == 0:
                w[:6] = [False] * 6
            if blk == nb - 1:
                w[14:] = [False, False]
            ops = _ops_sum(ops, _compress_ops(blk > 0, w))
        ops = _ops_sum(ops, *([node] * int(d)))
        longest = max(longest, nb + 2 * int(d))
    return ops, longest


def shred_phase(pool, reset_counts, counts, note, cuda_ms, int_ops_per_s,
                clock_hz, device=None, n_sets=32,
                lane_sets=8, big_lanes=4096, workdir=None):
    """Phase 16: the turbine shred lane at the JAX defaults.  (a) The
    GF(2) kernel on bench.py::measure_shred_recover's ragged-erasure
    32:32 sets (i % 32 erasures), 8 a dispatch, against its plain version
    and the codewords, also cut to 1, 127 and 129 bytes across the
    kernel's column tiles; one corrupted survivor; mixed geometry with
    padding, k = 1 and the protocol limit 67:67 through recover_batch
    against the host model; encode at 32:32.  (b) The merkle walk kernel
    on the 64 shreds of a signed 32:32 set against its plain version,
    np_batch_walk_roots and the signed root, and on ragged lanes (depths
    0-15, leaf lengths on the padding edges) at 1, 31, 32, 33 and
    big_lanes lanes.  (c) _ShredSigBatcher "device" against "host" on one
    32-shred burst of valid, forged, wrong-leader, unknown-leader, legacy
    and duplicate shreds.  (d) shred -> store and shred -> shred_recover
    -> sink in spawned processes, a slot of lane_sets sets with a
    corrupted set in the slot before and one in the live slot after (the
    store drops it, counts it once and exits 0) and forged shreds
    published into the shred tile's net in-link, the retransmits
    received by a child socket.  Each path runs
    with the launch counts set to 0 just before it.  A kernel's device ms
    is CUDA events around each of its launches (_launch_ms), as 15e
    times its kernels.  device None is the card.  Returns the numbers of
    the kernels record.  Raises on any failed check."""
    import tempfile

    import torch

    from firedancer_tpu_torch.ballet import reedsol as rs
    from firedancer_tpu_torch.ballet import shred as sl
    from firedancer_tpu_torch.ballet import bmtree
    from firedancer_tpu_torch.disco import shred_dest as sd_mod
    from firedancer_tpu_torch.disco import shred_tiles as st
    from firedancer_tpu_torch.disco import topo as topo_mod
    from firedancer_tpu_torch.disco.run import SupervisionPolicy, TopoRun
    from firedancer_tpu_torch.disco.tiles import read_capture
    from firedancer_tpu_torch.flamenco.leaders import leader_schedule
    from firedancer_tpu_torch.ops import bmtree_walk as bw
    from firedancer_tpu_torch.ops import gf2_recover as gf2
    from firedancer_tpu_torch.tango.ring import tx_burst
    from firedancer_tpu_torch.waltz.udpsock import UdpSock

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    tag = f"cs{os.getpid()}"
    t_phase = time.perf_counter()
    workdir = Path(workdir or tempfile.mkdtemp(prefix="fdtpu_phase16_"))
    rng = np.random.default_rng(1600)
    keys = shred_keys()
    out = {}
    k, n, sz = SHRED_K, 2 * SHRED_K, SHRED_SZ

    # ---- (a) kernel C: 32 ragged-erasure sets, 8 a dispatch
    data = [rng.integers(0, 256, (k, sz), np.uint8) for _ in range(n_sets)]
    reset_counts()
    parity = [rs.encode(d, k, torch_device=device) for d in data]
    got = counts()
    if got["gf2_recover"] != n_sets or not np.array_equal(
            parity[0], rs.encode(data[0], k, device=False)):
        raise AssertionError(f"phase 16a: encode at 32:32 differs from the "
                             f"host model (launches {got})")
    full = [np.vstack([d, p]) for d, p in zip(data, parity)]
    sets = []
    for i, cw in enumerate(full):
        shreds = [cw[j] for j in range(n)]
        for e in range(i % k):
            shreds[(3 * e + i) % n] = None
        sets.append((shreds, k, sz))
    uses = [tuple([j for j, s in enumerate(sh) if s is not None][:k])
            for sh, _, _ in sets]
    gms = pool.starmap(_recover_gfmat, [(k, n, u) for u in uses])
    row = rs.recover_blob_row_bytes(k, n, sz)
    blobs, gfmats = [], []
    for g in range(0, n_sets, SHRED_BATCH_SETS):
        blob = np.zeros((SHRED_BATCH_SETS, row), np.uint8)
        gm = np.zeros((SHRED_BATCH_SETS, n, k), np.uint8)
        for r in range(SHRED_BATCH_SETS):
            shreds = sets[g + r][0]
            for c, j in enumerate(uses[g + r]):
                blob[r, c * sz:(c + 1) * sz] = shreds[j]
            for j, s in enumerate(shreds):
                if s is not None:
                    blob[r, (k + j) * sz:(k + j + 1) * sz] = s
                    blob[r, (k + n) * sz + j] = 1
            gm[r] = np.frombuffer(gms[g + r], np.uint8).reshape(n, k)
        blobs.append(torch.from_numpy(blob).to(dev))
        gfmats.append(torch.from_numpy(gm).to(dev))
    reset_counts()
    verdicts = [gf2.recover_blob(b, m, k, n, sz)
                for b, m in zip(blobs, gfmats)]
    got = counts()
    c_err = 0
    for g, (v, b, m) in enumerate(zip(verdicts, blobs, gfmats)):
        p = gf2.recover_blob_plain(b, m, k, n, sz)
        if not torch.equal(v, p):
            raise AssertionError(f"phase 16a: dispatch {g}: kernel differs "
                                 f"from plain")
        c_err = max(c_err, int((v.to(torch.int16) - p).abs().max()))
        vh = v.cpu().numpy()
        for r in range(SHRED_BATCH_SETS):
            if not (vh[r, -1] == 1 and np.array_equal(
                    vh[r, :-1].reshape(n, sz), full[g * SHRED_BATCH_SETS
                                                    + r])):
                raise AssertionError(f"phase 16a: set {g * 8 + r} did not "
                                     f"recover its codeword")
    if got["gf2_recover"] != len(blobs):
        raise AssertionError(f"phase 16a: launches {got}")
    # one corrupted survivor: that set's flag alone drops
    bad = blobs[0].clone()
    j = uses[3][-1]
    bad[3, (k + j) * sz + 17] ^= 0x08
    ok = gf2.recover_blob(bad, gfmats[0], k, n, sz)[:, -1].cpu().tolist()
    if ok != [1, 1, 1, 0, 1, 1, 1, 1] or not torch.equal(
            gf2.recover_blob(bad, gfmats[0], k, n, sz),
            gf2.recover_blob_plain(bad, gfmats[0], k, n, sz)):
        raise AssertionError(f"phase 16a: corrupted survivor: flags {ok}")
    # set widths across the kernel's column tiles (64 bytes a block): 1,
    # 127 and 129 bytes, the first 8 patterns, one launch a width
    for s_e in (1, 127, 129):
        cws = [np.vstack([d[:, :s_e], rs.encode(d[:, :s_e], k,
                                                 device=False)])
               for d in data[:SHRED_BATCH_SETS]]
        surv_e = torch.from_numpy(np.stack([cw[list(u)] for cw, u in
                                            zip(cws, uses)])).to(dev)
        ref_e = torch.from_numpy(np.stack(cws)).to(dev)
        have_e = torch.zeros((SHRED_BATCH_SETS, n), dtype=torch.bool)
        for r, u in enumerate(uses[:SHRED_BATCH_SETS]):
            have_e[r, [j for j, s in enumerate(sets[r][0])
                       if s is not None]] = True
        have_e = have_e.to(dev)
        reset_counts()
        f_e, ok_e = gf2.gf2_recover(surv_e, gfmats[0], ref_e, have_e)
        if counts()["gf2_recover"] != 1:
            raise AssertionError(f"phase 16a: S {s_e}: launches {counts()}")
        pf_e, pok_e = gf2.gf2_recover_plain(surv_e, gfmats[0], ref_e,
                                            have_e)
        if not (torch.equal(f_e, pf_e) and torch.equal(ok_e, pok_e)
                and torch.equal(f_e, ref_e) and bool(ok_e.all())):
            raise AssertionError(f"phase 16a: S {s_e}: kernel differs from "
                                 f"plain or the codewords")
        c_err = max(c_err, int((f_e.to(torch.int16) - pf_e).abs().max()))
    # mixed geometry with padding (8:8, 3:5 and 1:1 beside a 32:32 set,
    # at sizes 1059, 33 and 1019) and the protocol limit 67:67, through
    # recover_batch against the host model
    small = []
    for kk, pp, ss, drop in ((8, 8, 1059, (0, 3, 9)), (3, 5, 33, (0, 4)),
                             (1, 1, sz, (0,))):
        d = rng.integers(0, 256, (kk, ss), np.uint8)
        cw = np.vstack([d, rs.encode(d, pp, device=False)])
        small.append(([None if j in drop else cw[j]
                       for j in range(kk + pp)], kk, ss))
    d67 = rng.integers(0, 256, (67, 64), np.uint8)
    cw67 = np.vstack([d67, rs.encode(d67, 67, torch_device=device)])
    lim = ([None if j in (70, 99, 133) else cw67[j] for j in range(134)],
           67, 64)
    mixed = [sets[0], small[0], small[1], small[2], lim]
    reset_counts()
    got_m = rs.recover_batch(mixed, torch_device=device)
    launched = counts()["gf2_recover"]
    want_m = rs.recover_batch(mixed, device=False)
    for i, (a, b) in enumerate(zip(got_m, want_m)):
        if isinstance(a, ValueError) or not all(
                np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"phase 16a: mixed set {i}: {a!r:.80}")
    if launched != 1:
        raise AssertionError(f"phase 16a: recover_batch launched {launched}")
    # the timed shape: one dispatch of 8 sets
    b0, m0 = blobs[0], gfmats[0]
    c_ms = cuda_ms(lambda: gf2.recover_blob(b0, m0, k, n, sz))
    c_dev = _launch_ms(torch, gf2, "gf2_recover",
                       lambda: gf2.recover_blob(b0, m0, k, n, sz))
    if device is None and not (c_dev or 0) > 0:
        raise AssertionError(f"phase 16a: gf2_recover device ms {c_dev}")
    c_plain = cuda_ms(lambda: gf2.recover_blob_plain(b0, m0, k, n, sz),
                      PLAIN_RUNS, 1)
    # the library yardstick: the product alone as one fp16 torch.bmm of
    # the expanded bit-matrices (0/1 entries, sums <= 8 * 67, exact in
    # fp16), on the unpacked survivors
    surv = b0[:, :k * sz].reshape(SHRED_BATCH_SETS, k, sz)
    bits16, bm16 = gf2._unpack(surv).half(), gf2.bitmatrix_plain(m0).half()
    prod = (torch.bmm(bm16, bits16).to(torch.int64) & 1).reshape(
        SHRED_BATCH_SETS, n, 8, sz)
    sh8 = torch.arange(8, device=dev)[None, None, :, None]
    if not torch.equal((prod << sh8).sum(2).to(torch.uint8).reshape(
            SHRED_BATCH_SETS, -1), verdicts[0][:, :-1]):
        raise AssertionError("phase 16a: the fp16 torch.bmm product differs")
    c_lib = cuda_ms(lambda: torch.bmm(bm16, bits16))
    c_bytes = b0.numel() + m0.numel() + SHRED_BATCH_SETS * (n * sz + 1)
    c_ops = 2 * SHRED_BATCH_SETS * 8 * n * 8 * k * sz
    c_bound = max((c_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                  (c_ops / INT8_TENSOR_OPS_PER_S * 1e3, "operations"))
    note(f"phase 16a: gf2_recover: {n_sets} ragged-erasure 32:32 sets (i % "
         f"32 erasures) in {len(blobs)} dispatches of {SHRED_BATCH_SETS} == "
         f"plain == the codewords, ok all 1, also at 1, 127 and 129 bytes; "
         f"encode 32:32 == host model; a "
         f"corrupted survivor drops its set's flag alone; mixed geometry "
         f"with padding, k = 1 and 67:67 through recover_batch == host "
         f"model in 1 launch; {SHRED_BATCH_SETS} x 32:32 x {sz}: call "
         f"{c_ms:.5f} ms, device {_ms_text(c_dev)} (CUDA events around "
         f"each launch), plain {c_plain:.4f} ms, "
         f"fp16 torch.bmm product alone {c_lib:.5f} ms, bound "
         f"{c_bound[0]:.6f} ms ({c_bound[1]}: {c_ops} int8 operations at "
         f"{INT8_TENSOR_OPS_PER_S / 1e12:.0f} T/s, {c_bytes} bytes); max "
         f"error {c_err}")
    out.update(c_err=c_err, c_ms=c_ms, c_dev=c_dev, c_plain=c_plain,
               c_lib=c_lib, c_bound=c_bound)

    # ---- (b) kernel D: a real set's 64 shreds, then ragged lanes
    fs = fec_set(rng.integers(0, 256, 30_000, np.uint8).tobytes(), 9, 0, k,
                 device=device)
    raws = fs.data_shreds + fs.code_shreds
    parsed = [sl.parse(r) for r in raws]
    leaf, lens, idxs, proofs, depths = _walk_rows(parsed)
    leaf_d = torch.from_numpy(leaf).to(dev)
    proofs_d = torch.from_numpy(proofs).to(dev)
    reset_counts()
    roots = bmtree.batch_walk_roots(leaf_d, lens, idxs, proofs_d, depths)
    got = counts()
    plain = bw.bmtree_walk_plain(leaf_d, *[torch.from_numpy(x).to(dev) for x
                                           in (lens, idxs)], proofs_d,
                                 torch.from_numpy(depths).to(dev))
    host = bmtree.np_batch_walk_roots(
        [s.merkle_leaf_data() for s in parsed],
        [s.tree_index() for s in parsed], [s.proof_nodes() for s in parsed])
    if not (torch.equal(roots, plain) and got["bmtree_walk"] == 1
            and [bytes(r) for r in roots.cpu().numpy()] == host
            and set(host) == {fs.merkle_root}):
        raise AssertionError(f"phase 16b: a 32:32 set's roots differ "
                             f"(launches {got})")
    # ragged lanes: the kernel at each lane count on its own rows, the
    # plain version once over all of them (it costs the same at 1 and at
    # 4,193 lanes: a few thousand launches a compression)
    sizes = (1, 31, 32, 33, 127, 128, 129, big_lanes)
    T = sum(sizes)
    lf = rng.integers(0, 256, (T, LEAF_MAXLEN), np.uint8)
    ln = rng.integers(0, LEAF_MAXLEN + 1, T).astype(np.int32)
    ix = rng.integers(0, 1 << 15, T).astype(np.int32)
    pf = rng.integers(0, 256, (T, PROOF_DEPTH, 20), np.uint8)
    dp = np.zeros(T, np.int32)
    at = 0
    for B in sizes:
        edge = list(WALK_EDGE_LENS)[:B]
        ln[at:at + len(edge)] = edge
        dp[at:at + B] = np.arange(B) % (PROOF_DEPTH + 1)
        at += B
    lf_d, pf_d = torch.from_numpy(lf).to(dev), torch.from_numpy(pf).to(dev)
    pr = bw.bmtree_walk_plain(lf_d, *[torch.from_numpy(x).to(dev)
                                      for x in (ln, ix)], pf_d,
                              torch.from_numpy(dp).to(dev))
    d_err, at = 0, 0
    for B in sizes:
        rows = slice(at, at + B)
        kr = bw.bmtree_walk(lf_d[rows], ln[rows], ix[rows], pf_d[rows],
                            dp[rows])
        h = min(B, 64)
        if not torch.equal(kr, pr[rows]) or [
                bytes(r) for r in kr[:h].cpu().numpy()] != \
                bmtree.np_batch_walk_roots(
                    [lf[at + i, :ln[at + i]] for i in range(h)],
                    ix[rows][:h].tolist(),
                    [list(pf[at + i, :dp[at + i]]) for i in range(h)]):
            raise AssertionError(f"phase 16b: {B} ragged lanes differ")
        d_err = max(d_err, int((kr.to(torch.int16) - pr[rows]).abs().max()))
        at += B
    # rows at every offset 0-15 of a blob whose rows are 1,560 bytes
    # apart (the shred tile's: 8-byte aligned), 40 lanes an offset (a
    # block's 32 and 8 more), each offset one launch; the plain version
    # once over all of them, and np_batch_walk_roots on every lane
    n_at, stride = 40, 1560
    blob = rng.integers(0, 256, (16 * n_at, stride), np.uint8)
    o_ln = rng.integers(0, LEAF_MAXLEN + 1, 16 * n_at).astype(np.int32)
    o_ix = rng.integers(0, 1 << 15, 16 * n_at).astype(np.int32)
    o_pf = rng.integers(0, 256, (16 * n_at, PROOF_DEPTH, 20), np.uint8)
    o_dp = (np.arange(16 * n_at) % (PROOF_DEPTH + 1)).astype(np.int32)
    o_lf = np.stack([blob[i, (i // n_at):(i // n_at) + LEAF_MAXLEN]
                     for i in range(16 * n_at)])
    for at in range(16):
        o_ln[at * n_at:at * n_at + len(WALK_EDGE_LENS)] = WALK_EDGE_LENS
    blob_d, o_pf_d = torch.from_numpy(blob).to(dev), torch.from_numpy(
        o_pf).to(dev)
    o_plain = bw.bmtree_walk_plain(
        torch.from_numpy(o_lf).to(dev), *[torch.from_numpy(x).to(dev)
                                          for x in (o_ln, o_ix)], o_pf_d,
        torch.from_numpy(o_dp).to(dev))
    o_host = bmtree.np_batch_walk_roots(
        [o_lf[i, :o_ln[i]] for i in range(16 * n_at)], o_ix.tolist(),
        [list(o_pf[i, :o_dp[i]]) for i in range(16 * n_at)])
    for at in range(16):
        rows = slice(at * n_at, (at + 1) * n_at)
        view = blob_d[rows, at:at + LEAF_MAXLEN]
        kr = bw.bmtree_walk(view, o_ln[rows], o_ix[rows], o_pf_d[rows],
                            o_dp[rows])
        if not torch.equal(kr, o_plain[rows]) or [
                bytes(r) for r in kr.cpu().numpy()] != o_host[rows]:
            raise AssertionError(f"phase 16b: rows at offset {at} of a "
                                 f"{stride}-byte stride differ")
        d_err = max(d_err, int((kr.to(torch.int16)
                                - o_plain[rows]).abs().max()))
    # the timed shape: one admission burst, sig_batch lanes of the set
    bl = (leaf_d[:SIG_BATCH], lens[:SIG_BATCH], idxs[:SIG_BATCH],
          proofs_d[:SIG_BATCH], depths[:SIG_BATCH])
    bl_plain = (bl[0], *[torch.from_numpy(x).to(dev) for x in bl[1:3]],
                bl[3], torch.from_numpy(bl[4]).to(dev))
    d_ms = cuda_ms(lambda: bw.bmtree_walk(*bl))
    d_dev = _launch_ms(torch, bw, "bmtree_walk", lambda: bw.bmtree_walk(*bl))
    if device is None and not (d_dev or 0) > 0:
        raise AssertionError(f"phase 16b: bmtree_walk device ms {d_dev}")
    d_plain = cuda_ms(lambda: bw.bmtree_walk_plain(*bl_plain), 1, 0)
    w_ops, longest = _walk_ops(bl[1], bl[4])
    d_bytes = SIG_BATCH * (LEAF_MAXLEN + PROOF_DEPTH * 20 + 12 + 32)
    d_issue = _sha256_bound_ms(w_ops, int_ops_per_s)
    d_cp = longest * 64 * SHA256_ROUND_DEPTH / clock_hz * 1e3
    d_bound = max((d_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                  (max(d_issue, d_cp), "operations"))
    d_term = "critical path" if d_cp >= d_issue else "issue"
    note(f"phase 16b: bmtree_walk: the 64 shreds of a signed 32:32 set "
         f"(depth {int(depths[0])}) == plain == np_batch_walk_roots == the "
         f"signed root in 1 launch; ragged lanes (depths 0-"
         f"{PROOF_DEPTH}, leaf lengths {list(WALK_EDGE_LENS)}) == plain at "
         f"1, 31, 32, 33, 127, 128, 129 and {big_lanes} lanes, == hashlib "
         f"on the first 64; rows at every offset 0-15 of a {stride}-byte "
         f"stride, {n_at} lanes each, == plain == hashlib; {SIG_BATCH} "
         f"lanes of the set: call {d_ms:.5f} ms, device "
         f"{_ms_text(d_dev)}, plain {d_plain:.4f} ms, bound "
         f"{d_bound[0]:.6f} ms"
         f" ({d_bound[1]}, set by the {d_term}: the issue bound "
         f"{d_issue:.6f} ms of {w_ops[0]} integer-pipe and {w_ops[1]} add "
         f"operations, the critical path {d_cp:.6f} ms of the longest "
         f"lane's {longest} compressions x 64 rounds x {SHA256_ROUND_DEPTH} "
         f"dependent operations at {clock_hz / 1e6:.0f} MHz; {d_bytes} "
         f"bytes); max error {d_err}")
    out.update(d_err=d_err, d_ms=d_ms, d_dev=d_dev, d_plain=d_plain,
               d_bound=d_bound, d_term=d_term)

    # ---- (c) the batcher: "device" against "host" on one burst
    burst = [(raws[i], keys["leader"]) for i in range(26)]
    burst += [(forge(raws[26]), keys["leader"]), (raws[27], keys["other"]),
              (raws[28], None), (legacy_shred(9), keys["leader"]),
              (raws[0], keys["leader"]), (raws[29], keys["leader"])]
    dev_b = st._ShredSigBatcher(batch=SIG_BATCH, backend="device",
                                device=device)
    dev_b.warm()
    host_b = st._ShredSigBatcher(batch=SIG_BATCH, backend="host")
    verdicts = []
    for b in (dev_b, host_b):
        for i, (raw, leader) in enumerate(burst):
            b.add(sl.parse(raw), raw, i, leader)
        if b is dev_b:
            reset_counts()
        verdicts.append([(t, ok) for _, _, t, ok in b.flush()])
        if b is dev_b:
            got_c = counts()
    want = [True] * 26 + [False] * 4 + [True, True]
    if not (verdicts[0] == verdicts[1]
            and [ok for _, ok in verdicts[0]] == want
            and got_c["bmtree_walk"] == got_c["sha512_ram"]
            == got_c["verify_tail"] == got_c["r_check"] == 1):
        raise AssertionError(f"phase 16c: device {verdicts[0]}, host "
                             f"{verdicts[1]}, launches {got_c}")
    note(f"phase 16c: _ShredSigBatcher(batch {SIG_BATCH}) device == host on "
         f"one burst (26 valid, a forged signature, the wrong leader, an "
         f"unknown leader, a legacy shred, a duplicate, 1 valid): "
         f"{sum(want)} pass; one flush launched bmtree_walk, sha512_ram, "
         f"verify_tail and r_check once each")

    # ---- (d) the lane in processes
    slot = 40
    frags, entries, valid, n_forged = lane_stream(
        slot, lane_sets, k, 6, SIG_BATCH, 1601, device=device,
        live_corrupt=True)
    child = UdpSock(bind_ip="127.0.0.1")
    cap = workdir / "payloads.cap"
    ext = {"device": device or ""}
    spec = (topo_mod.TopoBuilder(f"{tag}s", wksp_mb=64)
            .link("net", depth=1024, mtu=1280)
            .link("s_store", depth=1024, mtu=1280)
            .link("s_rec", depth=1024, mtu=1280)
            .link("r_sink", depth=64, mtu=32768)
            .tile("n", "sink", outs=["net"])
            .tile("shred", "shred", ins=["net"], outs=["s_store", "s_rec"],
                  net_ins=["net"], turbine=turbine_cfg(keys, child.port),
                  sig_backend="device", **ext)
            .tile("store", "store", ins=["s_store"], max_slots=1, **ext)
            .tile("rec", "shred_recover", ins=["s_rec"], outs=["r_sink"],
                  **ext)
            .tile("sink", "sink", ins=["r_sink"], capture_path=str(cap))
            .build())
    _shm_check(spec.wksp_mb << 20, note)
    old_env = {k: os.environ.get(k)
               for k in ("OMP_NUM_THREADS", "FDTPU_DRAIN_DIR")}
    os.environ["OMP_NUM_THREADS"] = "1"
    # each tile's drain manifest; shred's and shred_recover's record their
    # kernel launches
    os.environ["FDTPU_DRAIN_DIR"] = str(workdir / "drain")
    try:
        t0 = time.perf_counter()
        run = TopoRun(spec, policy=SupervisionPolicy(drain_timeout_s=120.0))
        try:
            run.wait_ready(timeout=300)
            t_boot = time.perf_counter() - t0
            lnk = run.jt.links["net"]
            lens = np.array([len(f) for f in frags], np.int32)
            offs = np.zeros(len(frags), np.int64)
            np.cumsum(lens[:-1], out=offs[1:])
            t0 = time.perf_counter()
            tx_burst(lnk.mcache, lnk.dcache, lnk.dcache.chunk0,
                     b"".join(frags), offs, lens,
                     np.zeros(len(frags), np.uint64))
            lnk = None

            def lane_done():
                rm, sm = run.metrics("rec"), run.metrics("store")
                return (rm["fec_complete_cnt"] + rm["fec_fail_cnt"]
                        == lane_sets + 2 and sm["complete_slot"] == slot
                        and sm["shred_store_cnt"] == len(valid)
                        and run.metrics("sink")["frag_cnt"] == lane_sets)

            _wait_for(lane_done, 300, "every set recovered and the slot "
                      "stored", run)
            t_lane = time.perf_counter() - t0
            got_udp = []

            def retransmitted():
                got_udp.extend(p.payload for p in child.recv_burst())
                return (len(got_udp)
                        >= run.metrics("shred")["turbine_tx_cnt"])

            _wait_for(retransmitted, 60, "the retransmits", run)
            if not run.drain():
                raise AssertionError("phase 16d: drain() did not drain "
                                     "every tile")
            shm, rm = run.metrics("shred"), run.metrics("rec")
            sm = run.metrics("store")
            st_s = run._load_drain_manifest("shred")["tile_state"]
            st_r = run._load_drain_manifest("rec")["tile_state"]
            st_st = run._load_drain_manifest("store")["tile_state"]
        finally:
            run.close()
            child.close()
    finally:
        for key, val in old_env.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    if set(run.exitcodes.values()) != {0}:
        raise AssertionError(f"phase 16d: exit codes {run.exitcodes}")
    payloads = [p for _, p in read_capture(str(cap))]
    # the retransmits the tree asks for: this node's children of every
    # admitted shred, by the tile's own stake table
    ci = sd_mod.StakeCI(keys["me"], 432_000)
    for pk, (stake, ip, port) in turbine_cfg(keys, child.port)[
            "stakes"].items():
        if ip:
            ci.set_contact(bytes.fromhex(pk), ip, port)
    sched = leader_schedule(0, {keys["leader"]: 1000}, 432_000)
    ci.set_stakes(0, {bytes.fromhex(pk): v[0] for pk, v in turbine_cfg(
        keys, child.port)["stakes"].items()})
    sdest = ci.sdest_for(slot, lambda s: sched[s])
    want_udp = sorted(
        r for r in valid for i in sdest.compute_children([sl.parse(r)],
                                                         200)[0]
        if sdest.idx_to_dest(i).pubkey == keys["child"])
    launches = {"gf2_recover": st_r["launches"].get("gf2_recover", 0),
                "bmtree_walk": st_s["launches"].get("bmtree_walk", 0)}
    on_card = device is None
    if not (payloads == entries and rm["fec_fail_cnt"] == 2
            and st_st == {"corrupt_set_cnt": 1}
            and sm["shred_store_cnt"] == len(valid)
            and sm["parse_fail_cnt"] == 0
            and rm["fec_host_fallback_cnt"] == 0
            and shm["shred_sig_fail_cnt"] == n_forged
            and shm["shred_rx_cnt"] == len(valid)
            and sm["complete_slot"] == slot
            and sorted(got_udp) == want_udp and want_udp
            and len(got_udp) == shm["turbine_tx_cnt"]
            and (not on_card or (
                launches["gf2_recover"] == st_r["fec_dispatch_cnt"] + 1
                and st_s["launches"]["bmtree_walk"]
                == st_s["launches"]["sha512_ram"]
                == st_s["launches"]["verify_tail"]
                == st_s["launches"]["r_check"]
                == st_s["sig_batch_cnt"] > 0))):
        raise AssertionError(
            f"phase 16d: {len(payloads)} payloads of {len(entries)} (equal "
            f"{payloads == entries}), recover {rm}, shred {shm}, store {sm},"
            f" udp {len(got_udp)} of {len(want_udp)} wanted, at the drain "
            f"{st_s} / {st_r} / {st_st}")
    note(f"phase 16d: shred -> store, shred -> shred_recover -> sink in "
         f"processes (sig_backend device, sig_batch {SIG_BATCH}, "
         f"{SHRED_BATCH_SETS} sets a dispatch): {len(frags)} frags into the "
         f"net in-link ({lane_sets} signed 32:32 sets of slot {slot} with "
         f"ragged erasures, a corrupted set of slot {slot - 1} and one of "
         f"the live slot {slot + 1}, {n_forged} forged shreds); the sink's "
         f"{len(payloads)} payloads == the entry "
         f"batches; fec_fail {rm['fec_fail_cnt']}, host fallback "
         f"{rm['fec_host_fallback_cnt']}, fec dispatches "
         f"{rm['fec_dispatch_cnt']}; shred_sig_fail "
         f"{shm['shred_sig_fail_cnt']}, admitted {shm['shred_rx_cnt']}, "
         f"bursts {shm['sig_batch_cnt']} ({shm['sig_deadline_flush_cnt']} "
         f"by age); store complete_slot {sm['complete_slot']}, "
         f"{sm['shred_store_cnt']} shreds stored, the live slot's corrupt "
         f"set dropped and counted once ({st_st}); the child "
         f"socket received the {len(got_udp)} retransmits the tree asks "
         f"for; launches in the tiles' processes (drain manifests): "
         f"gf2_recover {launches['gf2_recover']} == fec dispatches "
         f"{st_r['fec_dispatch_cnt']} + the warm-up, bmtree_walk "
         f"{st_s['launches'].get('bmtree_walk')} == sha512_ram == "
         f"verify_tail == r_check == bursts {st_s['sig_batch_cnt']} since "
         f"the warm-up; "
         f"every tile exited 0; boot {t_boot:.3f} s, the slot through the "
         f"lane in {t_lane:.3f} s")
    out.update(launches=launches)
    note(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---- phase 17: the supervised run ---------------------------------------


def _txn_host_ok(wire: bytes, mode: str = "strict") -> bool:
    """The host oracle of a wire txn: every signature by verify_one_host
    (or verify_one_host_antipa for mode "antipa"), for a pool worker."""
    from firedancer_tpu_torch.ballet import txn as txn_lib
    from firedancer_tpu_torch.ops import ed25519 as ed
    one = ed.verify_one_host_antipa if mode == "antipa" else ed.verify_one_host
    t = txn_lib.parse(wire)
    msg = t.message(wire)
    return all(one(s, msg, k)
               for s, k in zip(t.signatures(wire), t.signer_pubkeys(wire)))


def _stream_wires(pool, seed: int, n: int) -> list:
    """The first n wire txns of source_txn_stream(seed, 4), made by the
    pool in parts of 16."""
    return [w for part in pool.starmap(_stream_part, [
        (seed, 4, lo, min(lo + 16, n)) for lo in range(0, n, 16)])
        for _, w in part]


def _forged(wires, every: int) -> list:
    """Every `every`-th wire with one signature bit flipped."""
    out = list(wires)
    for i in range(0, len(out), every):
        b = bytearray(out[i])
        b[1 + 40] ^= 1
        out[i] = bytes(b)
    return out


class _StallFirst:
    """The device verifier with a stall after each of its first `n`
    dispatches: on the card a sleep kernel behind the dispatch's kernels
    (torch.cuda._sleep), so the verdict lands late; on the CPU a verdict
    that reads as pending for `stall_s`.  dispatches counts the calls."""

    def __init__(self, fn, n, stall_s=0.1):
        self.fn = fn
        self.device = fn.device
        self.mode = fn.mode
        self.n = n
        self.stall_s = stall_s
        self.dispatches = 0

    def dispatch_blob(self, blob, maxlen=None):
        import torch
        v = self.fn.dispatch_blob(blob, maxlen=maxlen)
        self.dispatches += 1
        if self.dispatches > self.n:
            return v
        if self.device.type == "cuda":
            torch.cuda._sleep(STALL_CYCLES)
            return v
        return _TimedVerdict(v, time.monotonic() + self.stall_s)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(port: int, path: str) -> tuple:
    """(status, body) of one GET on the supervisor's endpoint."""
    import urllib.error
    import urllib.request
    try:
        r = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                   timeout=60)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _metric(body: str, name: str, tile: str) -> int:
    """One tile's sample of a family in a /metrics page (-1 if absent)."""
    kind = tile.split(":", 1)[0]
    key = f'fdtpu_{name}{{tile="{tile}",kind="{kind}"}} '
    for line in body.splitlines():
        if line.startswith(key):
            return int(float(line[len(key):]))
    return -1


def _inj_bench_spec(name, device, buckets, n, seed, rate_ns, capture,
                    **vcfg):
    """verify-bench (source -> verify:0 -> dedup -> sink, the source's n
    txns paced rate_ns apart) with a second in-link into the verify tile
    that the caller writes by hand, its producer a sink-kind tile that
    publishes nothing.  n 0: no source traffic (a sink-kind tile stands
    in for the source; a source of count 0 would never stop)."""
    from firedancer_tpu_torch.disco.topo import TopoBuilder
    b = (TopoBuilder(name, wksp_mb=64)
         .link("src_verify", depth=4096, mtu=1280)
         .link("inj_verify", depth=4096, mtu=1280)
         .link("verify_dedup", depth=256, mtu=1280)
         .link("dedup_sink", depth=256, mtu=1280))
    if n:
        b.tile("source", "source", outs=["src_verify"], count=n, seed=seed,
               rate_ns=rate_ns)
    else:
        b.tile("source", "sink", outs=["src_verify"])
    return (b.tile("inj", "sink", outs=["inj_verify"])
            .tile("verify:0", "verify", ins=["src_verify", "inj_verify"],
                  outs=["verify_dedup"], device=device, buckets=buckets,
                  **vcfg)
            .tile("dedup", "dedup", ins=["verify_dedup"],
                  outs=["dedup_sink"])
            .tile("sink", "sink", ins=["dedup_sink"],
                  capture_path=str(capture))
            .build())


def _inject_wires(run, link: str, wires):
    """Publish wire txns on a running topology's link in one burst."""
    from firedancer_tpu_torch.tango.ring import tx_burst
    lnk = run.jt.links[link]
    lens = np.array([len(w) for w in wires], np.int32)
    offs = np.zeros(len(wires), np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    sigs = np.array([int.from_bytes(w[1:9], "little") & ((1 << 63) - 1)
                     for w in wires], np.uint64)
    tx_burst(lnk.mcache, lnk.dcache, lnk.dcache.chunk0, b"".join(wires),
             offs, lens, sigs)


def supervised_phase(pool, reset_counts, counts, note, device=None,
                     buckets=None, workdir=None, n_run=64, kill_after=32,
                     n_late=96, drill_txns=8, overhead_shape=(4096, 128),
                     overhead_turns=6, overhead_calls=10):
    """Phase 17: the supervised run, verify-bench at the bucket ladder
    `buckets` (default the full DEFAULT_BUCKETS).  (o) The guard's
    healthy-path cost: one dispatch_blob at overhead_shape wrapped and
    bare, in alternating turns, with the launches of the wrapped calls
    counted; the host backend's rate (it serves device "cpu" only).
    (a) `python -m firedancer_tpu_torch.app.fdtpuctl run` as a
    subprocess, `ready`, a scrape of /metrics (the guard's five families
    read 0) and /healthz (ok), then `fdtpuctl drain` (SIGTERM to the
    pidfile's supervisor): exit 0, the sink's txns the host oracle's.
    (b) restart_policy respawn with fail_dispatch_n:1,boot:0 on verify:0
    and no retry, its traffic written by hand on a second in-link: the
    failed dispatch ends the tile (DeviceFault, nothing recomputed on the
    host), its last metrics in a `respawn` bundle that `fdtpuctl
    postmortem` renders, one respawn, the txns after it all verdicted,
    nothing captured twice.  (b2) In process: the tile's first dispatch
    stalled past a 50 ms device_deadline_s raises DeviceFault at the
    harvest, nothing published; a new tile serves the rest, every
    verdict once and the host oracle's.  (c) restart_policy respawn with
    kill_after_frags:kill_after,boot:0 on verify:0, its traffic written
    by hand on a second in-link: the txns before the kill all verdicted,
    one respawn, a `respawn` bundle, nothing captured twice, the loss a
    tail of the burst that crossed the kill, and txns injected after the
    respawn all verdicted.  (d) The same kill on a packed_wire verify
    tile, whose frags are written by hand in the blob row layout: the
    frags it held unverdicted at its death counted.
    device None is the card.  Raises on any failed check; returns the
    numbers.  The work directory (a temporary one unless `workdir` is
    given) is removed when every check passed."""
    import shutil
    import signal as signal_mod
    import tempfile
    import threading

    from firedancer_tpu_torch.app import config as app_config
    from firedancer_tpu_torch.ballet import txn as txn_lib
    from firedancer_tpu_torch.disco import flightrec
    from firedancer_tpu_torch.disco import pipeline as pl
    from firedancer_tpu_torch.disco.faultinject import KILL_EXIT_CODE
    from firedancer_tpu_torch.disco.run import SupervisionPolicy, TopoRun
    from firedancer_tpu_torch.disco.tiles import read_capture
    from firedancer_tpu_torch.disco.topo import TopoBuilder
    from firedancer_tpu_torch.disco.verify_tile import VerifyTile
    from firedancer_tpu_torch.models import verifier as V
    from firedancer_tpu_torch.tango.ring import (PACKED_ROW_EXTRA, Cnc,
                                                 packed_row_ml)
    import torch

    cuda = device is None
    buckets = [list(b) for b in (buckets or pl.DEFAULT_BUCKETS)]
    tag = f"cs17{os.getpid()}"
    t_phase = time.perf_counter()
    own_dir = workdir is None
    workdir = Path(workdir or tempfile.mkdtemp(prefix="fdtpu_phase17_"))
    workdir.mkdir(parents=True, exist_ok=True)
    out = {}
    passed = False
    old_omp = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        # ---- (o) the guard's cost on the healthy path
        rows, ml = overhead_shape
        sv = V.SigVerifier(V.VerifierConfig(rows, ml), device=device)
        guard = pl.GuardedVerifier(sv)
        blob = V.pack_blob(*V.make_example_batch(rows, ml, sign_pool=64,
                                                 seed=1701))
        blob_t = torch.from_numpy(blob)
        if cuda:
            blob_t = blob_t.pin_memory()

        def call(fn):
            return np.asarray(fn.dispatch_blob(blob_t))

        for fn in (sv, guard, sv, guard):
            if not call(fn).all():
                raise AssertionError("phase 17o: a valid row rejected")
        turns = {"bare": [], "wrapped": []}
        for i in range(overhead_turns):
            order = (("bare", sv), ("wrapped", guard))
            for name, fn in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                for _ in range(overhead_calls):
                    call(fn)
                turns[name].append((time.perf_counter() - t0) * 1e3
                                   / overhead_calls)
        reset_counts()
        for _ in range(overhead_calls):
            call(guard)
        launches = counts()
        if cuda and not (launches["sha512_ram"] == launches["verify_tail"]
                         == launches["r_check"] == overhead_calls):
            raise AssertionError(f"phase 17o: launches {launches} for "
                                 f"{overhead_calls} wrapped calls")
        if (guard.device_fail_cnt, guard.fallback_lanes, guard.degraded) \
                != (0, 0, False):
            raise AssertionError("phase 17o: the guard fell back")
        bare = statistics.median(turns["bare"])
        wrapped = statistics.median(turns["wrapped"])
        out["overhead"] = {"bare_ms": bare, "wrapped_ms": wrapped,
                           "turns": turns}
        note(f"phase 17o: one {rows}x{ml} dispatch_blob + np.asarray, "
             f"{overhead_turns} alternating turns of {overhead_calls} "
             f"calls: bare {bare:.4f} ms, under GuardedVerifier "
             f"{wrapped:.4f} ms a call (medians; {wrapped - bare:+.4f} ms,"
             f" {100 * (wrapped / bare - 1):+.2f}%); {overhead_calls} "
             f"wrapped calls launched sha512 {launches['sha512_ram']}, "
             f"verify_tail {launches['verify_tail']}, r_check "
             f"{launches['r_check']}")
        # the host fallback's rate on live lanes (distinct signed rows,
        # verify_one_host on Python ints, one lane at a time)
        live = blob[:64]
        t0 = time.perf_counter()
        bits = V.host_verify_blob(live)
        host_vps = len(live) / (time.perf_counter() - t0)
        if not bits.all():
            raise AssertionError("phase 17o: the host fallback rejected a "
                                 "valid row")
        out["host_live_vps"] = host_vps
        note(f"phase 17o: the host fallback (models/verifier.py "
             f"host_verify_blob) on {len(live)} live rows: "
             f"{host_vps:.1f} lanes/s on this machine's host")
        sv = guard = blob = blob_t = live = None

        # ---- (a) fdtpuctl run, ready, /metrics, /healthz, drain
        t_a = time.perf_counter()
        port = _free_port()
        env = dict(os.environ, TMPDIR=str(workdir))
        (workdir / "a.toml").write_text(
            f'name = "{tag}a"\ntopology = "verify-bench"\n'
            f'[tiles.verify]\nbuckets = {json.dumps(buckets)}\n'
            f'device = "{device or ""}"\n'
            f'[tiles.sink]\ncapture_path = "{workdir / "a.cap"}"\n'
            f'[development]\nsource_count = {n_run}\n'
            f'[supervision]\ndrain_timeout_s = 120.0\n'
            f'[observability]\nhttp_port = {port}\n'
            f'flight_dir = "{workdir / "fa"}"\n')
        cfg = app_config.load(str(workdir / "a.toml"), environ={})
        spec = app_config.build_topology(cfg)
        _shm_check(spec.wksp_mb << 20, note)
        want_a = pool.starmap_async(_stream_part, [
            (cfg["development"]["bench_seed"], 4, lo, min(lo + 16, n_run))
            for lo in range(0, n_run, 16)])
        ctl = [sys.executable, "-m", "firedancer_tpu_torch.app.fdtpuctl",
               "--config", str(workdir / "a.toml")]
        log_a = open(workdir / "a.log", "w+")
        proc = subprocess.Popen(ctl + ["run"], cwd=ROOT, env=env,
                                stdout=log_a, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            r = subprocess.run(ctl + ["ready", "--timeout", "300"], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=330)
            if r.returncode != 0 or r.stdout.strip() != "ready":
                raise AssertionError(f"phase 17a: ready {r}; "
                                     f"{(workdir / 'a.log').read_text()}")
            t_ready = time.perf_counter() - t_a
            deadline = time.monotonic() + 300
            while True:
                code, body = _scrape(port, "/metrics")
                if code == 200 and _metric(body, "frag_cnt", "sink") \
                        == n_run:
                    break
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"phase 17a: {n_run} txns never reached the sink "
                        f"(run rc {proc.poll()})")
                time.sleep(0.05)
            fams = {f: _metric(body, f, "verify:0") for f in (
                "degraded_mode", "device_fail_cnt", "fallback_lane_cnt",
                "reprobe_cnt", "fallback_vps")}
            if set(fams.values()) != {0}:
                raise AssertionError(f"phase 17a: the guard's families "
                                     f"{fams}")
            code, health = _scrape(port, "/healthz")
            if code != 200 or not health.startswith("ok\n"):
                raise AssertionError(f"phase 17a: /healthz {code} {health}")
            t0 = time.perf_counter()
            r = subprocess.run(ctl + ["drain"], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=600)
            rc = proc.wait(timeout=120)
            t_drain = time.perf_counter() - t0
            if r.returncode != 0 or rc != 0:
                raise AssertionError(f"phase 17a: drain rc {r.returncode} "
                                     f"{r.stdout} {r.stderr}, run rc {rc}: "
                                     f"{(workdir / 'a.log').read_text()}")
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal_mod.SIGKILL)
                proc.wait()
            log_a.close()
        got_a = read_capture(str(workdir / "a.cap"))
        stream_a = [t for part in want_a.get(600) for t in part]
        ok_a = pool.map(_txn_host_ok, [w for _, w in stream_a])
        oracle_a = sorted(t for t, ok in zip(stream_a, ok_a) if ok)
        if sorted(got_a) != oracle_a or len(oracle_a) != n_run:
            raise AssertionError(f"phase 17a: the sink captured "
                                 f"{len(got_a)} txns, the oracle "
                                 f"{len(oracle_a)}")
        out["a_s"] = time.perf_counter() - t_a
        note(f"phase 17a: `fdtpuctl run` (verify-bench at buckets "
             f"{buckets}) -> `ready` after {t_ready:.3f} s; /metrics: the "
             f"sink at {n_run} txns, the guard's five families 0 ({fams});"
             f" /healthz {health.splitlines()[0]!r}; `fdtpuctl drain` -> "
             f"the supervisor exited 0 after {t_drain:.3f} s; the sink "
             f"captured {len(got_a)} == the host oracle's {len(oracle_a)}; "
             f"part (a) {out['a_s']:.1f} s")

        # ---- (b) a device fault fails the tile; its respawn serves on
        t_b = time.perf_counter()
        spec = _inj_bench_spec(f"{tag}b", device, buckets, 0, 1705, 0,
                               workdir / "b.cap",
                               faults="verify:0=fail_dispatch_n:1,boot:0",
                               supervision={"device_retry": 0})
        # all the traffic on the hand-written in-link: `first`, whose one
        # dispatch the plan fails, then n_late after the respawn's RUN
        first = _forged(_stream_wires(pool, 1705, 8), 4)
        first_ok = pool.map(_txn_host_ok, first)
        late_b = _forged(_stream_wires(pool, 1706, n_late), 8)
        want_late_b = {w for w, ok in zip(late_b,
                                          pool.map(_txn_host_ok, late_b))
                       if ok}
        policy = SupervisionPolicy(restart_policy="respawn", max_restarts=2,
                                   drain_timeout_s=120.0,
                                   heartbeat_stale_by_kind={"verify": 120.0})
        run = TopoRun(spec, policy=policy, flight_dir=str(workdir / "fb"))
        sup = threading.Thread(target=run.supervise,
                               kwargs={"poll_s": 0.02}, daemon=True)

        def captured_b():
            return {w for _, w in read_capture(str(workdir / "b.cap"))}

        try:
            run.wait_ready(timeout=300)
            p0 = run.procs["verify:0"]
            sup.start()
            _inject_wires(run, "inj_verify", first)
            _wait_for(lambda: not p0.is_alive(), 120,
                      "verify:0's exit on the device fault")
            t_death = time.perf_counter()
            _wait_for(lambda: (run.procs["verify:0"] is not p0
                               and run.jt.cnc["verify:0"].signal_query()
                               == Cnc.SIGNAL_RUN), 300,
                      "the respawned verify:0's RUN")
            t_respawn_b = time.perf_counter() - t_death
            _inject_wires(run, "inj_verify", late_b)
            _wait_for(lambda: want_late_b <= captured_b(), 300,
                      "the txns injected after the respawn at the sink")
            run._drain_req = True
            sup.join(300)
            if sup.is_alive():
                raise AssertionError("phase 17b: the drain did not end")
            vb = run.metrics("verify:0")
        finally:
            run._halting = True
            if sup.is_alive():
                sup.join(60)
            run.close()
        if p0.exitcode in (0, KILL_EXIT_CODE) or set(
                run.exitcodes.values()) != {0} or run.restarts != {
                "verify:0": 1}:
            raise AssertionError(f"phase 17b: the first verify:0 exited "
                                 f"{p0.exitcode}; exit codes "
                                 f"{run.exitcodes}, restarts {run.restarts}")
        guard_clean(vb, "phase 17b (the respawned tile)")
        got_b = [w for _, w in read_capture(str(workdir / "b.cap"))]
        kept_b = set(got_b)
        # the faulted dispatch held at least the first txn; a txn of
        # `first` that a later dispatch took is verdicted as the oracle's
        n_first = sum(w in kept_b for w in first)
        if (len(got_b) != len(kept_b) or first[0] in kept_b
                or kept_b - set(first) != want_late_b
                or any(w in kept_b and not ok
                       for w, ok in zip(first, first_ok))):
            raise AssertionError(
                f"phase 17b: captured {len(got_b)} ({len(kept_b)} "
                f"distinct), {n_first} of `first`, the oracle after the "
                f"respawn {len(want_late_b)}")
        bundles = {flightrec.load_bundle(str(p))["manifest"]["reason"]: p
                   for p in (workdir / "fb").iterdir()}
        if set(bundles) != {"respawn"}:
            raise AssertionError(f"phase 17b: bundles {sorted(bundles)}")
        dead = flightrec.load_bundle(str(bundles["respawn"]))["metrics"][
            "verify:0"]["slots"]
        dead = {k: dead[k] for k in GUARD_SLOTS + ("reprobe_cnt",)}
        if dead != {"device_fail_cnt": 1, "fallback_lane_cnt": 0,
                    "degraded_mode": 0, "reprobe_cnt": 0}:
            raise AssertionError(f"phase 17b: the dead tile's guard {dead}")
        r = subprocess.run(
            [sys.executable, "-m", "firedancer_tpu_torch.app.fdtpuctl",
             "postmortem", str(bundles["respawn"])], cwd=ROOT,
            capture_output=True, text=True, timeout=120)
        if (r.returncode != 0 or "reason respawn" not in r.stdout
                or "tile verify:0" not in r.stdout):
            raise AssertionError(f"phase 17b: postmortem {r}")
        out["b_s"] = time.perf_counter() - t_b
        out["fault_respawn_s"] = t_respawn_b
        note(f"phase 17b: verify-bench + a hand-written in-link, respawn "
             f"policy, fail_dispatch_n:1,boot:0 on verify:0 (device_retry "
             f"0): the first dispatch failed and the tile exited "
             f"{p0.exitcode} (DeviceFault; nothing recomputed on the "
             f"host); its last metrics in the `respawn` bundle {dead}, "
             f"`fdtpuctl postmortem` rendered it "
             f"({len(r.stdout.splitlines())} lines); death -> the "
             f"respawned tile's RUN in {t_respawn_b:.3f} s; of the "
             f"{len(first)} txns sent before the fault "
             f"{len(first) - n_first} lost with the faulted dispatch; the "
             f"{len(want_late_b)} valid of {n_late} injected after the "
             f"respawn all captured, the forged none, each once; every "
             f"tile's last incarnation exited 0; part (b) "
             f"{out['b_s']:.1f} s")

        # ---- (b2) in process: a verdict past the deadline
        t_b2 = time.perf_counter()
        stream = _forged(_stream_wires(pool, 1702, 10 * drill_txns), 5)
        parts = [stream[i:i + drill_txns]
                 for i in range(0, len(stream), drill_txns)]
        oracle = [w for w, ok in zip(stream, pool.map(_txn_host_ok, stream))
                  if ok and w not in parts[0]]
        sup_cfg = {"device_deadline_s": 0.05, "device_retry": 0}

        def tile_for(n_stall):
            tile = VerifyTile()
            ctx = _RecCtx({"buckets": buckets, "device": device,
                           "supervision": sup_cfg})
            tile.init(ctx)
            if not cuda:
                # the guard's card behaviour, to run the part on the CPU
                tile.guard.on_card = True
            stall = _StallFirst(tile.guard.fn, n_stall)
            tile.guard.fn = stall
            return tile, ctx, stall

        def feed(tile, ctx, part):
            pipe = tile.pipe
            offs = np.zeros(len(part) + 1, np.int64)
            np.cumsum([len(w) for w in part], out=offs[1:])
            metas = np.zeros(len(part), dtype=[("sig", np.uint64)])
            tile.on_burst(ctx, 0, metas, np.frombuffer(b"".join(part),
                                                       np.uint8),
                          offs, len(part))
            tile._forward(ctx, pipe.dispatch_open())
            deadline = time.monotonic() + 60
            while pipe.inflight or pipe.lat_inflight:
                tile.after_credit(ctx)
                if time.monotonic() > deadline:
                    raise TimeoutError("phase 17b2: a harvest")
                time.sleep(0.001)

        tile, ctx, stall = tile_for(1)
        t0 = time.perf_counter()
        try:
            feed(tile, ctx, parts[0])
            raise AssertionError("phase 17b2: no DeviceFault past the "
                                 "deadline")
        except pl.DeviceFault as e:
            fault_s = time.perf_counter() - t0
            why = str(e)
        tile.fini(ctx)
        m0 = dict(ctx.metrics)
        if (ctx.published or stall.dispatches != 1 or not tile.guard.faulted
                or (m0["device_fail_cnt"], m0["fallback_lane_cnt"],
                    m0["degraded_mode"]) != (1, 0, 0)):
            raise AssertionError(f"phase 17b2: the faulted tile published "
                                 f"{len(ctx.published)}, metrics {m0}")
        if cuda:
            torch.cuda.synchronize()     # the stall ends; nothing reads it
        # the next incarnation: a new tile serves the parts that follow
        tile = ctx = stall = None
        tile, ctx, stall = tile_for(0)
        reset_counts()
        for part in parts[1:]:
            feed(tile, ctx, part)
        tile.fini(ctx)
        launches = counts()
        got = [p for p, _ in ctx.published]
        n_dev = stall.dispatches
        if sorted(got) != sorted(oracle) or len(set(got)) != len(got):
            raise AssertionError(f"phase 17b2: published {len(got)} "
                                 f"({len(set(got))} distinct), the oracle "
                                 f"{len(oracle)}")
        guard_clean(ctx.metrics, "phase 17b2 (the next tile)")
        if cuda and not (launches["sha512_ram"] == launches["verify_tail"]
                         == launches["r_check"] == n_dev):
            raise AssertionError(f"phase 17b2: launches {launches} for "
                                 f"{n_dev} device dispatches")
        out["b2_s"] = time.perf_counter() - t_b2
        note(f"phase 17b2: VerifyTile in process, device_deadline_s 50 ms: "
             f"its first dispatch ({len(parts[0])} txns) stalled "
             f"{STALL_CYCLES} cycles on the card; the harvest raised "
             f"DeviceFault after {fault_s:.3f} s ({why!r}), nothing "
             f"published, the late verdict never read, the metrics "
             f"device_fail_cnt 1, fallback_lane_cnt 0, degraded_mode 0. A "
             f"new tile (the respawn's stand-in) took the {len(parts) - 1} "
             f"parts after it: {n_dev} dispatches, sha512 launches "
             f"{launches['sha512_ram']}; published {len(got)}, each once, "
             f"== the host oracle of those parts; part (b2) "
             f"{out['b2_s']:.1f} s")
        tile = ctx = stall = None

        # ---- (c) respawn after an injected kill
        t_c = time.perf_counter()
        spec = _inj_bench_spec(
            f"{tag}c", device, buckets, 0, 1703, 0, workdir / "c.cap",
            faults=f"verify:0=kill_after_frags:{kill_after},boot:0")
        # all the traffic on the hand-written in-link: `pre` txns the
        # first incarnation verdicts, then 16 across its kill threshold,
        # then n_late after the respawn's RUN
        pre = kill_after - 8
        txns = [w for part in pool.starmap(_stream_part, [
            (1703, 4, lo, lo + 8) for lo in range(0, pre + 16, 8)])
            for _, w in part]
        first, cross = txns[:pre], txns[pre:]
        late = _forged([w for part in pool.starmap(_stream_part, [
            (1704, 4, lo, min(lo + 16, n_late))
            for lo in range(0, n_late, 16)]) for _, w in part], 8)
        late_ok = pool.map(_txn_host_ok, late)
        want_late = {w for w, ok in zip(late, late_ok) if ok}
        policy = SupervisionPolicy(restart_policy="respawn", max_restarts=2,
                                   drain_timeout_s=120.0,
                                   heartbeat_stale_by_kind={"verify": 120.0})
        run = TopoRun(spec, policy=policy, flight_dir=str(workdir / "fc"))
        sup = threading.Thread(target=run.supervise,
                               kwargs={"poll_s": 0.02}, daemon=True)

        def captured():
            return {w for _, w in read_capture(str(workdir / "c.cap"))}

        try:
            run.wait_ready(timeout=300)
            p0 = run.procs["verify:0"]
            sup.start()
            _inject_wires(run, "inj_verify", first)
            _wait_for(lambda: set(first) <= captured(), 120,
                      f"the first {pre} txns at the sink", run)
            _inject_wires(run, "inj_verify", cross)
            _wait_for(lambda: not p0.is_alive(), 120, "the injected kill")
            t_death = time.perf_counter()
            if p0.exitcode != 86:
                raise AssertionError(f"phase 17c: the first verify:0 "
                                     f"exited {p0.exitcode}")
            _wait_for(lambda: (run.procs["verify:0"] is not p0
                               and run.jt.cnc["verify:0"].signal_query()
                               == Cnc.SIGNAL_RUN), 300,
                      "the respawned verify:0's RUN")
            t_respawn = time.perf_counter() - t_death
            mode = smi("compute_mode") if cuda else "cpu"
            _inject_wires(run, "inj_verify", late)
            _wait_for(lambda: want_late <= captured(), 300,
                      "the txns injected after the respawn at the sink")
            run._drain_req = True
            sup.join(300)
            if sup.is_alive():
                raise AssertionError("phase 17c: the drain did not end")
            dd = run.metrics("dedup")
            vc = run.metrics("verify:0")
        finally:
            run._halting = True
            if sup.is_alive():
                sup.join(60)
            run.close()
        if set(run.exitcodes.values()) != {0} or run.restarts != {
                "verify:0": 1}:
            raise AssertionError(f"phase 17c: exit codes {run.exitcodes}, "
                                 f"restarts {run.restarts}")
        guard_clean(vc, "phase 17c")
        got_c = [w for _, w in read_capture(str(workdir / "c.cap"))]
        kept = set(got_c)
        # the kill fires before frag `kill_after`: at most the 7 of
        # `cross` ahead of it were processed, and the loss is a tail of
        # `cross` (those 7 unless their verdicts were published, the
        # doomed frag, the rest of its burst)
        n_cross = sum(w in kept for w in cross)
        if (len(got_c) != len(kept) or dd["dup_drop_cnt"] != 0
                or kept != set(first) | set(cross[:n_cross]) | want_late
                or n_cross > kill_after - 1 - pre):
            raise AssertionError(
                f"phase 17c: captured {len(got_c)} ({len(kept)} distinct),"
                f" {n_cross} of the {len(cross)} across the kill, dedup "
                f"dups {dd['dup_drop_cnt']}")
        bundles = sorted(flightrec.load_bundle(str(p))["manifest"]["reason"]
                         for p in (workdir / "fc").iterdir())
        if bundles != ["respawn"]:
            raise AssertionError(f"phase 17c: bundles {bundles}")
        out["c_s"] = time.perf_counter() - t_c
        out["respawn_s"] = t_respawn
        out["lost"] = len(cross) - n_cross
        note(f"phase 17c: verify-bench + a hand-written in-link, respawn "
             f"policy, kill_after_frags:{kill_after},boot:0 on verify:0 "
             f"(exit 86): death -> the respawned tile's RUN in "
             f"{t_respawn:.3f} s (backoff {policy.backoff_s(1, 'verify:0'):.3f}"
             f" s, a new process and CUDA context, the kernels from the "
             f"build cache, every ladder shape warmed); compute_mode "
             f"{mode}; restarts {run.restarts}, one `respawn` bundle; "
             f"{pre} txns verdicted before the kill, all captured; of the "
             f"{len(cross)} sent across it {n_cross} captured and "
             f"{len(cross) - n_cross} lost, the last ones (the tile's "
             f"unverdicted frags, the doomed frag and its burst's tail); "
             f"{len(want_late)} of {n_late} injected after the respawn "
             f"passed the host oracle and all reached the sink, the forged "
             f"none; nothing captured twice, dedup dup_drop "
             f"{dd['dup_drop_cnt']}; every tile's last incarnation exited "
             f"0; part (c) {out['c_s']:.1f} s")

        # ---- (d) the same kill on a packed_wire tile: the frags it held
        t_d = time.perf_counter()
        rows_d = buckets[0][0]
        ml_d = packed_row_ml(256)
        stride_d = ml_d + PACKED_ROW_EXTRA
        kd, per = 12, 4                 # kill threshold, txns a frag
        pre_d = kd - 8
        spec = (TopoBuilder(f"{tag}d", wksp_mb=96)
                .link("inj_verify", depth=32, mtu=rows_d * stride_d)
                .link("verify_dedup", depth=256, mtu=1280)
                .link("dedup_sink", depth=256, mtu=1280)
                .tile("inj", "sink", outs=["inj_verify"])
                .tile("verify:0", "verify", ins=["inj_verify"],
                      outs=["verify_dedup"], device=device, packed_wire=1,
                      buckets=[[rows_d, ml_d]],
                      faults=f"verify:0=kill_after_frags:{kd},boot:0")
                .tile("dedup", "dedup", ins=["verify_dedup"],
                      outs=["dedup_sink"])
                .tile("sink", "sink", ins=["dedup_sink"],
                      capture_path=str(workdir / "d.cap"))
                .build())
        _shm_check(spec.wksp_mb << 20, note)
        # frags of `per` txns each (the first forged), the rest zero
        # rows: pre_d frags the first incarnation verdicts, 16 across its
        # kill threshold, 4 after the respawn's RUN
        wires_d = _forged(_stream_wires(pool, 1707, (pre_d + 20) * per),
                          per)
        frags_d = [wires_d[i:i + per] for i in range(0, len(wires_d), per)]
        ok_d = dict(zip(wires_d, pool.map(_txn_host_ok, wires_d)))

        def packed(frag):
            blk = np.zeros((rows_d, stride_d), np.uint8)
            for j, w in enumerate(frag):
                t = txn_lib.parse(w)
                msg = t.message(w)
                blk[j, :len(msg)] = np.frombuffer(msg, np.uint8)
                blk[j, ml_d:] = np.frombuffer(
                    w[1:65] + t.signer_pubkeys(w)[0]
                    + np.int32(len(msg)).tobytes(), np.uint8)
            return blk

        cursor = {"chunk": None}

        def inject_packed(frags):
            lnk = run.jt.links["inj_verify"]
            if cursor["chunk"] is None:
                cursor["chunk"] = lnk.dcache.chunk0
            metas = []
            for frag in frags:
                blk = packed(frag)
                chunk = cursor["chunk"]
                lnk.dcache.write_view(chunk, blk.nbytes)[:] = blk.ravel()
                cursor["chunk"] = lnk.dcache.advance(chunk, blk.nbytes)
                metas.append((chunk, int.from_bytes(frag[0][1:9], "little")
                              & ((1 << 63) - 1), len(frag)))
            for chunk, sig, n in metas:
                lnk.mcache.publish(sig=sig, chunk=chunk, sz=n)

        def passing(frags):
            return {w for f in frags for w in f if ok_d[w]}

        first_d = frags_d[:pre_d]
        cross_d = frags_d[pre_d:pre_d + 16]
        late_d = frags_d[pre_d + 16:]
        policy = SupervisionPolicy(restart_policy="respawn", max_restarts=2,
                                   drain_timeout_s=120.0,
                                   heartbeat_stale_by_kind={"verify": 120.0})
        run = TopoRun(spec, policy=policy, flight_dir=str(workdir / "fd"))
        sup = threading.Thread(target=run.supervise,
                               kwargs={"poll_s": 0.02}, daemon=True)

        def captured_d():
            return {w for _, w in read_capture(str(workdir / "d.cap"))}

        try:
            run.wait_ready(timeout=300)
            p0 = run.procs["verify:0"]
            sup.start()
            inject_packed(first_d)
            _wait_for(lambda: passing(first_d) <= captured_d(), 120,
                      f"the first {pre_d} frags' txns at the sink", run)
            inject_packed(cross_d)
            _wait_for(lambda: not p0.is_alive(), 120, "the injected kill")
            t_death = time.perf_counter()
            _wait_for(lambda: (run.procs["verify:0"] is not p0
                               and run.jt.cnc["verify:0"].signal_query()
                               == Cnc.SIGNAL_RUN), 300,
                      "the respawned verify:0's RUN")
            t_respawn_d = time.perf_counter() - t_death
            inject_packed(late_d)
            _wait_for(lambda: passing(late_d) <= captured_d(), 300,
                      "the frags injected after the respawn at the sink")
            run._drain_req = True
            sup.join(300)
            if sup.is_alive():
                raise AssertionError("phase 17d: the drain did not end")
            dd = run.metrics("dedup")
            vd = run.metrics("verify:0")
        finally:
            run._halting = True
            if sup.is_alive():
                sup.join(60)
            run.close()
        if (p0.exitcode != KILL_EXIT_CODE
                or set(run.exitcodes.values()) != {0}
                or run.restarts != {"verify:0": 1}):
            raise AssertionError(f"phase 17d: the first verify:0 exited "
                                 f"{p0.exitcode}; exit codes "
                                 f"{run.exitcodes}, restarts {run.restarts}")
        guard_clean(vd, "phase 17d")
        got_d = [w for _, w in read_capture(str(workdir / "d.cap"))]
        kept_d = set(got_d)
        # the kill fires before frag kd: the kd - 1 - pre_d frags of
        # cross_d ahead of it were taken and dispatched (their credits
        # held until the verdict), the rest acked unread.  A taken frag
        # is verdicted whole or lost whole, in dispatch order
        taken = kd - 1 - pre_d
        done = [bool(passing([f]) & kept_d) for f in cross_d]
        n_done = sum(done)
        if (len(got_d) != len(kept_d) or dd["dup_drop_cnt"] != 0
                or done != [True] * n_done + [False] * (16 - n_done)
                or n_done > taken
                or kept_d != (passing(first_d) | passing(cross_d[:n_done])
                              | passing(late_d))):
            raise AssertionError(
                f"phase 17d: captured {len(got_d)} ({len(kept_d)} "
                f"distinct), frags of the 16 across the kill verdicted "
                f"{done}, dedup dups {dd['dup_drop_cnt']}")
        bundles = sorted(flightrec.load_bundle(str(p))["manifest"]["reason"]
                         for p in (workdir / "fd").iterdir())
        if bundles != ["respawn"]:
            raise AssertionError(f"phase 17d: bundles {bundles}")
        out["d_s"] = time.perf_counter() - t_d
        out["packed_respawn_s"] = t_respawn_d
        out["packed_held_lost"] = taken - n_done
        note(f"phase 17d: a packed_wire verify:0 ({rows_d} x {ml_d} rows a "
             f"frag, {per} txns each, the first forged), respawn policy, "
             f"kill_after_frags:{kd},boot:0: {pre_d} frags before the kill "
             f"all verdicted; of the 16 sent across it the tile took "
             f"{taken} (dispatched, credits held) and acked "
             f"{16 - taken} unread; of the {taken} taken {n_done} were "
             f"verdicted before the deferred kill and "
             f"{taken - n_done} lost holding their credits "
             f"({per * (taken - n_done)} txns), with the {16 - taken} "
             f"unread ones {16 - n_done} frags lost in all, none verdicted "
             f"twice (dedup dup_drop {dd['dup_drop_cnt']}); death -> the "
             f"respawned tile's RUN in {t_respawn_d:.3f} s; the {len(late_d)}"
             f" frags after it all verdicted, the host oracle's; part (d) "
             f"{out['d_s']:.1f} s")
        passed = True
    finally:
        if old_omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = old_omp
        if own_dir and passed:
            shutil.rmtree(workdir, ignore_errors=True)
        elif not passed:
            note(f"phase 17: the work directory {workdir} is kept")
    out["s"] = time.perf_counter() - t_phase
    note(f"phase 17: {out['s']:.1f} s")
    return out


def serving_buckets(shapes=BUCKETS):
    """The serving buckets' blobs, (batch, ml, ragged) each: valid
    signatures (256 distinct signings), message lengths 64 at ml 128 and
    uniform in [0, ml] where ragged, a quarter of the rows with one bit
    of S flipped.  Returns ([(batch, ml, blob, expected bits, SHA-512
    blocks, message bytes)], {(batch, ml): the clean arrays})."""
    from firedancer_tpu_torch.models import verifier as V
    buckets, clean = [], {}
    for batch, bml, ragged in shapes:
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
    return buckets, clean


# ---- phase 18: the antipa mode -------------------------------------------


def antipa_edge_ks() -> list:
    """The divstep halving's edge scalars: 0 .. 3, L - 1, L - 2, 2^127 - 1,
    2^127, 2^128, the inverses of small primes (slow for Euclid), powers
    of two and 2^250 mod L (the premultiply)."""
    from firedancer_tpu_torch.ops import scalar25519 as sc
    L = sc.L
    ks = [0, 1, 2, 3, L - 1, L - 2, (1 << 127) - 1, 1 << 127, 1 << 128]
    ks += [pow(x, L - 2, L) for x in (2, 3, 5, 7, 11, 97)]
    ks += [pow(2, j, L) for j in (1, 63, 125, 126, 127, 128, 251)]
    return ks + [pow(2, sc.DIVSTEP_ITERS, L)]


def torsion_forgery(seed: bytes, msg: bytes, order: int, tag: bytes = b""):
    """(sig, pub, k) whose verify defect [S]B - [k]A - R is a point of
    order `order` (1, 2 or 4): R = [r]B + T with the honest S = r + k a.
    Strict verify rejects it unless order is 1; antipa accepts it where
    the order divides v."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    P, L = ed.P, ed.L
    t = {1: (0, 1, 1, 0), 2: (0, P - 1, 1, 0),
         4: (ed.cv.SQRT_M1, 0, 1, 0)}[order]
    pub, a, _ = ed.keypair_from_seed(seed)
    r = int.from_bytes(hashlib.sha512(b"forge" + tag + seed + msg).digest(),
                       "little") % L
    rb = ed._compress_host(ed._pt_add_host(ed._scalar_mul_base_host(r), t))
    k = int.from_bytes(hashlib.sha512(rb + pub + msg).digest(),
                       "little") % L
    return rb + ((r + k * a) % L).to_bytes(32, "little"), pub, k


def torsion_forgeries(msg: bytes, seed: bytes = bytes(range(7, 39))) -> list:
    """One forgery of each case that decides antipa against strict: order
    2 with v even (antipa accepts) and odd, order 4 with v = 0 mod 4
    (accepts) and not.  (sig, pub, k, order, v) each, the first nonce tag
    that gives the case."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    want, out = [(2, True), (2, False), (4, True), (4, False)], {}
    for t in range(512):
        for order in (2, 4):
            sig, pub, k = torsion_forgery(seed, msg, order, t.to_bytes(2,
                                                                  "little"))
            v = ed._divstep_halve_host(k)[1]
            out.setdefault((order, v % order == 0), (sig, pub, k, order, v))
        if len(out) == len(want):
            return [out[w] for w in want]
    raise AssertionError("torsion_forgeries: a case was not found")


def antipa_edge_lanes(seed: bytes = bytes(range(3, 35))) -> list:
    """The antipa tail's edge lanes, fed digests directly: (pub, r, s,
    digest) 160-byte rows.  A signature made valid for each edge scalar
    k (antipa_edge_ks; R = [r]B, S = r + k a), its digest k and k + L;
    valid ones for seeded k whose c = v S mod L has its 32nd window >= 8
    (the signed recode's carry into a 33rd digit) and whose c >> 128 has
    a 32nd window 0; the torsion forgeries of torsion_forgeries with
    their real digests; and prechecks at their edges: S = L, R the
    identity's encoding (small order), R's y >= p (accepted mod p), A
    of order 8.  Each lane's bit on the host is ed.antipa_k_host."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import scalar25519 as sc
    L = sc.L
    pub, a, _ = ed.keypair_from_seed(seed)

    def signed(k: int, tag: bytes = b""):
        r = int.from_bytes(hashlib.sha512(b"edge" + tag + k.to_bytes(
            32, "little")).digest(), "little") % L
        return (ed._compress_host(ed._scalar_mul_base_host(r)),
                ((r + k * a) % L).to_bytes(32, "little"))

    rows = []
    for k in antipa_edge_ks():
        rb, sb = signed(k)
        for d in (k, k + L):
            rows.append(pub + rb + sb + d.to_bytes(64, "little"))
    rng = np.random.default_rng(int.from_bytes(seed[:4], "little"))
    found = 0
    while found < 4:
        k = int.from_bytes(rng.bytes(32), "little") % L
        rb, sb = signed(k)
        v = ed._divstep_halve_host(k)[1]
        c = v * int.from_bytes(sb, "little") % L
        if (c >> 124) & 0xF >= 8:
            rows.append(pub + rb + sb + k.to_bytes(64, "little"))
            found += 1
    msg = bytes(range(32))
    for sig, pk, _, _, _ in torsion_forgeries(msg):
        rows.append(pk + sig + hashlib.sha512(sig[:32] + pk + msg).digest())
    k = antipa_edge_ks()[-1]
    rb, sb = signed(k, b"pre")
    ident = (1).to_bytes(32, "little")
    # the least y whose y + p still fits 255 bits and decompresses
    y0 = next(y for y in range(2, 19)
              if ed._decompress_host(y.to_bytes(32, "little")))
    hi = (y0 + ed.P).to_bytes(32, "little")
    o8 = ed.cv.ORDER8_Y0.to_bytes(32, "little")
    kd = k.to_bytes(64, "little")
    rows += [pub + rb + L.to_bytes(32, "little") + kd,
             pub + ident + sb + kd, pub + hi + sb + kd, o8 + rb + sb + kd]
    return rows


def _antipa_k_row(row: bytes) -> bool:
    """antipa_tail's bit on the host for one (pub, r, s, digest) row, for
    a pool worker."""
    from firedancer_tpu_torch.ops import ed25519 as ed
    return ed.antipa_k_host(row[32:96], row[:32],
                            int.from_bytes(row[96:], "little") % ed.L)


def torsion_txns(seed: int = 1818) -> list:
    """Wire txns of one signature each, signed by torsion forgeries of
    order 2: (wire, v even) for the first two nonces of each parity.  The
    antipa host twin accepts the even ones; strict rejects all four."""
    from firedancer_tpu_torch.ballet import txn as txn_lib
    from firedancer_tpu_torch.ops import ed25519 as ed
    rng = np.random.default_rng(seed)
    key, blockhash, program = rng.bytes(32), rng.bytes(32), rng.bytes(32)
    pub = ed.keypair_from_seed(key)[0]
    out = {True: [], False: []}
    for i in range(256):
        msg = txn_lib.build_unsigned(
            [pub], blockhash, [(1, bytes([0]), (1 << 40 | i).to_bytes(
                8, "little"))], extra_accounts=[program])
        sig, _, k = torsion_forgery(key, msg, 2)
        even = ed._divstep_halve_host(k)[1] % 2 == 0
        if len(out[even]) < 2:
            out[even].append(txn_lib.assemble([sig], msg))
        if len(out[True]) == len(out[False]) == 2:
            return [(w, e) for e in (True, False) for w in out[e]]
    raise AssertionError("torsion_txns: too few forgeries of a parity")


def antipa_phase(pool, reset_counts, counts, note, cuda_ms, dev_ms,
                 int_ops_per_s, buckets=None, device=None,
                 lanes=(1, 7, 32, 4096, 4097, 4111, 32768), n_sample=256,
                 engine_cfg=(4096, 128), n_batches=8, tile_buckets=None,
                 n_wires=512):
    """Phase 18: the antipa mode, through every layer that serves it.
    (a) The antipa_tail kernel against its plain version and the host
    (ed.antipa_k_host) at `lanes` lanes (whole blocks of the kernel's
    32 lanes at 32, 4096 and 32768, a partial last block at the
    others), the edge lanes of antipa_edge_lanes (fed digests directly)
    first, then the adversarial kinds with their real digests; on the
    card the kernel's residency (registers, shared bytes, blocks an
    SM).  (b) SigVerifier(mode="antipa")
    .dispatch_blob at the serving buckets (serving_buckets, or `buckets`):
    sha512_ram and antipa_tail launched once a dispatch and nothing else;
    bits == as constructed == the strict fused verifier's, and the host
    twin's on n_sample seeded rows a bucket; each kernel against its
    plain version at the path's shapes; on the card the kernel's call
    and device ms beside its bound, and dispatch_blob in both modes in
    turns.  (c) The engine (make_ingest) at engine_cfg over n_batches
    batches against serial dispatch_blob.  (d) A port VerifyTile with
    FDTPU_VERIFY_MODE=antipa at tile_buckets (DEFAULT_BUCKETS) on
    n_wires wire txns (a ninth forged) and four torsion forgeries: the
    accepted set the antipa host twin's (the even-v forgeries in it,
    which strict rejects), compile_cnt and the guard's counters 0.
    device None is the card.  Raises on any failed check; returns the
    numbers for the kernels record."""
    import torch

    from firedancer_tpu_torch.disco import pipeline as pl
    from firedancer_tpu_torch.disco.verify_tile import VerifyTile
    from firedancer_tpu_torch.models import verifier as V
    from firedancer_tpu_torch.ops import antipa_tail as at
    from firedancer_tpu_torch.ops import sha512_kernel as sk
    from firedancer_tpu_torch.tools.kernel_time import (antipa_bound_ms,
                                                        antipa_residency)
    t_phase = time.perf_counter()
    cuda = device is None
    dev = torch.device("cuda", 0) if cuda else torch.device(device)
    out = {"residency": None}
    if cuda:
        from firedancer_tpu_torch.kernels import build
        out["residency"] = antipa_residency(torch, build.load("antipa_tail"))
        note(f"phase 18: antipa_tail residency {json.dumps(out['residency'])}")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def tail_args(blob, ml):
        r, s, a = blob[:, ml:ml + 32], blob[:, ml + 32:ml + 64], \
            blob[:, ml + 64:ml + 96]
        return a, r, s, sk.sha512_ram(blob[:, :ml], r, a, blob[:, ml + 96:])

    def hold(args, what) -> None:
        got, want = at.antipa_tail(*args), at.antipa_tail_plain(*args)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"phase 18 {what}: antipa_tail differs from "
                                 f"plain on {int((got != want).sum())} of "
                                 f"{len(want)} lanes")

    # ---- (a) the kernel against plain and the host, edge lanes first
    edges = antipa_edge_lanes()
    msgs, lens, sigs, pubs, _ = V.make_adversarial_batch(TAIL_LANES, 128)
    ab = torch.from_numpy(V.pack_blob(msgs, lens, sigs, pubs)).to(dev)
    dig = tail_args(ab, 128)[3].cpu().numpy()
    rows = np.frombuffer(b"".join(edges + [
        bytes(pubs[i]) + bytes(sigs[i]) + bytes(dig[i])
        for i in range(len(pubs))]), np.uint8).reshape(-1, 160)
    host = np.array(pool.map(_antipa_k_row, [bytes(r) for r in rows]))
    for n in lanes:
        t = torch.from_numpy(np.resize(rows, (n, 160))).to(dev)
        args = (t[:, :32], t[:, 32:64], t[:, 64:96], t[:, 96:])
        hold(args, f"{n} lanes")
        bits = at.antipa_tail(*args).cpu().numpy()
        if not np.array_equal(bits, np.resize(host, n)):
            raise AssertionError(f"phase 18a: {n} lanes differ from the "
                                 f"host on {int((bits != np.resize(host, n)).sum())}")
    per = (out["residency"] or {}).get("lanes_a_block")
    note(f"phase 18a: antipa_tail == plain == host (antipa_k_host) at "
         f"{', '.join(map(str, lanes))} lanes"
         + (f" (last block {', '.join(str(n % per or per) for n in lanes)} "
            f"of {per} lanes)" if per else "") + ", 0 lanes differing: "
         f"{len(edges)} edge lanes fed digests directly ({int(host[:len(edges)].sum())} "
         f"accept: the halving's edge scalars as k and k + L, c's 32nd "
         f"window >= 8, order-2 and order-4 forgeries with v even and "
         f"odd, S = L, R the identity, R's y >= p, A of order 8), then "
         f"{len(pubs)} adversarial lanes")

    # ---- (b) dispatch_blob at the serving buckets
    if buckets is None:
        buckets = serving_buckets()[0]
    shapes = [(b, m) for b, m, *_ in buckets]
    strict_v = {bm: V.SigVerifier(V.VerifierConfig(*bm), device=device)
                for bm in shapes}
    anti_v = {bm: V.SigVerifier(V.VerifierConfig(*bm), mode="antipa",
                                device=device) for bm in shapes}
    strict_bits = [np.asarray(strict_v[(b, m)].dispatch_blob(x))
                   for b, m, x, *_ in buckets]
    reset_counts()
    res = [np.asarray(anti_v[(b, m)].dispatch_blob(x))
           for b, m, x, *_ in buckets]
    launches = counts()
    want_l = {k: len(buckets) if k in ("sha512_ram", "antipa_tail") else 0
              for k in launches}
    if launches != want_l:
        raise AssertionError(f"phase 18b: launches {launches}, expected "
                             f"{want_l}")
    rng = np.random.default_rng(18)
    for (b, m, x, expect, *_), r, sb in zip(buckets, res, strict_bits):
        if not (np.array_equal(r, expect) and np.array_equal(r, sb)):
            raise AssertionError(f"phase 18b: {b}x{m}: {int((r != sb).sum())} "
                                 f"bits differ from strict, "
                                 f"{int((r != expect).sum())} from as built")
        idx = np.sort(rng.choice(b, min(n_sample, b), replace=False))
        hb = np.concatenate([np.asarray(h, bool) for h in pool.map(
            _host_blob_antipa, np.array_split(x[idx], 8))])
        if not np.array_equal(hb, r[idx]):
            raise AssertionError(f"phase 18b: {b}x{m}: "
                                 f"{int((hb != r[idx]).sum())} of {len(idx)} "
                                 f"sampled rows differ from the host twin")
        blob = torch.from_numpy(x).to(dev)
        hold(tail_args(blob, m), f"{b}x{m}")
        note(f"phase 18b: SigVerifier(mode='antipa').dispatch_blob {b}x{m}: "
             f"{int(r.sum())} accept == as built == strict fused; the host "
             f"twin on {len(idx)} seeded rows; antipa_tail == plain")
    note(f"phase 18b: launches {launches} for {len(buckets)} dispatches")
    out.update({"launches": launches["antipa_tail"], "err": 0, "times": {}})
    if cuda:
        for b, m, x, *_ in buckets:
            blob = torch.from_numpy(x).to(dev)
            args = tail_args(blob, m)
            t_k = cuda_ms(lambda: at.antipa_tail(*args))
            d_k = dev_ms(lambda: at.antipa_tail(*args), "antipa_tail_kernel")
            bd = antipa_bound_ms(b, int_ops_per_s)
            e2e = {"strict": [], "antipa": []}
            for mode in ("strict", "antipa", "antipa", "strict"):
                ver = (anti_v if mode == "antipa" else strict_v)[(b, m)]
                for _ in range(3):
                    np.asarray(ver.dispatch_blob(x))
                ts = []
                for _ in range(RUNS):
                    t0 = time.perf_counter()
                    np.asarray(ver.dispatch_blob(x))
                    ts.append((time.perf_counter() - t0) * 1e3)
                e2e[mode].append(statistics.median(ts))
            out["times"][f"{b}x{m}"] = {
                "ms": t_k, "device_ms": d_k, "bound_ms": bd[0],
                "bound_by": bd[1], "dispatch_antipa_ms": e2e["antipa"],
                "dispatch_strict_ms": e2e["strict"]}
            note(f"phase 18 {b}x{m}: antipa_tail call {t_k:.5f} ms, device "
                 f"{d_k:.5f} ms (bound {bd[0]:.5f} ms, {bd[1]}); "
                 f"dispatch_blob + harvest, strict fused "
                 f"{e2e['strict'][0]:.4f}, {e2e['strict'][1]:.4f} ms, antipa "
                 f"{e2e['antipa'][0]:.4f}, {e2e['antipa'][1]:.4f} ms "
                 f"(turns strict, antipa, antipa, strict; median of {RUNS})")
        b, m, x = buckets[0][:3]
        args = tail_args(torch.from_numpy(x).to(dev), m)
        out["plain_ms"] = cuda_ms(lambda: at.antipa_tail_plain(*args),
                                  PLAIN_RUNS, 1)
        note(f"phase 18 {b}x{m}: plain antipa_tail {out['plain_ms']:.4f} ms")

    # ---- (c) the engine against serial dispatch_blob
    b, ml = engine_cfg
    sv = anti_v.get((b, ml)) or V.SigVerifier(V.VerifierConfig(b, ml),
                                             mode="antipa", device=device)
    batches = [V.make_example_batch(b, ml, i % 2 == 0, 1800 + i,
                                    sign_pool=32)
               for i in range(n_batches - 1)]
    batches.append(V.make_adversarial_batch(b, ml, seed=1899)[:4])
    serial = [np.asarray(sv.dispatch_blob(V.pack_blob(*x))) for x in batches]
    strict_sv = V.SigVerifier(V.VerifierConfig(b, ml), device=device)
    strict_ser = [np.asarray(strict_sv.dispatch_blob(V.pack_blob(*x)))
                  for x in batches]
    eng = sv.make_ingest(nbuf=3, depth=2)
    reset_counts()
    got = []
    for x in batches:
        got += eng.submit(*x)
    got += eng.drain()
    launches_c = counts()
    if len(got) != n_batches or any(not np.array_equal(g, s) or
                                    not np.array_equal(g, t)
                                    for g, s, t in zip(got, serial,
                                                       strict_ser)):
        raise AssertionError("phase 18c: the engine's bits differ from "
                             "serial dispatch_blob or from strict")
    if not (launches_c["sha512_ram"] == launches_c["antipa_tail"]
            == eng.dispatches == n_batches and launches_c["verify_tail"]
            == launches_c["r_check"] == 0):
        raise AssertionError(f"phase 18c: launches {launches_c}")
    note(f"phase 18c: engine {b}x{ml}, make_ingest(nbuf=3, depth=2) in "
         f"antipa mode: bits == serial dispatch_blob == strict on all "
         f"{n_batches} x {b} rows; sha512 and antipa_tail launches "
         f"{launches_c['antipa_tail']} == dispatches; stats {eng.stats()}")

    # ---- (d) the verify tile with FDTPU_VERIFY_MODE=antipa
    tb = [list(x) for x in (tile_buckets or pl.DEFAULT_BUCKETS)]
    tors = torsion_txns()
    wires = _forged(_stream_wires(pool, 1818, n_wires), 9)
    wires = wires[:n_wires // 2] + [w for w, _ in tors] + wires[n_wires // 2:]
    host_a = pool.map(functools.partial(_txn_host_ok, mode="antipa"), wires)
    host_s = pool.map(_txn_host_ok, wires)
    want = {w for w, ok in zip(wires, host_a) if ok}
    even = {w for w, e in tors if e}
    if not (even <= want and not even & {w for w, ok in zip(wires, host_s)
                                         if ok}):
        raise AssertionError("phase 18d: the even-v forgeries do not split "
                             "the two host twins")
    prev = os.environ.get("FDTPU_VERIFY_MODE")
    os.environ["FDTPU_VERIFY_MODE"] = "antipa"
    try:
        cfg = {"buckets": tb}
        if device is not None:
            cfg["device"] = device
        tile, ctx = VerifyTile(), _RecCtx(cfg)
        t0 = time.perf_counter()
        tile.init(ctx)
        t_boot = time.perf_counter() - t0
    finally:
        if prev is None:
            del os.environ["FDTPU_VERIFY_MODE"]
        else:
            os.environ["FDTPU_VERIFY_MODE"] = prev
    if tile.guard.fn.mode != "antipa":
        raise AssertionError("phase 18d: the tile's verifier is not antipa")
    reset_counts()
    t0 = time.perf_counter()
    for lo in range(0, len(wires), 64):
        part = wires[lo:lo + 64]
        offs = np.zeros(len(part) + 1, np.int64)
        np.cumsum([len(w) for w in part], out=offs[1:])
        metas = np.zeros(len(part), dtype=[("sig", np.uint64)])
        tile.on_burst(ctx, 0, metas, np.frombuffer(b"".join(part), np.uint8),
                      offs, len(part))
        tile.after_credit(ctx)
    tile._forward(ctx, tile.pipe.flush())
    sync()
    t_wire = time.perf_counter() - t0
    tile._sync_metrics(ctx)
    guard_clean(ctx.metrics, "phase 18d")
    launches_d = counts()
    snap = tile.pipe.metrics.snapshot()
    got_w = [p for p, _ in ctx.published]
    if len(got_w) != len(set(got_w)) or set(got_w) != want:
        raise AssertionError(f"phase 18d: accepted {len(got_w)} wire txns, "
                             f"the antipa host twin {len(want)}")
    if snap["compile_cnt"] or not (
            launches_d["sha512_ram"] == launches_d["antipa_tail"]
            == snap["batches"] > 0 and launches_d["verify_tail"] == 0):
        raise AssertionError(f"phase 18d: compile_cnt {snap['compile_cnt']}, "
                             f"launches {launches_d} for {snap['batches']} "
                             f"dispatches")
    note(f"phase 18d: VerifyTile with FDTPU_VERIFY_MODE=antipa at buckets "
         f"{tb}: boot {t_boot:.3f} s; {len(wires)} wire txns "
         f"({len(wires) - len(want)} rejected: a ninth forged and the odd-v "
         f"order-2 forgeries), accepted {len(got_w)} == the antipa host "
         f"twin, the {len(even)} even-v order-2 forgeries among them "
         f"(strict rejects them); {len(wires) / t_wire:.1f} txns/s; sha512 "
         f"and antipa_tail launches {launches_d['antipa_tail']} == "
         f"{snap['batches']} dispatches; compile_cnt 0; guard counters 0")
    out["phase_s"] = time.perf_counter() - t_phase
    note(f"phase 18: {out['phase_s']:.1f} s")
    return out


def _host_blob_antipa(blob):
    """host_verify_blob in antipa mode, for a pool worker."""
    from firedancer_tpu_torch.models import verifier as V
    return V.host_verify_blob(blob, mode="antipa")


# ---- phase 19: the leader's tail ----------------------------------------

def _archived(path) -> dict:
    """slot -> (entry-batch bytes, entries) of every slot a store's
    SlotArchive holds."""
    from firedancer_tpu_torch.ballet import entry as entry_lib
    from firedancer_tpu_torch.flamenco.blockstore import SlotArchive
    arch = SlotArchive(str(path))
    try:
        return {s: (arch.get(s), entry_lib.deserialize_batch(arch.get(s)))
                for s in arch.slots()}
    finally:
        arch.close()


def leader_tail_spec(tag, device, hpt, tps, n_src, seed, workdir, key_path,
                     keys):
    """Phase 19's topology: leader-bench with [leader] pack_shards = 2 at
    hpt x tps (source -> verify -> leader_pack:0..1 -> leader_merge ->
    poh_dev -> sink, the sink capturing every entry poh_dev publishes),
    and the leader's tail beside the sink on poh_dev's link: shred (the
    leader role, 32:32) <-> sign, shred -> store; the shred tile's second
    fan-out link is the net in-link of a follower shred tile whose
    turbine stakes only the leader (its admission on the card) ->
    shred_recover -> sink, and -> its own store.  Both stores archive
    their complete slots.  Returns (cfg, spec)."""
    from firedancer_tpu_torch.app import config as app_config
    from firedancer_tpu_torch.disco import topo as topo_mod
    cfg = app_config.load(environ={})
    cfg["name"] = tag
    cfg["topology"] = "leader-bench"
    cfg["development"]["source_count"] = n_src
    cfg["development"]["bench_seed"] = seed
    cfg["tiles"]["verify"]["device"] = device or ""
    cfg["leader"].update(pack_shards=2, hashes_per_tick=hpt,
                         ticks_per_slot=tps, device=device or "",
                         capture_path=str(workdir / "entries.cap"))
    cfg["supervision"]["drain_timeout_s"] = 120.0
    front = app_config.build_topology(cfg)
    ext = {"device": device or None}
    follower = {"identity": keys["me"].hex(), "fanout": 200, "port": 0,
                "slots_per_epoch": 432_000,
                "stakes": {keys["leader"].hex(): [1000, "", 0],
                           keys["me"].hex(): [0, "", 0]}}
    L, T, IL = topo_mod.LinkSpec, topo_mod.TileSpec, topo_mod.InLink
    links = (L("shred_sign", 16, 128), L("sign_shred", 16, 128),
             L("s_store", 4096, 1280), L("s_net", 4096, 1280),
             L("f_store", 4096, 1280), L("f_rec", 4096, 1280),
             L("r_sink", 64, 32768))
    tiles = (
        T("shred", "shred", (IL("poh_sink"),),
          ("shred_sign", "s_store", "s_net"),
          {"fec_data_cnt": SHRED_K, **ext}),
        T("sign", "sign", (IL("shred_sign"),), ("sign_shred",),
          {"key_path": str(key_path)}),
        T("store", "store", (IL("s_store"),), (),
          {"max_slots": 64, "archive_path": str(workdir / "leader.slots"),
           **ext}),
        T("fshred", "shred", (IL("s_net"),), ("f_store", "f_rec"),
          {"net_ins": ["s_net"], "turbine": follower,
           "sig_backend": "device", **ext}),
        T("fstore", "store", (IL("f_store"),), (),
          {"max_slots": 64,
           "archive_path": str(workdir / "follower.slots"), **ext}),
        T("frec", "shred_recover", (IL("f_rec"),), ("r_sink",), dict(ext)),
        T("rsink", "sink", (IL("r_sink"),), (),
          {"capture_path": str(workdir / "recovered.cap")}))
    spec = topo_mod.TopoSpec(front.app, front.links + links,
                             front.tiles + tiles, wksp_mb=160).validate()
    return cfg, spec


def leader_tail_phase(reset_counts, counts, note, device=None,
                      hpt=POH_HASHES_PER_TICK, tps=POH_TICKS_PER_SLOT,
                      n_src=512, seed=2, slots=2, workdir=None):
    """Phase 19: the leader's tail in spawned processes (leader_tail_spec):
    verified txns through the sharded pack and its merge into poh_dev's
    chain, cut into signed 32:32 FEC sets (each root signed by the sign
    tile through the keyguard, each set's parity one launch of the GF(2)
    kernel), stored, and admitted by a follower on the card (sha512,
    verify_tail, r_check and bmtree_walk) into shred_recover (GF(2)) and
    its own store.  It runs until `slots` slots are complete in both
    stores and every txn is in the chain, then drain()s.  Checks: both
    archives hold every slot poh_dev published, complete, each slot's
    entries byte for byte the captured ones, the chain re-verifies from
    the seed, the recovered set payloads are the follower's slot bytes;
    sign_cnt == fec_set_cnt, refuse_cnt 0, the follower's
    shred_sig_fail_cnt 0, the shards' sched_txn_cnt sum to the accepted
    txns (both shards scheduled some), drain() True, every exit code 0;
    on the card the tiles' drain manifests count one gf2_recover launch
    a set in the leader's shred process, poh_spans and mixin_tree as
    15d, and as many bmtree_walk, sha512_ram, verify_tail and r_check
    launches as admission bursts in the follower's.  It prints the
    slot's wall time (the leader store's complete_slot polled every 5
    ms), each set's cut in the tile (make_fec_set with its signing) and
    the keyguard round trip (both from the tile's drain manifest), a
    set's cut in this process (make_fec_set with a fixed signature)
    against its encode launch's device time (CUDA events), and shreds a
    second into the leader's store over the measured slot.  device None
    is the card.  The default seed's four source keys split two and two
    between the shards' fee-payer partitions.  Returns the numbers for
    the kernels record.  Raises on any failed check."""
    import shutil
    import tempfile

    import torch

    from firedancer_tpu_torch.ballet import entry as entry_lib
    from firedancer_tpu_torch.ballet import shred as sl
    from firedancer_tpu_torch.disco import keyguard
    from firedancer_tpu_torch.disco.leader_tiles import PohDevTile
    from firedancer_tpu_torch.disco.run import SupervisionPolicy, TopoRun
    from firedancer_tpu_torch.disco.tiles import read_capture
    from firedancer_tpu_torch.ops import gf2_recover as gf2

    tag = f"cs{os.getpid()}t"
    t_phase = time.perf_counter()
    own_dir = workdir is None
    workdir = Path(workdir or tempfile.mkdtemp(prefix="fdtpu_phase19_"))
    keys = shred_keys()
    kpath = workdir / "leader.json"
    keyguard.keypair_write(str(kpath), LEADER_SEED, keys["leader"])
    cfg, spec = leader_tail_spec(tag, device, hpt, tps, n_src, seed,
                                 workdir, kpath, keys)
    _shm_check(spec.wksp_mb << 20, note)
    old_env = {k: os.environ.get(k)
               for k in ("OMP_NUM_THREADS", "FDTPU_DRAIN_DIR")}
    os.environ["OMP_NUM_THREADS"] = "1"
    # each tile's drain manifest: the shred tiles', poh_dev's and
    # shred_recover's record their kernel launches
    os.environ["FDTPU_DRAIN_DIR"] = str(workdir / "drain")
    done_at = {}       # leader store's complete_slot -> (time, stored)
    try:
        t0 = time.perf_counter()
        run = TopoRun(spec, policy=SupervisionPolicy.from_cfg(cfg))
        try:
            run.wait_ready(timeout=cfg["supervision"]["boot_grace_s"])
            t_boot = time.perf_counter() - t0
            t0 = time.perf_counter()
            packs = [t.name for t in spec.tiles if t.kind == "leader_pack"]

            def tail_done():
                sm = run.metrics("store")
                done_at.setdefault(sm["complete_slot"], (
                    time.perf_counter(), sm["shred_store_cnt"]))
                v = run.metrics("verify:0")
                sched = sum(run.metrics(p)["sched_txn_cnt"] for p in packs)
                return (v["verify_pass_cnt"] == n_src and sched == n_src
                        and run.metrics("poh_dev")["mixin_cnt"]
                        == run.metrics("leader_merge")["mb_merge_cnt"]
                        and sm["complete_slot"] >= slots
                        and run.metrics("fstore")["complete_slot"] >= slots)

            _wait_for(tail_done, 600, f"{slots} slots stored by both "
                      f"stores and every txn in the chain", run)
            t_run = time.perf_counter() - t0
            t0 = time.perf_counter()
            drained = run.drain()
            t_drain = time.perf_counter() - t0
            m = {t.name: run.metrics(t.name) for t in spec.tiles}
            man = {n: run._load_drain_manifest(n)["tile_state"]
                   for n in ("shred", "fshred", "poh_dev", "frec")}
        finally:
            run.close()
    finally:
        for k, val in old_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    if not drained or set(run.exitcodes.values()) != {0}:
        raise AssertionError(f"phase 19: drain() {drained}, exit codes "
                             f"{run.exitcodes}")
    done_bit = PohDevTile.SLOT_DONE_BIT
    recs = read_capture(str(workdir / "entries.cap"))
    cap = {}
    for s, p in recs:
        cap.setdefault(s & ~done_bit, []).append(p)
    ents = [entry_lib.Entry.deserialize(p)[0] for _, p in recs]
    chain_ok = entry_lib.verify_chain(bytes(32), ents)
    lead, foll = (_archived(workdir / f"{w}.slots")
                  for w in ("leader", "follower"))
    bad = [(w, s) for w, arch in (("leader", lead), ("follower", foll))
           for s in sorted(set(arch) | set(cap))
           if s not in arch or s not in cap
           or [e.serialize() for e in arch[s][1]] != cap[s]]
    rec = {}
    for s, p in read_capture(str(workdir / "recovered.cap")):
        rec.setdefault(s, []).append(p)
    rec_bad = [s for s in rec if s not in foll
               or b"".join(rec[s]) != foll[s][0]]
    sh, fsh, gm = m["shred"], m["fshred"], m["sign"]
    sched = [m[p]["sched_txn_cnt"] for p in packs]
    on_card = device is None
    la, fl = man["shred"]["launches"], man["fshred"]["launches"]
    pl = man["poh_dev"]["launches"]
    n_sets = sh["fec_set_cnt"]
    if not (chain_ok and not bad and not rec_bad and len(lead) >= slots
            and gm["sign_cnt"] == n_sets > 0 and gm["refuse_cnt"] == 0
            and sh["unshred_entry_cnt"] == 0
            and m["store"]["parse_fail_cnt"] == 0
            and fsh["shred_sig_fail_cnt"] == 0
            and fsh["shred_rx_cnt"] == sh["shred_tx_cnt"] // 2
            and m["frec"]["fec_fail_cnt"] == 0
            and m["frec"]["fec_host_fallback_cnt"] == 0
            and sum(sched) == m["verify:0"]["verify_pass_cnt"] == n_src
            and min(sched) > 0
            and m["leader_merge"]["drain_drop_cnt"] == 0
            and (not on_card or (
                la["gf2_recover"] == man["shred"]["fec_set_cnt"] > 0
                and pl["poh_spans"] == (man["poh_dev"]["dispatch_cnt"]
                                        + man["poh_dev"][
                                            "splice_dispatch_cnt"])
                and pl["mixin_tree"] == man["poh_dev"]["splice_dispatch_cnt"]
                and fl["bmtree_walk"] == fl["sha512_ram"]
                == fl["verify_tail"] == fl["r_check"]
                == man["fshred"]["sig_batch_cnt"] > 0
                and man["frec"]["launches"]["gf2_recover"]
                == man["frec"]["fec_dispatch_cnt"] + 1))):
        raise AssertionError(
            f"phase 19: chain {chain_ok}, slots captured {sorted(cap)}, "
            f"leader archive {sorted(lead)}, follower {sorted(foll)}, "
            f"differing {bad}, recovered differing {rec_bad}; shred {sh}, "
            f"sign {gm}, follower {fsh}, recover {m['frec']}, shards "
            f"{sched}, verify {m['verify:0']}; at the drain {man}")
    # the slot's wall time and the store's shred rate over the last slot
    # whose close and its predecessor's the poll both saw (slot 1's close
    # includes the boot's tail)
    pairs = [s for s in sorted(done_at) if s > 1 and s - 1 in done_at]
    t_slot = shreds_s = None
    if pairs:
        (t_a, n_a), (t_b, n_b) = done_at[pairs[-1] - 1], done_at[pairs[-1]]
        t_slot = t_b - t_a
        shreds_s = (n_b - n_a) / t_slot
    sign_us = [ns / 1e3 for ns in man["shred"]["sign_ns"]]
    cut_ms = [ns / 1e6 for ns in man["shred"]["cut_ns"]]
    # one set's cut in this process at the tile's batch_max, a fixed
    # signature in place of the keyguard, against its encode launch
    batch, size = [], 0
    for p in (p for s in sorted(cap) for p in cap[s]):
        batch.append(entry_lib.Entry.deserialize(p)[0])
        size += len(p)
        if size >= 16 << 10:
            break
    blob = entry_lib.serialize_batch(batch)
    sig64 = bytes(64)

    def cut():
        return sl.make_fec_set(blob, 1, 1, 1, 0, lambda r: sig64,
                               data_cnt=SHRED_K, code_cnt=SHRED_K,
                               torch_device=device)

    reset_counts()
    for _ in range(3):
        cut()
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        cut()
        walls.append((time.perf_counter() - t0) * 1e3)
    cut_here = statistics.median(walls)
    enc_ms = _launch_ms(torch, gf2, "gf2_recover", cut)
    n_cut = counts()["gf2_recover"]
    if on_card and n_cut != 2 * (3 + RUNS):
        raise AssertionError(f"phase 19: {2 * (3 + RUNS)} cuts launched "
                             f"gf2_recover {n_cut} times")
    launches = {"shred.gf2_recover": la.get("gf2_recover", 0),
                "frec.gf2_recover": man["frec"]["launches"]["gf2_recover"],
                "poh_spans": pl["poh_spans"], "mixin_tree": pl["mixin_tree"],
                **{f"fshred.{k}": fl.get(k, 0) for k in (
                    "sha512_ram", "verify_tail", "r_check", "bmtree_walk")}}
    note(f"phase 19: the leader's tail in processes (leader-bench, "
         f"pack_shards 2, poh_dev at {hpt} x {tps}, 32:32 sets): {n_src} "
         f"txns accepted and scheduled once each by the two shards "
         f"({sched[0]} + {sched[1]}), merged ({m['leader_merge']['mb_merge_cnt']}"
         f" microblocks, {m['leader_merge']['merge_budget_defer_cnt']} "
         f"deferred), {len(ents)} entries in {len(cap)} slots re-verify "
         f"from the seed; {n_sets} FEC sets, sign_cnt {gm['sign_cnt']}, "
         f"refuse_cnt {gm['refuse_cnt']}; both archives hold slots "
         f"{sorted(lead)} complete, each slot's entries byte for byte "
         f"poh_dev's, the last cut by the drain; the follower admitted "
         f"{fsh['shred_rx_cnt']} shreds in {fsh['sig_batch_cnt']} bursts, "
         f"shred_sig_fail {fsh['shred_sig_fail_cnt']}; shred_recover's "
         f"{sum(map(len, rec.values()))} set payloads == the follower's "
         f"slot bytes; drain() True in {t_drain:.3f} s, every tile exited "
         f"0; boot {t_boot:.3f} s, run {t_run:.3f} s; launches in the "
         f"tiles' processes (drain manifests) {launches}")
    slot_txt = ("the poll saw no two consecutive slots close: slot wall "
                "time and shred rate not measured" if t_slot is None else
                f"slot {pairs[-1]} closed {t_slot:.4f} s after slot "
                f"{pairs[-1] - 1} in the leader's store (Agave's slot "
                f"{AGAVE_SLOT_MS:.0f} ms); {shreds_s:.1f} shreds a second "
                f"into the leader's store over it")
    note(f"phase 19: {slot_txt}; a set's cut in the shred tile, "
         f"signing included: median {statistics.median(cut_ms):.4f} ms, "
         f"max {max(cut_ms):.4f} ms over {len(cut_ms)} sets; the keyguard "
         f"round trip: median {statistics.median(sign_us):.1f} us, max "
         f"{max(sign_us):.1f} us; in this process a set of "
         f"{len(blob)} bytes ({len(batch)} entries) cut by make_fec_set "
         f"with a fixed signature {cut_here:.4f} ms (median of {RUNS}), "
         f"its encode launch {_ms_text(enc_ms)} of device time")
    if own_dir:
        shutil.rmtree(workdir, ignore_errors=True)
    out = {"launches": launches, "fec_sets": n_sets, "t_slot": t_slot,
           "shreds_s": shreds_s, "cut_ms": statistics.median(cut_ms),
           "sign_us": statistics.median(sign_us), "cut_here_ms": cut_here,
           "encode_ms": enc_ms, "phase_s": time.perf_counter() - t_phase}
    note(f"phase 19: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from firedancer_tpu_torch.kernels import build
        from firedancer_tpu_torch.models import verifier as V
        from firedancer_tpu_torch.ops import antipa_tail as at
        from firedancer_tpu_torch.ops import curve25519 as cv
        from firedancer_tpu_torch.ops import decompress as dc
        from firedancer_tpu_torch.ops import dsm
        from firedancer_tpu_torch.ops import ed25519 as ed
        from firedancer_tpu_torch.ops import bmtree_walk as bw
        from firedancer_tpu_torch.ops import f25519 as fe
        from firedancer_tpu_torch.ops import gf2_recover as gf2
        from firedancer_tpu_torch.ops import mixin_tree as mt
        from firedancer_tpu_torch.ops import msm as ms
        from firedancer_tpu_torch.ops import poh_spans as ps
        from firedancer_tpu_torch.ops import r_check as rck
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
        back-to-back calls where three traces held under half a launch a
        call of it."""
        ms, _, _, how = device_ms(torch, fn, entry, RUNS)
        if how != "profiler":
            note(f"{entry}: three profiler traces held under half a launch "
                 f"a call of it; its device ms {ms:.5f} is by CUDA events "
                 f"around {RUNS} back-to-back calls")
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
    buckets, clean = serving_buckets()
    verifiers = {(b, m): V.SigVerifier(V.VerifierConfig(b, m))
                 for b, m, *_ in buckets}
    counted = {"sha512_ram": sk.sha512_ram, "verify_tail": vt.verify_tail,
               "r_check": rck.r_check, "decompress": dc.decompress,
               "reduce_recode": rr.reduce_recode,
               "dsm_tail_q": dsm.dsm_tail_q,
               "double_scalar_mul_base": dsm.double_scalar_mul_base,
               "rlc_recode": rl.rlc_recode, "poh_spans": ps.poh_spans,
               "mixin_tree": mt.mixin_tree, "gf2_recover": gf2.gf2_recover,
               "bmtree_walk": bw.bmtree_walk, "antipa_tail": at.antipa_tail}

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
    if not (launches["sha512_ram"] == launches["verify_tail"]
            == launches["r_check"] == len(buckets)):
        raise AssertionError(f"launches {launches} for {len(buckets)} "
                             f"dispatches")
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
                              "dsm_tail_q", "r_check"),
                    "unfused": ("sha512_ram", "decompress",
                                "double_scalar_mul_base", "r_check")}
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
        y_r = rck._parse_r_bytes(r_)[0]
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

    # ---- phase 5c: the finish (r_check kernel) vs plain, bit for bit, in
    # both forms: ok_y with the fused tail's X and Z, qy with the unfused
    # layout's X, Y and Z, on the 32768 x 128 bucket's rows with the
    # adversarial lanes over the first 528 and the edge lanes
    # (r_check_edges) over the first of those, R read in place
    rc_err, rc_edges = 0, 0
    blob_np = next(b[2] for b in buckets if b[:2] == (32768, 128))
    for n in (1, 4096, 4097, 32768):
        blob = hold_rows(blob_np, 128, n)
        m_, r_, s_, a_, ln_ = cols(blob, 128)
        digest = sk.sha512_ram(m_, r_, a_, ln_)
        ok_t, qx, qz = vt.verify_tail(a_, s_, digest, r_)
        q = dsm.double_scalar_mul_base(
            sc.scalar_windows(s_), sc.limbs_to_windows(sc.reduce_512(digest)),
            cv.neg(ed._decompress_checked(a_)[1]))
        qy = q.Y.clone()
        rc_edges = write_r_edges(qx, qz, qy, ok_t, r_)
        write_r_edges(q.X, q.Z, q.Y, ok_t.clone(), r_)
        for form, args, kw in (("ok_y", (qx, qz, r_, ok_t), {}),
                               ("qy", (q.X, q.Z, r_), {"qy": q.Y})):
            got = rck.r_check(*args, **kw)
            want = rck.r_check_plain(*args, **kw)
            rc_err = max(rc_err, hold(f"r_check {form}", (got,), (want,)))
            if n > 1 and not (bool(got.any()) and not bool(got.all())):
                raise AssertionError(f"r_check {form} {n} lanes: the bits "
                                     f"are not mixed")
    print(f"r_check: kernel == plain at 1, 4096, 4097 and 32768 lanes in "
          f"the ok_y and qy forms ({rc_edges} edge lanes: Z = 0 and p, R's "
          f"y >= p, off the curve, the five small-order y, x = 0 with the "
          f"sign bit, the largest TIGHT limbs, and Z the {len(r_check_long_zs())}"
          f" seeded values whose division runs the most divsteps, "
          f"{rc_divsteps(r_check_long_zs()[0])} at most), max error {rc_err}")

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

    def rc_bound(qz):
        """((least ms, what bounds it, the term that sets it), the Fermat
        count's ms) of the finish in the ok_y form on Z planes qz: reads X
        and Z (int64 planes), ok_y and R, writes the bit; the operations
        and the longest lane's critical path of the batches and steps
        each lane's Z takes (rc_steps, over the pool)."""
        n = qz.shape[1]
        zs = fe.to_ints(qz.cpu())
        with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as p_:
            steps = [x for part in p_.map(
                _rc_steps_of, [zs[i::64] for i in range(64)]) for x in part]
        ops = sum(b * RC_BATCH_OPS + k * RC_STEP_OPS for b, k in steps)
        cp = max(b * RC_BATCH_DEPTH + k * RC_STEP_DEPTH
                 for b, k in steps) / (clock_mhz * 1e6) * 1e3
        b_ = bound(n * (160 + 1 + 32 + 1), ops)
        term = ("bytes" if b_[1] == "bytes" else
                "critical path" if cp > b_[0] else "issue")
        old = bound(n * (160 + 1 + 32 + 1),
                    n * (RC_MUL * MUL_OPS + RC_SQR * SQR_OPS))
        return (max(b_[0], cp), b_[1] if term != "critical path"
                else "operations", term), old[0]

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
        t_r = cuda_ms(lambda: rck.r_check(qx, qz, r_bytes, ok_t))
        d_r = dev_ms(lambda: rck.r_check(qx, qz, r_bytes, ok_t),
                     "r_check_kernel")
        ver = verifiers[(batch, bml)]
        t_e2e = wall_ms(lambda: np.asarray(ver.dispatch_blob(blob_np)))
        sb, tb = sha_bound(batch, nblocks, msg_bytes), tail_bound(batch)
        rb, rb_old = rc_bound(qz)
        timing[(batch, bml)] = (t_sha, t_tail, sb, tb, d_sha, d_tail,
                                t_r, d_r, rb)
        note(f"{batch}x{bml}: sha512 kernel call {t_sha:.5f} ms, device "
             f"{d_sha:.5f} ms (bound {sb[0]:.5f} ms, {sb[1]}; a warp's most "
             f"blocks over its blocks {ragged:.4f}), verify_tail kernel call "
             f"{t_tail:.5f} ms, device {d_tail:.5f} ms (bound {tb[0]:.5f} "
             f"ms, {tb[1]}), r_check kernel call {t_r:.5f} ms, device "
             f"{d_r:.5f} ms (bound {rb[0]:.6f} ms, {rb[1]}, set by the "
             f"{rb[2]}; the Fermat finish's count {rb_old:.5f} ms), "
             f"dispatch_blob "
             f"end to end {t_e2e:.4f} ms = "
             f"{batch / t_e2e * 1e3:.1f} verifies/s; verify_tail: "
             f"{design_note(chain4_ops(batch, True), d_tail, tb)}")
        for what, fn in (
                ("r_check", lambda: rck.r_check(qx, qz, r_bytes, ok_t)),
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
    ok_t, qx, qz = vt.verify_tail(*args)
    plain_rc = cuda_ms(lambda: rck.r_check_plain(qx, qz, args[3], ok_t),
                       PLAIN_RUNS, 1)
    note(f"{batch}x{bml}: plain sha512 {plain_sha:.4f} ms, plain "
         f"verify_tail {plain_tail:.4f} ms, plain r_check (the torch finish "
         f"the kernel replaced) {plain_rc:.4f} ms")

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
        y_r = rck._parse_r_bytes(r_)[0]
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
        # ---- phase 15: the leader lane: the PoH spans and mixin-tree
        # kernels, leader-bench in processes, the poh_dev tile at the
        # Solana clock defaults
        lead = leader_phase(pool, reset_counts, counts, note, cuda_ms,
                            dev_ms, int_ops_per_s, clock_mhz * 1e6,
                            hpt=POH_HASHES_PER_TICK, tps=POH_TICKS_PER_SLOT)
        # ---- phase 16: the turbine shred lane: the GF(2) and merkle walk
        # kernels, the admission batcher, shred -> store and shred ->
        # shred_recover -> sink in processes
        shred = shred_phase(pool, reset_counts, counts, note, cuda_ms,
                            int_ops_per_s, clock_mhz * 1e6)
        # ---- phase 17: the supervised run: `fdtpuctl run`, the verify
        # tile's guard under injected dispatch failures and a stalled
        # card, and a respawn after an injected kill
        supervised_phase(pool, reset_counts, counts, note)
        # ---- phase 18: the antipa mode: the antipa_tail kernel against
        # plain and the host, SigVerifier(mode="antipa") at the serving
        # buckets, the engine and a verify tile in antipa mode
        anti = antipa_phase(pool, reset_counts, counts, note, cuda_ms,
                            dev_ms, int_ops_per_s, buckets=buckets)
    # ---- phase 19: the leader's tail: the sharded pack, poh_dev, the
    # shred tile's leader role with the sign tile, the stores and a
    # follower admitting every shred on the card
    tail = leader_tail_phase(reset_counts, counts, note)

    # ---- the kernels record: the strict kernels at the serving bucket
    # (the first, where their plain versions were timed), the RLC kernels
    # at 32768 x 128 (the A side for msm); launches from each path's run
    # above
    t_sha, t_tail, sb, tb, d_sha, d_tail, t_r, d_r, rb = timing[
        BUCKETS[0][:2]]
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
        # the finish: no Pallas kernel (the XLA step after them, with its
        # batch inversion); no torch call computes a batch field inverse
        {"name": "r_check", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/r_check.cu",
         "replaces": "firedancer_tpu/ops/ed25519.py:79 _compressed_r_check,"
                     " firedancer_tpu/ops/f25519.py:477 batch_inv",
         "launches": launches["r_check"], "max_abs_err": rc_err,
         "ms": t_r, "device_ms": d_r, "plain_ms": plain_rc,
         "bound_ms": rb[0], "bound_by": rb[1], "bound_term": rb[2],
         "library_ms": None,
         "shape": f"{BUCKETS[0][0]}x{BUCKETS[0][1]}, ok_y form",
         "ms_32768": timing[(32768, 128)][6],
         "device_ms_32768": timing[(32768, 128)][7],
         "bound_ms_32768": timing[(32768, 128)][8][0]},
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
    # the leader lane's hand kernels (no Pallas kernel in the JAX package:
    # they replace its lax.scan code); launches from phase 15e's poh_dev
    # run, times at the shapes named
    kernels += [
        {"name": "poh_spans", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/poh_spans.cu",
         "replaces": "firedancer_tpu/ballet/poh_engine.py:51 poh_spans_blob;"
                     " firedancer_tpu/ballet/poh.py:41 verify_entries",
         "launches": lead["launches"]["poh_spans"],
         "max_abs_err": lead["poh_err"], "ms": lead["rc_ms"],
         "device_ms": lead["rc_dev"], "plain_ms": lead["poh_plain_ms"],
         "bound_ms": lead["rc_bound"][0], "bound_by": lead["rc_bound"][1],
         "bound_term": lead["rc_term"], "library_ms": None,
         "shape": f"{lead['rc_entries']} entries of a "
                  f"{POH_HASHES_PER_TICK} x {POH_TICKS_PER_SLOT} slot, one "
                  f"step a lane",
         "plain_shape": "8 lanes x 2 steps x 64 hashes",
         "chain_ms": lead["chain_ms"],
         "chain_hashes_per_s": lead["chain_hps"],
         "chain_critical_path_ms": lead["chain_cp_ms"],
         "poh_dev_slot_s": lead["t_slot"],
         "poh_dev_slot_chain_hashes": lead["slot_hashes"],
         "poh_dev_slot_kernel_ms": lead["slot_kernel_ms"],
         "poh_dev_slot_kernel_share": lead["slot_kernel_share"]},
        {"name": "mixin_tree", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/mixin_tree.cu",
         "replaces": "firedancer_tpu/ballet/entry.py:146 _mixin_roots",
         "launches": lead["launches"]["mixin_tree"],
         "max_abs_err": lead["m_err"], "ms": lead["m_ms"],
         "device_ms": lead["m_dev"], "plain_ms": lead["m_plain"],
         "bound_ms": lead["m_bound"][0], "bound_by": lead["m_bound"][1],
         "library_ms": None, "shape": "8 trees x 31 leaves (W 32)"}]
    # the shred lane's hand kernels (the JAX package compiles the GF(2)
    # product and the proof walk with XLA); launches from phase 16d's
    # tiles, times at the default dispatch shapes
    kernels += [
        {"name": "gf2_recover", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/gf2_recover.cu",
         "replaces": "firedancer_tpu/ballet/reedsol.py:292 "
                     "_recover_batch_core, :334 recover_blob, :157 "
                     "_encode_device",
         "launches": shred["launches"]["gf2_recover"],
         "max_abs_err": shred["c_err"], "ms": shred["c_ms"],
         "device_ms": shred["c_dev"], "plain_ms": shred["c_plain"],
         "bound_ms": shred["c_bound"][0], "bound_by": shred["c_bound"][1],
         "library_ms": shred["c_lib"],
         "library": "torch.bmm fp16, the product alone",
         "device_ms_by": "CUDA events around each launch",
         "shape": f"{SHRED_BATCH_SETS} sets x 32:32 x {SHRED_SZ} bytes",
         "leader_tail_launches": {
             "shred": tail["launches"]["shred.gf2_recover"],
             "shred_recover": tail["launches"]["frec.gf2_recover"]},
         "leader_tail_fec_sets": tail["fec_sets"],
         "leader_tail_encode_ms": tail["encode_ms"]},
        {"name": "bmtree_walk", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/bmtree_walk.cu",
         "replaces": "firedancer_tpu/ballet/bmtree.py:84 batch_walk_roots",
         "launches": shred["launches"]["bmtree_walk"],
         "max_abs_err": shred["d_err"], "ms": shred["d_ms"],
         "device_ms": shred["d_dev"], "plain_ms": shred["d_plain"],
         "bound_ms": shred["d_bound"][0], "bound_by": shred["d_bound"][1],
         "bound_term": shred["d_term"], "library_ms": None,
         "device_ms_by": "CUDA events around each launch",
         "shape": f"{SIG_BATCH} shreds of a 32:32 set (depth 6)",
         "leader_tail_launches": tail["launches"]["fshred.bmtree_walk"]}]
    # the antipa mode's hand kernel (the JAX package runs these steps as
    # XLA device code); launches from phase 18b's dispatches, times at
    # 4096 x 128 (plain there) and 32768 x 128
    a4, a32 = (anti["times"][f"{b}x{m}"] for b, m, _ in BUCKETS[:2])
    kernels.append(
        {"name": "antipa_tail", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/antipa_tail.cu",
         "replaces": "firedancer_tpu/ops/ed25519.py:326 verify_batch_antipa"
                     " (after the digest), firedancer_tpu/ops/"
                     "scalar25519.py:353 halve_scalar",
         "launches": anti["launches"], "max_abs_err": anti["err"],
         "ms": a4["ms"], "device_ms": a4["device_ms"],
         "plain_ms": anti["plain_ms"], "bound_ms": a4["bound_ms"],
         "bound_by": a4["bound_by"], "library_ms": None,
         "shape": f"{BUCKETS[0][0]}x{BUCKETS[0][1]}",
         "ms_32768": a32["ms"], "device_ms_32768": a32["device_ms"],
         "bound_ms_32768": a32["bound_ms"], "residency": anti["residency"],
         "dispatch_ms": {k: {"antipa": v["dispatch_antipa_ms"],
                             "strict": v["dispatch_strict_ms"]}
                         for k, v in anti["times"].items()}})
    # phase 19's launches in the tail's processes (the follower's
    # admission, poh_dev) beside each row's own
    for row in kernels:
        key = {"poh_spans": "poh_spans", "mixin_tree": "mixin_tree",
               "sha512_ram": "fshred.sha512_ram",
               "verify_tail": "fshred.verify_tail",
               "r_check": "fshred.r_check"}.get(row["name"])
        if key is not None:
            row["leader_tail_launches"] = tail["launches"][key]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def shred_only() -> int:
    """Phase 16 alone: python3 chip_smoke.py --phase 16.  Builds the
    kernels, runs shred_phase on the card and prints its numbers; no
    {"ok": ...} line, which only the whole run prints."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from firedancer_tpu_torch.kernels import build
        from firedancer_tpu_torch.ops import bmtree_walk as bw
        from firedancer_tpu_torch.ops import gf2_recover as gf2
        from firedancer_tpu_torch.ops import r_check as rck
        from firedancer_tpu_torch.ops import sha512_kernel as sk
        from firedancer_tpu_torch.ops import verify_tail as vt
        from firedancer_tpu_torch.tools import kernel_time as kt
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card}")
    logs = build.build_all()
    for name in ("gf2_recover", "bmtree_walk"):
        for line in logs[name].splitlines():
            if "Used" in line:
                print(f"  {name}.cu ptxas: {line.split(':', 1)[1].strip()}")
    counted = (gf2.gf2_recover, bw.bmtree_walk, sk.sha512_ram,
               vt.verify_tail, rck.r_check)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def counts() -> dict:
        return {fn.__name__: fn.launches for fn in counted}

    def note(msg: str):
        print(f"{msg}  [{card}]", flush=True)

    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        out = shred_phase(
            pool, reset_counts, counts, note,
            lambda fn, runs=RUNS, warmup=3: kt.cuda_ms(torch, fn, runs,
                                                       warmup)[0],
            sms * INT32_LANES_PER_SM * clock_hz, clock_hz)
    print(json.dumps(out))
    return 0


def supervised_only() -> int:
    """Phase 17 alone: python3 chip_smoke.py --phase 17.  Builds the
    kernels, runs supervised_phase on the card and prints its numbers; no
    {"ok": ...} line, which only the whole run prints."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from firedancer_tpu_torch.kernels import build
        from firedancer_tpu_torch.ops import r_check as rck
        from firedancer_tpu_torch.ops import sha512_kernel as sk
        from firedancer_tpu_torch.ops import verify_tail as vt
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(f"card: {card}")
    build.build_all()
    counted = {"sha512_ram": sk.sha512_ram, "verify_tail": vt.verify_tail,
               "r_check": rck.r_check}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def counts() -> dict:
        return {k: fn.launches for k, fn in counted.items()}

    def note(msg: str):
        print(f"{msg}  [{card}]", flush=True)

    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        out = supervised_phase(pool, reset_counts, counts, note)
    print(json.dumps({k: v for k, v in out.items() if k != "overhead"}))
    return 0


def antipa_only() -> int:
    """Phase 18 alone: python3 chip_smoke.py --phase 18.  Builds the
    kernels, runs antipa_phase on the card and prints its numbers; no
    {"ok": ...} line, which only the whole run prints."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from firedancer_tpu_torch.kernels import build
        from firedancer_tpu_torch.ops import antipa_tail as at
        from firedancer_tpu_torch.ops import r_check as rck
        from firedancer_tpu_torch.ops import sha512_kernel as sk
        from firedancer_tpu_torch.ops import verify_tail as vt
        from firedancer_tpu_torch.tools import kernel_time as kt
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card}")
    logs = build.build_all()
    for line in logs["antipa_tail"].splitlines():
        if "Used" in line or "stack frame" in line:
            print(f"  antipa_tail.cu ptxas: {line.split(':', 1)[-1].strip()}")
    counted = {"sha512_ram": sk.sha512_ram, "antipa_tail": at.antipa_tail,
               "verify_tail": vt.verify_tail, "r_check": rck.r_check}

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def counts() -> dict:
        return {k: fn.launches for k, fn in counted.items()}

    def note(msg: str):
        print(f"{msg}  [{card}]", flush=True)

    def dev_ms(fn, entry):
        return kt.device_ms(torch, fn, entry, RUNS)[0]

    with mp.get_context("spawn").Pool(min(8, os.cpu_count() or 1)) as pool:
        out = antipa_phase(
            pool, reset_counts, counts, note,
            lambda fn, runs=RUNS, warmup=3: kt.cuda_ms(torch, fn, runs,
                                                       warmup)[0],
            dev_ms, sms * INT32_LANES_PER_SM * clock_hz)
    print(json.dumps(out))
    return 0


def leader_tail_only() -> int:
    """Phase 19 alone: python3 chip_smoke.py --phase 19.  Builds the
    kernels, runs leader_tail_phase on the card and prints its numbers;
    no {"ok": ...} line, which only the whole run prints."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from firedancer_tpu_torch.kernels import build
        from firedancer_tpu_torch.ops import gf2_recover as gf2
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(f"card: {card}")
    build.build_all()

    def reset_counts():
        gf2.gf2_recover.launches = 0

    def counts() -> dict:
        return {"gf2_recover": gf2.gf2_recover.launches}

    def note(msg: str):
        print(f"{msg}  [{card}]", flush=True)

    print(json.dumps(leader_tail_phase(reset_counts, counts, note)))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase", "19"]:
        sys.exit(leader_tail_only())
    if sys.argv[1:] == ["--phase", "16"]:
        sys.exit(shred_only())
    if sys.argv[1:] == ["--phase", "18"]:
        sys.exit(antipa_only())
    if sys.argv[1:] == ["--phase", "17"]:
        sys.exit(supervised_only())
    sys.exit(main())
