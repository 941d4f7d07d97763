#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's strict ed25519 verify path on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from firedancer_tpu_torch/csrc, holds each one
against its plain torch version on the card, runs the real conformance
corpora and the serving buckets through SigVerifier.dispatch_blob, checks
that both kernels carried that path, and times the kernels, their plain
versions, the torch finish (_compressed_r_check) and the whole dispatch.
Every time is printed beside the card's name and power limit.  The
second-to-last line is the {"kernels": [...]} record; the last line is
{"ok": true, "device": {...}}.  Any failed check raises, and the script
then exits non-zero without those lines.  It needs no network and exits
non-zero where there is no CUDA device or no port package beside it.
"""

import hashlib
import json
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
SHA_LANES, SHA_MAXLEN = 4096, 1232
TAIL_LANES = 528
# the serving buckets: (batch, msg_maxlen, ragged message lengths)
BUCKETS = ((4096, 128, False), (32768, 128, False), (4096, 1232, True))

# 32x32->64 multiply-adds of one field product and one squaring
# (csrc/fe25519.cuh: 10 x 10 and 55 column terms)
MUL_OPS, SQR_OPS = 100, 55
# Field products of one verify-tail lane (csrc/verify_tail.cu), counted
# from the code: decompression with its square-root chain (pow22523: 251
# squarings, 11 products) 257 S + 18 M; the [0..8](-A) table 72 M; the
# chain, 64 windows of four doublings (16 S + 13 M), a Niels add (8 M)
# and an affine add without T (6 M): 1024 S + 1728 M; the y-compare 1 M.
TAIL_SQR, TAIL_MUL = 257 + 1024, 18 + 72 + 1728 + 1
# 64-bit operations of one SHA-512 block (80 rounds of 26, 64 schedule
# steps of 13), each two 32-bit instructions on this card
SHA_OPS_PER_BLOCK = 2 * (80 * 26 + 64 * 13)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from firedancer_tpu_torch.kernels import build
        from firedancer_tpu_torch.models import verifier as V
        from firedancer_tpu_torch.ops import ed25519 as ed
        from firedancer_tpu_torch.ops import f25519 as fe
        from firedancer_tpu_torch.ops import sha512_kernel as sk
        from firedancer_tpu_torch.ops import verify_tail as vt
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2

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

    def cuda_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(RUNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def wall_ms(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(RUNS):
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

    # ---- phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{', '.join(sorted(logs))}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "Used" in line:
                print(f"  {name}.cu ptxas: {line.split(':', 1)[1].strip()}")

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
    bits = ed.verify_blob(ablob).cpu().tolist()
    host = ed.host_verify_blob(V.pack_blob(msgs, lens, sigs, pubs))
    if bits != host or [k for k, b in zip(kinds, bits) if b] != [
            "valid"] * kinds.count("valid"):
        raise AssertionError("verify_blob disagrees with the host verifier "
                             "on the adversarial lanes")
    print(f"verify_tail: kernel == plain on {len(kinds)} lanes "
          f"({', '.join(V.ADVERSARIAL_KINDS)}): ok bits, canonical X and Z, "
          f"affine x; verify_blob == host verifier")

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
    cver = V.SigVerifier(V.VerifierConfig(len(vecs), cml))
    cbits = np.asarray(cver.dispatch_blob(
        V.pack_blob(cmsgs, clens, csigs, cpubs)))
    golden = np.array([v["ok"] for v in vecs])
    if not np.array_equal(cbits, golden):
        raise AssertionError(f"corpus: {int((cbits != golden).sum())} of "
                             f"{len(vecs)} vectors differ from golden")
    print(f"corpus: {len(vecs)} wycheproof/cctv/malleability vectors == "
          f"golden ({int(golden.sum())} accept)")

    # ---- phase 5: the main path, SigVerifier.dispatch_blob
    buckets = []
    for batch, bml, ragged in BUCKETS:
        r = np.random.default_rng(batch + bml)
        blens = r.integers(0, bml + 1, batch) if ragged else None
        bm, bl, bs, bp = V.make_example_batch(batch, bml, True, batch + bml,
                                              sign_pool=256, lens=blens)
        bad = r.choice(batch, batch // 4, replace=False)
        bs[bad, 32 + r.integers(0, 31, len(bad))] ^= 1   # corrupt S
        expect = np.ones(batch, bool)
        expect[bad] = False
        buckets.append((batch, bml, V.pack_blob(bm, bl, bs, bp), expect,
                        int(((bl.astype(np.int64) + 64 + 17 + 127)
                             // 128).sum()), int(bl.sum())))
    verifiers = {(b, m): V.SigVerifier(V.VerifierConfig(b, m))
                 for b, m, *_ in buckets}
    sk.sha512_ram.launches = 0
    vt.verify_tail.launches = 0
    verdicts = [verifiers[(b, m)].dispatch_blob(blob_np)
                for b, m, blob_np, *_ in buckets]
    results = [np.asarray(v) for v in verdicts]
    launches = {"sha512_ram": sk.sha512_ram.launches,
                "verify_tail": vt.verify_tail.launches}
    for (batch, bml, _, expect, *_), res in zip(buckets, results):
        if res.shape != (batch,) or not np.array_equal(res, expect):
            raise AssertionError(f"dispatch_blob {batch}x{bml}: "
                                 f"{int((res != expect).sum())} bits wrong")
        print(f"dispatch_blob {batch}x{bml}: {int(res.sum())} accept, "
              f"{batch - int(res.sum())} reject, as constructed")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not carry the path: {launches}")
    print(f"launches on the main path: {launches}")
    # each kernel against its plain version at every shape the path gave it
    for batch, bml, blob_np, *_ in buckets:
        blob = torch.from_numpy(blob_np).to(dev)
        sha_err = max(sha_err, hold_sha(blob, bml))
        tail_err = max(tail_err, hold_tail(tail_args(blob, bml))[0])
        print(f"{batch}x{bml}: sha512 and verify_tail kernels == plain "
              f"(digests; ok bits, canonical X and Z)")

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

    # ---- phase 6: timings (CUDA events; median of {RUNS} after warmup)
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

    timing = {}
    for batch, bml, blob_np, _, nblocks, msg_bytes in buckets:
        blob = torch.from_numpy(blob_np).to(dev)
        t_sha = cuda_ms(lambda: sha(blob, bml))
        args = tail_args(blob, bml)
        t_tail = cuda_ms(lambda: vt.verify_tail(*args))
        ok_t, qx, qz = vt.verify_tail(*args)
        r_bytes = args[3]
        t_r = cuda_ms(lambda: ed._compressed_r_check(qx, qz, r_bytes, ok_t))
        ver = verifiers[(batch, bml)]
        t_e2e = wall_ms(lambda: np.asarray(ver.dispatch_blob(blob_np)))
        sb, tb = sha_bound(batch, nblocks, msg_bytes), tail_bound(batch)
        timing[(batch, bml)] = (t_sha, t_tail, sb, tb)
        note(f"{batch}x{bml}: sha512 kernel {t_sha:.5f} ms (bound "
             f"{sb[0]:.5f} ms, {sb[1]}), verify_tail kernel {t_tail:.5f} ms "
             f"(bound {tb[0]:.5f} ms, {tb[1]}), _compressed_r_check "
             f"{t_r:.5f} ms, dispatch_blob end to end {t_e2e:.4f} ms = "
             f"{batch / t_e2e * 1e3:.1f} verifies/s")
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
    plain_sha = cuda_ms(lambda: sk.sha512_ram_plain(m_, r_, a_, ln_))
    args = tail_args(blob, bml)
    plain_tail = cuda_ms(lambda: vt.verify_tail_plain(*args))
    note(f"{batch}x{bml}: plain sha512 {plain_sha:.4f} ms, plain "
         f"verify_tail {plain_tail:.4f} ms")

    # ---- the kernels record, at the serving bucket (the first one)
    t_sha, t_tail, sb, tb = timing[(batch, bml)]
    kernels = [
        {"name": "sha512_ram", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/sha512.cu",
         "replaces": "firedancer_tpu/ops/sha512_pallas.py:118",
         "launches": launches["sha512_ram"], "max_abs_err": sha_err,
         "ms": t_sha, "plain_ms": plain_sha, "bound_ms": sb[0],
         "bound_by": sb[1], "library_ms": None},
        {"name": "verify_tail", "route": "cuda",
         "source": "firedancer_tpu_torch/csrc/verify_tail.cu",
         "replaces": "firedancer_tpu/ops/curve_pallas.py:1039",
         "launches": launches["verify_tail"], "max_abs_err": tail_err,
         "ms": t_tail, "plain_ms": plain_tail, "bound_ms": tb[0],
         "bound_by": tb[1], "library_ms": None},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
