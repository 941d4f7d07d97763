#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the card.

    python3 firedancer_tpu_torch/tools/kernel_time.py [--root DIR]
        [--label L] [--kernels msm,verify_tail,r_check,dsm_tail_q,
        dsm_base,sha512,decompress,reduce_recode,rlc_recode,poh_spans,
        mixin_tree,gf2_recover,bmtree_walk,antipa_tail] [--lanes N,...]
        [--sass] [--phases]

Imports firedancer_tpu_torch from DIR (default: the checkout that holds
this script), builds its kernels, prints the chosen kernels' ptxas -v
lines (registers, shared memory, stack and spills of each entry and
out-of-line function), with --sass also the static SASS instruction
counts of each kernel entry by opcode (cuobjdump -sass: the code as
compiled, not as executed) and of each loop in it (a backward branch and
the instructions from its target to it), each with its shares of the
integer pipe, the FMA pipe and the rest (PIPES) and its IMAD forms, and
cut at its barriers (bar_segments), and times each call two ways:
  call ms    CUDA events around the whole wrapper call (median, min and
             max of 20 after 3 warm-ups): the host's enqueue, the
             allocations and the follow-on device ops included;
  device ms  the kernel entry's own device time a call from
             torch.profiler's key_averages() over 20 calls, beside the
             entry's launches and the other device ops a call (if the
             profiler shows no device time, CUDA events around 20
             back-to-back calls over 20; the JSON says which).
On inputs made from fixed seeds:
  msm          msm_lanes at 4096 and 32768 points, m 8, nwin 64 and 32,
               both selects, on points decompressed from random encodings
               and random digits;
  verify_tail  at 4096 x 128, 32768 x 128 and 4096 x 1232 (or at the
               lane counts given by --lanes, x 128), on the digests,
               keys, S and R of valid signatures (make_example_batch),
               as dispatch_blob gives them;
  r_check      at the same shapes, on verify_tail's X, Z and ok bits of
               those signatures and their R, as the fused layout gives
               them;
  antipa_tail  at the same shapes, on the same signatures' keys, R, S
               and digests, as the antipa mode's dispatch_blob gives
               them, each beside its bound (antipa_bound_ms) and the SM
               clock nvidia-smi reads after it; its residency (registers,
               shared bytes, blocks an SM) where the checkout's library
               reports it; with --phases, one lane's time split by
               phase: a timing-only build of csrc/antipa_tail.cu with
               -DAP_CLOCKS (phase_split), whose clock64() stamps at the
               phase edges give each phase's cycles over the lanes;
  dsm_tail_q   at the same shapes' 128-byte ones, on the same
               signatures' windows (reduce_recode), decompressed keys
               and R's y;
  dsm_base     double_scalar_mul_base at the same 128-byte shapes, on
               the same signatures' unsigned windows of S and of k mod L
               and the negated keys, as chip_smoke's phase 11b gives
               them;
  sha512       sha512_ram at the same shapes, on chip_smoke's serving
               buckets (64-byte messages at 128; lengths uniform in
               [0, 1232] at 1232), read in place from the packed blob;
  decompress   the keys at the 128-byte shapes, and the RLC pair (A and
               R; decompress_pair where the checkout has it, else two
               decompress calls), plus the decompress launches of one
               verify_batch_rlc call at the first shape;
  reduce_recode, rlc_recode  at the 128-byte shapes, on the same
               signatures' S and digests and random z;
  poh_spans    one step a lane of CHAIN_HASHES plain hashes from random
               starts, at 1 and 32 lanes and at 32, 128, 256 and 512
               lanes an SM, with the hashes/s of a lane and of all (and
               of one lane its cycles a hash at the max SM clock); the
               re-check of a SLOT_HPT x SLOT_TPS slot's entries (one step
               a lane: 7 mixin entries of 1,562 hashes and a tick entry of
               1,566 a tick, random starts and mixins); and one lane
               through that whole slot (call ms only, SLOT_RUNS calls);
  mixin_tree   8 trees of 31 leaves (W 32, the poh_dev tile's shape),
               2 of 1,024 and 40 of widths 1-33 at W 64 (chip_smoke's
               15c), on random signatures;
  gf2_recover  recover_blob at the shred_recover tile's dispatch, 8
               32:32 sets of 1,019 bytes with i % 32 erasures
               (bench.py::measure_shred_recover's), with the input the
               checkout's wrapper takes: the GF(2^8) matrices where
               ops/gf2_recover.py has bitmatrix_plain, else their int8
               bit-matrices; and the yardstick beside it: the product
               alone as one float16 torch.bmm of the bit-matrices on the
               unpacked survivors (call ms only);
  bmtree_walk  the shred tile's admission burst, 32 shreds of a signed
               32:32 set (depth 6), and 4096 random lanes of every leaf
               length and depth.
The last line is one JSON object: the label, the card's name and power
limit (nvidia-smi), the call times in ms, the device times in ms, the
launches and the other device ops a call, the device-time method, the
SM clocks read after the antipa_tail timings and the phase splits.
To compare two checkouts, run it for each in turn on one card, one run
after another: A, B, B, A.
"""

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

RUNS, M = 20, 8
CHAIN_HASHES = 20_000
# the Solana SDK's clock defaults: hashes a tick, ticks a slot
SLOT_HPT, SLOT_TPS, SLOT_MIXINS, SLOT_RUNS = 12_500, 64, 7, 3
# the pipe an opcode issues to on an SM sub-partition (sm_90): the
# integer pipe, 16 lanes wide, or the FMA pipe, which also runs IMAD and
# its forms; the rest (memory, barriers, branches, moves) is "other"
PIPES = {"int": {"IADD3", "LOP3", "SHF", "LEA", "SEL", "ISETP", "PRMT",
                 "IMNMX", "VIMNMX", "FLO", "POPC", "BMSK", "SGXT", "IABS",
                 "PLOP3"},
         "fma": {"IMAD", "FFMA", "FMUL", "FADD"}}
SOURCES = {"msm": "msm", "verify_tail": "verify_tail", "r_check": "r_check",
           "dsm_tail_q": "dsm",
           "dsm_base": "dsm", "sha512": "sha512", "decompress": "decompress",
           "reduce_recode": "reduce_recode", "rlc_recode": "rlc_recode",
           "poh_spans": "poh_spans", "mixin_tree": "mixin_tree",
           "gf2_recover": "gf2_recover", "bmtree_walk": "bmtree_walk",
           "antipa_tail": "antipa_tail"}
# each kernel's entry, as the profiler names its device events
ENTRIES = {"msm": "msm_kernel", "verify_tail": "verify_tail_kernel",
           "r_check": "r_check_kernel",
           "dsm_tail_q": "dsm_tail_q_kernel", "dsm_base": "dsm_base_kernel",
           "sha512": "sha512_ram_kernel", "decompress": "decompress_kernel",
           "reduce_recode": "reduce_recode_kernel",
           "rlc_recode": "rlc_recode_kernel",
           "poh_spans": "poh_spans_kernel", "mixin_tree": "mixin_tree_kernel",
           "gf2_recover": "gf2_kernel", "bmtree_walk": "bmtree_walk_kernel",
           "antipa_tail": "antipa_tail_kernel"}

# The antipa tail's least work a lane (csrc/antipa_tail.cu), counted from
# its code as chip_smoke.py counts the strict tail's (TAIL_SQR,
# TAIL_MUL).  Field products: two decompressions (257 S + 18 M each),
# two [0..8] Niels tables (72 M each), 32 windows of four doublings (16 S
# + 13 M) and 33 windows of two Niels adds (8 M each), an affine add
# with T (7 M) and one without (6 M); a squaring is 55 and a product 100
# 32 x 32 -> 64 multiply-adds (csrc/fe25519.cuh).  The scalar half's
# 32-bit operations: 250 divsteps of 84 (two masks, two selects, two
# masked additions and two shifts of 8 words, delta and the swap bit),
# 24 Lagrange rounds of 384 (three swaps, two bit lengths, two shifts,
# four additions, two norms of 72, two compares with their selects), the
# two starting norms, three reductions mod L of 158 (chip_smoke's
# SC_REDUCE_OPS: k, 2^250 k and |v| S), the 64 word products of |v| S (2
# each) and their carries, the 2^250 shift and the negation (16 each),
# four 4-word recodes of 80 and S < L (8).  Bytes: pub, R, S and the
# digest read, the bit written.
AP_SQR = 2 * 257 + 32 * 16
AP_MUL = 2 * 18 + 2 * 72 + 32 * 13 + 33 * (2 * 8 + 7 + 6)
AP_SCALAR_OPS = (250 * 84 + 24 * 384 + 2 * 72 + 3 * 158 + 3 * 64 + 2 * 16
                 + 4 * 80 + 8)
AP_BYTES = 3 * 32 + 64 + 1


def antipa_bound_ms(n: int, int_ops_per_s: float) -> tuple[float, str]:
    """(least ms, what bounds it) of antipa_tail on n lanes: AP_BYTES a
    lane over 3.35 TB/s against its operations over int_ops_per_s."""
    tb = n * AP_BYTES / 3.35e12
    to = n * (AP_SQR * 55 + AP_MUL * 100 + AP_SCALAR_OPS) / int_ops_per_s
    return max(tb, to) * 1e3, "bytes" if tb > to else "operations"


def antipa_two_pipe_ms(n: int, int_ops_per_s: float) -> float:
    """antipa_tail's operation bound on n lanes if the field products'
    multiply-adds (IMAD) issue on the FMA pipe while the scalar half's
    operations take the integer pipe, each at int_ops_per_s, and a
    scheduler issues one instruction a cycle (twice int_ops_per_s in
    all): the larger of the multiply-adds over one pipe and all
    operations over both."""
    mads = AP_SQR * 55 + AP_MUL * 100
    return n * max(mads, AP_SCALAR_OPS,
                   (mads + AP_SCALAR_OPS) / 2) / int_ops_per_s * 1e3


def clocks_lib(build):
    """(library, phase names, stamps a lane) of the timing-only build of
    the checkout's csrc/antipa_tail.cu: nvcc with -DAP_CLOCKS into its
    _build/clocks-<hash>, whose fd_antipa_tail takes an (n, stamps)
    int64 stamp output after the stream, whose fd_antipa_tail_phases
    names the phases as name:first-last stamp, ';' between them, and
    whose fd_antipa_tail_nstamp gives the stamps a lane.  Never loaded
    by the wrapper."""
    import ctypes
    out = build.BUILD / f"clocks-{build._src_hash()}"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libantipa_tail_clocks.so"
    if not lib.exists():
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DAP_CLOCKS",
                              "-o", str(lib), str(build.CSRC /
                                                  "antipa_tail.cu")],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc -DAP_CLOCKS failed:\n{res.stdout}"
                               f"{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    dll.fd_antipa_tail.argtypes = [p, ll, p, ll, p, ll, p, ll, p, i, p, p, p]
    dll.fd_antipa_tail.restype = i
    dll.fd_antipa_tail_phases.restype = ctypes.c_char_p
    names = [(name, *map(int, span.split("-"))) for name, span in (
        part.rsplit(":", 1) for part in
        dll.fd_antipa_tail_phases().decode().split(";"))]
    dll.fd_antipa_tail_nstamp.restype = i
    return dll, names, dll.fd_antipa_tail_nstamp()


def phase_split(torch, dll, names, nstamp, consts, a_, r_, s_, digest,
                want, runs: int = 3) -> dict[str, list[float]]:
    """{phase: [mean, median, max] cycles a lane} of the timing-only
    build on these inputs: each phase's stamps differenced a lane (one
    SM's clock64), over the lanes, from the last of runs calls; its bits
    must equal want, the served kernel's."""
    n = a_.shape[0]
    ok = torch.empty(n, dtype=torch.uint8, device=a_.device)
    clk = torch.zeros((n, nstamp), dtype=torch.int64, device=a_.device)
    for _ in range(runs):
        rc = dll.fd_antipa_tail(
            a_.data_ptr(), a_.stride(0), r_.data_ptr(), r_.stride(0),
            s_.data_ptr(), s_.stride(0), digest.data_ptr(),
            digest.stride(0), consts.data_ptr(), n, ok.data_ptr(),
            torch.cuda.current_stream().cuda_stream, clk.data_ptr())
        if rc:
            raise RuntimeError(f"antipa_tail clocks build: CUDA error {rc}")
    torch.cuda.synchronize()
    if not torch.equal(ok.bool(), want):
        raise AssertionError("antipa_tail clocks build: bits differ")
    st = clk.cpu().numpy()
    out = {}
    for name, a, b in names:
        d = (st[:, b] - st[:, a]).astype(np.float64)
        out[name] = [float(d.mean()), float(np.median(d)), float(d.max())]
    return out


def sm_clock_mhz() -> float:
    """The card's SM clock now (nvidia-smi clocks.sm), MHz."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def antipa_residency(torch, lib) -> dict[str, int] | None:
    """antipa_tail's registers, static and dynamic shared bytes,
    blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    threads and lanes a block and stack bytes, from the library's
    fd_antipa_tail_residency; None where the library has none."""
    import ctypes
    fn = getattr(lib, "fd_antipa_tail_residency", None)
    if fn is None:
        return None
    out = (ctypes.c_int * 7)()
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(0):
        rc = fn(ctypes.addressof(out))
    if rc:
        raise RuntimeError(f"fd_antipa_tail_residency: CUDA error {rc}")
    keys = ("registers", "static_shared_bytes", "dynamic_shared_bytes",
            "blocks_an_sm", "threads_a_block", "lanes_a_block",
            "stack_bytes")
    return dict(zip(keys, out))


def cuda_ms(torch, fn, runs: int = RUNS, warmup: int = 3) -> list[float]:
    """[median, min, max] ms of runs calls after the warm-ups."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        ts.append(a.elapsed_time(z))
    return [statistics.median(ts), min(ts), max(ts)]


def device_ms(torch, fn, entry: str, runs: int = RUNS, warmup: int = 3,
              tries: int = 3):
    """(ms, launches, other device ops, method) a call: the device time
    of the kernels whose name holds entry, from torch.profiler's
    key_averages() over runs calls after the warm-ups; the entry's
    launches and the other device ops a call.  The trace may miss an
    event at its edge (19 of 20 seen), so ms is the mean of the launches
    it holds times the launches a call.  A trace that holds fewer than
    half a launch a call of the entry (none, rounded), or no device time
    at all, is taken again, up to tries traces; after that, ms is CUDA
    events around runs back-to-back calls over runs, and the counts are
    None."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        seen = other = 0
        for e in prof.key_averages():
            if not str(e.device_type).endswith("CUDA"):
                continue
            t = max(e.device_time_total, e.self_device_time_total)
            if entry in e.key:
                us += t
                seen += e.count
            else:
                other += e.count
        per_call = round(seen / runs)
        if per_call and us > 0:
            return (us / seen * per_call / 1e3, per_call,
                    round(other / runs), "profiler")
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(runs):
        fn()
    z.record()
    z.synchronize()
    return a.elapsed_time(z) / runs, None, None, "events"


def sass_of(lib, nvcc: str) -> dict[str, list[tuple[int, str, str]]]:
    """{function: [(address, opcode, instruction text)]} of a library
    from cuobjdump -sass, the opcode without its modifiers; a label's
    address is that of the instruction after it."""
    tool = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    fns, fn = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = fns.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)[^;]*)", line)
        if m and fn is not None:
            fn.append((int(m.group(1), 16), m.group(3).split(".")[0],
                       m.group(2).strip()))
    return fns


def _sass(build, src: str) -> dict[str, list[tuple[int, str, str]]]:
    """sass_of csrc/<src>.cu's library."""
    return sass_of(build.BUILD / build._src_hash() / f"lib{src}.so",
                   build.nvcc())


def _opcodes(instrs) -> dict[str, int]:
    ops = {}
    for _, op, _ in instrs:
        ops[op] = ops.get(op, 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def pipe_shares(instrs) -> dict[str, object]:
    """The counts of instrs on the integer pipe, the FMA pipe and the
    rest (PIPES), and the IMAD forms by their first modifier."""
    out = {"int": 0, "fma": 0, "other": 0}
    forms = {}
    for _, op, text in instrs:
        pipe = next((p for p, ops in PIPES.items() if op in ops), "other")
        out[pipe] += 1
        if op == "IMAD":
            m = re.search(r"\bIMAD(\.[A-Z]+)?", text)
            form = "IMAD" + (m.group(1) or "")
            forms[form] = forms.get(form, 0) + 1
    out["imad_forms"] = forms
    return out


def bar_segments(body) -> list[tuple[str, list]]:
    """A loop body cut after each barrier instruction: [(the barrier's
    text, or "end", the instructions up to and with it)].  In a kernel
    whose warps hand work over at named barriers, the stretches between
    them are each warp's work between two handovers."""
    out, seg = [], []
    for ins in body:
        seg.append(ins)
        if ins[1] == "BAR":
            out.append((ins[2], seg))
            seg = []
    if seg:
        out.append(("end", seg))
    return out


def sass_counts(build, src: str) -> dict[str, dict[str, int]]:
    """{kernel entry: {opcode: static count}} of csrc/<src>.cu's library."""
    return {k: _opcodes(v) for k, v in _sass(build, src).items()
            if "kernel" in k}


def loops_of(fns) -> dict[str, list[tuple[int, int, list]]]:
    """{kernel entry: [(first address, last address, instructions)]} of
    sass_of's functions: each backward branch of the entry and the
    instructions from its target to it, the body of one trip of that
    loop."""
    out = {}
    for k, instrs in fns.items():
        if "kernel" not in k:
            continue
        loops = []
        for addr, op, text in instrs:
            m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", text)
            if op == "BRA" and m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                loops.append((lo, addr,
                              [i for i in instrs if lo <= i[0] <= addr]))
        out[k] = loops
    return out


def sass_loops(build, src: str) -> dict[str, list[tuple[int, int, list]]]:
    """loops_of csrc/<src>.cu's library."""
    return loops_of(_sass(build, src))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(SOURCES))
    ap.add_argument("--lanes", default="",
                    help="the per-signature kernels at these lane counts "
                         "(x 128) instead of the default shapes")
    ap.add_argument("--sass", action="store_true",
                    help="print each kernel's static SASS opcode counts")
    ap.add_argument("--phases", action="store_true",
                    help="split antipa_tail's lane time by phase (a "
                         "timing-only -DAP_CLOCKS build)")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    unknown = set(kernels) - set(SOURCES)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}; choose from "
                 f"{','.join(SOURCES)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    logs = build.build_all()
    for src in sorted({SOURCES[k] for k in kernels}):
        for line in logs[src].splitlines():
            if "ptxas info" in line or "stack frame" in line:
                print(f"{args.label} {src}.cu {line.strip()}")
        if args.sass:
            for fn, ops in sass_counts(build, src).items():
                print(f"{args.label} {src}.cu sass {fn} total "
                      f"{sum(ops.values())} {json.dumps(ops)}")
            for fn, loops in sass_loops(build, src).items():
                for lo, hi, body in loops:
                    print(f"{args.label} {src}.cu sass {fn} loop "
                          f"{lo:#x}-{hi:#x} body {len(body)} "
                          f"{json.dumps(_opcodes(body))} pipes "
                          f"{json.dumps(pipe_shares(body))}")
                    segs = bar_segments(body)
                    for bar, seg in segs if len(segs) > 1 else ():
                        print(f"{args.label} {src}.cu sass {fn} loop "
                              f"{lo:#x} to {seg[-1][0]:#x} ({bar}): "
                              f"{len(seg)} {json.dumps(pipe_shares(seg))}")

    dev = torch.device("cuda", 0)
    times, dev_times, launches, others, methods = {}, {}, {}, {}, set()
    sm_clocks, phases = {}, {}
    if "antipa_tail" in kernels:
        res = antipa_residency(torch, build.load("antipa_tail"))
        print(f"{args.label} antipa_tail residency: {json.dumps(res)}")

    def profiled(key: str, kernel: str, fn, runs: int = RUNS):
        d, k, o, how = device_ms(torch, fn, ENTRIES[kernel], runs)
        dev_times[key], launches[key], others[key] = d, k, o
        methods.add(how)

    def timed(key: str, kernel: str, fn):
        times[key] = cuda_ms(torch, fn)
        profiled(key, kernel, fn)

    if "msm" in kernels:
        rng = np.random.default_rng(5)
        for n in (4096, 32768):
            b = torch.from_numpy(rng.integers(0, 256, (n, 32),
                                              np.uint8)).to(dev)
            pts = dc.decompress(b)[2]
            for nwin in (64, 32):
                win = torch.from_numpy(rng.integers(0, 16, (nwin, n),
                                                    np.uint8)).to(dev)
                for sel in ms.SELECTS:
                    timed(f"msm {n} {sel} nwin {nwin}", "msm",
                          lambda: ms.msm_lanes(win, pts, M, nwin, sel))
    if "poh_spans" in kernels:
        from firedancer_tpu_torch.ballet.poh_engine import (row_bytes,
                                                            stamp_lanes)
        from firedancer_tpu_torch.ops import poh_spans as ps
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock_hz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0]) * 1e6
        rng = np.random.default_rng(13)
        for lanes in (1, 32, 32 * sms, 128 * sms, 256 * sms, 512 * sms):
            # a row: start | mixin | n (u32 LE) | has_mixin | active
            rows = np.zeros((lanes, row_bytes(1)), np.uint8)
            rows[:, :32] = rng.integers(0, 256, (lanes, 32), np.uint8)
            rows[:, 64:68] = np.frombuffer(
                np.uint32(CHAIN_HASHES).astype("<u4").tobytes(), np.uint8)
            rows[:, 69] = 1
            blob = torch.from_numpy(rows).to(dev)
            key = f"poh_spans {lanes} lanes x {CHAIN_HASHES}"
            timed(key, "poh_spans",
                  lambda: ps.poh_spans(blob, 1, (CHAIN_HASHES,)))
            t = times[key][0]
            print(f"{args.label} {key} ({lanes / sms:g} lanes an SM): "
                  f"{CHAIN_HASHES / t * 1e3:.1f} hashes/s a lane, "
                  f"{lanes * CHAIN_HASHES / t * 1e3:.1f} in all"
                  + (f", {clock_hz * t / 1e3 / CHAIN_HASHES:.1f} cycles a "
                     f"hash at {clock_hz / 1e6:.0f} MHz" if lanes == 1
                     else ""))
        # a slot's entries: SLOT_MIXINS mixin entries and a tick entry a
        # tick; its re-check is one step a lane, the chain one lane
        n_m = SLOT_HPT // (SLOT_MIXINS + 1)
        n_t = SLOT_HPT - SLOT_MIXINS * n_m
        spec = [(n_m, rng.bytes(32)) if k < SLOT_MIXINS else (n_t, None)
                for _ in range(SLOT_TPS) for k in range(SLOT_MIXINS + 1)]
        rc = np.zeros((len(spec), row_bytes(1)), np.uint8)
        stamp_lanes(rc, [(rng.bytes(32), [e]) for e in spec])
        rc_blob = torch.from_numpy(rc).to(dev)
        timed(f"poh_spans recheck {len(spec)} entries", "poh_spans",
              lambda: ps.poh_spans(rc_blob, 1, (SLOT_HPT,)))
        sl = np.zeros((1, row_bytes(len(spec))), np.uint8)
        stamp_lanes(sl, [(rng.bytes(32), spec)])
        sl_blob = torch.from_numpy(sl).to(dev)
        sl_caps = tuple(n for n, _ in spec)
        key = f"poh_spans slot {SLOT_HPT} x {SLOT_TPS}"
        times[key] = cuda_ms(torch, lambda: ps.poh_spans(
            sl_blob, len(spec), sl_caps), SLOT_RUNS, 1)
        t = times[key][0]
        print(f"{args.label} {key}: {t:.3f} ms, "
              f"{SLOT_HPT * SLOT_TPS / t * 1e3:.1f} hashes/s, "
              f"{clock_hz * t / 1e3 / (SLOT_HPT * SLOT_TPS):.1f} cycles a "
              f"hash at {clock_hz / 1e6:.0f} MHz")
    if "mixin_tree" in kernels:
        from firedancer_tpu_torch.ops import mixin_tree as mt
        rng = np.random.default_rng(14)
        sigs = torch.from_numpy(rng.integers(0, 256, (8, 32, 64),
                                             np.uint8)).to(dev)
        widths = torch.full((8,), 31, dtype=torch.int32, device=dev)
        timed("mixin_tree 8 x 31", "mixin_tree",
              lambda: mt.mixin_tree(sigs, widths))
        for B, W, ws in ((2, 1024, [1024, 1024]),
                         (40, 64, list(range(1, 34)) + [1] * 7)):
            s_ = torch.from_numpy(rng.integers(0, 256, (B, W, 64),
                                               np.uint8)).to(dev)
            w_ = torch.tensor(ws, dtype=torch.int32, device=dev)
            timed(f"mixin_tree {B} x {W}", "mixin_tree",
                  lambda: mt.mixin_tree(s_, w_))
    if "gf2_recover" in kernels:
        from firedancer_tpu_torch.ballet import reedsol as rs
        from firedancer_tpu_torch.ops import gf2_recover as gf2
        k, n, sz, B = 32, 64, 1019, 8
        rng = np.random.default_rng(15)
        blob = np.zeros((B, rs.recover_blob_row_bytes(k, n, sz)), np.uint8)
        gm = np.zeros((B, n, k), np.uint8)
        # random rows, not codewords: the kernel's time does not depend
        # on the bytes, only on the shapes
        for i in range(B):
            surv = rng.integers(0, 256, (n, sz), np.uint8)
            gone = {(3 * e + i) % n for e in range(i % k)}
            have = [j for j in range(n) if j not in gone]
            use = tuple(have[:k])
            blob[i, :k * sz] = surv[list(use)].reshape(-1)
            for j in have:
                blob[i, (k + j) * sz:(k + j + 1) * sz] = surv[j]
                blob[i, (k + n) * sz + j] = 1
            gm[i] = rs._recover_gfmat(k, n, use)
        bm = np.stack([rs._bitmatrix(g) for g in gm])
        blob_d = torch.from_numpy(blob).to(dev)
        # the change's wrapper takes the matrices, the parent's the
        # bit-matrices
        mat_d = torch.from_numpy(gm if hasattr(gf2, "bitmatrix_plain")
                                 else bm).to(dev)
        timed("gf2_recover 8 x 32:32", "gf2_recover",
              lambda: gf2.recover_blob(blob_d, mat_d, k, n, sz))
        bits16 = gf2._unpack(blob_d[:, :k * sz].reshape(B, k, sz)).half()
        bm16 = torch.from_numpy(bm).to(dev).half()
        times["gf2_recover torch.bmm fp16 product"] = cuda_ms(
            torch, lambda: torch.bmm(bm16, bits16))
    if "bmtree_walk" in kernels:
        from firedancer_tpu_torch.ballet import shred as sl
        from firedancer_tpu_torch.ops import bmtree_walk as bw
        rng = np.random.default_rng(16)
        fs = sl.make_fec_set(rng.bytes(30_000), 9, 1, 1, 0,
                             lambda root: ed.sign(bytes(32), root),
                             torch_device=dev)
        shreds = [sl.parse(r) for r in fs.data_shreds[:32]]
        leaf = np.zeros((32, 1164), np.uint8)
        proofs = np.zeros((32, 15, 20), np.uint8)
        lens, idxs, deps = (np.zeros(32, np.int32) for _ in range(3))
        for j, s_ in enumerate(shreds):
            ld = s_.merkle_leaf_data()
            leaf[j, :len(ld)] = np.frombuffer(ld, np.uint8)
            lens[j], idxs[j] = len(ld), s_.tree_index()
            deps[j] = s_.merkle_proof_len
            for d, node in enumerate(s_.proof_nodes()):
                proofs[j, d] = np.frombuffer(node, np.uint8)
        lf = torch.from_numpy(leaf).to(dev)
        pf = torch.from_numpy(proofs).to(dev)
        timed("bmtree_walk 32 shreds of a 32:32 set", "bmtree_walk",
              lambda: bw.bmtree_walk(lf, lens, idxs, pf, deps))
        lf4 = torch.from_numpy(rng.integers(0, 256, (4096, 1164),
                                            np.uint8)).to(dev)
        pf4 = torch.from_numpy(rng.integers(0, 256, (4096, 15, 20),
                                            np.uint8)).to(dev)
        ln4 = rng.integers(0, 1165, 4096).astype(np.int32)
        ix4 = rng.integers(0, 1 << 15, 4096).astype(np.int32)
        dp4 = (np.arange(4096) % 16).astype(np.int32)
        timed("bmtree_walk 4096 random lanes", "bmtree_walk",
              lambda: bw.bmtree_walk(lf4, ln4, ix4, pf4, dp4))
    shapes = ([(int(n), 128) for n in args.lanes.split(",")] if args.lanes
              else [(4096, 128), (32768, 128), (4096, 1232)])
    wide_only = {"verify_tail", "r_check", "sha512", "antipa_tail"}
    for n, ml in shapes:
        if ml != 128 and not wide_only & set(kernels):
            continue
        # chip_smoke's serving buckets: 64-byte messages at 128, lengths
        # uniform in [0, ml] otherwise
        lens = (None if ml == 128 else
                np.random.default_rng(n + ml).integers(0, ml + 1, n))
        msgs, lens, sigs, pubs = V.make_example_batch(
            n, ml, True, n + ml, sign_pool=256, lens=lens)
        blob = torch.from_numpy(V.pack_blob(msgs, lens, sigs, pubs)).to(dev)
        m_, r_, s_ = blob[:, :ml], blob[:, ml:ml + 32], blob[:, ml + 32:ml + 64]
        a_, ln_ = blob[:, ml + 64:ml + 96], blob[:, ml + 96:]
        if "sha512" in kernels:
            timed(f"sha512 {n}x{ml}", "sha512",
                  lambda: sk.sha512_ram(m_, r_, a_, ln_))
        digest = sk.sha512_ram(m_, r_, a_, ln_)
        if "verify_tail" in kernels:
            timed(f"verify_tail {n}x{ml}", "verify_tail",
                  lambda: vt.verify_tail(a_, s_, digest, r_))
        if "r_check" in kernels:
            from firedancer_tpu_torch.ops import r_check as rck
            ok_t, qx, qz = vt.verify_tail(a_, s_, digest, r_)
            timed(f"r_check {n}x{ml}", "r_check",
                  lambda: rck.r_check(qx, qz, r_, ok_t))
        if "antipa_tail" in kernels:
            from firedancer_tpu_torch.ops import antipa_tail as at
            key = f"antipa_tail {n}x{ml}"
            timed(key, "antipa_tail",
                  lambda: at.antipa_tail(a_, r_, s_, digest))
            sm_clocks[key] = sm_clock_mhz()
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            clock_hz = float(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, check=True).stdout.split()[0]) * 1e6
            b_ms, b_by = antipa_bound_ms(n, sms * 64 * clock_hz)
            print(f"{args.label} {key}: device {dev_times[key]:.5f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}; IMAD on the FMA pipe "
                  f"beside the integer pipe: "
                  f"{antipa_two_pipe_ms(n, sms * 64 * clock_hz):.5f}), "
                  f"SM clock {sm_clocks[key]:.0f} MHz after it")
            if args.phases:
                dll, names, nstamp = clocks_lib(build)
                want = at.antipa_tail(a_, r_, s_, digest)
                split = phase_split(torch, dll, names, nstamp,
                                    at.kernel_consts(dev), a_, r_, s_,
                                    digest, want)
                mhz = sm_clock_mhz()
                phases[key] = {"sm_clock_mhz": mhz, "cycles": split}
                for name, (mean, med, mx) in split.items():
                    print(f"{args.label} {key} phase {name}: mean "
                          f"{mean:.0f}, median {med:.0f}, max {mx:.0f} "
                          f"cycles ({mean / mhz:.2f} us at {mhz:.0f} MHz)")
        if ml != 128:
            continue
        if "decompress" in kernels:
            timed(f"decompress {n}", "decompress", lambda: dc.decompress(a_))
            if hasattr(dc, "decompress_pair"):
                timed(f"decompress pair {n}", "decompress",
                      lambda: dc.decompress_pair(a_, r_))
            else:
                timed(f"decompress pair {n}", "decompress",
                      lambda: (dc.decompress(a_), dc.decompress(r_)))
            if n == shapes[0][0]:
                z = torch.from_numpy(np.random.default_rng(n).integers(
                    0, 256, (n, 16), np.uint8)).to(dev)
                sg = blob[:, ml:ml + 64]
                # whole RLC calls: their decompress launches and other
                # device ops (three: a trace can miss the event at its
                # edge)
                profiled(f"verify_batch_rlc {n}", "decompress",
                         lambda: ed.verify_batch_rlc(
                             m_, sk.lens_from_bytes(ln_), sg, a_, z), 3)
        if "reduce_recode" in kernels:
            timed(f"reduce_recode {n}x{ml}", "reduce_recode",
                  lambda: rr.reduce_recode(s_, digest))
        if "rlc_recode" in kernels:
            z = torch.from_numpy(np.random.default_rng(n).integers(
                0, 256, (n, 16), np.uint8)).to(dev)
            timed(f"rlc_recode {n}x{ml}", "rlc_recode",
                  lambda: rl.rlc_recode(s_, digest, z))
        if not {"dsm_tail_q", "dsm_base"} & set(kernels):
            continue
        _, a_pt = ed._decompress_checked(a_)
        if "dsm_tail_q" in kernels:
            _, wins = rr.reduce_recode(s_, digest)
            y_r = fe.from_bytes(r_)
            timed(f"dsm_tail_q {n}x{ml}", "dsm_tail_q",
                  lambda: dsm.dsm_tail_q(wins, a_pt, y_r))
        if "dsm_base" in kernels:
            s_win = sc.scalar_windows(s_)
            k_win = sc.limbs_to_windows(sc.reduce_512(digest))
            neg_a = cv.neg(a_pt)
            timed(f"dsm_base {n}x{ml}", "dsm_base",
                  lambda: dsm.double_scalar_mul_base(s_win, k_win, neg_a))
    print(json.dumps({"label": args.label, "card": card, "ms": times,
                      "device_ms": dev_times, "launches": launches,
                      "other_device_ops": others,
                      "device_method": sorted(methods),
                      "sm_clock_mhz": sm_clocks, "phases": phases}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
