#!/usr/bin/env python3
"""Time the port's point-chain kernels of one checkout on the card.

    python3 firedancer_tpu_torch/tools/kernel_time.py [--root DIR]
        [--label L] [--kernels msm,verify_tail,dsm_tail_q] [--lanes N,...]

Imports firedancer_tpu_torch from DIR (default: the checkout that holds
this script), builds its kernels, prints the chosen kernels' ptxas -v
lines (registers, shared memory, stack and spills of each entry and
out-of-line function) and times them with CUDA events (median, min and
max of 20 after 3 warm-ups), on inputs made from fixed seeds:
  msm          msm_lanes at 4096 and 32768 points, m 8, nwin 64 and 32,
               both selects, on points decompressed from random encodings
               and random digits;
  verify_tail  at 4096 x 128, 32768 x 128 and 4096 x 1232 (or at the
               lane counts given by --lanes, x 128), on the digests,
               keys, S and R of valid signatures (make_example_batch),
               as dispatch_blob gives them;
  dsm_tail_q   at the same shapes' 128-byte ones, on the same
               signatures' windows (reduce_recode), decompressed keys
               and R's y.
The last line is one JSON object: the label, the card's name and power
limit (nvidia-smi) and the times in ms.  To compare two checkouts, run it
for each in turn on one card, one run after another: A, B, B, A.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

RUNS, M = 20, 8
SOURCES = {"msm": "msm", "verify_tail": "verify_tail", "dsm_tail_q": "dsm"}


def cuda_ms(torch, fn) -> list[float]:
    """[median, min, max] ms of RUNS calls after 3 warm-ups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        ts.append(a.elapsed_time(z))
    return [statistics.median(ts), min(ts), max(ts)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(SOURCES))
    ap.add_argument("--lanes", default="",
                    help="verify_tail and dsm_tail_q at these lane counts "
                         "(x 128) instead of the three default shapes")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    import torch
    if not torch.cuda.is_available():
        print("kernel_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from firedancer_tpu_torch.kernels import build
    from firedancer_tpu_torch.models import verifier as V
    from firedancer_tpu_torch.ops import decompress as dc
    from firedancer_tpu_torch.ops import dsm
    from firedancer_tpu_torch.ops import ed25519 as ed
    from firedancer_tpu_torch.ops import msm as ms
    from firedancer_tpu_torch.ops import reduce_recode as rr
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

    dev = torch.device("cuda", 0)
    times = {}
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
                    times[f"msm {n} {sel} nwin {nwin}"] = cuda_ms(
                        torch, lambda: ms.msm_lanes(win, pts, M, nwin, sel))
    shapes = ([(int(n), 128) for n in args.lanes.split(",")] if args.lanes
              else [(4096, 128), (32768, 128), (4096, 1232)])
    for n, ml in shapes:
        if "verify_tail" not in kernels and (
                "dsm_tail_q" not in kernels or ml != 128):
            continue
        msgs, lens, sigs, pubs = V.make_example_batch(n, ml, True, n + ml,
                                                      sign_pool=256)
        blob = torch.from_numpy(V.pack_blob(msgs, lens, sigs, pubs)).to(dev)
        m_, r_, s_ = blob[:, :ml], blob[:, ml:ml + 32], blob[:, ml + 32:ml + 64]
        a_, ln_ = blob[:, ml + 64:ml + 96], blob[:, ml + 96:]
        digest = sk.sha512_ram(m_, r_, a_, ln_)
        if "verify_tail" in kernels:
            times[f"verify_tail {n}x{ml}"] = cuda_ms(
                torch, lambda: vt.verify_tail(a_, s_, digest, r_))
        if "dsm_tail_q" in kernels and ml == 128:
            _, wins = rr.reduce_recode(s_, digest)
            _, a_pt = ed._decompress_checked(a_)
            y_r = ed._parse_r_bytes(r_)[0]
            times[f"dsm_tail_q {n}x{ml}"] = cuda_ms(
                torch, lambda: dsm.dsm_tail_q(wins, a_pt, y_r))
    print(json.dumps({"label": args.label, "card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
