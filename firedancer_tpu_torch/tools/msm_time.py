#!/usr/bin/env python3
"""Time the msm kernel of one checkout on the card.

    python3 firedancer_tpu_torch/tools/msm_time.py [--root DIR] [--label L]

Imports firedancer_tpu_torch from DIR (default: the checkout that holds
this script), builds its kernels, prints the msm kernels' ptxas -v lines
and times msm_lanes with CUDA events (median of 20 after 3 warm-ups) at
the RLC path's shapes: 4096 and 32768 points, m 8, nwin 64 and 32, both
selects, on points decompressed from random encodings and random digits,
made from a fixed seed.  The last line is one JSON object: the label,
the card's name and power limit (nvidia-smi) and the times in ms.  To
compare two checkouts, run it for each in turn on one card, one run
after another: A, B, B, A.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

RUNS, M = 20, 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("msm_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.root)
    from firedancer_tpu_torch.kernels import build
    from firedancer_tpu_torch.ops import decompress as dc
    from firedancer_tpu_torch.ops import msm as ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log = build.build_all()["msm"]
    entry = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line or "stack frame" in line:
            print(f"{args.label} msm.cu {entry} ptxas: {line.strip()}")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    times = {}
    for n in (4096, 32768):
        b = torch.from_numpy(rng.integers(0, 256, (n, 32), np.uint8)).to(dev)
        pts = dc.decompress(b)[2]
        for nwin in (64, 32):
            win = torch.from_numpy(rng.integers(0, 16, (nwin, n),
                                                np.uint8)).to(dev)
            for sel in ms.SELECTS:
                def fn():
                    ms.msm_lanes(win, pts, M, nwin, sel)
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
                times[f"{n} {sel} nwin {nwin}"] = statistics.median(ts)
    print(json.dumps({"label": args.label, "card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
