#!/usr/bin/env python3
"""Run the plain conv forms of the port (`afp_tpu_torch/ops/cuda/fir_td.py:
_conv`, bf16×3 and HIGHEST) in many fresh CPU processes and count their
distinct outputs.

    python3 cpu_conv_repeat.py [--runs 400] [--jobs 4]

The plain versions are the yardstick of the card tests and the route of
the CPU tests against `afp_tpu`, and they multiply on the CPU's f32 GEMM
(`torch.matmul`).  That GEMM gave the plain K5 a second, coarser result in
3 of ~770 fresh processes before K5 moved to float64 reductions.  Each run
here is a new Python process that computes `_conv` at three of the CPU
tests' shapes (the C5 cascade at one stream, the C8 cascade at batch 8,
a short 'fft'-test cascade at batch 4), seeded with numpy, at both
precisions, and prints the SHA-256 of each output.  The parent prints one
line per shape and precision with the number of runs and of distinct
outputs, and exits 1 when any shape gave more than one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

#: (name, batch, taps, outputs): the shapes of the CPU tests' conv calls
SHAPES = (("c5", 1, 379, 4096), ("c8", 8, 209, 2048), ("short", 4, 129, 512))


def one_run() -> dict:
    import numpy as np
    import torch

    from afp_tpu_torch.ops.cuda.fir_td import _conv

    out = {}
    for name, B, n, T in SHAPES:
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.standard_normal((B, n - 1 + T)).astype(np.float32))
        h = torch.from_numpy((rng.standard_normal(n) / n).astype(np.float32))
        for highest in (False, True):
            y = _conv(x, h, highest).numpy()
            key = f"{name}:{'HIGHEST' if highest else 'B3'}"
            out[key] = hashlib.sha256(y.tobytes()).hexdigest()[:16]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=400)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(one_run()))
        return 0

    def spawn(_):
        r = subprocess.run([sys.executable, __file__, "--child"], check=True,
                           capture_output=True, text=True)
        return json.loads(r.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.jobs) as pool:
        runs = list(pool.map(spawn, range(args.runs)))
    bad = False
    for key in runs[0]:
        seen: dict = {}
        for r in runs:
            seen[r[key]] = seen.get(r[key], 0) + 1
        bad |= len(seen) > 1
        print(f"{key}: {len(runs)} runs, {len(seen)} distinct outputs {seen}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
