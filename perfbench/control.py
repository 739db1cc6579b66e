#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the cell's
reference (the one its configuration names) put in the program's place and
computed in bfloat16 (input, gained signal and taps rounded), compared with
the float64 reference exactly as a run compares the program, on the same
seeded inputs, rows and blocks as a run of the cell that returns
`--blocks` blocks in its window:

    python3 perfbench/control.py --workload <cell> --blocks <n> --seeds <s> ...

One JSON line per seed gives the numbers beside their limits; the control
has to exceed a limit on every seed.  The benchmark's runs never run it.
The inputs are drawn on the CUDA card, as a run draws them (`--device cpu`
draws them on the CPU: other numbers, for the tests).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def control_reading(bench, workload: str, seed: int, blocks: int,
                    device: str = "cuda", shrink=None) -> dict:
    """The control's numbers for one seed: {name: {"value", "limit"}} and
    whether a run with these outputs would have been judged correct."""
    import torch

    from perfbench.harness import check, traffic
    from perfbench.harness.runner import cell_parts

    _, conf, mix, loop, stream, serving = cell_parts(bench, workload, shrink)
    reference_blocks = bench.reference(conf).reference_blocks
    B, T = int(stream["batch"]), int(stream["blocksize"])
    pool = traffic.make_pool(mix, B, T, float(stream["samplerate"]), seed,
                             torch.device(device))
    rows = check.sample_rows(B, seed)
    keeper = check.Keeper(rows, seed)
    first = loop.warm_blocks(serving)
    dummy = np.zeros((B, T), dtype=np.float32)
    for k in range(first, first + int(blocks)):
        keeper.offer(k, dummy)
    ks, _ = keeper.kept()
    ds = int(seed) % (1 << 31)

    def block_of(k):
        return pool[k % len(pool)]

    kw = dict(config=conf, seed=int(seed))
    ref = reference_blocks(block_of, rows, ks, stream, ds, "float64", **kw)
    low = reference_blocks(block_of, rows, ks, stream, ds, "bfloat16", **kw)
    if stream.get("emit") == "pcm16":
        prog = np.clip(np.round(low * 32768.0), -32768, 32767).astype(np.int16)
    else:
        prog = low.astype(np.float32)
    correct, nums = check.compare(prog, ref, conf["limits"], 0, 0)
    return {"seed": seed, "blocks": len(ks), "correct": correct, "check": nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--blocks", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if str(Path(p or ".").resolve()) != here]
    sys.path.insert(0, str(ROOT))
    from perfbench.harness.bench import Bench

    bench = Bench(ROOT)
    for s in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **control_reading(bench, args.workload, s, args.blocks,
                                            args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
