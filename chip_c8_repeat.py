#!/usr/bin/env python3
"""Repeat the C8 batch-8 card-against-CPU check of `chip_smoke.py` (phase 4)
in fresh processes on one NVIDIA GPU, and say which stage differs.

    python3 chip_c8_repeat.py [--runs 20] [--out build/c8_repeat]

Each run is a new Python process (a new CUDA context and caching allocator)
that drives the C8 chain (`chip_smoke.C8`, AGC 'exact', batch 8, 4 blocks,
dither on) through `Pipeline.run` on the card and on the CPU, as the smoke
does.  Runs alternate two conditions of the card's memory:

* poisoned: a large tensor filled with NaN is freed into the caching
  allocator first, so any output or workspace element that a kernel fails
  to write reads NaN;
* warm: the smoke's batch-4096 C8 blocks run first, so the allocator hands
  the batch-8 run the blocks those freed, as in the smoke.

Every call of K5 (`rms_desired`), K6 (`smooth_gain_apply`) and K8
(`fir_td_mxu_pair`) on the card is recorded with its inputs and held
against its plain version on the same inputs (K6 bit for bit, K5 and K8 in
dB), so a difference between the card and the CPU is traced to its stage.
A run prints one JSON line; the parent prints a summary and writes every
line to ``<out>/runs.jsonl`` and the arrays of any run whose card or CPU
output differs from the first run's to ``<out>/run_<i>.npz``.  Exits 1
when the card and the CPU differ by more than ``chip_smoke.CHAIN_DB`` in
any run, when a kernel differs from its plain version, or when the card's
(or the CPU's) outputs differ between runs.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _cpu(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, (tuple, list)):
        return type(v)(_cpu(u) for u in v)
    if isinstance(v, dict):
        return {k: _cpu(u) for k, u in v.items()}
    return v


def _f64(t) -> np.ndarray:
    return t.float().numpy().astype(np.float64)


def _main_out(stage, r):
    """The output array of a recorded call: K5's d, K6's gained block (its
    pair merged), K8's y."""
    if stage == "K5":
        return _f64(r)
    if stage == "K6":
        return _f64(r[0][0]) + _f64(r[0][1])
    return _f64(r[0])


def child(index: int, poison: bool, warm: bool, out: Path) -> int:
    import torch

    import chip_smoke as S
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.engine import pipeline as P
    from afp_tpu_torch.ops.cuda import (fir_td_mxu_pair_plain, rms_desired_plain,
                                        smooth_gain_apply_plain)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sz = S.Sizes()
    if warm:
        g = torch.Generator(device=dev).manual_seed(11)
        blocks = torch.randn(2, sz.c8_batch, sz.c8_block, generator=g,
                             device=dev) * 0.1
        for mode in ("exact", "fast"):
            pipe = Pipeline(S.c8_config(sz, agc_mode=mode), dev)
            params = pipe.device_params(PipelineParams.design(pipe.cfg))
            pipe.run(params, pipe.init_state(seed=0), blocks)
        torch.cuda.synchronize()
        del blocks
    if poison:
        junk = torch.full((1 << 28,), float("nan"), device=dev)  # 1 GiB
        torch.cuda.synchronize()
        del junk

    calls = []  # (stage, cpu args, cpu kwargs, cpu result) of each card call
    recording = [True]

    def recorder(stage, fn):
        def wrapped(*args, **kw):
            res = fn(*args, **kw)
            if recording[0]:
                torch.cuda.synchronize()
                calls.append((stage, _cpu(args), _cpu(kw), _cpu(res)))
            return res
        return wrapped

    P.rms_desired = recorder("K5", P.rms_desired)
    P.smooth_gain_apply = recorder("K6", P.smooth_gain_apply)
    P.fir_td_mxu_pair = recorder("K8", P.fir_td_mxu_pair)

    small = S.c8_config(sz, batch=8)
    sig = (np.random.default_rng(4).standard_normal((4, 8, sz.c8_block)) * 0.1
           ).astype(np.float32)
    sig[:, 0] *= 8.0
    outs = {}
    for where in (dev, torch.device("cpu")):
        pipe = Pipeline(small, where)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        _, y = pipe.run(params, pipe.init_state(seed=1), sig)
        outs[len(outs)] = y.cpu().numpy()
        recording[0] = False
    card, cpu = outs[0], outs[1]

    plain = {"K5": rms_desired_plain, "K6": smooth_gain_apply_plain,
             "K8": fir_td_mxu_pair_plain}
    stages = []
    for stage, args, kw, got in calls:
        want = plain[stage](*args, **kw)
        if stage == "K5":
            rec = dict(db=S.err_db(_f64(got), _f64(want)),
                       nan=int(torch.isnan(got).sum()))
        elif stage == "K6":
            (gh, gl), gc = got
            (wh, wl), wc = want
            rec = dict(equal=bool(torch.equal(gh, wh) and torch.equal(gl, wl)
                                  and torch.equal(gc, wc)),
                       n_diff=int((gh != wh).sum() + (gl != wl).sum()),
                       nan=int(torch.isnan(gh.float()).sum()))
        else:
            rec = dict(db=S.err_db(_f64(got[0]), _f64(want[0])),
                       tails=bool(torch.equal(got[1], want[1])
                                  and torch.equal(got[2], want[2])),
                       nan=int(torch.isnan(got[0]).sum()))
        stages.append(dict(stage=stage, **rec))

    e = S.err_db(card, cpu)
    diff = np.abs(card.astype(np.float64) - cpu)
    at = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
    line = dict(run=index, poison=poison, warm=warm, card=_digest(card),
                cpu=_digest(cpu), db=e, at=at, card_at=float(card[at]),
                cpu_at=float(cpu[at]),
                per_block_db=[S.err_db(a, b) for a, b in zip(card, cpu)],
                stages=stages,
                cpu_capability=torch.backends.cpu.get_cpu_capability(),
                threads=torch.get_num_threads())
    np.savez_compressed(out / f"run_{index}.npz", card=card, cpu=cpu,
                        **{f"{s}_{i}": _main_out(s, r)
                           for i, (s, _, _, r) in enumerate(calls)})
    print(json.dumps(line), flush=True)
    return 0


def cpu_model() -> str:
    try:
        for ln in Path("/proc/cpuinfo").read_text().splitlines():
            if ln.startswith("model name"):
                return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out", default="build/c8_repeat")
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--poison", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--warm", type=int, default=0, help=argparse.SUPPRESS)
    a = ap.parse_args()
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    if a.child is not None:
        return child(a.child, bool(a.poison), bool(a.warm), out)

    import torch

    if not torch.cuda.is_available():
        print("chip_c8_repeat: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S

    print(S.gpu_line(), "|", cpu_model(), flush=True)
    from afp_tpu_torch.ops.cuda import _build

    _build.load()  # build once; the runs load the cached library
    lines = []
    for i in range(a.runs):
        cmd = [sys.executable, __file__, "--child", str(i), "--out", str(out),
               "--poison", str(i % 2), "--warm", str(i // 2 % 2)]
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            print(p.stdout, p.stderr, file=sys.stderr)
            return 1
        line = json.loads(p.stdout.strip().splitlines()[-1])
        lines.append(line)
        bad = [s for s in line["stages"] if s.get("nan") or s.get("equal") is False
               or s.get("tails") is False or s.get("db", -999) > S.CONV_DB]
        print(f"run {i} poison={line['poison']} warm={line['warm']}: card "
              f"{line['card']} cpu {line['cpu']} {line['db']:.1f} dB at "
              f"{line['at']} (card {line['card_at']!r}, cpu {line['cpu_at']!r}); "
              f"stages off: {bad}", flush=True)
    (out / "runs.jsonl").write_text("".join(json.dumps(x) + "\n" for x in lines))
    for x in lines[1:]:
        if (x["card"], x["cpu"]) == (lines[0]["card"], lines[0]["cpu"]):
            (out / f"run_{x['run']}.npz").unlink()
    cards = sorted({x["card"] for x in lines})
    cpus = sorted({x["cpu"] for x in lines})
    worst = max(x["db"] for x in lines)
    stage_bad = any(s.get("nan") or s.get("equal") is False or s.get("tails") is False
                    or s.get("db", -999) > S.CONV_DB
                    for x in lines for s in x["stages"])
    print(json.dumps(dict(runs=len(lines), card_outputs=len(cards),
                          cpu_outputs=len(cpus), worst_db=worst,
                          stage_fault=stage_bad)))
    return int(worst > S.CHAIN_DB or stage_bad or len(cards) > 1 or len(cpus) > 1)


if __name__ == "__main__":
    sys.exit(main())
