#!/usr/bin/env python3
"""What holds the AGC kernels K5 and K6 back, on one CUDA card: their times
at the C8 point beside patched copies that cut one part of their work.

    python3 chip_agc_ablate.py                     # this checkout's variants
    python3 chip_agc_ablate.py --parent DIR        # and DIR's (an unpacked
                                                   # earlier commit)
    python3 chip_agc_ablate.py --measure           # the package beside this
                                                   # script, once

For each variant the script copies a package (`afp_tpu_torch/` of this
checkout, or of the checkout at DIR), `chip_smoke.py`, `chip_variants.py`
and itself into ``build/agc_ablate/<i>/`` (`chip_variants.make_copy`) and
rewrites pieces of a kernel source in the copy (the first variant of each
package is copied as it is).  A variant whose rewrite does not occur
exactly once in its package's source is skipped with a line that says so:
the ``parent`` variants match the commit before K5/K6's redesign.  The
checkout's own package is never changed.  All copies build at once, one
process each; then each copy runs ``--measure`` in a process of its own,
every variant once in order and once in reverse (a line each as it ends),
so that a drift of the card shows as a difference between the two rounds.
``--measure`` times, at batch 4096, block 2048, W = 512 (the C8 point),
each kernel's device time (`chip_smoke.device_ms`: calls queued behind a
spin kernel) and the CUDA-event time of back-to-back calls (which reads
the wrapper's host time once the kernel is shorter), K5 into [T, B], into the 32-sample chunk
means and from int16 x, and K6 'exact' with the pair store and the carry,
with the f32 store, blockwise on the chunk means and from int16 x; it takes
only the wrappers' public arguments, so it times any checkout it is copied
into.  A cut variant computes wrong values: only its time is read.

The variants that cut: K6 with the x/y traffic cut (the recurrence and its
d staging alone: the chain's floor); K6 with the recurrence cut (the gains
are clip(d): the apply's traffic alone); K5 without the sqrt and division,
without its loads (zeros), without its scans; K5 with 3 blocks an SM, and
with tiles of 1024 outputs at 2 blocks an SM.  The build step prints
ptxas's registers and spills.  With ``--parent``: the earlier K5 without
its doubling levels, the earlier K6 without its recurrence and
without its apply.  The card's name and power limit come first; the numbers
also go to ``build/agc_ablate/agc_ablate.json``.  Without a CUDA device it
exits 1.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import chip_smoke as cs
import chip_variants as cv

ROOT = Path(__file__).resolve().parent
SCRIPT = Path(__file__).name
OUT_DIR = ROOT / "build" / "agc_ablate"
RMS, SCAN = "agc_rms.cu", "agc_scan.cu"

#: (name, package: "tree" or "parent", rewrites [(source, old, new)])
VARIANTS = (
    ("K5/K6 as committed", "tree", []),
    ("K6 chain alone (x/y traffic cut)", "tree", [
        (SCAN, "  if (vec) load_chunk(0, cur);", ""),
        (SCAN, "    if (vec && c + 1 < nch) load_chunk(c + 1, nxt);", ""),
        (SCAN, "      if (r >= nb || j * kRun >= n) continue;", "      continue;")]),
    ("K6 apply alone (recurrence cut: g = d)", "tree", [
        (SCAN, "            g = step2(g, dv[q], a_att, om_att, a_rel, om_rel);",
         "            g = dv[q];")]),
    ("K5 without sqrt and division", "tree", [
        (RMS, "  const float rms = __fsqrt_rn(fmaxf(s, 0.f));\n"
              "  return fminf(fmaxf(__fdiv_rn(target, __fadd_rn(rms, 1e-10f)), 0.f),\n"
              "               max_gain);",
         "  return fminf(__fmul_rn(s, target), max_gain);")]),
    ("K5 loads cut (zeros)", "tree", [
        (RMS, "  float v[4] = {0.f, 0.f, 0.f, 0.f};\n  if (b < a.B) {",
         "  float v[4] = {0.f, 0.f, 0.f, 0.f};\n  if (b < 0) {")]),
    ("K5 scans cut", "tree", [
        (RMS, "      suffix_scan(vs[i], lane, s);",
         "      s[0] = vs[i].x; s[1] = vs[i].y; s[2] = vs[i].z; s[3] = vs[i].w;"),
        (RMS, "      const float t = prefix_scan(vp[i], lane, p);",
         "      const float t = vp[i].x; p[0] = vp[i].y; p[1] = vp[i].z; p[2] = vp[i].w;"
         " p[3] = t;")]),
    ("K5 time tile 1024, 2 blocks/SM", "tree", [
        (RMS, "constexpr int kTimeTile = 512;", "constexpr int kTimeTile = 1024;"),
        (RMS, "__launch_bounds__(kThreads, 4) rms_desired_kernel",
         "__launch_bounds__(kThreads, 2) rms_desired_kernel")]),
    ("K5 3 blocks/SM", "tree", [
        (RMS, "__launch_bounds__(kThreads, 4) rms_desired_kernel",
         "__launch_bounds__(kThreads, 3) rms_desired_kernel")]),
    ("parent K5/K6 as committed", "parent", []),
    ("parent K5 without its doubling levels", "parent", [
        (RMS, "    for (int k = 1; k < kLane; k *= 2) {",
         "    for (int k = 1; k < 1; k *= 2) {")]),
    ("parent K6 without its recurrence (g = d)", "parent", [
        (SCAN, "          g = step(g, ds[t][lane], a_att, a_rel);",
         "          g = ds[t][lane];")]),
    ("parent K6 without its apply", "parent", [
        (SCAN, "    for (int i = threadIdx.x; i < nb * n; i += kThreads) {",
         "    for (int i = threadIdx.x; i < 0; i += kThreads) {")]),
)


def patch(rewrites):
    """The rewrite of a copy: each (source, old, new) of `rewrites` in the
    copy's `csrc/`."""
    def run(dst: Path) -> None:
        for name, old, new in rewrites:
            cv.replace_once(dst / "afp_tpu_torch" / "csrc" / name, old, new)
    return run


def measure(torch, dev) -> dict:
    """Device and CUDA-event times (ms) of K5 and K6 at the C8 point, from
    fixed seeds (every copy sees the same data)."""
    from afp_tpu_torch.engine import Pipeline
    from afp_tpu_torch.ops.cuda import agc_rms as R
    from afp_tpu_torch.ops.cuda import agc_scan as S

    sz = cs.Sizes()
    pipe = Pipeline(cs.c8_config(sz), dev)
    B, T = sz.c8_batch, sz.c8_block
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(B, T, generator=g, device=dev) * 0.1
    x[: B // 8] *= 8.0
    x16 = torch.clamp(torch.round(x * 32768), -32768, 32767).to(torch.int16)
    init = torch.rand(B, generator=g, device=dev) * 4.0 + 0.2
    band, (lp, rp) = pipe._rms_band, pipe._rms_pad
    a_att, a_rel = pipe.agc.a_att, pipe.agc.a_rel
    d = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True)
    dm = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True, mean_chunk=32)
    k5 = {"K5 [T, B]": lambda: R.rms_desired(x, band, lp, rp, 0.1, 10.0, True,
                                             transposed=True),
          "K5 means": lambda: R.rms_desired(x, band, lp, rp, 0.1, 10.0, True,
                                            transposed=True, mean_chunk=32),
          "K5 int16": lambda: R.rms_desired(x16, band, lp, rp, 0.1, 10.0, True,
                                            transposed=True)}
    k6 = {"K6 exact pair": lambda: S.smooth_gain_apply(
              d, x, a_att, a_rel, 10.0, init=init, emit_split=True),
          "K6 exact f32": lambda: S.smooth_gain_apply(d, x, a_att, a_rel, 10.0, init=init),
          "K6 blockwise means pair": lambda: S.smooth_gain_apply(
              dm, x, a_att, a_rel, 10.0, init=init, emit_split=True, blockwise=32,
              d_is_means=True),
          "K6 int16 pair": lambda: S.smooth_gain_apply(
              d, x16, a_att, a_rel, 10.0, init=init, emit_split=True)}
    out = {}
    for name, fn in {**k5, **k6}.items():
        out[name] = cs.device_ms(torch, fn, 20)
        out[name + " (events)"] = cs.time_ms(torch, fn, 20)
    out["copy of x (events)"] = cs.time_ms(torch, lambda: x.clone(), 20)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_agc_ablate: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args == ["--build"]:
        from afp_tpu_torch.ops.cuda import _build

        log = _build.build().with_suffix(".log")
        print(json.dumps(cs.ptxas_report(log, ("rms_desired_kernel", "agc_apply_kernel"))))
        return 0
    dev = torch.device("cuda", 0)
    if args == ["--measure"]:
        print(json.dumps(measure(torch, dev)))
        return 0
    parent = Path(args[1]).resolve() if args[:1] == ["--parent"] else None
    smi = cs.gpu_line()
    cs.say(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    todo = []
    for i, (name, pkg, rw) in enumerate(VARIANTS):
        if pkg == "parent" and parent is None:
            continue
        try:
            todo.append((name, cv.make_copy(OUT_DIR / str(i), ROOT if pkg == "tree"
                                            else parent, SCRIPT, patch(rw))))
        except ValueError as e:  # the rewrite belongs to another commit
            cs.say(f"variant {name}: skipped, {e}")
    regs = cv.build_all([d for _, d in todo], SCRIPT)
    cs.say(f"built {len(todo)} variants in {time.perf_counter() - t0:.1f} s")
    for (name, _), reg in zip(todo, regs):
        cs.say(f"ptxas {name}: " + "; ".join(
            f"{k.split('_GLOBAL__N_')[-1][-40:]} {v}" for k, v in reg.items()))
    results = {name: [] for name, _ in todo}
    for rnd, order in enumerate((todo, todo[::-1])):
        for name, dst in order:
            try:
                res = cv.child(dst, SCRIPT, "--measure")
            except RuntimeError as e:  # one variant's failure loses no other
                cs.say(f"round {rnd + 1} variant {name}: failed: {str(e)[-300:]}")
                continue
            results[name].append(res)
            cs.say(f"round {rnd + 1} variant {name}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in res.items()))
    (OUT_DIR / "agc_ablate.json").write_text(json.dumps(
        dict(device=smi, variants=results), indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
