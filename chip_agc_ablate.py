#!/usr/bin/env python3
"""What holds the AGC kernels K5, K6, K9 and K14 back, on one CUDA card:
their times at the C8 point beside patched copies that cut one part of
their work.

    python3 chip_agc_ablate.py                     # this checkout's variants
    python3 chip_agc_ablate.py --parent DIR        # and DIR's (an unpacked
                                                   # earlier commit)
    python3 chip_agc_ablate.py --measure           # the package beside this
                                                   # script, once

For each variant the script copies a package (`afp_tpu_torch/` of this
checkout, or of the checkout at DIR), `chip_smoke.py`, `chip_variants.py`
and itself into ``build/agc_ablate/<i>/`` (`chip_variants.make_copy`) and
rewrites pieces of the kernel sources in the copy (the first variant of
each package is copied as it is).  A variant whose rewrite does not occur
exactly once in its package's source is skipped with a line that says so.
The checkout's own package is never changed.  All copies build at once,
one process each; then each copy runs ``--measure`` in a process of its
own, every variant once in order and once in reverse (a line each as it
ends), so that a drift of the card shows as a difference between the two
rounds.  ``--measure`` times, at batch 4096, block 2048, W = 512 (the C8
point), each kernel's device time (`chip_smoke.device_ms`: calls queued
behind a spin kernel) and the CUDA-event time of back-to-back calls
(which reads the wrapper's host time once the kernel is shorter): K5 into
[T, B]; K6 'exact' with the pair store and the carry, with the f32 store
and from int16 x; K14 with the pair store and the carry, with the f32
store and the restart, and from int16 x; K9 from time-major d into the
batch-major store (the smoke's form), from batch-major d, and from
time-major d into the time-major store.  It takes only the wrappers'
public arguments, so it times any checkout it is copied into.  A cut
variant computes wrong values: only its time is read.

The variants that cut: the chains alone (K6's and K14's apply warps, K14's
window work and K9's stores cut: each recurrence warp with its d staging,
the chain's floor); the applies alone (K6's and K14's recurrences and
K14's window work cut); K14's window warps alone (its chain and apply
cut), and that without its sqrt and division or without the loads of
its running sums.  Two more change K14's number of window warps (6) to 4
and 8.  The build step prints ptxas's registers and spills.  The card's
name and power limit come first; the numbers also go to
``build/agc_ablate/agc_ablate.json``.  Without a CUDA device it exits 1.
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
ROLES, SCAN, FUSED = "agc_roles.cuh", "agc_scan.cu", "agc_fused.cu"

#: the apply warps of K6 and K14 cut (`agc_roles.cuh:apply_role`)
CUT_APPLY = [
    (ROLES, "  if (vec) load_chunk(0, cur);", ""),
    (ROLES, "    if (vec && c + 1 < nch) load_chunk(c + 1, nxt);", ""),
    (ROLES, "      if (r >= nb || j * kRun >= n) continue;", "      continue;")]
#: K14's window work cut (no loads, no sums, no d: the slots keep what
#: they held), its barriers kept
CUT_WINDOW = [
    (FUSED, "= live ? chunk_total(ap, vec, row + k * kTC) : 0.f;", "= 0.f;"),
    (FUSED, "const bool in_n = live && i + h < nch, in_o = live && i - h >= 0;",
     "const bool in_n = false, in_o = false;"),
    (FUSED, "#pragma unroll 1\n    for (int g = 0; g < kTC / kGroup; ++g) {",
     "#pragma unroll 1\n    for (int g = 0; g < 0; ++g) {")]
#: the recurrences of K14 and K6 cut (the gains are d)
CUT_K14_CHAIN = [
    (FUSED, "    g = run_chain(g, RowsD{ds + w * kSlot + lane}, kTC,\n"
            "                  a.init == nullptr && i == 0, gl, al);",
     "    g = ds[w * kSlot + lane];")]
CUT_K6_CHAIN = [(SCAN, "        g = run_chain(g, RowsD{dc}, n, false, gl, al);",
                 "        g = dc[0];")]
#: K9's stores cut, both layouts
CUT_K9_STORE = [
    (SCAN, "        if (l < nb)\n          a.out[", "        if (l < 0)\n          a.out["),
    (SCAN, "        if (r >= nb || j * kRun >= n) continue;", "        continue;")]

#: (name, package: "tree" or "parent", rewrites [(source, old, new)])
VARIANTS = (
    ("as committed", "tree", []),
    ("chains alone (K6/K14 apply, K14 window work, K9 stores cut)", "tree",
     CUT_APPLY + CUT_WINDOW + CUT_K9_STORE),
    ("applies alone (K6/K14 recurrence and K14 window work cut)", "tree",
     CUT_K6_CHAIN + CUT_K14_CHAIN + CUT_WINDOW),
    ("K14 window warps alone (its chain and apply cut)", "tree",
     CUT_APPLY + CUT_K14_CHAIN),
    *((f"K14 {n} window warps", "tree",
       [(FUSED, "constexpr int kWindowWarps = 6;", f"constexpr int kWindowWarps = {n};")])
      for n in (4, 8)),
    ("K14 window warps alone, no sqrt or division (d = W)", "tree",
     CUT_APPLY + CUT_K14_CHAIN + [
         (FUSED, "            desired(__fmul_rn(W, a.inv_w), a.target, ap.max_gain);",
          "            W;")]),
    ("K14 window warps alone, no loads for the running sums", "tree",
     CUT_APPLY + CUT_K14_CHAIN + [
         (FUSED, "const bool in_n = live && i + h < nch, in_o = live && i - h >= 0;",
          "const bool in_n = false, in_o = false;")]),
    ("parent as committed", "parent", []),
)


def patch(rewrites):
    """The rewrite of a copy: each (source, old, new) of `rewrites` in the
    copy's `csrc/`."""
    def run(dst: Path) -> None:
        for name, old, new in rewrites:
            cv.replace_once(dst / "afp_tpu_torch" / "csrc" / name, old, new)
    return run


def measure(torch, dev) -> dict:
    """Device and CUDA-event times (ms) of K5, K6, K14 and K9 at the C8
    point, from fixed seeds (every copy sees the same data)."""
    from afp_tpu_torch.engine import Pipeline
    from afp_tpu_torch.ops.cuda import agc_fused as K14
    from afp_tpu_torch.ops.cuda import agc_rms as R
    from afp_tpu_torch.ops.cuda import agc_scan as S

    sz = cs.Sizes()
    pipe = Pipeline(cs.c8_config(sz), dev)
    B, T, W = sz.c8_batch, sz.c8_block, sz.c8_window
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(B, T, generator=g, device=dev) * 0.1
    x[: B // 8] *= 8.0
    x16 = torch.clamp(torch.round(x * 32768), -32768, 32767).to(torch.int16)
    init = torch.rand(B, generator=g, device=dev) * 4.0 + 0.2
    band, (lp, rp) = pipe._rms_band, pipe._rms_pad
    a_att, a_rel = pipe.agc.a_att, pipe.agc.a_rel
    knobs = (a_att, a_rel, 0.1, 10.0)
    d = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True)
    db = d.T.contiguous()
    fns = {
        "K5 [T, B]": lambda: R.rms_desired(x, band, lp, rp, 0.1, 10.0, True,
                                           transposed=True),
        "K6 exact pair": lambda: S.smooth_gain_apply(d, x, a_att, a_rel, 10.0, init=init,
                                                     emit_split=True),
        "K6 exact f32": lambda: S.smooth_gain_apply(d, x, a_att, a_rel, 10.0, init=init),
        "K6 int16 pair": lambda: S.smooth_gain_apply(d, x16, a_att, a_rel, 10.0,
                                                     init=init, emit_split=True),
        "K14 pair": lambda: K14.agc_rms_apply(x, W, *knobs, init=init, emit_split=True),
        "K14 f32 restart": lambda: K14.agc_rms_apply(x, W, *knobs),
        "K14 int16 pair": lambda: K14.agc_rms_apply(x16, W, *knobs, init=init,
                                                    emit_split=True),
        "K9 [T, B] -> [B, T]": lambda: S.smooth_gain_scan(
            d, a_att, a_rel, init=init, time_major=True, out_batch_major=True),
        "K9 [B, T] -> [B, T]": lambda: S.smooth_gain_scan(
            db, a_att, a_rel, init=init, out_batch_major=True),
        "K9 [T, B] -> [T, B]": lambda: S.smooth_gain_scan(d, a_att, a_rel, init=init,
                                                          time_major=True),
    }
    out = {}
    for name, fn in fns.items():
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
        print(json.dumps(cs.ptxas_report(log, ("rms_desired_kernel", "agc_"))))
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
