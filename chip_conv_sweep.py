#!/usr/bin/env python3
"""Geometry sweep of the tensor-core conv body on one CUDA card.

    python3 chip_conv_sweep.py            # every variant
    python3 chip_conv_sweep.py --measure  # the package beside this script

The body's geometry is four constants of `afp_tpu_torch/csrc/fir_td.cu`:
``kAccSteps`` (the k-steps summed in one fragment before the fp32 add),
``kBodyWarps`` (the warps of a block, 64 outputs each), ``kBodyMT`` (the m16
row tiles of a warp) and ``kBodyMinBlocks`` (the blocks an SM must hold,
which caps the registers), mirrored by ``ACC_STEPS`` and ``_CONV_ROWS,
_CONV_COLS`` of `afp_tpu_torch/ops/cuda/fir_td.py`.  For each variant the
sweep copies `afp_tpu_torch/`, `chip_smoke.py`, `chip_variants.py` and this
script into ``build/conv_sweep/<i>/`` (`chip_variants.make_copy`) and
rewrites those constants in the copy (the first variant is the committed
geometry, copied as it is); the checkout's own package is never changed.
All copies build at once, one process each, and each checks that its library reports the geometry its Python mirror
computes (`built_conv_geometry` ≡ `conv_geometry`).  Then each copy runs
``--measure`` in a process of its own, in turn: ptxas's registers and
spills of every conv instantiation, the error of the conv against its plain
version at the card tests' long shapes (random taps: bf16×3 at 1151 and
2058 taps, HIGHEST at 379, 457 and 1226, HIGHEST K11 with one band of 300)
and at the C5 headline, and the CUDA-event times of K1 (bf16×3 and
HIGHEST; and with one tap, with and without the dither, which leaves a
block's staging, tiles and store) and K3 at the C5 headline, K8 at the C8
point and K11 (both precisions) at C8-psg, beside a copy of the one-tap
block.  ``--measure`` takes only the wrappers' public arguments, so it also
times another checkout it is copied into.  The card's name and power limit
come first; the numbers also go to ``build/conv_sweep/conv_sweep.json``.
Without a CUDA device it exits 1.
"""
from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import chip_smoke as cs
import chip_variants as cv

ROOT = Path(__file__).resolve().parent
SCRIPT = Path(__file__).name
SWEEP_DIR = ROOT / "build" / "conv_sweep"

#: (name, geometry: acc_steps, warps, mt, min_blocks); the first is the
#: committed geometry
VARIANTS = (
    ("16 rows x 512, 2 blocks/SM, sums of 16 k-steps (committed)", None),
    ("32 rows x 512, 1 block/SM", dict(acc_steps=16, warps=8, mt=2, min_blocks=1)),
    ("32 rows x 256, 1 block/SM", dict(acc_steps=16, warps=4, mt=2, min_blocks=1)),
    ("16 rows x 256, 3 blocks/SM", dict(acc_steps=16, warps=4, mt=1, min_blocks=3)),
    ("sums of 8 k-steps", dict(acc_steps=8, warps=8, mt=1, min_blocks=2)),
    ("sums of 64 k-steps", dict(acc_steps=64, warps=8, mt=1, min_blocks=2)),
)


def _sub(text: str, pattern: str, value: str) -> str:
    out, n = re.subn(pattern, lambda m: m.group(1) + value, text, flags=re.M)
    if n != 1:
        raise ValueError(f"pattern {pattern!r} matched {n} times")
    return out


def set_geometry(dst: Path, geo: dict) -> None:
    """Rewrite the body's geometry constants of the copy at `dst` to `geo`,
    in the C++ and in the Python mirror."""
    cu = dst / "afp_tpu_torch" / "csrc" / "fir_td.cu"
    s = cu.read_text()
    for name, key in (("kAccSteps", "acc_steps"), ("kBodyWarps", "warps"),
                      ("kBodyMT", "mt"), ("kBodyMinBlocks", "min_blocks")):
        s = _sub(s, rf"^(constexpr int {name} = )\d+", str(geo[key]))
    cu.write_text(s)
    py = dst / "afp_tpu_torch" / "ops" / "cuda" / "fir_td.py"
    s = _sub(py.read_text(), r"^(ACC_STEPS = )\d+", str(geo["acc_steps"]))
    s = _sub(s, r"^(_CONV_ROWS, _CONV_COLS = )\d+, \d+",
             f"{16 * geo['mt']}, {64 * geo['warps']}")
    py.write_text(s)


def build_and_check() -> dict:
    """(In a copy.) Build the library and hold the Python mirror of the
    geometry against the library's, over tap counts of one to three window
    chunks; return the ptxas report of the conv kernels."""
    from afp_tpu_torch.ops.cuda import _build
    from afp_tpu_torch.ops.cuda import fir_td as F

    lib = _build.build()
    for hi in (False, True):
        for n in (1, 17, 209, 379, 457, 1151, 1226, 2058, 4090):
            want, got = F.conv_geometry(n, hi), F.built_conv_geometry(n, hi)
            if any(got[k] != v for k, v in want.items()):
                raise RuntimeError(f"geometry mirror differs at n={n} highest={hi}: "
                                   f"{want} vs {got}")
    return cs.ptxas_report(lib.with_suffix(".log"), ("fir_conv_kernel", "fir_ps_kernel"))


def measure(torch, dev) -> dict:
    """Errors and times of the package beside this script on the C5/C8
    shapes (the data comes from fixed seeds, so every copy sees the same)."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import fir_td as F

    out = {}
    g = torch.Generator(device=dev).manual_seed(3)
    for name, B, T, n, prec in (("B3 n1151", 4, 1024, 1151, "B3"),
                                ("B3 n2058", 4, 512, 2058, "B3"),
                                ("HIGHEST n379", 6, 640, 379, "HIGHEST"),
                                ("HIGHEST n457", 8, 640, 457, "HIGHEST"),
                                ("HIGHEST n1226", 4, 512, 1226, "HIGHEST")):
        x = torch.randn(B, n - 1 + T, generator=g, device=dev) * 0.3
        h = torch.randn(n, generator=g, device=dev) * 0.3
        out[f"db {name}"] = cs.err_db(F.fir_td_mxu(x, h, precision=prec).cpu(),
                                      F.fir_td_mxu_plain(x, h, precision=prec).cpu())
    x = torch.randn(7, 299 + 256, generator=g, device=dev) * 0.3
    k = torch.randn(1, 300, generator=g, device=dev) * 0.3
    gk = torch.ones(7, 1, device=dev)
    out["db K11 HIGHEST n300"] = cs.err_db(
        F.fir_td_mxu_per_stream(x, k, gk, precision="HIGHEST").cpu(),
        F.fir_td_mxu_per_stream_plain(x, k, gk, precision="HIGHEST").cpu())

    sz = cs.Sizes()
    g = torch.Generator(device=dev).manual_seed(0)
    p5 = Pipeline(cs.c5_config(sz), dev)
    h5 = p5.device_params(PipelineParams.design(p5.cfg)).casc_main
    n5 = p5.n_casc
    x5 = torch.randn(sz.batch, n5 - 1 + sz.block, generator=g, device=dev) * 0.3
    p8 = Pipeline(cs.c8_config(sz), dev)
    prm8 = p8.device_params(PipelineParams.design(p8.cfg))
    h8, n8, B8, T8 = prm8.combined_cascade(True), p8.n_casc, sz.c8_batch, sz.c8_block
    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16)
    for prec in ("B3", "HIGHEST"):
        y = F.fir_td_mxu(x5, h5, precision=prec)
        out[f"db C5 {prec}"] = cs.err_db(y.cpu(), F.fir_td_mxu_plain(
            x5, h5, precision=prec).cpu())
        out[f"ms K1 {prec}"] = cs.time_ms(
            torch, lambda: F.fir_td_mxu(x5, h5, precision=prec, **dkw), 10)
    # one tap: one k-step, so the staging, tiles and store of the same block
    x1, h1 = x5[:, n5 - 1:].contiguous(), h5[:1].contiguous()
    out["ms copy of the 1-tap block"] = cs.time_ms(torch, lambda: x1.clone(), 10)
    out["ms K1 B3 1 tap"] = cs.time_ms(torch, lambda: F.fir_td_mxu(x1, h1, **dkw), 10)
    out["ms K1 B3 1 tap no dither"] = cs.time_ms(torch, lambda: F.fir_td_mxu(x1, h1), 10)
    ring = torch.randn(4, sz.batch, sz.block, generator=g, device=dev) * 0.3
    tail = torch.randn(sz.batch, p5._k_pad, generator=g, device=dev) * 0.3
    out_r = torch.zeros_like(ring)
    out["ms K3"] = cs.time_ms(torch, lambda: F.fir_td_mxu_ring_f32(
        ring, 1, tail, h5, out_r, **dkw), 10)
    del ring, tail, out_r
    xh, xl = F.split_bf16(torch.randn(B8, T8, generator=g, device=dev) * 0.1)
    th, tl = F.split_bf16(torch.randn(B8, F.ring_k_pad(n8), generator=g, device=dev) * 0.1)
    out["ms K8"] = cs.time_ms(torch, lambda: F.fir_td_mxu_pair(
        xh, xl, th, tl, h8, **dkw), 10)
    x8 = torch.randn(B8, n8 - 1 + T8, generator=g, device=dev) * 0.1
    bands, gains = prm8.casc_bands, torch.as_tensor(cs.psg_gains(B8), device=dev)
    for prec in ("B3", "HIGHEST"):
        out[f"ms K11 {prec}"] = cs.time_ms(torch, lambda: F.fir_td_mxu_per_stream(
            x8, bands, gains, precision=prec, **dkw), 10)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_conv_sweep: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--build"]:
        print(json.dumps(build_and_check()))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--measure"]:
        print(json.dumps(measure(torch, dev)))
        return 0
    smi = cs.gpu_line()
    cs.say(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    dirs = [cv.make_copy(SWEEP_DIR / str(i), ROOT, SCRIPT,
                         None if geo is None else lambda d, g=geo: set_geometry(d, g))
            for i, (_, geo) in enumerate(VARIANTS)]
    regs = cv.build_all(dirs, SCRIPT)
    cs.say(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s; each "
           f"library's geometry == its Python mirror")
    results = {}
    for (name, geo), d, reg in zip(VARIANTS, dirs, regs):
        res = cv.child(d, SCRIPT, "--measure")
        results[name] = dict(geometry=geo, ptxas=reg, **res)
        cs.say(f"variant {name}: " + ", ".join(
            f"{k} {v:.3f}" if k.startswith("ms") else f"{k} {v:.1f}"
            for k, v in res.items()))
        for kern, r in reg.items():
            cs.say(f"  ptxas {kern}: {r}")
    (SWEEP_DIR / "conv_sweep.json").write_text(json.dumps(
        dict(device=smi, variants=results), indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
