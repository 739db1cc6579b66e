#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`afp_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each; any failure raises (exit code != 0):

1. the card's name and power limit (nvidia-smi); no CUDA device → exit 1;
2. build the CUDA kernels from `afp_tpu_torch/csrc` with nvcc;
3. each kernel against its plain PyTorch version at the headline shapes:
   conv ≤ −110 dB max-abs relative error, clip and noise bit-exact, both
   times with CUDA events;
4. `Pipeline.run` at the C5 headline (batch 4096, 8 blocks), and the
   single-stream chain against the float64 oracle of `bench.py:394-418`
   (< −90 dB);
5. `RingServer` at the headline (16 slots, chunk 4, 16 blocks), megakernel
   and per-step forms: bit-identical with dither on, ≤ −110 dB against
   staged steps with dither off;
6. `StreamEngine` with the README quick-start configuration ('fft', EQ on,
   batch 512): process_block ×4, set_eq_gains, ×2, process_signal, with no
   degradation-ladder fallback;
7. every kernel launched during phases 4-6.

Then, as its last three lines: the nvidia-smi line, one JSON object with
each kernel's launches, error and times, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, replace

import numpy as np

#: the C5 headline (`bench.py:312-334`): upsample 4× vhq → 1001-tap hamming
#: lowpass at 11 kHz → decimate → TPDF dither, 'td_mxu', no EQ, no clip
HEADLINE = dict(samplerate=44100, blocksize=4096, upsample_factor=4,
                numtaps=1001, batch=4096, filter_type="lowpass",
                cutoff=11000.0, window_type="hamming", eq_enabled=False,
                agc_enabled=False, downsample_mode="decimate",
                dither_kind="tpdf", output_clip=None, conv_strategy="td_mxu",
                resample_quality="vhq")
#: the README quick start (`README.md:137-146`): config defaults otherwise
#: ('fft', clip 0.99, 'hq', resample down)
QUICKSTART = dict(samplerate=44100, blocksize=4096, upsample_factor=4,
                  numtaps=1001, cutoff=11000.0, window_type="hamming",
                  batch=512, eq_enabled=True, agc_enabled=False,
                  dither_kind="tpdf")

CONV_DB = -110.0  # kernel vs plain, and ring vs staged: bf16×3 order class
ORACLE_DB = -90.0  # the reference's contract vs the float64 oracle


@dataclass
class Sizes:
    """Shapes of the run (the headline's; smaller ones rehearse on a CPU)."""

    batch: int = 4096
    block: int = 4096
    slots: int = 16
    chunk: int = 4
    serve_blocks: int = 16
    run_blocks: int = 8
    quick_batch: int = 512


def err_db(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(20 * np.log10(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)
                               + 1e-300))


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(torch, fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call of `fn` on the device (CUDA events)."""
    for _ in range(warm):
        fn()
    if not torch.cuda.is_available():
        return float("nan")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 3


def phase_kernels(torch, dev, sz: Sizes) -> dict:
    """Each kernel against its plain version on the same device tensors."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.ops.cuda import dither_cuda
    from afp_tpu_torch.ops.cuda import fir_td as F
    from afp_tpu_torch.ops.dither import dither_plain

    cfg = StreamConfig(**{**HEADLINE, "batch": sz.batch, "blocksize": sz.block})
    pipe = Pipeline(cfg, dev)
    h = pipe.device_params(PipelineParams.design(pipe.cfg)).casc_main
    n, kp, B, T, S = pipe.n_casc, pipe._k_pad, sz.batch, sz.block, sz.slots
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev) * 0.3

    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    res = {}

    # K1: staged conv
    x_ext = randn(B, n - 1 + T)
    yk = F.fir_td_mxu(x_ext, h)
    yp = F.fir_td_mxu_plain(x_ext, h)
    e_conv = err_db(yk.cpu(), yp.cpu())
    ye = F.fir_td_mxu(x_ext, h, **dkw)
    epi_ok = torch.equal(ye, F._finish(yk, 0.2, (5, 7), 16, True))
    e_full = err_db(ye.cpu(), F.fir_td_mxu_plain(x_ext, h, **dkw).cpu())
    check(e_conv <= CONV_DB and e_full <= CONV_DB and epi_ok,
          f"K1: conv {e_conv:.1f} dB, dithered {e_full:.1f} dB, epilogue "
          f"bit-exact {epi_ok}")
    res["fir_td_mxu"] = dict(
        max_abs_err=float((yk - yp).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu(x_ext, h, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_plain(x_ext, h, **dkw), 3))
    say(f"phase 3 K1 fir_td_mxu [{B}, {n - 1}+{T}] x {n} taps: conv "
        f"{e_conv:.1f} dB, with clip+dither {e_full:.1f} dB vs plain, epilogue "
        f"bit-exact; {res['fir_td_mxu']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu']['plain_ms']:.3f} ms")
    del x_ext, yk, yp, ye

    # K3: one ring step (slot 5 of S)
    ring, tail = randn(S, B, T), randn(B, kp)
    idx = 5 % S
    ok_, tk = F.fir_td_mxu_ring_f32(ring, idx, tail, h, torch.zeros_like(ring))
    op_, tp = F.fir_td_mxu_ring_f32_plain(ring, idx, tail, h, torch.zeros_like(ring))
    e_conv = err_db(ok_[idx].cpu(), op_[idx].cpu())
    oe, _ = F.fir_td_mxu_ring_f32(ring, idx, tail, h, torch.zeros_like(ring), **dkw)
    epi_ok = torch.equal(oe[idx], F._finish(ok_[idx], 0.2, (5, 7), 16, True))
    untouched = bool((oe[(idx + 1) % S] == 0).all())
    check(e_conv <= CONV_DB and epi_ok and torch.equal(tk, tp) and untouched,
          f"K3: conv {e_conv:.1f} dB, epilogue {epi_ok}, tail "
          f"{torch.equal(tk, tp)}, other slots untouched {untouched}")
    out_r = torch.zeros_like(ring)
    res["fir_td_mxu_ring_f32"] = dict(
        max_abs_err=float((ok_[idx] - op_[idx]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_f32(ring, idx, tail, h, out_r, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_f32_plain(
            ring, idx, tail, h, out_r, **dkw), 3))
    say(f"phase 3 K3 fir_td_mxu_ring_f32 ring [{S}, {B}, {T}] tail {kp}: conv "
        f"{e_conv:.1f} dB vs plain, tail and epilogue bit-exact; "
        f"{res['fir_td_mxu_ring_f32']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_f32']['plain_ms']:.3f} ms")
    del ok_, op_, oe

    # K4: a chunk of steps in one launch, wrapping the slot index
    start, steps = S - 2, sz.chunk
    slots = [(start + i) % S for i in range(steps)]
    mk, mtk = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, torch.zeros_like(ring), steps)
    mp, mtp = F.fir_td_mxu_ring_mega_f32_plain(ring, start, tail, h,
                                               torch.zeros_like(ring), steps)
    e_conv = max(err_db(mk[s].cpu(), mp[s].cpu()) for s in slots)
    me, _ = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, torch.zeros_like(ring),
                                       steps, **dkw)
    epi_ok = all(torch.equal(me[s], F._finish(mk[s], 0.2, (5, 7 + i), 16, True))
                 for i, s in enumerate(slots))
    ck, ct = torch.zeros_like(ring), tail
    for i, s in enumerate(slots):
        ck, ct = F.fir_td_mxu_ring_f32(ring, s, ct, h, ck,
                                       **{**dkw, "dither_key": (5, 7 + i)})
    chained = torch.equal(ck, me)
    check(e_conv <= CONV_DB and epi_ok and torch.equal(mtk, mtp) and chained,
          f"K4: conv {e_conv:.1f} dB, epilogue {epi_ok}, tail "
          f"{torch.equal(mtk, mtp)}, equals chained K3 {chained}")
    res["fir_td_mxu_ring_mega_f32"] = dict(
        max_abs_err=max(float((mk[s] - mp[s]).abs().max()) for s in slots),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_f32(
            ring, start, tail, h, out_r, steps, **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_f32_plain(
            ring, start, tail, h, out_r, steps, **dkw), 2))
    say(f"phase 3 K4 fir_td_mxu_ring_mega_f32 {steps} steps from slot {start}: "
        f"conv {e_conv:.1f} dB vs plain, tail and epilogue bit-exact, equals "
        f"{steps} chained K3 steps bit for bit; "
        f"{res['fir_td_mxu_ring_mega_f32']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_mega_f32']['plain_ms']:.3f} ms per dispatch")
    del ring, out_r, mk, mp, me, ck

    # K2: standalone dither at the quick-start block [512, 4096]
    x = randn(sz.quick_batch, T)
    same = all(torch.equal(dither_cuda(x, (3, 9), 24, k), dither_plain(x, (3, 9), 24, k))
               for k in ("tpdf", "rpdf"))
    check(same, "K2: kernel noise differs from the plain version")
    res["dither_cuda"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: dither_cuda(x, (3, 9), 24, "tpdf"), 20),
        plain_ms=time_ms(torch, lambda: dither_plain(x, (3, 9), 24, "tpdf"), 5))
    say(f"phase 3 K2 dither_cuda [{sz.quick_batch}, {T}]: TPDF and RPDF "
        f"bit-exact vs plain; {res['dither_cuda']['ms']:.3f} ms vs plain "
        f"{res['dither_cuda']['plain_ms']:.3f} ms")
    return res


# ---------------------------------------------------------------- phase 4


def phase_pipeline(torch, dev, sz: Sizes) -> None:
    import scipy.signal as sps

    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.ops.resample import streaming_kernel

    cfg = StreamConfig(**{**HEADLINE, "batch": sz.batch, "blocksize": sz.block})
    pipe = Pipeline(cfg, dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    g = torch.Generator(device=dev).manual_seed(1)
    blocks = torch.randn(sz.run_blocks, sz.batch, sz.block, generator=g,
                         device=dev) * 0.3
    state, y0 = pipe.step(params, pipe.init_state(seed=0), blocks[0])  # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, outs = pipe.run(params, pipe.init_state(seed=0), blocks)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all())
          and torch.equal(outs[0], y0), "Pipeline.run: shape, finiteness or "
          "first block differs from step")
    audio_s = sz.run_blocks * sz.batch * sz.block / cfg.samplerate
    say(f"phase 4 Pipeline.run headline batch {sz.batch} x {sz.run_blocks} "
        f"blocks: {wall * 1e3:.1f} ms wall ({wall * 1e3 / sz.run_blocks:.2f} "
        f"ms/block, {audio_s / wall:.0f}x realtime, host clock)")
    del blocks, outs

    # the bench's accuracy gate: one stream, dither off, vs float64 oracle
    ccfg = replace(pipe.cfg, batch=1, dither_kind="off")
    cpipe = Pipeline(ccfg, dev)
    cparams = cpipe.device_params(PipelineParams.design(cpipe.cfg))
    sig = (np.random.default_rng(0).standard_normal((1, sz.block * 4)) * 0.3
           ).astype(np.float32)
    _, out = cpipe.process_signal(cparams, cpipe.init_state(), sig, fold=False)
    out = out.cpu().numpy()[0]
    upf = ccfg.upsample_factor
    y = sps.upfirdn(streaming_kernel(upf, 1, quality=ccfg.resample_quality),
                    sig[0].astype(np.float64), upf, 1)[: sig.shape[1] * upf]
    main = PipelineParams.design(cpipe.cfg).main_taps.astype(np.float64)
    gold = np.convolve(y, main)[: len(y)][::upf]
    e = err_db(out, gold)
    check(e < ORACLE_DB, f"oracle: {e:.1f} dB breaks the {ORACLE_DB} dB contract")
    say(f"phase 4 oracle: one stream, 4 blocks, dither off: {e:.1f} dB vs the "
        f"float64 oracle (< {ORACLE_DB})")


# ---------------------------------------------------------------- phase 5


def phase_serving(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
    from afp_tpu_torch.runtime import RingServer

    g = torch.Generator(device=dev).manual_seed(2)
    src = (torch.randn(sz.serve_blocks, sz.batch, sz.block, generator=g,
                       device=dev) * 0.3).cpu().numpy()
    outs = {}
    for dither in ("tpdf", "off"):
        cfg = StreamConfig(**{**HEADLINE, "batch": sz.batch,
                              "blocksize": sz.block, "dither_kind": dither})
        for mega in (True, False):
            pipe = Pipeline(cfg, dev)
            srv = RingServer(pipe, slots=sz.slots, chunk=sz.chunk,
                             max_inflight=2, seed=0, mega=mega)
            got = []
            stats = srv.serve(iter(src), got.append)
            outs[dither, mega] = np.stack(got)
            check(stats["blocks"] == sz.serve_blocks, "RingServer lost blocks")
            lat = stats["latency"]
            say(f"phase 5 RingServer mega={mega} dither={dither}: "
                f"{stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms "
                f"({stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, "
                f"p95 {lat['p95_ms']:.1f} ms land-to-drain, host clock)")
    check(np.array_equal(outs["tpdf", True], outs["tpdf", False]),
          "RingServer mega and per-step outputs differ with dither on")
    pipe = Pipeline(StreamConfig(**{**HEADLINE, "batch": sz.batch,
                                    "blocksize": sz.block, "dither_kind": "off"}), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    st = pipe.init_state(seed=0)
    staged = []
    for blk in src:
        st, y = pipe.step(params, st, blk)
        staged.append(y.cpu().numpy())
    staged = np.stack(staged)
    e = {m: err_db(outs["off", m], staged) for m in (True, False)}
    check(all(v <= CONV_DB for v in e.values()),
          f"RingServer vs staged steps: {e}")
    check(all(np.isfinite(v).all() for v in outs.values()), "non-finite output")
    say(f"phase 5 RingServer: mega == per-step bit for bit (dither on); vs "
        f"staged steps (dither off) mega {e[True]:.1f} dB, per-step "
        f"{e[False]:.1f} dB (<= {CONV_DB})")


# ---------------------------------------------------------------- phase 6


def phase_engine(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import StreamConfig, StreamEngine

    cfg = StreamConfig(**{**QUICKSTART, "batch": sz.quick_batch,
                          "blocksize": sz.block})
    eng = StreamEngine(cfg, device=dev)
    rng = np.random.default_rng(3)
    outs = []
    for i in range(6):
        if i == 4:
            eng.set_eq_gains([1.0] * 6 + [2.0] * 3)
        blk = (rng.standard_normal((sz.quick_batch, sz.block)) * 0.1).astype(np.float32)
        outs.append(eng.process_block(blk))
    audio = (rng.standard_normal((sz.quick_batch, 44100)) * 0.1).astype(np.float32)
    sig_out = eng.process_signal(audio)
    m = eng.metrics
    check(m.underruns == m.fallback_replays == m.fallback_silence == 0,
          f"StreamEngine ladder fired: {m.snapshot()}")
    check(all(o.shape == (sz.quick_batch, sz.block) and np.isfinite(o).all()
              and np.abs(o).max() <= 0.99 + 2.0 ** -22 for o in outs)
          and sig_out.shape == (sz.quick_batch, 44100 // sz.block * sz.block),
          "StreamEngine outputs: shape, finiteness or clip")
    say(f"phase 6 StreamEngine quick start (fft, EQ, batch {sz.quick_batch}): "
        f"6 blocks + set_eq_gains + process_signal, metrics {m.snapshot()}")


# ---------------------------------------------------------------- main


REPLACES = {
    "fir_td_mxu": ("afp_tpu_torch/csrc/fir_td.cu", "afp_tpu/ops/pallas/fir_td.py:1665"),
    "fir_td_mxu_ring_f32": ("afp_tpu_torch/csrc/fir_td.cu",
                            "afp_tpu/ops/pallas/fir_td.py:1173"),
    "fir_td_mxu_ring_mega_f32": ("afp_tpu_torch/csrc/fir_td.cu",
                                 "afp_tpu/ops/pallas/fir_td.py:1612"),
    "dither_cuda": ("afp_tpu_torch/csrc/dither.cu",
                    "afp_tpu/ops/pallas/dither_pl.py:69"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the plain references must run in full fp32, never TF32 (−60 dB class)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = gpu_line()
    say(f"phase 1 device: {smi} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda})")

    from afp_tpu_torch.ops.cuda import KERNELS, _build

    t0 = time.perf_counter()
    _build.load()
    say(f"phase 2 build: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    sz = Sizes()
    res = phase_kernels(torch, dev, sz)

    for k in KERNELS:  # count only the main path's launches from here on
        k.launches = 0
    phase_pipeline(torch, dev, sz)
    phase_serving(torch, dev, sz)
    phase_engine(torch, dev, sz)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in KERNELS}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path never launched: {launches}")
    reference = sorted(m for m in sys.modules
                       if m.split(".")[0] in ("jax", "jaxlib", "afp_tpu"))
    check(not reference, f"jax or the JAX package was imported: {reference[:5]}")
    say(f"phase 7 launches on the main path: {launches}")

    kernels = [dict(name=name, route="cuda", source=REPLACES[name][0],
                    replaces=REPLACES[name][1], launches=launches[name],
                    **res[name]) for name in launches]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
