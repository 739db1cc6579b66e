#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (`afp_tpu_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each; any failure raises (exit code != 0):

1. the card's name and power limit (nvidia-smi); no CUDA device → exit 1;
2. build the CUDA kernels from `afp_tpu_torch/csrc` with nvcc (one nvcc per
   source, in parallel);
3. each kernel against its plain PyTorch version on the same device tensors,
   both timed with CUDA events: the C5 kernels K1-K4 and K2 at the C5
   headline (conv ≤ −110 dB, clip and noise bit-exact), and the C8 AGC
   kernels at the C8 point (batch 4096, block 2048, W = 512): K5 ≤ −110 dB,
   K6 bit-exact, K8/K7 ≤ −110 dB with tails bit-exact and K7 ≡ K8; then the
   transport forms: K12 and K12-mega (int16 PCM rings reaching −32768 and
   32767) ≡ K3/K4 fed n/32768, K13 and K13-mega ≡ K3/K4 fed the split, each
   ≤ −110 dB against its plain version; the int16 store of K1, K3, K4, K7,
   K8, K12, K13 ≡ quantize_pcm16 of its own f32 output; K5/K6 on int16 x ≡
   f32 x of n/32768;
4. `Pipeline.run` at the C5 headline (batch 4096, 8 blocks), and the
   single-stream chain against the float64 oracle of `bench.py:394-418`
   (< −90 dB); then the C8 chain (`bench.py:827-843`): 'exact' and 'fast'
   AGC, 8 blocks each at batch 4096, a batch-8 run against the port's CPU
   run (≤ −100 dB), and 4 streams × 4 blocks against a float64 oracle of
   AGC + chain (< −90 dB); then the transport forms: C5-i16io (int16 in
   and out, 8 blocks) and C8-i16io 'exact' and 'fast' (8 blocks each), each
   ≡ quantize_pcm16 of the f32 chain fed n/32768, and the C5-pcm16 (one
   stream × 4 blocks) and C8-pcm16 (4 streams × 4 blocks) oracles (< −90 dB;
   with int16 out, ≤ 1 LSB from the quantized oracle);
5. `RingServer` at the C5 headline (16 slots, chunk 4, 16 blocks),
   megakernel and per-step forms: bit-identical with dither on, ≤ −110 dB
   against staged steps with dither off; then the C8 chain's per-step ring
   (16 slots, chunk 4, 16 blocks) ≡ its staged steps, dither on; then
   C5-i16io and C5-pair, mega and per-step ≡ each other and ≡ the staged
   steps with dither on, and C8-i16io's per-step ring ≡ its staged steps;
6. `StreamEngine` with the README quick-start configuration ('fft', EQ on,
   batch 512): process_block ×4, set_eq_gains, ×2, process_signal; and with
   the C8 configuration: process_block ×4, apply_config with a new AGC
   target, ×2; then at C8-i16io the same with int16 blocks in and out and a
   float block refused; no degradation-ladder fallback;
7. every kernel (K1-K8, K12, K13) launched during phases 4-6, and each
   transport phase launched its kernels (K12, K13, the int16 store, the
   int16 loads of K5/K6).

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

#: the C8 AGC chain (`bench.py:827-843`): 2× upsample → 129-tap lowpass at
#: 14 kHz with the 9-band EQ → decimate, AGC window 512 before it, clip
#: 0.99, TPDF dither, 'td_mxu', at the bench's batch (`bench.py:1382`)
C8 = dict(samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=129,
          batch=4096, cutoff=14000.0, eq_enabled=True, agc_enabled=True,
          agc_mode="exact", agc_window_size=512, agc_carry=True,
          downsample_mode="decimate", dither_kind="tpdf", output_clip=0.99,
          conv_strategy="td_mxu")

CONV_DB = -110.0  # kernel vs plain, and ring vs staged: bf16×3 order class
ORACLE_DB = -90.0  # the reference's contract vs the float64 oracle
CHAIN_DB = -100.0  # the C8 chain on the card vs the port's CPU run


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
    c8_batch: int = 4096
    c8_block: int = 2048
    c8_window: int = 512


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


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def c8_config(sz: Sizes, **over):
    from afp_tpu_torch.engine import StreamConfig

    return StreamConfig(**{**C8, "batch": sz.c8_batch, "blocksize": sz.c8_block,
                           "agc_window_size": sz.c8_window, **over})


def c5_config(sz: Sizes, **over):
    from afp_tpu_torch.engine import StreamConfig

    return StreamConfig(**{**HEADLINE, "batch": sz.batch, "blocksize": sz.block,
                           **over})


def pcm16(torch, dev, shape, seed: int, scale: float = 0.3):
    """int16 PCM noise on `dev` (``scale`` of full scale) that reaches both
    ends of the range, −32768 and 32767."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, generator=g, device=dev) * (scale * 32768.0)
    x = torch.clamp(torch.round(x), -32768.0, 32767.0).to(torch.int16)
    x.view(-1)[:2] = torch.tensor([-32768, 32767], dtype=torch.int16, device=dev)
    return x


def lsb_diff(a, b) -> tuple[int, int]:
    """(max |a − b|, count of samples that differ) of two int16 arrays."""
    d = np.abs(np.asarray(a, dtype=np.int32) - np.asarray(b, dtype=np.int32))
    return int(d.max()), int((d > 0).sum())


def quantized(y: np.ndarray) -> np.ndarray:
    """`quantize_pcm16` in numpy (round half to even, then clamp)."""
    return np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)


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


def phase_kernels_agc(torch, dev, sz: Sizes) -> dict:
    """K5-K8 against their plain versions at the C8 point."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import agc_rms as R
    from afp_tpu_torch.ops.cuda import agc_scan as S
    from afp_tpu_torch.ops.cuda import fir_td as F

    pipe = Pipeline(c8_config(sz), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    h = params.combined_cascade(pipe.has_eq)
    B, T, W, kp, n = sz.c8_batch, sz.c8_block, sz.c8_window, pipe._k_pad, pipe.n_casc
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(B, T, generator=g, device=dev) * 0.1
    x[: B // 8] *= 8.0  # loud streams: the gain releases and clips
    a_att, a_rel = pipe.agc.a_att, pipe.agc.a_rel
    res = {}

    # K5: the two-level window (W = 512), a direct one, the chunk means
    lp, rp = pipe._rms_pad
    band = pipe._rms_band
    dk = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True)
    e5 = err_db(dk.cpu(), R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, True,
                                              transposed=True).cpu())
    wd = 300
    band_d = F.band_matrix(np.full(wd, 1.0 / wd, np.float32)).to(dev)
    ex_d = R.band_is_exact_bf16(band_d.cpu())
    pd = (wd // 2, wd - 1 - wd // 2)
    e5d = err_db(R.rms_desired(x, band_d, *pd, 0.1, 10.0, ex_d, transposed=True).cpu(),
                 R.rms_desired_plain(x, band_d, *pd, 0.1, 10.0, ex_d,
                                     transposed=True).cpu())
    mk = R.rms_desired(x, band, lp, rp, 0.1, 10.0, True, transposed=True, mean_chunk=32)
    e5m = err_db(mk.cpu(), R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, True,
                                               transposed=True, mean_chunk=32).cpu())
    check(max(e5, e5d, e5m) <= CONV_DB and not ex_d,
          f"K5: W={W} {e5:.1f} dB, W={wd} {e5d:.1f} dB, means {e5m:.1f} dB")
    dp = R.rms_desired_plain(x, band, lp, rp, 0.1, 10.0, True, transposed=True)
    res["rms_desired"] = dict(
        max_abs_err=float((dk - dp).abs().max()),
        ms=time_ms(torch, lambda: R.rms_desired(x, band, lp, rp, 0.1, 10.0, True,
                                                transposed=True), 10),
        plain_ms=time_ms(torch, lambda: R.rms_desired_plain(
            x, band, lp, rp, 0.1, 10.0, True, transposed=True), 3))
    say(f"phase 3 K5 rms_desired [{B}, {T}] -> [T, B]: W={W} two-level "
        f"{e5:.1f} dB, W={wd} direct {e5d:.1f} dB, chunk means {e5m:.1f} dB vs "
        f"plain; {res['rms_desired']['ms']:.3f} ms vs plain "
        f"{res['rms_desired']['plain_ms']:.3f} ms")
    del dp

    # K6: exact and blockwise, f32 and pair, a ring slot; bit-exact
    init = torch.rand(B, generator=g, device=dev) * 4.0 + 0.2
    ring = torch.randn(3, B, T, generator=g, device=dev) * 0.1
    ring[1] = x
    cases = [
        ("exact f32 + init", dk, dict(init=init)),
        ("exact pair, ring slot", dk, dict(emit_split=True, ring_idx=1)),
        ("blockwise means f32", mk, dict(init=init, blockwise=32, d_is_means=True)),
        ("blockwise pair", dk, dict(emit_split=True, blockwise=32)),
    ]
    for name, d, kw in cases:
        src = ring if "ring_idx" in kw else x
        (yk, ck) = S.smooth_gain_apply(d, src, a_att, a_rel, 10.0, **kw)
        (yp, cp) = S.smooth_gain_apply_plain(d, src, a_att, a_rel, 10.0, **kw)
        same = torch.equal(ck, cp) and (
            all(torch.equal(a, b) for a, b in zip(yk, yp))
            if isinstance(yk, tuple) else torch.equal(yk, yp))
        check(same, f"K6 {name}: kernel differs from its plain version")
    res["smooth_gain_apply"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: S.smooth_gain_apply(
            dk, x, a_att, a_rel, 10.0, init=init, emit_split=True), 10),
        plain_ms=time_ms(torch, lambda: S.smooth_gain_apply_plain(
            dk, x, a_att, a_rel, 10.0, init=init, emit_split=True), 1))
    say(f"phase 3 K6 smooth_gain_apply [{T}, {B}]: {', '.join(c[0] for c in cases)} "
        f"bit-exact vs plain (y, pair, carry); "
        f"{res['smooth_gain_apply']['ms']:.3f} ms vs plain "
        f"{res['smooth_gain_apply']['plain_ms']:.3f} ms (exact, pair)")
    (xh, xl), _ = S.smooth_gain_apply(dk, x, a_att, a_rel, 10.0, init=init,
                                      emit_split=True)
    del ring, mk

    # K8: the pair conv, clip + dither fused; K7: the same into a ring slot
    th, tl = F.split_bf16(torch.randn(B, kp, generator=g, device=dev) * 0.1)
    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    y8, t8h, t8l = F.fir_td_mxu_pair(xh, xl, th, tl, h)
    yp8, p8h, p8l = F.fir_td_mxu_pair_plain(xh, xl, th, tl, h)
    e8 = err_db(y8.cpu(), yp8.cpu())
    y8e, _, _ = F.fir_td_mxu_pair(xh, xl, th, tl, h, **dkw)
    e8e = err_db(y8e.cpu(), F.fir_td_mxu_pair_plain(xh, xl, th, tl, h, **dkw)[0].cpu())
    epi_ok = torch.equal(y8e, F._finish(y8, 0.2, (5, 7), 16, True))
    tails = torch.equal(t8h, p8h) and torch.equal(t8l, p8l)
    check(e8 <= CONV_DB and e8e <= CONV_DB and epi_ok and tails,
          f"K8: conv {e8:.1f} dB, dithered {e8e:.1f} dB, epilogue {epi_ok}, "
          f"tail {tails}")
    res["fir_td_mxu_pair"] = dict(
        max_abs_err=float((y8 - yp8).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_pair(xh, xl, th, tl, h, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_pair_plain(
            xh, xl, th, tl, h, **dkw), 3))
    say(f"phase 3 K8 fir_td_mxu_pair [{B}, {T}] pair + tail {kp} x {n} taps: "
        f"conv {e8:.1f} dB, with clip+dither {e8e:.1f} dB vs plain, epilogue "
        f"and tail bit-exact; {res['fir_td_mxu_pair']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_pair']['plain_ms']:.3f} ms")
    Sl, idx = sz.slots, 5 % sz.slots
    out0 = torch.full((Sl, B, T), 7.0, device=dev)
    o7, t7h, t7l = F.fir_td_mxu_pair_to_ring(xh, xl, th, tl, h, idx, out0.clone(), **dkw)
    untouched = all(bool((o7[s] == 7.0).all()) for s in (0, (idx + 1) % Sl))
    same = torch.equal(o7[idx], y8e) and torch.equal(t7h, p8h) and torch.equal(t7l, p8l)
    check(same and untouched, f"K7: slot equals K8 and tails {same}, other "
          f"slots untouched {untouched}")
    res["fir_td_mxu_pair_to_ring"] = dict(
        max_abs_err=float((o7[idx] - F.fir_td_mxu_pair_plain(
            xh, xl, th, tl, h, **dkw)[0]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_pair_to_ring(
            xh, xl, th, tl, h, idx, out0, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_pair_to_ring_plain(
            xh, xl, th, tl, h, idx, out0, **dkw), 3))
    say(f"phase 3 K7 fir_td_mxu_pair_to_ring slot {idx} of [{Sl}, {B}, {T}]: "
        f"equals K8 bit for bit, tail bit-exact, other slots untouched; "
        f"{res['fir_td_mxu_pair_to_ring']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_pair_to_ring']['plain_ms']:.3f} ms")

    # the int16 store of K8 and K7 ≡ quantize_pcm16 of their f32 output
    q8 = F.fir_td_mxu_pair(xh, xl, th, tl, h, emit_i16=True, **dkw)[0]
    out16 = torch.zeros((Sl, B, T), dtype=torch.int16, device=dev)
    q7 = F.fir_td_mxu_pair_to_ring(xh, xl, th, tl, h, idx, out16, **dkw)[0]
    check(torch.equal(q8, F.quantize_pcm16(y8e)) and torch.equal(q7[idx], q8),
          "K8/K7 int16 store differs from quantize_pcm16 of the f32 output")
    t8 = time_ms(torch, lambda: F.fir_td_mxu_pair(xh, xl, th, tl, h,
                                                  emit_i16=True, **dkw), 10)
    t7 = time_ms(torch, lambda: F.fir_td_mxu_pair_to_ring(
        xh, xl, th, tl, h, idx, out16, **dkw), 10)
    say(f"phase 3 int16 store: K8 and K7 == quantize_pcm16 of their f32 "
        f"output bit for bit; K8 {t8:.3f} ms, K7 {t7:.3f} ms")
    del out16, q7

    # K5 and K6 on int16 x ≡ f32 x of n/32768 (exact, chunk means, pair)
    x16 = pcm16(torch, dev, (B, T), 14, scale=0.1)
    x16f = F.pcm16_to_f32(x16)
    kw5 = dict(transposed=True)
    same = True
    for mc in (0, 32):
        same = same and torch.equal(
            R.rms_desired(x16, band, lp, rp, 0.1, 10.0, True, mean_chunk=mc, **kw5),
            R.rms_desired(x16f, band, lp, rp, 0.1, 10.0, True, mean_chunk=mc, **kw5))
    d16 = R.rms_desired(x16, band, lp, rp, 0.1, 10.0, True, **kw5)
    for kw6 in (dict(init=init, emit_split=True), dict(emit_split=True, blockwise=32)):
        (ah, al), ac = S.smooth_gain_apply(d16, x16, a_att, a_rel, 10.0, **kw6)
        (bh, bl), bc = S.smooth_gain_apply(d16, x16f, a_att, a_rel, 10.0, **kw6)
        same = same and torch.equal(ah, bh) and torch.equal(al, bl) and torch.equal(ac, bc)
    check(same, "K5/K6 on int16 x differ from f32 x of n/32768")
    t5 = time_ms(torch, lambda: R.rms_desired(x16, band, lp, rp, 0.1, 10.0, True,
                                              **kw5), 10)
    t6 = time_ms(torch, lambda: S.smooth_gain_apply(
        d16, x16, a_att, a_rel, 10.0, init=init, emit_split=True), 10)
    say(f"phase 3 int16 x: K5 (exact, chunk means) and K6 (exact, blockwise, "
        f"pair) on int16 [{B}, {T}] == f32 x of n/32768 bit for bit; K5 "
        f"{t5:.3f} ms, K6 {t6:.3f} ms")
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


# ---------------------------------------------------------------- C8 chain


def c8_oracle(x: np.ndarray, cfg, design) -> np.ndarray:
    """The C8 chain in float64 over [B, N·L] input: per block, the AGC of
    the reference (boxcar RMS with 'same' zero padding, desired gain, the
    attack/release recurrence carried across blocks from unity as
    `tests/test_agc_fused.py:37-53` writes it, the 0.1..max_gain clip, the
    ±0.99 clip); then the linear chain on the whole gained stream:
    upsample, main ⊛ Σ gᵢ·bandᵢ, decimate, clip."""
    import scipy.signal as sps

    from afp_tpu_torch.ops.agc import agc_alphas
    from afp_tpu_torch.ops.resample import streaming_kernel

    B, N = x.shape
    L, w = cfg.blocksize, cfg.agc_window_size
    a_att, a_rel = agc_alphas(w, cfg.agc_attack, cfg.agc_release)
    t, mg = cfg.agc_target_level, cfg.agc_max_gain
    g = np.ones(B)
    gained = np.empty((B, N))
    for b0 in range(0, N, L):
        xb = x[:, b0:b0 + L].astype(np.float64)
        ss = np.stack([np.convolve(r, np.ones(w) / w, "same") for r in xb * xb])
        d = np.clip(t / (np.sqrt(np.maximum(ss, 0)) + 1e-10), 0, mg)
        gs = np.empty_like(d)
        for i in range(L):
            a = np.where(d[:, i] > g, a_att, a_rel)
            g = a * d[:, i] + (1 - a) * g
            gs[:, i] = g
        gs = np.clip(gs, 0.1, mg)
        g = gs[:, -1]
        gained[:, b0:b0 + L] = np.clip(xb * gs, -0.99, 0.99)
    upf = cfg.upsample_factor
    h = sum(gi * np.convolve(design.main_taps.astype(np.float64), b.astype(np.float64))
            for gi, b in zip(design.eq_gains, design.eq_taps))
    h_up = streaming_kernel(upf, 1, quality=cfg.resample_quality)
    out = []
    for r in gained:
        y = sps.upfirdn(h_up, r, upf, 1)[: N * upf]
        out.append(np.convolve(y, h)[: len(y)][::upf])
    return np.clip(np.stack(out), -cfg.output_clip, cfg.output_clip)


def phase_c8_pipeline(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import Pipeline, PipelineParams

    g = torch.Generator(device=dev).manual_seed(11)
    blocks = torch.randn(sz.run_blocks, sz.c8_batch, sz.c8_block, generator=g,
                         device=dev) * 0.1
    for mode in ("exact", "fast"):
        pipe = Pipeline(c8_config(sz, agc_mode=mode), dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        pipe.run(params, pipe.init_state(seed=0), blocks[:1])  # warm-up
        sync(torch, dev)
        t0 = time.perf_counter()
        state, outs = pipe.run(params, pipe.init_state(seed=0), blocks)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        check(outs.shape == blocks.shape and bool(torch.isfinite(outs).all())
              and float(outs.abs().max()) <= 0.99 + 2.0 ** -14
              and bool(torch.isfinite(state.agc_gain).all()),
              f"C8 {mode}: shape, finiteness, clip or gain carry")
        audio_s = sz.run_blocks * sz.c8_batch * sz.c8_block / pipe.cfg.samplerate
        say(f"phase 4 C8 Pipeline.run agc_mode={mode} batch {sz.c8_batch} x "
            f"{sz.run_blocks} blocks of {sz.c8_block}: {wall * 1e3:.1f} ms wall "
            f"({wall * 1e3 / sz.run_blocks:.2f} ms/block, {audio_s / wall:.0f}x "
            f"realtime, host clock)")
    del blocks, outs

    # the card against the port's CPU run (plain versions), batch 8
    small = c8_config(sz, batch=8)
    sig = (np.random.default_rng(4).standard_normal((4, 8, sz.c8_block)) * 0.1
           ).astype(np.float32)
    sig[:, 0] *= 8.0
    outs = {}
    for where in (dev, torch.device("cpu")):
        pipe = Pipeline(small, where)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        _, y = pipe.run(params, pipe.init_state(seed=1), sig)
        outs[where.type] = y.cpu().numpy()
    e = err_db(outs[dev.type], outs["cpu"])
    check(e <= CHAIN_DB, f"C8 batch 8: card vs CPU {e:.1f} dB")
    say(f"phase 4 C8 batch 8, 4 blocks, dither on: card vs the port's CPU run "
        f"{e:.1f} dB (<= {CHAIN_DB})")

    # the float64 oracle: 4 streams, 4 blocks, dither off
    ocfg = c8_config(sz, batch=4, dither_kind="off")
    pipe = Pipeline(ocfg, dev)
    design = PipelineParams.design(pipe.cfg)
    params = pipe.device_params(design)
    x = (np.random.default_rng(5).standard_normal((4, 4 * sz.c8_block)) * 0.1
         ).astype(np.float32)
    x[0, : sz.c8_block] *= 8.0
    x[1] *= 1e-2
    _, out = pipe.process_signal(params, pipe.init_state(), x, fold=False)
    e = err_db(out.cpu().numpy(), c8_oracle(x, pipe.cfg, design))
    check(e < ORACLE_DB, f"C8 oracle: {e:.1f} dB breaks the {ORACLE_DB} dB contract")
    say(f"phase 4 C8 oracle: 4 streams, 4 blocks, dither off: {e:.1f} dB vs "
        f"the float64 AGC + chain (< {ORACLE_DB})")


def phase_c8_serving(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.runtime import RingServer

    g = torch.Generator(device=dev).manual_seed(12)
    src = (torch.randn(sz.serve_blocks, sz.c8_batch, sz.c8_block, generator=g,
                       device=dev) * 0.1).cpu().numpy()
    pipe = Pipeline(c8_config(sz), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    # a first server over the same blocks warms the allocators (rings, the
    # pinned staging buffers of every in-flight block) and the kernels'
    # first launches; the second is the one measured and checked
    RingServer(pipe, params, slots=sz.slots, chunk=sz.chunk, max_inflight=2,
               seed=0).serve(iter(src), lambda _: None)
    srv = RingServer(pipe, params, slots=sz.slots, chunk=sz.chunk,
                     max_inflight=2, seed=0)
    got = []
    stats = srv.serve(iter(src), got.append)
    check(stats["blocks"] == sz.serve_blocks, "C8 RingServer lost blocks")
    st = pipe.init_state(seed=0)
    same = True
    for blk, o in zip(src, got):
        st, y = pipe.step(params, st, blk)
        same = same and np.array_equal(o, y.cpu().numpy())
    check(same and torch.equal(st.agc_gain, srv.state.agc_gain),
          "C8 RingServer differs from the staged steps (dither on)")
    lat = stats["latency"]
    say(f"phase 5 C8 RingServer per-step ring, {sz.slots} slots, chunk "
        f"{sz.chunk}: {stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms "
        f"({stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
        f"{lat['p95_ms']:.1f} ms land-to-drain, host clock); ring == staged "
        f"bit for bit, dither on")


def phase_c8_engine(torch, dev, sz: Sizes) -> None:
    from afp_tpu_torch.engine import StreamEngine

    cfg = c8_config(sz)
    eng = StreamEngine(cfg, device=dev)
    rng = np.random.default_rng(13)
    outs = []
    for i in range(6):
        if i == 4:
            check(eng.apply_config(replace(eng.cfg, agc_target_level=0.2)),
                  "C8 apply_config with a new AGC target was not a dynamic swap")
        blk = (rng.standard_normal((sz.c8_batch, sz.c8_block)) * 0.1).astype(np.float32)
        outs.append(eng.process_block(blk))
    m = eng.metrics
    check(m.underruns == m.fallback_replays == m.fallback_silence == 0,
          f"C8 StreamEngine ladder fired: {m.snapshot()}")
    check(all(o.shape == (sz.c8_batch, sz.c8_block) and np.isfinite(o).all()
              and np.abs(o).max() <= 0.99 + 2.0 ** -14 for o in outs)
          and float(eng.params.agc_target) == np.float32(0.2),
          "C8 StreamEngine outputs: shape, finiteness, clip or the swap")
    say(f"phase 6 C8 StreamEngine batch {sz.c8_batch}: 4 blocks + apply_config "
        f"(agc_target_level 0.1 -> 0.2, dynamic) + 2 blocks, metrics {m.snapshot()}")


# ---------------------------------------------------------------- transport


def phase_kernels_transport(torch, dev, sz: Sizes) -> dict:
    """K12 and K13 (and their megakernel forms) against their plain
    versions and against K3/K4, and the int16 store of K1, K3, K4, K12 and
    K13, at the C5 headline."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import fir_td as F

    pipe = Pipeline(c5_config(sz), dev)
    h = pipe.device_params(PipelineParams.design(pipe.cfg)).casc_main
    n, kp, B, T, S = pipe.n_casc, pipe._k_pad, sz.batch, sz.block, sz.slots
    dkw = dict(out_clip=0.2, dither_key=(5, 7), dither_bits=16, dither_tpdf=True)
    idx, start, steps = 5 % S, S - 2, sz.chunk
    slots = [(start + i) % S for i in range(steps)]

    def z(dtype=torch.float32):
        return torch.zeros((S, B, T), dtype=dtype, device=dev)

    res = {}
    ring16, tail16 = pcm16(torch, dev, (S, B, T), 20), pcm16(torch, dev, (B, kp), 21)
    ringf, tailf = F.pcm16_to_f32(ring16), F.pcm16_to_f32(tail16)

    # K12, one step: vs plain, ≡ K3 on n/32768, int16 store ≡ quantized
    ok, tk = F.fir_td_mxu_ring_pcm16(ring16, idx, tail16, h, z())
    op, tp = F.fir_td_mxu_ring_pcm16_plain(ring16, idx, tail16, h, z())
    e12 = err_db(ok[idx].cpu(), op[idx].cpu())
    of, tf = F.fir_td_mxu_ring_f32(ringf, idx, tailf, h, z())
    k3 = torch.equal(ok, of) and torch.equal(F.pcm16_to_f32(tk), tf)
    ye, _ = F.fir_td_mxu_ring_pcm16(ring16, idx, tail16, h, z(), **dkw)
    qe, _ = F.fir_td_mxu_ring_pcm16(ring16, idx, tail16, h, z(torch.int16), **dkw)
    store = torch.equal(qe, F.quantize_pcm16(ye))
    check(e12 <= CONV_DB and torch.equal(tk, tp) and k3 and store,
          f"K12: conv {e12:.1f} dB, tail {torch.equal(tk, tp)}, == K3 {k3}, "
          f"int16 store {store}")
    out16 = z(torch.int16)
    res["fir_td_mxu_ring_pcm16"] = dict(
        max_abs_err=float((ok[idx] - op[idx]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_pcm16(
            ring16, idx, tail16, h, out16, **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_pcm16_plain(
            ring16, idx, tail16, h, out16, **dkw), 3))
    say(f"phase 3 K12 fir_td_mxu_ring_pcm16 int16 ring [{S}, {B}, {T}] tail "
        f"{kp}: conv {e12:.1f} dB vs plain, int16 tail bit-exact, == K3 on "
        f"n/32768 bit for bit, int16 store == quantize_pcm16; "
        f"{res['fir_td_mxu_ring_pcm16']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_pcm16']['plain_ms']:.3f} ms (int16 in and out)")
    del ok, op, of, ye, qe

    # K12 megakernel: vs plain, ≡ K4 on n/32768, int16 store
    mk, mt = F.fir_td_mxu_ring_mega_pcm16(ring16, start, tail16, h, z(), steps)
    mp, mpt = F.fir_td_mxu_ring_mega_pcm16_plain(ring16, start, tail16, h, z(), steps)
    e12m = max(err_db(mk[s].cpu(), mp[s].cpu()) for s in slots)
    m4, m4t = F.fir_td_mxu_ring_mega_f32(ringf, start, tailf, h, z(), steps, **dkw)
    q12, q12t = F.fir_td_mxu_ring_mega_pcm16(ring16, start, tail16, h,
                                             z(torch.int16), steps, **dkw)
    k4 = torch.equal(q12, F.quantize_pcm16(m4)) and torch.equal(
        F.pcm16_to_f32(q12t), m4t)
    check(e12m <= CONV_DB and torch.equal(mt, mpt) and k4,
          f"K12 mega: conv {e12m:.1f} dB, tail {torch.equal(mt, mpt)}, int16 "
          f"store == quantized K4 on n/32768 {k4}")
    res["fir_td_mxu_ring_mega_pcm16"] = dict(
        max_abs_err=max(float((mk[s] - mp[s]).abs().max()) for s in slots),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_pcm16(
            ring16, start, tail16, h, out16, steps, **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_pcm16_plain(
            ring16, start, tail16, h, out16, steps, **dkw), 2))
    say(f"phase 3 K12 fir_td_mxu_ring_mega_pcm16 {steps} steps from slot "
        f"{start}: conv {e12m:.1f} dB vs plain, int16 tail bit-exact, int16 "
        f"store == quantize_pcm16 of K4 on n/32768 bit for bit; "
        f"{res['fir_td_mxu_ring_mega_pcm16']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_mega_pcm16']['plain_ms']:.3f} ms per dispatch")
    del ring16, mk, mp, q12, out16

    # the int16 store of K1, K3, K4 ≡ quantize_pcm16 of their f32 output
    g = torch.Generator(device=dev).manual_seed(22)
    ring = torch.randn(S, B, T, generator=g, device=dev) * 0.3
    tail = torch.randn(B, kp, generator=g, device=dev) * 0.3
    ext = torch.cat([tail[:, kp - (n - 1):], ring[idx]], dim=-1)
    y1 = F.fir_td_mxu(ext, h, **dkw)
    s1 = torch.equal(F.fir_td_mxu(ext, h, emit_i16=True, **dkw), F.quantize_pcm16(y1))
    y3, _ = F.fir_td_mxu_ring_f32(ring, idx, tail, h, z(), **dkw)
    s3 = torch.equal(F.fir_td_mxu_ring_f32(ring, idx, tail, h, z(torch.int16), **dkw)[0],
                     F.quantize_pcm16(y3))
    y4, _ = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, z(), steps, **dkw)
    s4 = torch.equal(F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, z(torch.int16),
                                                steps, **dkw)[0], F.quantize_pcm16(y4))
    check(s1 and s3 and s4, f"int16 store: K1 {s1}, K3 {s3}, K4 {s4}")
    out16 = z(torch.int16)
    t1 = time_ms(torch, lambda: F.fir_td_mxu(ext, h, emit_i16=True, **dkw), 10)
    t3 = time_ms(torch, lambda: F.fir_td_mxu_ring_f32(ring, idx, tail, h, out16,
                                                      **dkw), 10)
    t4 = time_ms(torch, lambda: F.fir_td_mxu_ring_mega_f32(
        ring, start, tail, h, out16, steps, **dkw), 5)
    say(f"phase 3 int16 store: K1, K3, K4 == quantize_pcm16 of their f32 "
        f"output bit for bit; K1 {t1:.3f} ms, K3 {t3:.3f} ms, K4 {t4:.3f} ms "
        f"per {steps} steps")
    del y1, y3, y4, out16

    # K13: the pair rings of the f32 ring ≡ K3/K4 on it, ≡ K7 on a slot
    rh, rl = F.split_bf16(ring)
    th, tl = F.split_bf16(tail)
    ck, ch, cl = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, z())
    cp, cph, cpl = F.fir_td_mxu_ring_plain(rh, rl, idx, th, tl, h, z())
    e13 = err_db(ck[idx].cpu(), cp[idx].cpu())
    c3, c3t = F.fir_td_mxu_ring_f32(ring, idx, tail, h, z())
    c7, c7h, c7l = F.fir_td_mxu_pair_to_ring(rh[idx], rl[idx], th, tl, h, idx, z())
    sh, sl = F.split_bf16(c3t)
    same = (torch.equal(ck, c3) and torch.equal(ck, c7) and torch.equal(ch, sh)
            and torch.equal(cl, sl) and torch.equal(ch, c7h) and torch.equal(cl, c7l))
    q13 = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, z(torch.int16), **dkw)[0]
    y13 = F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, z(), **dkw)[0]
    store = torch.equal(q13, F.quantize_pcm16(y13))
    tails = torch.equal(ch, cph) and torch.equal(cl, cpl)
    check(e13 <= CONV_DB and tails and same and store,
          f"K13: conv {e13:.1f} dB, tails {tails}, == K3 and K7 {same}, int16 "
          f"store {store}")
    out_r = z()
    res["fir_td_mxu_ring"] = dict(
        max_abs_err=float((ck[idx] - cp[idx]).abs().max()),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring(rh, rl, idx, th, tl, h, out_r,
                                                    **dkw), 10),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_plain(
            rh, rl, idx, th, tl, h, out_r, **dkw), 3))
    say(f"phase 3 K13 fir_td_mxu_ring pair rings [{S}, {B}, {T}] tail {kp}: "
        f"conv {e13:.1f} dB vs plain, pair tail bit-exact, == K3 on the f32 "
        f"ring and == K7 on the slot bit for bit, int16 store == "
        f"quantize_pcm16; {res['fir_td_mxu_ring']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring']['plain_ms']:.3f} ms")
    del ck, cp, c3, c7, q13, y13

    mk, mh, ml = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z(), steps)
    mp, mph, mpl = F.fir_td_mxu_ring_mega_plain(rh, rl, start, th, tl, h, z(), steps)
    e13m = max(err_db(mk[s].cpu(), mp[s].cpu()) for s in slots)
    me, meh, mel = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z(), steps, **dkw)
    m4, m4t = F.fir_td_mxu_ring_mega_f32(ring, start, tail, h, z(), steps, **dkw)
    sh, sl = F.split_bf16(m4t)
    k4 = torch.equal(me, m4) and torch.equal(meh, sh) and torch.equal(mel, sl)
    q13m = F.fir_td_mxu_ring_mega(rh, rl, start, th, tl, h, z(torch.int16), steps,
                                  **dkw)[0]
    store = torch.equal(q13m, F.quantize_pcm16(me))
    tails = torch.equal(mh, mph) and torch.equal(ml, mpl)
    check(e13m <= CONV_DB and tails and k4 and store,
          f"K13 mega: conv {e13m:.1f} dB, tails {tails}, == K4 {k4}, int16 "
          f"store {store}")
    res["fir_td_mxu_ring_mega"] = dict(
        max_abs_err=max(float((mk[s] - mp[s]).abs().max()) for s in slots),
        ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega(
            rh, rl, start, th, tl, h, out_r, steps, **dkw), 5),
        plain_ms=time_ms(torch, lambda: F.fir_td_mxu_ring_mega_plain(
            rh, rl, start, th, tl, h, out_r, steps, **dkw), 2))
    say(f"phase 3 K13 fir_td_mxu_ring_mega {steps} steps from slot {start}: "
        f"conv {e13m:.1f} dB vs plain, pair tail bit-exact, == K4 on the f32 "
        f"ring bit for bit, int16 store == quantize_pcm16; "
        f"{res['fir_td_mxu_ring_mega']['ms']:.3f} ms vs plain "
        f"{res['fir_td_mxu_ring_mega']['plain_ms']:.3f} ms per dispatch")
    return res


def c5_oracle(x: np.ndarray, cfg, design) -> np.ndarray:
    """The C5 chain in float64 over [B, N] input (`bench.py:394-418`):
    upsample, the main FIR, decimate."""
    import scipy.signal as sps

    from afp_tpu_torch.ops.resample import streaming_kernel

    upf = cfg.upsample_factor
    h_up = streaming_kernel(upf, 1, quality=cfg.resample_quality)
    main = design.main_taps.astype(np.float64)
    out = []
    for r in x.astype(np.float64):
        y = sps.upfirdn(h_up, r, upf, 1)[: len(r) * upf]
        out.append(np.convolve(y, main)[: len(y)][::upf])
    return np.stack(out)


def run_wall(torch, dev, pipe, params, blocks) -> tuple:
    """`Pipeline.run` over `blocks` after a one-block warm-up: (outputs,
    wall seconds, host clock ending in a synchronize)."""
    pipe.run(params, pipe.init_state(seed=0), blocks[:1])
    sync(torch, dev)
    t0 = time.perf_counter()
    _, outs = pipe.run(params, pipe.init_state(seed=0), blocks)
    sync(torch, dev)
    return outs, time.perf_counter() - t0


def phase_transport_pipeline(torch, dev, sz: Sizes) -> None:
    """C5-i16io and C8-i16io through `Pipeline.run`, each ≡ quantize_pcm16
    of the f32 chain fed n/32768 with the same 16-bit dither; the C5-pcm16
    and C8-pcm16 oracles."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import fir_td as F

    io = dict(ingest="pcm16", emit="pcm16")
    runs = [("C5-i16io", c5_config(sz, **io), sz.batch, sz.block, 0.3)]
    runs += [(f"C8-i16io {m}", c8_config(sz, agc_mode=m, **io), sz.c8_batch,
              sz.c8_block, 0.1) for m in ("exact", "fast")]
    for name, cfg, B, T, scale in runs:
        pipe = Pipeline(cfg, dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        blocks = pcm16(torch, dev, (sz.run_blocks, B, T), 30, scale=scale)
        outs, wall = run_wall(torch, dev, pipe, params, blocks)
        fpipe = Pipeline(replace(pipe.cfg, ingest="f32", emit="f32"), dev)
        fparams = fpipe.device_params(PipelineParams.design(fpipe.cfg))
        _, fo = fpipe.run(fparams, fpipe.init_state(seed=0),
                          F.pcm16_to_f32(blocks[:2]))
        check(outs.dtype == torch.int16 and outs.shape == blocks.shape
              and pipe.cfg.dither_bits == 16
              and torch.equal(outs[:2], F.quantize_pcm16(fo)),
              f"{name}: dtype, shape, or not quantize_pcm16 of the f32 chain")
        audio_s = sz.run_blocks * B * T / pipe.cfg.samplerate
        say(f"phase 4 {name} Pipeline.run batch {B} x {sz.run_blocks} blocks "
            f"of {T}, int16 in and out: {wall * 1e3:.1f} ms wall "
            f"({wall * 1e3 / sz.run_blocks:.2f} ms/block, {audio_s / wall:.0f}x "
            f"realtime, host clock); == quantize_pcm16 of the f32 chain on "
            f"n/32768 bit for bit (2 blocks, 16-bit dither)")
        del blocks, outs, fo

    # the oracles: pcm16 in, dither off; f32 out < −90 dB, int16 out ≤ 1 LSB
    rng = np.random.default_rng(6)
    x5 = np.clip(np.round(rng.standard_normal((1, 4 * sz.block)) * 0.3 * 32768),
                 -32768, 32767).astype(np.int16)
    x8 = np.clip(np.round(rng.standard_normal((4, 4 * sz.c8_block)) * 0.1 * 32768),
                 -32768, 32767).astype(np.int16)
    x8[0, : sz.c8_block] = np.clip(x8[0, : sz.c8_block].astype(np.int32) * 8,
                                   -32768, 32767)
    x8[1] //= 100
    for name, base, x, oracle in (
            ("C5-pcm16", c5_config(sz, batch=1), x5, c5_oracle),
            ("C8-pcm16", c8_config(sz, batch=4), x8, c8_oracle)):
        outs = {}
        for emit in ("f32", "pcm16"):
            pipe = Pipeline(replace(base, ingest="pcm16", emit=emit,
                                    dither_kind="off"), dev)
            design = PipelineParams.design(pipe.cfg)
            params = pipe.device_params(design)
            _, out = pipe.process_signal(params, pipe.init_state(), x, fold=False)
            outs[emit] = out.cpu().numpy()
        gold = oracle(x.astype(np.float32) / np.float32(32768.0), pipe.cfg, design)
        e = err_db(outs["f32"], gold)
        dmax, ndiff = lsb_diff(outs["pcm16"], quantized(gold))
        check(e < ORACLE_DB and dmax <= 1,
              f"{name} oracle: {e:.1f} dB, int16 out {dmax} LSB")
        say(f"phase 4 {name} oracle: {x.shape[0]} stream(s) x 4 blocks, int16 "
            f"in, dither off: {e:.1f} dB vs the float64 oracle on n/32768 "
            f"(< {ORACLE_DB}); int16 out max |d| {dmax} LSB from the quantized "
            f"oracle, {ndiff} of {gold.size} samples differ (<= 1 LSB)")


def serve_warm(pipe, params, src, sz: Sizes, mega: bool = False):
    """Serve `src` once to warm the allocators (rings, pinned staging) and
    the kernels' first launches, then again: (outputs, serve() stats)."""
    from afp_tpu_torch.runtime import RingServer

    kw = dict(slots=sz.slots, chunk=sz.chunk, max_inflight=2, seed=0, mega=mega)
    RingServer(pipe, params, **kw).serve(iter(src), lambda _: None)
    got = []
    stats = RingServer(pipe, params, **kw).serve(iter(src), got.append)
    check(stats["blocks"] == len(src), "RingServer lost blocks")
    return np.stack(got), stats


def staged_outputs(torch, pipe, params, src) -> np.ndarray:
    st = pipe.init_state(seed=0)
    outs = []
    for blk in src:
        st, y = pipe.step(params, st, blk)
        outs.append(y.cpu().numpy())
    return np.stack(outs)


def phase_transport_serving(torch, dev, sz: Sizes) -> None:
    """RingServer at C5-i16io and C5-pair (mega and per-step) and at
    C8-i16io (per-step), each ≡ its staged steps with dither on."""
    from afp_tpu_torch.engine import Pipeline, PipelineParams
    from afp_tpu_torch.ops.cuda import split_bf16
    from afp_tpu_torch.runtime import RingServer

    g = torch.Generator(device=dev).manual_seed(40)
    srcf = list((torch.randn(sz.serve_blocks, sz.batch, sz.block, generator=g,
                             device=dev) * 0.3).cpu().numpy())
    src16 = list(pcm16(torch, dev, (sz.serve_blocks, sz.batch, sz.block), 41)
                 .cpu().numpy())
    for name, cfg, src in (
            ("C5-i16io", c5_config(sz, ingest="pcm16", emit="pcm16"), src16),
            ("C5-pair", c5_config(sz, ingest="pair"), srcf)):
        pipe = Pipeline(cfg, dev)
        params = pipe.device_params(PipelineParams.design(pipe.cfg))
        outs = {}
        for mega in (True, False):
            outs[mega], stats = serve_warm(pipe, params, src, sz, mega=mega)
            lat = stats["latency"]
            say(f"phase 5 {name} RingServer mega={mega}, {sz.slots} slots, chunk "
                f"{sz.chunk}: {stats['blocks']} blocks in "
                f"{stats['wall_s'] * 1e3:.1f} ms once warm "
                f"({stats['wall_s'] * 1e3 / stats['blocks']:.2f} ms/block, "
                f"{stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
                f"{lat['p95_ms']:.1f} ms land-to-drain, host clock)")
        staged = staged_outputs(torch, pipe, params, src)
        same = (np.array_equal(outs[True], outs[False])
                and np.array_equal(outs[False], staged))
        if pipe._pair_ingest:  # the producer's own (hi, lo) pairs, landed as is
            pairs = [split_bf16(torch.from_numpy(b)) for b in src[: sz.chunk]]
            srv = RingServer(pipe, params, slots=sz.slots, chunk=sz.chunk,
                             max_inflight=2, seed=0)
            same = same and np.array_equal(np.stack(list(srv.stream(iter(pairs)))),
                                           staged[: sz.chunk])
        check(same, f"{name} RingServer: mega, per-step and staged differ "
              "(dither on)")
        say(f"phase 5 {name} RingServer: mega == per-step == staged steps bit "
            f"for bit, dither on, output {outs[True].dtype}")

    pipe = Pipeline(c8_config(sz, ingest="pcm16", emit="pcm16"), dev)
    params = pipe.device_params(PipelineParams.design(pipe.cfg))
    src = list(pcm16(torch, dev, (sz.serve_blocks, sz.c8_batch, sz.c8_block), 42,
                     scale=0.1).cpu().numpy())
    got, stats = serve_warm(pipe, params, src, sz)
    check(np.array_equal(got, staged_outputs(torch, pipe, params, src))
          and got.dtype == np.int16,
          "C8-i16io RingServer differs from the staged steps (dither on)")
    lat = stats["latency"]
    say(f"phase 5 C8-i16io RingServer per-step ring, {sz.slots} slots, chunk "
        f"{sz.chunk}: {stats['blocks']} blocks in {stats['wall_s'] * 1e3:.1f} ms "
        f"once warm ({stats['wall_s'] * 1e3 / stats['blocks']:.2f} ms/block, "
        f"{stats['xrt']:.0f}x realtime, p50 {lat['p50_ms']:.1f} ms, p95 "
        f"{lat['p95_ms']:.1f} ms land-to-drain, host clock); ring == staged bit "
        f"for bit, dither on, int16 in and out")


def phase_transport_engine(torch, dev, sz: Sizes) -> None:
    """StreamEngine at C8-i16io: int16 blocks in and out through a dynamic
    AGC swap; a float block is refused before the ladder."""
    from afp_tpu_torch.engine import StreamEngine

    eng = StreamEngine(c8_config(sz, ingest="pcm16", emit="pcm16"), device=dev)
    blocks = pcm16(torch, dev, (6, sz.c8_batch, sz.c8_block), 50, scale=0.1).cpu().numpy()
    outs = []
    for i, blk in enumerate(blocks):
        if i == 4:
            check(eng.apply_config(replace(eng.cfg, agc_target_level=0.2)),
                  "C8-i16io apply_config with a new AGC target was not a dynamic swap")
        outs.append(eng.process_block(blk))
    try:
        eng.process_block(blocks[0].astype(np.float32))
        refused = False
    except ValueError:
        refused = True
    m = eng.metrics
    check(refused and m.underruns == m.fallback_replays == m.fallback_silence == 0,
          f"C8-i16io StreamEngine: float block refused {refused}, metrics "
          f"{m.snapshot()}")
    check(all(o.dtype == np.int16 and o.shape == (sz.c8_batch, sz.c8_block)
              and np.abs(o.astype(np.int32)).max() <= 0.99 * 32768 + 2
              for o in outs) and float(eng.params.agc_target) == np.float32(0.2),
          "C8-i16io StreamEngine outputs: dtype, shape, clip or the swap")
    say(f"phase 6 C8-i16io StreamEngine batch {sz.c8_batch}: 4 int16 blocks + "
        f"apply_config (agc_target_level 0.1 -> 0.2, dynamic) + 2, int16 out, "
        f"a float block refused (ValueError), metrics {m.snapshot()}")


# ---------------------------------------------------------------- main


REPLACES = {
    "fir_td_mxu": ("afp_tpu_torch/csrc/fir_td.cu", "afp_tpu/ops/pallas/fir_td.py:1665"),
    "fir_td_mxu_ring_f32": ("afp_tpu_torch/csrc/fir_td.cu",
                            "afp_tpu/ops/pallas/fir_td.py:1173"),
    "fir_td_mxu_ring_mega_f32": ("afp_tpu_torch/csrc/fir_td.cu",
                                 "afp_tpu/ops/pallas/fir_td.py:1612"),
    "dither_cuda": ("afp_tpu_torch/csrc/dither.cu",
                    "afp_tpu/ops/pallas/dither_pl.py:69"),
    "rms_desired": ("afp_tpu_torch/csrc/agc_rms.cu",
                    "afp_tpu/ops/pallas/agc_rms.py:330"),
    "smooth_gain_apply": ("afp_tpu_torch/csrc/agc_scan.cu",
                          "afp_tpu/ops/pallas/agc_scan.py:384"),
    "fir_td_mxu_pair_to_ring": ("afp_tpu_torch/csrc/fir_td.cu",
                                "afp_tpu/ops/pallas/fir_td.py:828"),
    "fir_td_mxu_pair": ("afp_tpu_torch/csrc/fir_td.cu",
                        "afp_tpu/ops/pallas/fir_td.py:700"),
    "fir_td_mxu_ring_pcm16": ("afp_tpu_torch/csrc/fir_td.cu",
                              "afp_tpu/ops/pallas/fir_td.py:1270"),
    "fir_td_mxu_ring_mega_pcm16": ("afp_tpu_torch/csrc/fir_td.cu",
                                   "afp_tpu/ops/pallas/fir_td.py:1638"),
    "fir_td_mxu_ring": ("afp_tpu_torch/csrc/fir_td.cu",
                        "afp_tpu/ops/pallas/fir_td.py:946"),
    "fir_td_mxu_ring_mega": ("afp_tpu_torch/csrc/fir_td.cu",
                             "afp_tpu/ops/pallas/fir_td.py:1445"),
}

#: the kernels each transport phase must launch: K12 and K13 themselves,
#: the int16 store (K12 at C5-i16io, K8 and K7 at C8-i16io) and K5/K6's
#: int16 loads (C8-i16io)
TRANSPORT_LAUNCHES = {
    "phase_transport_pipeline": ("fir_td_mxu_ring_pcm16", "fir_td_mxu_pair",
                                 "rms_desired", "smooth_gain_apply"),
    "phase_transport_serving": ("fir_td_mxu_ring_pcm16",
                                "fir_td_mxu_ring_mega_pcm16", "fir_td_mxu_ring",
                                "fir_td_mxu_ring_mega", "fir_td_mxu_pair_to_ring",
                                "rms_desired", "smooth_gain_apply"),
    "phase_transport_engine": ("fir_td_mxu_pair", "rms_desired",
                               "smooth_gain_apply"),
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
    res = {}
    for phase in (phase_kernels, phase_kernels_agc, phase_kernels_transport):
        t0 = time.perf_counter()
        res.update(phase(torch, dev, sz))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        say(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s)")

    for k in KERNELS:  # count only the main path's launches from here on
        k.launches = 0
    for phase in (phase_pipeline, phase_c8_pipeline, phase_transport_pipeline,
                  phase_serving, phase_c8_serving, phase_transport_serving,
                  phase_engine, phase_c8_engine, phase_transport_engine):
        t0 = time.perf_counter()
        before = {k.__name__: k.launches for k in KERNELS}
        phase(torch, dev, sz)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        delta = {k.__name__: k.launches - before[k.__name__] for k in KERNELS}
        want = TRANSPORT_LAUNCHES.get(phase.__name__, ())
        check(all(delta[k] > 0 for k in want),
              f"{phase.__name__} did not launch all of {want}: {delta}")
        say(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s"
            + (f"; launched {({k: delta[k] for k in want})}" if want else "")
            + ")")
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
