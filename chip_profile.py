#!/usr/bin/env python3
"""Where the device time goes, per cell, on one CUDA card (torch.profiler).

    python3 chip_profile.py
    python3 chip_profile.py --walls      # the staged walls alone, no profiler
    python3 chip_profile.py --multirate  # the multirate paths (smoke phase 9)

For each cell of `chip_smoke.py` at its full size: a staged `Pipeline.run`
over 8 blocks and, for the serving cells, one `RingServer` serve
of 16 blocks (16 slots, chunk 4), each after a warm-up run of the same
work and under `torch.profiler` (CPU and CUDA activities).  Per block it
prints the host wall time (ending in a synchronize), the device time by
kernel class (the port's kernels by name, cuFFT, the packing's gathers,
PyTorch's other kernels, the host↔device copies), the device busy time (the union of the device
events) and the idle share ``1 − busy / wall``.  The card's name and power
limit come first.  With ``--walls`` it times each cell's staged run
``WALL_RUNS`` times on the host clock (ending in a synchronize), without
the profiler, after two warm-up runs, and prints the median, least and
most ms per block and every run: to compare two checkouts, copy this
script into the other and run the two in turn, more than once.  With
``--multirate`` it profiles the multirate paths of the smoke's phase 9
instead, each whole path beside its resampler alone on the same input, so
the resampler's share of the device time reads off two lines: the literal
chain at the C5 headline (4 blocks of [4096, 4096], 'fft', TPDF) beside
its up `PolyResampler` and beside the fused K1 chain; the compat ASRC C8
from 48 kHz (3 blocks of [64, 2048]) beside `resample_poly` on those
blocks; and the CLI's exact ASRC, a 60 s stereo 48 kHz signal through
`StreamEngine.process_signal` at the CLI's defaults, beside its
frontend's push alone.  Without a CUDA device it exits 1.
"""
from __future__ import annotations

import sys
import time

import chip_smoke as cs

BLOCKS = 8  # staged blocks per cell; the serving cells serve 16
WALL_RUNS = 20  # timed staged runs per cell with --walls

#: device event name → class (first match wins)
CLASSES = (("fir_ps_kernel", "K11"), ("fir_conv_kernel", "conv"),
           ("ring_tail_kernel", "ring tail"), ("rms_desired_kernel", "K5"),
           ("agc_apply_kernel", "K6"), ("agc_fused_kernel", "K14"),
           ("agc_scan_kernel", "K9"), ("dither_kernel", "K2"),
           ("Memcpy HtoD", "H2D"), ("Memcpy DtoH", "D2H"),
           ("Memcpy DtoD", "D2D"), ("Memset", "memset"), ("fft", "cuFFT"),
           ("index", "gather"), ("gather", "gather"))


def klass(name: str) -> str:
    low = name.lower()
    for key, cls in CLASSES:
        if key.lower() in low:
            return cls
    return "torch other"


def profiled(torch, fn, per: int) -> str:
    """Run `fn` once to warm up, then under the profiler: one line of
    per-block times (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by[klass(e.name)] = by.get(klass(e.name), 0.0) + (end - start)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):  # the union of the device intervals
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    ms = 1e3 / per
    parts = ", ".join(f"{k} {v / 1e3 / per:.3f}" for k, v in
                      sorted(by.items(), key=lambda kv: -kv[1]))
    return (f"wall {wall * ms:.3f} ms/block, busy {busy / 1e3 / per:.3f} ms "
            f"(idle {100 * max(0.0, 1 - busy / 1e6 / wall):.0f}%): {parts}")


def walls(torch, fn) -> str:
    """`fn` (one staged run of BLOCKS blocks) twice to warm up, then
    WALL_RUNS times on the host clock: one line of ms per block."""
    fn()
    fn()
    ms = []
    for _ in range(WALL_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / BLOCKS)
    return (f"wall median {sorted(ms)[len(ms) // 2]:.3f} ms/block, least "
            f"{min(ms):.3f}, most {max(ms):.3f} over {WALL_RUNS} runs: "
            + " ".join(f"{v:.3f}" for v in ms))


def cells(torch, dev, sz):
    """(name, pipeline, params, batch, block, serves?, packing) for each
    cell: the smoke's, with C5-highest, C8-highest and C8-psg-highest
    (``td_precision='HIGHEST'``, staged only: no ring form) and C8-one
    (``agc_one_kernel``)."""
    from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                      batch)

    def shared(pipe):
        return pipe.device_params(PipelineParams.design(pipe.cfg))

    out = []
    for name, cfg, bank in (
            ("C5", cs.c5_config(sz), False),
            ("C5-bank", cs.c5_config(sz), True),
            ("C5-i16io", cs.c5_config(sz, ingest="pcm16", emit="pcm16"), False),
            ("C5-i16io-bank", cs.c5_config(sz, ingest="pcm16", emit="pcm16"), True)):
        pipe = Pipeline(cfg, dev)
        out.append((name, pipe, cs.c5_bank(pipe) if bank else shared(pipe),
                    sz.batch, sz.block, True, None))
    pp = Pipeline(cs.c5_config(sz), dev)
    pparams, pk = cs.c5_bank(pp, interleaved=True)
    out.append(("C5-bank-packed", pp, pparams, sz.batch, sz.block, True, pk))
    ph = Pipeline(cs.c5_config(sz), dev, td_precision="HIGHEST")
    out.append(("C5-highest", ph, shared(ph), sz.batch, sz.block, False, None))
    p8 = Pipeline(cs.c8_config(sz), dev)
    out.append(("C8", p8, shared(p8), sz.c8_batch, sz.c8_block, True, None))
    for name, kw in (("C8-highest", dict(td_precision="HIGHEST")),
                     ("C8-one", dict(agc_one_kernel=True))):
        pk8 = Pipeline(cs.c8_config(sz), dev, **kw)
        out.append((name, pk8, shared(pk8), sz.c8_batch, sz.c8_block,
                    pk8.supports_ring_step, None))
    out.append(("C8-psg", p8, batch.with_per_stream_gains(
        p8, shared(p8), cs.psg_gains(sz.c8_batch)), sz.c8_batch, sz.c8_block,
        False, None))
    ph8 = Pipeline(cs.c8_config(sz), dev, td_precision="HIGHEST")
    out.append(("C8-psg-highest", ph8, batch.with_per_stream_gains(
        ph8, shared(ph8), cs.psg_gains(sz.c8_batch)), sz.c8_batch, sz.c8_block,
        False, None))
    out.append(("C8-psagc", p8, cs.psagc_params(p8, shared(p8)), sz.c8_batch,
                sz.c8_block, True, None))
    qs = Pipeline(StreamConfig(**{**cs.QUICKSTART, "batch": sz.quick_batch,
                                  "blocksize": sz.block}), dev)
    out.append(("QS", qs, shared(qs), sz.quick_batch, sz.block, False, None))
    out.append(("QS-psg", qs, batch.with_per_stream_gains(
        qs, shared(qs), cs.psg_gains(sz.quick_batch)), sz.quick_batch, sz.block,
        False, None))
    return out


def multirate(torch, dev, sz) -> None:
    """The ``--multirate`` lines (see the module docstring)."""
    import numpy as np

    from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                      StreamEngine)
    from afp_tpu_torch.ops.resample import PolyResampler, resample_poly
    from afp_tpu_torch.runtime import AsrcFrontend

    def build(cfg):
        pipe = Pipeline(cfg, dev)
        return pipe, pipe.device_params(PipelineParams.design(pipe.cfg))

    g = torch.Generator(device=dev).manual_seed(9)
    nb = sz.multi_blocks
    blocks = torch.randn(nb, sz.batch, sz.block, generator=g, device=dev) * 0.3
    for name, cfg in (("literal chain", cs.c5_config(sz, fuse_rate_conversion=False,
                                                     conv_strategy="fft")),
                      ("fused K1 chain", cs.c5_config(sz))):
        pipe, params = build(cfg)
        line = profiled(torch, lambda: pipe.run(params, pipe.init_state(), blocks), nb)
        print(f"C5 {name} [{sz.batch}, {sz.block}]: {line}", flush=True)
    up = PolyResampler.init(4, 1, block=sz.block, batch_shape=(sz.batch,),
                            quality="vhq", device=dev)

    def resample_all():
        st = up
        for b in blocks:
            st, _ = st.process(b)

    print(f"C5 literal chain's up PolyResampler alone: "
          f"{profiled(torch, resample_all, nb)}", flush=True)
    del blocks

    cfg = cs.c8_config(sz, batch=sz.asrc_batch, source_samplerate=48000,
                       asrc_mode="compat")
    pipe, params = build(cfg)
    x = torch.randn(3, cfg.batch, cfg.blocksize, generator=g, device=dev) * 0.1
    line = profiled(torch, lambda: pipe.run(params, pipe.init_state(), x), 3)
    print(f"compat ASRC C8 from 48 kHz [{cfg.batch}, {cfg.blocksize}]: {line}",
          flush=True)
    line = profiled(torch, lambda: [resample_poly(b, 44100, 48000,
                                                  quality=cfg.resample_quality)
                                    for b in x], 3)
    print(f"compat ASRC's resample_poly alone: {line}", flush=True)

    n = int(sz.cli_seconds * 48000)
    sig = (np.random.default_rng(10).standard_normal((2, n)) * 0.3).astype(np.float32)
    ecfg = StreamConfig(samplerate=44100, source_samplerate=48000, batch=2)
    nblk = -(-n * 44100 // 48000) // ecfg.blocksize
    line = profiled(torch, lambda: StreamEngine(ecfg, device=dev).process_signal(
        sig, fold="prefer"), nblk)
    print(f"CLI --samplerate 44100, {sz.cli_seconds:g} s stereo 48 kHz through "
          f"StreamEngine.process_signal: {line}", flush=True)
    line = profiled(torch, lambda: AsrcFrontend(
        48000, 44100, batch=2, quality=ecfg.resample_quality, device=dev).push(sig),
        nblk)
    print(f"CLI --samplerate's frontend push alone: {line}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.gpu_line(), flush=True)
    from afp_tpu_torch.runtime import RingServer

    if sys.argv[1:] == ["--multirate"]:
        multirate(torch, dev, cs.Sizes())
        return 0
    only_walls = sys.argv[1:] == ["--walls"]
    g = torch.Generator(device=dev).manual_seed(7)
    for name, pipe, params, B, T, serve, packing in cells(torch, dev, cs.Sizes()):
        if pipe.in_dtype == torch.int16:
            blocks = cs.pcm16(torch, dev, (BLOCKS, B, T), 8, scale=0.1)
        else:
            blocks = torch.randn(BLOCKS, B, T, generator=g, device=dev) * 0.1
        def run():
            return pipe.run(params, pipe.init_state(), blocks)

        line = walls(torch, run) if only_walls else profiled(torch, run, BLOCKS)
        print(f"{name} staged Pipeline.run [{B}, {T}]: {line}", flush=True)
        if serve and pipe.supports_ring_step and not only_walls:
            src = list(blocks.cpu().numpy()) * 2
            mega = not pipe.cfg.agc_enabled
            srv = RingServer(pipe, params, slots=16, chunk=4, max_inflight=2,
                             mega=mega, packing=packing)
            line = profiled(torch, lambda: srv.serve(iter(src), lambda _: None),
                            len(src))
            print(f"{name} RingServer mega={mega}, 16 slots, chunk 4: {line}",
                  flush=True)
        del blocks
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
