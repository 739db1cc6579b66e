"""Per-stream parameter banks: every stream gets its own filter and EQ
curve (the counterpart of `examples/per_stream_banks.py`).

Stream k runs a different filter design (rotating cutoffs and types), all
in the same fused pass: one [B, F] response bank on 'fft'; on 'td_mxu' a
bank of designs by batch tile (K10), packed from an interleaved order; and
per-stream AGC targets read by K5 and K6.

Run: python -m afp_tpu_torch.examples.per_stream_banks [--streams 8] [--blocks 20]
"""
import argparse
import dataclasses
import time

import numpy as np

from afp_tpu_torch.engine import (Pipeline, PipelineParams, StreamConfig,
                                  with_per_stream_agc, with_per_stream_filters)
from afp_tpu_torch.runtime.devices import torch_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=20)
    args = ap.parse_args()
    device = torch_device("per_stream_banks")

    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=257,
        batch=args.streams, eq_enabled=False, agc_enabled=False,
        dither_kind="off", downsample_mode="decimate", output_clip=None,
    )
    pipe = Pipeline(cfg, device)

    # one design per stream: rotating lowpass cutoffs + a bandpass + a highpass
    variants = []
    for k in range(args.streams):
        if k % 4 == 3:
            variants.append(dict(filter_type="bandpass",
                                 cutoff=(300.0 * (k + 1), 4000.0 + 800.0 * k)))
        elif k % 4 == 2:
            variants.append(dict(filter_type="highpass", cutoff=500.0 + 400.0 * k))
        else:
            variants.append(dict(cutoff=4000.0 + 1500.0 * k))
    bank = with_per_stream_filters(pipe, variants)

    rng = np.random.default_rng(0)
    sig = (rng.standard_normal((args.streams, cfg.blocksize * args.blocks))
           * 0.3).astype(np.float32)
    t0 = time.perf_counter()
    _, out = pipe.process_signal(bank, pipe.init_state(), sig)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    audio = sig.size / cfg.samplerate
    print(f"{args.streams} streams × {args.blocks} blocks ({device}), each "
          f"with its own kernel: {audio / dt:,.0f}× realtime")
    for k in (0, min(2, args.streams - 1), min(3, args.streams - 1)):
        print(f"  stream {k} ({variants[k]}): out rms {out[k].std():.4f}")

    # the 'td_mxu' banked path: designs fill whole batch tiles (≥ 8 rows),
    # so this runs two designs over tile-aligned halves
    if args.streams >= 16 and args.streams % 16 == 0:
        tpipe = Pipeline(dataclasses.replace(cfg, conv_strategy="td_mxu"),
                         device)
        half = args.streams // 2
        tbank = with_per_stream_filters(
            tpipe, [dict(cutoff=4000.0)] * half + [dict(cutoff=15000.0)] * half)
        t0 = time.perf_counter()
        _, tout = tpipe.process_signal(tbank, tpipe.init_state(), sig)
        tout = tout.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"td_mxu banked (2 designs × {half} streams): "
              f"{audio / dt:,.0f}× realtime; "
              f"rms lo-cut {tout[0].std():.4f} vs hi-cut {tout[-1].std():.4f}")

        # stream→tile packing: the same two designs strictly interleaved
        # (un-tileable as given); pack=True sorts them into device order
        # and the outputs return in caller order
        pbank, pk = with_per_stream_filters(
            tpipe, [dict(cutoff=4000.0 if i % 2 == 0 else 15000.0)
                    for i in range(args.streams)], pack=True)
        _, pout = tpipe.process_signal(pbank, tpipe.init_state(),
                                       pk.pack(sig))
        pout = pk.unpack(pout.cpu().numpy())
        print(f"packed interleaved designs: even-row rms {pout[0].std():.4f}"
              f" (lo-cut) vs odd-row {pout[1].std():.4f} (hi-cut)")

    # per-stream AGC policy banks: one batch, two AGC targets
    acfg = dataclasses.replace(
        cfg, blocksize=2048, batch=max(2, args.streams),
        agc_enabled=True, agc_mode="fast", agc_window_size=256,
        conv_strategy="td_mxu")
    apipe = Pipeline(acfg, device)
    aparams = apipe.device_params(PipelineParams.design(apipe.cfg))
    half = acfg.batch // 2
    aparams = with_per_stream_agc(
        apipe, aparams,
        target_level=np.r_[np.full(half, 0.05),
                           np.full(acfg.batch - half, 0.3)])
    quiet = (np.random.default_rng(1).standard_normal(
        (acfg.batch, acfg.blocksize)) * 0.01).astype(np.float32)
    _, y = apipe.step(aparams, apipe.init_state(), quiet)
    y = y.cpu().numpy()
    print(f"per-stream AGC targets 0.05 vs 0.30 on quiet input: "
          f"out rms {y[:half].std():.4f} vs {y[half:].std():.4f}")


if __name__ == "__main__":
    main()
