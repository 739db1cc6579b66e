"""Baseline streaming engine: the `stream_process.py` analog (C5), the
counterpart of `examples/baseline_stream.py`.

The reference's operating point (`stream_process.py:19-30`): fs 44.1 kHz,
4× upsample, block 4096, 301-tap hamming lowpass at 11 kHz, dither,
last-good fallback, run as a batch of `--streams` concurrent channels
under the simulated-clock stream; throughput and the response plot
are reported at the end.

Run: python -m afp_tpu_torch.examples.baseline_stream [--streams 64] [--blocks 50]
"""
import argparse
import os

import numpy as np

from afp_tpu_torch.engine import PipelineParams, StreamConfig, StreamEngine
from afp_tpu_torch.runtime import SimulatedStream
from afp_tpu_torch.runtime.devices import torch_device
from afp_tpu_torch.viz import matplotlib_available, plot_filter_response


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=50)
    ap.add_argument("--realtime", action="store_true",
                    help="pace at the real block rate (default: free-run)")
    ap.add_argument("--out-dir", default="build/examples")
    args = ap.parse_args()
    device = torch_device("baseline_stream")

    cfg = StreamConfig(
        samplerate=44100,
        blocksize=4096,
        upsample_factor=4,
        numtaps=301,
        batch=args.streams,
        filter_type="lowpass",
        cutoff=11000.0,
        window_type="hamming",
        eq_enabled=False,
        agc_enabled=False,
        downsample_mode="decimate",
        dither_kind="tpdf",
        output_clip=None,
    )
    engine = StreamEngine(cfg, device=device)
    print(f"Starting DSP processing with {cfg.upsample_factor}x upsampling "
          f"({device})...")
    print(f"Streams: {cfg.batch}  block: {cfg.blocksize}  "
          f"upsampled rate: {cfg.upsampled_rate} Hz")

    # response plot of the main filter (the reference plots at startup,
    # `stream_process.py:43`)
    if matplotlib_available():
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "baseline_response.png")
        design = PipelineParams.design(engine.cfg)
        plot_filter_response(design.main_taps, fs=cfg.upsampled_rate,
                             filter_type=cfg.filter_type, save_path=path)
        print(f"Response plot: {path}")
    else:
        print("matplotlib is not installed: no response plot")

    rng = np.random.default_rng(0)
    t = np.arange(cfg.blocksize) / cfg.samplerate

    def source(i):
        tone = 0.3 * np.sin(2 * np.pi * 440 * (t + i * cfg.blocksize / cfg.samplerate))
        noise = 0.01 * rng.standard_normal((cfg.batch, cfg.blocksize))
        return (tone[None, :] + noise).astype(np.float32)

    stream = SimulatedStream(engine, source=source, realtime=args.realtime)
    snap = stream.run(args.blocks)
    print("metrics:", snap)
    print(f"aggregate xRT (busy): {engine.metrics.xrt_busy(cfg.samplerate):,.0f}")


if __name__ == "__main__":
    main()
