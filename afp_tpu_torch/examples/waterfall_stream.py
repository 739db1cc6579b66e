"""Waterfall engine: the `stream_process_GUI_Waterfall.py` analog (C10),
the counterpart of `examples/waterfall_stream.py`.

Each output block's Hann-windowed spectrum is taken on the engine's device
and pushed into the 50-deep history ring there (`Waterfall.py:112,
471-478`), then the ring is rendered as a 3-D surface PNG (`:312-339`).

Run: python -m afp_tpu_torch.examples.waterfall_stream [--out-dir build/examples]
"""
import argparse
import os

import numpy as np
import torch

from afp_tpu_torch.engine import StreamConfig, StreamEngine
from afp_tpu_torch.ops.spectrum import (spectrum_db, spectrum_freqs,
                                        spectrum_peak, waterfall_init,
                                        waterfall_push)
from afp_tpu_torch.runtime.devices import torch_device
from afp_tpu_torch.viz import matplotlib_available, plot_waterfall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="build/examples")
    args = ap.parse_args()
    device = torch_device("waterfall_stream")

    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=1, numtaps=129,
        batch=1, cutoff=14000.0, eq_enabled=True, agc_enabled=False,
        dither_kind="off", downsample_mode="resample", output_clip=None,
    )
    engine = StreamEngine(cfg, device=device)
    freqs = spectrum_freqs(cfg.blocksize, cfg.samplerate)
    ring = waterfall_init(len(freqs), device=device)

    rng = np.random.default_rng(4)
    t0 = np.arange(cfg.blocksize) / cfg.samplerate
    for i in range(60):
        f = 500 + 50 * i  # sweeping tone
        block = (0.3 * np.sin(2 * np.pi * f * (t0 + i * cfg.blocksize / cfg.samplerate))
                 + 0.01 * rng.standard_normal(cfg.blocksize)).astype(np.float32)
        out = engine.process_block(block[None, :])
        db = spectrum_db(torch.as_tensor(out[0], device=device))
        ring = waterfall_push(ring, db)
        if i % 20 == 0:
            pf, pl = spectrum_peak(db, freqs)
            print(f"block {i}: peak {float(pf):.0f} Hz @ {float(pl):.1f} dB")

    if matplotlib_available():
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "waterfall.png")
        plot_waterfall(ring.cpu().numpy(), freqs,
                       block_seconds=cfg.blocksize / cfg.samplerate,
                       save_path=path)
        print(f"Waterfall: {path}")
    else:
        print("matplotlib is not installed: no waterfall plot")


if __name__ == "__main__":
    main()
