"""Multiband-EQ engine: the `stream_process_EQ.py` /
`stream_process_EQ_GUI.py` analog (C6/C7), the counterpart of
`examples/eq_stream.py`.

The reference's 3-band inline variant (`stream_process_EQ.py:33-37`: bass
1.0×, mid 1.2×, treble 1.5×) and the GUI's 9-band variant
(`stream_process_EQ_GUI.py:87-90`) are both gain vectors here: the EQ bank
folds into the fused frequency response either way.

Run: python -m afp_tpu_torch.examples.eq_stream [--bands 9|3]
"""
import argparse
import dataclasses
import os

import numpy as np

from afp_tpu_torch.engine import EQBand, StreamConfig, StreamEngine
from afp_tpu_torch.runtime.devices import torch_device
from afp_tpu_torch.ui import EqualizerController
from afp_tpu_torch.viz import matplotlib_available

#: the 3-band table of `stream_process_EQ.py:33-37`
THREE_BAND = (
    EQBand("Bass", 60.0, 250.0, 1.0),
    EQBand("Mid", 500.0, 2000.0, 1.2),
    EQBand("Treble", 4000.0, 16000.0, 1.5),
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", type=int, choices=(3, 9), default=9)
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--out-dir", default="build/examples")
    args = ap.parse_args()
    device = torch_device("eq_stream")

    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=129,
        batch=args.streams, cutoff=14000.0, eq_enabled=True,
        agc_enabled=False, dither_kind="tpdf", downsample_mode="resample",
        output_clip=None,
    )
    if args.bands == 3:
        cfg = dataclasses.replace(cfg, eq_bands=THREE_BAND)
    ctl = EqualizerController(StreamEngine(cfg, device=device))
    print(f"{args.bands}-band EQ ({device}), gains: {ctl.get_gains()}")

    rng = np.random.default_rng(1)
    sig = (0.2 * rng.standard_normal((cfg.batch, cfg.blocksize * 20))
           ).astype(np.float32)
    out1 = ctl.engine.process_signal(sig[:, : cfg.blocksize * 10])

    # live gain change: glitch-free, no rebuild (the apply_changes path)
    if args.bands == 9:
        ctl.set_gains([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0])  # treble boost
    else:
        ctl.set_gains([1.5, 1.0, 0.5])
    out2 = ctl.engine.process_signal(sig[:, cfg.blocksize * 10:])
    print("output rms before/after gain change:",
          float(np.std(out1)), float(np.std(out2)))
    print(f"aggregate xRT (busy): {ctl.engine.metrics.xrt_busy(cfg.samplerate):,.0f}")
    if matplotlib_available():
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, "eq_response.png")
        ctl.plot_response(save_path=path)
        print(f"Response plot: {path}")
    else:
        print("matplotlib is not installed: no response plot")


if __name__ == "__main__":
    main()
