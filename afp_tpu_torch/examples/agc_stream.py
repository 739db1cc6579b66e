"""AGC + ASRC engine: the `stream_process_AGC.py` analog (C8), the
counterpart of `examples/agc_stream.py`.

Automatic gain control (windowed RMS → attack/release smoothing,
`stream_process_AGC.py:43-89`) behind the exact ASRC from the source rate
(`:126-129`), on the card.

Run: python -m afp_tpu_torch.examples.agc_stream [--source-rate 48000]
"""
import argparse

import numpy as np

from afp_tpu_torch.engine import StreamConfig, StreamEngine
from afp_tpu_torch.runtime.devices import torch_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source-rate", type=int, default=48000)
    ap.add_argument("--streams", type=int, default=8)
    args = ap.parse_args()
    device = torch_device("agc_stream")

    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=2, numtaps=129,
        batch=args.streams, cutoff=14000.0, eq_enabled=True,
        agc_enabled=True, agc_target_level=0.1, agc_max_gain=10.0,
        source_samplerate=args.source_rate,
        dither_kind="tpdf", downsample_mode="resample", output_clip=0.99,
    )
    engine = StreamEngine(cfg, device=device)
    print(f"ASRC {args.source_rate} → {cfg.samplerate} Hz; AGC target "
          f"{cfg.agc_target_level}, max gain {cfg.agc_max_gain} ({device})")

    rng = np.random.default_rng(2)
    # a quiet signal the AGC should bring up toward the target level
    quiet = (0.005 * rng.standard_normal((cfg.batch, cfg.blocksize * 20))
             ).astype(np.float32)
    out = engine.process_signal(quiet)
    print("input rms:", float(np.std(quiet)), "→ output rms:",
          float(np.std(out[:, cfg.blocksize * 5:])))
    if np.max(np.abs(out)) > 0.99 + 1e-6:
        raise SystemExit("output exceeds the ±0.99 clamp")
    print(f"aggregate xRT (busy): {engine.metrics.xrt_busy(cfg.samplerate):,.0f}")


if __name__ == "__main__":
    main()
