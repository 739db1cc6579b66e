"""Stateful-OLA engine with presets: the `stream_process_GUI_Presets.py`
analog (C9), the counterpart of `examples/presets_stream.py`.

The preset system (save/load/delete, excluding samplerate/blocksize,
`Presets.py:153-195`), validated config (`:358-398`), and engine-state
checkpointing with a resume that equals the uninterrupted stream.

Run: python -m afp_tpu_torch.examples.presets_stream [--out-dir build/examples]
"""
import argparse
import os

import numpy as np

from afp_tpu_torch.engine import StreamConfig, StreamEngine
from afp_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from afp_tpu_torch.runtime.devices import torch_device
from afp_tpu_torch.ui import EqualizerController


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="build/examples")
    args = ap.parse_args()
    device = torch_device("presets_stream")
    os.makedirs(args.out_dir, exist_ok=True)
    store = os.path.join(args.out_dir, "presets.json")
    if os.path.exists(store):
        os.remove(store)

    cfg = StreamConfig(
        samplerate=44100, blocksize=1024, upsample_factor=1, numtaps=129,
        batch=4, cutoff=14000.0, eq_enabled=True, agc_enabled=False,
        dither_kind="off", downsample_mode="resample", output_clip=None,
    )
    ctl = EqualizerController(StreamEngine(cfg, device=device),
                              preset_path=store)

    # save two presets, flip between them
    ctl.set_gains([2.0] * 3 + [1.0] * 6)
    ctl.save_preset("bass boost")
    ctl.set_gains([1.0] * 6 + [2.0] * 3)
    ctl.save_preset("treble boost")
    print("presets:", ctl.preset_names)

    ctl.load_preset("bass boost")
    print("loaded 'bass boost', gains:", ctl.get_gains())

    # config validation clamps (the Presets-generation rules)
    ctl.set_field(numtaps=5000)
    ctl.apply_changes()
    print("clamped: numtaps", ctl.engine.cfg.numtaps, "(requested 5000)")
    ctl.set_field(numtaps=129)
    ctl.apply_changes()

    # process, checkpoint mid-stream, resume bit for bit
    rng = np.random.default_rng(3)
    sig = (0.2 * rng.standard_normal((4, 1024 * 8))).astype(np.float32)
    ctl.engine.process_signal(sig[:, : 1024 * 4])
    ck = os.path.join(args.out_dir, "presets_stream.npz")
    save_checkpoint(ck, ctl.engine)
    resumed = load_checkpoint(ck, device=device)
    a = ctl.engine.process_signal(sig[:, 1024 * 4:])
    b = resumed.process_signal(sig[:, 1024 * 4:])
    print("resume max diff:", float(np.max(np.abs(a - b))))

    ctl.delete_preset("treble boost")
    print("after delete:", ctl.preset_names)


if __name__ == "__main__":
    main()
