"""Live duplex audio through the engine on the card: the
`stream_process.py` analog with a real sound card
(`stream_process.py:128-139`), the counterpart of
`examples/live_audio.py`.

Needs the optional sounddevice/PortAudio backend; without it this prints
the compute devices and exits 0 (`baseline_stream` is the hardware-free
path).

Run: python -m afp_tpu_torch.examples.live_audio [--device-in 1 --device-out 0] [--seconds 10]
"""
import argparse
import time

from afp_tpu_torch.engine import StreamConfig, StreamEngine
from afp_tpu_torch.runtime import AudioStream, audio_available
from afp_tpu_torch.runtime.devices import format_devices, torch_device


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-in", type=int, default=None)
    ap.add_argument("--device-out", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cutoff", type=float, default=11000.0)
    ap.add_argument("--numtaps", type=int, default=301)
    args = ap.parse_args()
    device = torch_device("live_audio")

    if not audio_available():
        print("No PortAudio backend here: live audio unavailable.")
        print("Use `python -m afp_tpu_torch.examples.baseline_stream` "
              "(simulated clock) instead.")
        print("\nCompute devices:\n" + format_devices(device))
        return 0

    import sounddevice as sd

    print(sd.query_devices())
    cfg = StreamConfig(
        samplerate=44100, blocksize=2048, upsample_factor=2,
        numtaps=args.numtaps, cutoff=args.cutoff, batch=1,
        eq_enabled=True, agc_enabled=False, dither_kind="tpdf",
    )
    engine = StreamEngine(cfg, device=device)
    audio_device = None
    if args.device_in is not None or args.device_out is not None:
        audio_device = (args.device_in, args.device_out)
    with AudioStream(engine, device=audio_device) as stream:
        t_end = time.time() + args.seconds
        while time.time() < t_end:
            time.sleep(1.0)
            m = engine.metrics
            print(f"blocks {m.blocks_processed}  underruns {m.underruns}  "
                  f"cpu_load {stream.cpu_load:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
