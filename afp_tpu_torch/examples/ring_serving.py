"""Device-ring serving: the throughput-first production loop, the
counterpart of `examples/ring_serving.py`.

The headline operating point (1001-tap lowpass, 4× upsample folded to one
base-rate cascade, TPDF dither) served through `RingServer`: blocks land
in device input-ring slots, each dispatch advances a chunk of blocks with
the conv kernel reading and writing ring slots in place
(`Pipeline.run_ring`), and outputs drain in order while later chunks are
already queued.

Run: python -m afp_tpu_torch.examples.ring_serving [--streams 64] [--blocks 32] [--mega]

`--mega` dispatches each chunk as one kernel launch
(`Pipeline.run_ring_mega`), with the same outputs, bit for bit.
`--pcm16` serves raw int16 PCM blocks (``ingest='pcm16'``): the input
ring holds int16 and the kernel converts (n/32768, exact), halving the
ingest bytes.  `--retune` swaps the filter design mid-serve; the new bank
takes effect at the next chunk dispatch.
"""
import argparse
import dataclasses
import time

import numpy as np

from afp_tpu_torch.engine import Pipeline, StreamConfig
from afp_tpu_torch.runtime import RingServer
from afp_tpu_torch.runtime.devices import torch_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--mega", action="store_true",
                    help="one-launch dispatch per chunk (run_ring_mega)")
    ap.add_argument("--pcm16", action="store_true",
                    help="serve raw int16 PCM blocks (ingest='pcm16')")
    ap.add_argument("--retune", action="store_true",
                    help="swap the filter design mid-serve: the new bank is "
                         "designed on this thread and takes effect at the "
                         "next chunk dispatch")
    args = ap.parse_args()
    device = torch_device("ring_serving")

    cfg = StreamConfig(
        samplerate=44100,
        blocksize=4096,
        upsample_factor=4,
        numtaps=1001,
        batch=args.streams,
        filter_type="lowpass",
        cutoff=11000.0,
        window_type="hamming",
        eq_enabled=False,
        agc_enabled=False,
        downsample_mode="decimate",
        dither_kind="tpdf",
        output_clip=None,
        conv_strategy="td_mxu",
        ingest="pcm16" if args.pcm16 else "pair",
    )
    pipe = Pipeline(cfg, device)
    srv = RingServer(pipe, slots=4 * args.chunk, chunk=args.chunk,
                     mega=args.mega)

    rng = np.random.default_rng(0)
    blocks = (rng.standard_normal(
        (args.blocks, args.streams, cfg.blocksize)) * 0.3).astype(np.float32)
    if args.pcm16:
        # the pcm16 contract: the source data IS 16-bit PCM
        blocks = np.clip(np.round(blocks * 32768.0), -32768, 32767
                         ).astype(np.int16)

    # warm-up dispatch, then the timed serve
    _ = list(srv.stream(iter(blocks[: args.chunk])))
    source = iter(blocks)
    if args.retune:
        half = args.blocks // 2

        def retuning():
            for i, b in enumerate(blocks):
                if i == half:
                    srv.retune(dataclasses.replace(cfg, cutoff=6000.0))
                    print(f"retuned to 6 kHz at block {i} "
                          "(effective next chunk)")
                yield b
        source = retuning()
    peak = [0.0]
    t0 = time.time()
    m = srv.serve(source, lambda out: peak.__setitem__(
        0, max(peak[0], float(np.max(np.abs(out))))))
    print(f"served {m['blocks']} blocks x {args.streams} streams ({device}) "
          f"in {m['wall_s']:.3f}s -> {m['xrt']:.0f}x realtime "
          f"(peak out {peak[0]:.3f})")
    if m["blocks"] != args.blocks:
        raise SystemExit(f"served {m['blocks']} of {args.blocks} blocks")
    print(f"total wall (incl. warmup): {time.time() - t0:.3f}s")


if __name__ == "__main__":
    main()
