"""Kernel (tensor) parallelism: one very long FIR sharded over a mesh, the
counterpart of `examples/long_kernel_parallel.py`.

Room-correction and convolution-reverb kernels run to 10⁵–10⁶ taps.
`KernelParallelConv` splits the tap axis over the mesh: each shard
convolves the same stream against its chunk (a D×-shorter FFT) and one sum
per block reassembles the exact full-kernel output
(`afp_tpu_torch/parallel/kp.py`).

Run: python -m afp_tpu_torch.examples.long_kernel_parallel [--taps 50000] [--block 4096] [--devices 8]

The mesh is `--devices` shards on the card (all on one card), or on the
CPU under ``AFP_FORCE_CPU=1``.
"""
import argparse

import numpy as np
import torch

from afp_tpu_torch.ops.convolve import OverlapSave, next_pow2
from afp_tpu_torch.parallel import KernelParallelConv, make_mesh
from afp_tpu_torch.runtime.devices import torch_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--taps", type=int, default=50000)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args()
    device = torch.device(torch_device("long_kernel_parallel"))

    rng = np.random.default_rng(0)
    h = (rng.standard_normal(args.taps) / np.sqrt(args.taps)).astype(np.float32)
    mesh = make_mesh(args.devices, axis_names=("kernel",),
                     devices=[device] * args.devices)
    kp = KernelParallelConv(h, block=args.block, mesh=mesh, batch=2)
    full_fft = next_pow2(args.block + args.taps - 1)
    print(f"{args.taps}-tap kernel over {args.devices} devices: per-device "
          f"FFT {kp.nfft} vs single-device {full_fft} "
          f"({full_fft // kp.nfft}× smaller)")

    ref = OverlapSave.init(h, block=args.block, batch_shape=(2,), device=device)
    st = kp.init_state()
    worst = 0.0
    for _ in range(8):
        blk = torch.as_tensor((rng.standard_normal((2, args.block)) * 0.3)
                              .astype(np.float32), device=device)
        st, y = kp.step(st, blk)
        ref, gold = ref.process(blk)
        worst = max(worst, float((y - gold).abs().max()
                                 / (gold.abs().max() + 1e-30)))
    print(f"sharded vs full-kernel stream: worst rel err "
          f"{20 * np.log10(worst + 1e-300):.1f} dB over 8 blocks")


if __name__ == "__main__":
    main()
