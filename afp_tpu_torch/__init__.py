"""afp_tpu_torch — the filter chain of `afp_tpu` in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (H100, sm_90a).

The package mirrors `afp_tpu`'s layout: each module sits at the path of its
counterpart there.  It imports torch and numpy, never jax and nothing of
`afp_tpu`: the numpy-only host code it needs (`design/`, `utils/`, the
framer, presets) is copied, and the tests hold the copies bit-exact to the
reference.  The native host ring (`native/host_ring.cpp`) is shared: the port builds it
with g++ into `build/afp_tpu_torch/`.

Layers:
  design/    L1 filter design (host float64, numpy)
  engine/    config, pipeline (fused and literal multirate chains, device
             ASRC), StreamEngine, metrics, presets, checkpoints
  ops/       resampling and FFT convolution, the AGC, plain dither noise,
             CUDA kernels (ops/cuda)
  runtime/   RingServer (device-ring serving), the native host ring and
             pacer, the block dispatcher and simulated stream, the sound-card
             bridge, the block framer, the ASRC frontend, device enumeration
  utils/     WAV I/O, logging
  csrc/      CUDA C++ sources, built with nvcc at first use
  cli.py     ``python -m afp_tpu_torch process|batch|stream|preset|devices|design``

Subpackages are imported lazily, so `import afp_tpu_torch` stays cheap.
"""

__version__ = "0.1.0"

_LAZY = ("design", "engine", "ops", "runtime", "utils")

__all__ = ["__version__", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
