"""FFT sizing for the overlap-save path (counterpart of
`afp_tpu/ops/convolve.py:next_pow2`).  The fused 'fft' strategy runs
overlap-save with `torch.fft` inside `engine/pipeline.py`; the general
`fft_convolve`/`OverlapSave`/`OverlapAdd` ops are ROADMAP §1 item 10."""
from __future__ import annotations

__all__ = ["next_pow2"]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference FFT sizing,
    `stream_process_GUI_Presets.py:56-57`)."""
    return 1 << (int(n) - 1).bit_length()
