"""Waterfall spectrum rendering (L4; the port's copy of
`afp_tpu/viz/waterfall.py`).

The reference's 3-D time×frequency×dB surface of the last 50 block
spectra (`stream_process_GUI_Waterfall.py:312-339, 471-478`), rendered
headless from a spectrum ring (:mod:`afp_tpu_torch.ops.spectrum`);
matplotlib is imported only when a figure is drawn.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["plot_waterfall"]


def plot_waterfall(ring: np.ndarray, freqs: np.ndarray,
                   block_seconds: float = 0.046,
                   save_path: Optional[str] = None,
                   db_floor: float = -120.0):
    """Render a [depth, n_bins] spectrum-history ring as a 3-D surface.

    `ring` newest-last (the :func:`afp_tpu_torch.ops.spectrum.waterfall_push`
    layout); `freqs` in Hz.  Returns the matplotlib Figure.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401 (registers 3d proj)

    ring = np.asarray(ring, dtype=np.float64)
    depth, n_bins = ring.shape
    t = np.arange(depth) * block_seconds
    F, T = np.meshgrid(np.asarray(freqs), t)

    fig = plt.figure(figsize=(10, 7))
    ax = fig.add_subplot(111, projection="3d")
    Z = np.clip(ring, db_floor, None)
    ax.plot_surface(T, F, Z, cmap="viridis", linewidth=0, antialiased=False)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (Hz)")
    ax.set_zlabel("Magnitude (dB)")
    ax.set_title("Waterfall Spectrum")
    if save_path:
        fig.savefig(save_path, dpi=100)
    return fig
