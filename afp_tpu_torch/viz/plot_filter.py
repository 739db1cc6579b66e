"""Offline filter-response plots (L4; the port's copy of
`afp_tpu/viz/plot_filter.py`, numpy and matplotlib only).

The reference's response figure (`plot_filter.py:11-132`): magnitude (dB),
phase and centered impulse panels, with adaptive log/linear frequency
scaling, rendered headless with Agg over the port's numpy `freqz`.
:func:`compute_response` holds the panel data without matplotlib, which
is imported only when a figure is drawn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..design.freqz import freqz

__all__ = ["plot_filter_response", "ResponseData", "compute_response"]

#: grid resolution of the response evaluation (matches the design-path freqz)
WORN = 8000
#: max samples shown in the impulse panel
IMPULSE_SPAN = 200
#: dB floor of the magnitude panel
DB_FLOOR = -120.0


@dataclass
class ResponseData:
    """Precomputed panel data — separable from rendering so headless callers
    (tests, web UIs) can consume the numbers directly."""

    freqs: np.ndarray  # Hz
    magnitude_db: np.ndarray
    phase_rad: np.ndarray  # wrapped
    taps: np.ndarray
    impulse_window: tuple  # (start, end) sample indices shown
    fs: float
    log_axis: bool

    @property
    def ticks(self):
        nyq = self.fs / 2
        if self.log_axis:
            return [t for t in (20, 100, 1000, 10000, nyq) if t <= nyq]
        return list(np.linspace(0, nyq, num=9))


def compute_response(coefficients, fs: float) -> ResponseData:
    """Evaluate everything the figure needs (no matplotlib involved)."""
    taps = np.asarray(coefficients, dtype=np.float64)
    freqs, H = freqz(taps, worN=WORN, fs=fs)
    span = min(IMPULSE_SPAN, len(taps))
    mid = len(taps) // 2
    start = max(0, mid - span // 2)
    return ResponseData(
        freqs=freqs,
        magnitude_db=20 * np.log10(np.abs(H) + 1e-8),
        phase_rad=np.angle(H),
        taps=taps,
        impulse_window=(start, min(len(taps), start + span)),
        fs=fs,
        # log axis only when the band extends past the audible range
        log_axis=fs / 2 > 20000,
    )


def _freq_panel(ax, data: ResponseData, values, color: str):
    plot = ax.semilogx if data.log_axis else ax.plot
    plot(data.freqs, values, color=color)
    ticks = data.ticks
    ax.set_xticks(ticks)
    ax.set_xticklabels([f"{int(t)}" if t >= 1 else f"{t:.1f}" for t in ticks])
    ax.set_xlim((20, data.fs / 2) if data.log_axis else (0, data.fs / 2))
    ax.grid(True, which="both", linestyle=":")


def plot_filter_response(coefficients, fs: float = 44100,
                         filter_type: Optional[str] = None,
                         save_path: Optional[str] = None,
                         show: bool = False,
                         spectrum: Optional[tuple] = None,
                         spectrum_label: str = "Output spectrum"):
    """Render the response figure; returns the matplotlib Figure.

    `save_path` writes a PNG; `show=True` attempts a non-blocking interactive
    display when a GUI backend exists.  `spectrum=(freqs_hz, db)` overlays a
    live output spectrum on the magnitude panel with a peak annotation — the
    reference GUI's observation surface
    (`stream_process_EQ_GUI.py:395-411`).  The spectrum is
    peak-normalized to 0 dB so it shares the response axis.
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    data = compute_response(coefficients, fs)

    fig, (ax_mag, ax_phase, ax_imp) = plt.subplots(
        3, 1, figsize=(12, 8), gridspec_kw={"height_ratios": [2, 1, 1]}
    )

    _freq_panel(ax_mag, data, data.magnitude_db, "C0")
    headroom = max(5.0, float(np.max(data.magnitude_db)) + 5.0)
    ax_mag.set_ylim(DB_FLOOR, headroom)
    ax_mag.set_ylabel("Magnitude (dB)")
    name = (filter_type or "FIR").capitalize()
    ax_mag.set_title(f"{name} Filter Response (Fs={fs / 1000:.1f}kHz)")

    if spectrum is not None:
        sfreqs = np.asarray(spectrum[0], dtype=np.float64)
        sdb = np.asarray(spectrum[1], dtype=np.float64)
        if sdb.ndim > 1:  # batched spectra: show the first stream
            sdb = sdb[0]
        raw_peak_db = float(np.max(sdb))
        sdb = sdb - raw_peak_db  # peak-normalize onto the response axis
        plot = ax_mag.semilogx if data.log_axis else ax_mag.plot
        lo = 1 if data.log_axis and sfreqs[0] == 0 else 0
        plot(sfreqs[lo:], sdb[lo:], color="C3", alpha=0.6,
             linewidth=0.8, label=spectrum_label)
        # peak annotation (`stream_process_EQ_GUI.py:404-409`) — search
        # the same bins the overlay draws (a DC peak at x=0 would render
        # nowhere on a semilogx axis)
        pk = lo + int(np.argmax(sdb[lo:]))
        ax_mag.plot([sfreqs[pk]], [sdb[pk]], "C3v", markersize=7)
        # annotate the PICKED bin's raw level (sdb[pk] is relative to the
        # all-bin peak; with a dominant DC bin excluded from the search,
        # quoting raw_peak_db here would pair this bin's frequency with
        # the DC bin's dB)
        ax_mag.annotate(
            f"Peak: {sfreqs[pk]:.0f} Hz ({sdb[pk] + raw_peak_db:.1f} dB)",
            xy=(sfreqs[pk], sdb[pk]), xytext=(5, 8),
            textcoords="offset points", color="C3", fontsize=9,
        )
        ax_mag.legend(loc="lower left", fontsize=8)

    _freq_panel(ax_phase, data, data.phase_rad, "C1")
    ax_phase.set_ylabel("Phase (radians)")
    ax_phase.set_xlabel("Frequency (Hz)")

    lo, hi = data.impulse_window
    marker, stems, _ = ax_imp.stem(
        np.arange(lo, hi), data.taps[lo:hi],
        linefmt="C2-", markerfmt="C2o", basefmt="C7:",
    )
    plt.setp(stems, linewidth=0.5)
    plt.setp(marker, markersize=3)
    ax_imp.set_xlim(lo, hi)
    ax_imp.set_title("Impulse Response (Centered)")
    ax_imp.set_xlabel("Samples")
    ax_imp.set_ylabel("Amplitude")
    ax_imp.grid(True, linestyle=":")

    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100)
    if show:
        plt.show(block=False)
        plt.pause(0.1)
    return fig
