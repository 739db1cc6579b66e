"""Optional tkinter front end over the headless controller (counterpart
of `afp_tpu/ui/gui.py`).

Re-creates the control surface of the reference's `EqualizerGUI` family
(`stream_process_EQ_GUI.py:115-344`): 9 EQ gain sliders,
cutoff/taps/window/type fields, Apply / Reset buttons, preset combobox with
Save/Load/Delete (`stream_process_GUI_Presets.py:143-195`), and an embedded
response plot.  All logic lives in
:class:`~afp_tpu_torch.ui.controller.EqualizerController`; this module is a
thin view and imports tkinter only inside its functions — the engine never
depends on a display.
"""
from __future__ import annotations

from typing import Optional

from .controller import EqualizerController

__all__ = ["EqualizerGUI", "gui_available"]


def gui_available() -> bool:
    try:
        import tkinter as tk

        root = tk.Tk()
        root.destroy()
        return True
    except Exception:
        return False


class EqualizerGUI:
    """tkinter view over an :class:`EqualizerController`."""

    def __init__(self, controller: Optional[EqualizerController] = None):
        import tkinter as tk
        from tkinter import ttk

        self.ctl = controller or EqualizerController()
        self.root = tk.Tk()
        self.root.title("afp_tpu_torch Real-Time Audio Equalizer")

        cfg = self.ctl.engine.cfg

        # --- EQ sliders ---
        eq_frame = ttk.LabelFrame(self.root, text="Equalizer")
        eq_frame.grid(row=0, column=0, padx=8, pady=4, sticky="nsew")
        self._gain_vars = []
        for i, band in enumerate(cfg.eq_bands):
            var = tk.DoubleVar(value=band.gain)
            self._gain_vars.append(var)
            ttk.Label(eq_frame, text=f"{band.name}\n{band.low:.0f}-{band.high:.0f} Hz").grid(
                row=0, column=i, padx=2
            )
            tk.Scale(
                eq_frame, from_=4.0, to=0.0, resolution=0.1, variable=var,
                command=lambda _v, idx=i: self._on_gain(idx), length=140,
            ).grid(row=1, column=i, padx=2)

        # --- filter fields ---
        f_frame = ttk.LabelFrame(self.root, text="Main Filter")
        f_frame.grid(row=1, column=0, padx=8, pady=4, sticky="nsew")
        self._fields = {}
        for col, (label, key, value) in enumerate([
            ("Cutoff (Hz)", "cutoff", cfg.cutoff if not isinstance(cfg.cutoff, tuple) else 14000.0),
            ("Taps", "numtaps", cfg.numtaps),
            ("Samplerate", "samplerate", cfg.samplerate),
            ("Upsample", "upsample_factor", cfg.upsample_factor),
            ("Blocksize", "blocksize", cfg.blocksize),
        ]):
            ttk.Label(f_frame, text=label).grid(row=0, column=col, padx=4)
            var = tk.StringVar(value=str(value))
            self._fields[key] = var
            ttk.Entry(f_frame, textvariable=var, width=9).grid(row=1, column=col, padx=4)
        from ..design.windows import WINDOW_NAMES

        ttk.Label(f_frame, text="Window").grid(row=0, column=5, padx=4)
        self._window_var = tk.StringVar(value=cfg.window_type)
        ttk.Combobox(f_frame, textvariable=self._window_var,
                     values=list(WINDOW_NAMES), width=12).grid(row=1, column=5)
        ttk.Label(f_frame, text="Type").grid(row=0, column=6, padx=4)
        self._type_var = tk.StringVar(value=cfg.filter_type)
        ttk.Combobox(f_frame, textvariable=self._type_var,
                     values=["lowpass", "highpass", "bandpass", "bandstop"],
                     width=10).grid(row=1, column=6)
        self._minphase_var = tk.BooleanVar(value=cfg.min_phase)
        ttk.Checkbutton(f_frame, text="Min phase",
                        variable=self._minphase_var).grid(row=1, column=7)

        btns = ttk.Frame(self.root)
        btns.grid(row=2, column=0, pady=4)
        ttk.Button(btns, text="Apply", command=self.apply_changes).grid(row=0, column=0, padx=4)
        ttk.Button(btns, text="Reset to Defaults", command=self.reset).grid(row=0, column=1, padx=4)
        self._rate_label = ttk.Label(btns, text=f"{self.ctl.upsampled_rate} Hz")
        self._rate_label.grid(row=0, column=2, padx=8)
        # live stream control + metrics readout (the reference runs the
        # audio thread alongside mainloop, `stream_process_EQ_GUI.py:486-494`;
        # cpu_load watchdog `:454-457`)
        self._stream_btn = ttk.Button(btns, text="Start Stream",
                                      command=self.toggle_stream)
        self._stream_btn.grid(row=0, column=3, padx=4)
        self._metrics_label = ttk.Label(btns, text="stopped")
        self._metrics_label.grid(row=0, column=4, padx=8)

        # --- presets ---
        p_frame = ttk.LabelFrame(self.root, text="Presets")
        p_frame.grid(row=0, column=1, rowspan=3, padx=8, pady=4, sticky="ns")
        self._preset_var = tk.StringVar(value="")
        self._preset_box = ttk.Combobox(p_frame, textvariable=self._preset_var,
                                        values=self.ctl.preset_names, width=14)
        self._preset_box.pack(padx=4, pady=4)
        ttk.Button(p_frame, text="Save", command=self._save_preset).pack(pady=2)
        ttk.Button(p_frame, text="Load", command=self._load_preset).pack(pady=2)
        ttk.Button(p_frame, text="Delete", command=self._delete_preset).pack(pady=2)
        self._spectrum_var = tk.BooleanVar(value=self.ctl.show_spectrum)
        ttk.Checkbutton(p_frame, text="Show Spectrum",
                        variable=self._spectrum_var,
                        command=self._toggle_spectrum).pack(pady=2)
        ttk.Button(p_frame, text="Waterfall",
                   command=self.open_waterfall).pack(pady=2)

        # --- embedded response canvas (the reference GUIs embed matplotlib,
        # `stream_process_EQ_GUI.py:263-278, 390-418`) ---
        self._canvas = None
        self._canvas_frame = ttk.LabelFrame(self.root, text="Filter Response")
        self._canvas_frame.grid(row=3, column=0, columnspan=2, padx=8, pady=4,
                                sticky="nsew")
        self.draw_response()
        self.root.protocol("WM_DELETE_WINDOW", self._on_close)

    def _on_close(self) -> None:
        self.ctl.stop_stream()
        self.root.destroy()

    # --- handlers (all delegate to the controller) ---

    def _on_gain(self, idx: int) -> None:
        self.ctl.set_gain(idx, self._gain_vars[idx].get())

    def toggle_stream(self) -> None:
        """Start/Stop the controller-owned live stream: a real AudioStream
        when PortAudio is present, else the paced SimulatedStream — with the
        periodic spectrum feed and a metrics readout polled via `after`."""
        try:
            if self.ctl.streaming:
                self.ctl.stop_stream()
                self._stream_btn.configure(text="Start Stream")
                self._metrics_label.configure(text="stopped")
                return
            from ..runtime.audio import audio_available

            self.ctl.start_stream(use_audio=audio_available(), realtime=True)
            self._stream_btn.configure(text="Stop Stream")
            self._poll_metrics()
        except Exception as e:
            print(f"Stream control error: {e}")

    def _poll_metrics(self) -> None:
        """1 Hz metrics + spectrum refresh while streaming (the reference's
        monitor loop, `stream_process_EQ_GUI.py:454-457`)."""
        if not self.ctl.streaming:
            return
        snap = self.ctl.metrics_snapshot()
        self._metrics_label.configure(
            text=f"blocks {snap['blocks']}  xRT {snap['xrt_busy']}  "
                 f"underruns {snap['underruns']}  drops {snap['drops']}")
        if self.ctl.show_spectrum and self.ctl.spectrum_peak is not None:
            self.draw_response()  # live overlay refresh
        self.root.after(1000, self._poll_metrics)

    def _toggle_spectrum(self) -> None:
        self.ctl.show_spectrum = bool(self._spectrum_var.get())

    def draw_response(self) -> None:
        """(Re)render the controller's response figure into the embedded
        canvas — spectrum overlay included when one was captured."""
        try:
            from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg

            fig = self.ctl.plot_response()
            fig.set_size_inches(9, 6)
            if self._canvas is not None:
                # close the superseded figure too — pyplot keeps every
                # figure registered, so Apply-spam would leak MBs each
                import matplotlib.pyplot as plt

                plt.close(self._canvas.figure)
                self._canvas.get_tk_widget().destroy()
            self._canvas = FigureCanvasTkAgg(fig, master=self._canvas_frame)
            self._canvas.draw()
            self._canvas.get_tk_widget().pack(fill="both", expand=True)
        except Exception as e:  # canvas is best-effort; controls must survive
            print(f"Response canvas unavailable: {e}")

    def open_waterfall(self) -> None:
        """Waterfall window (3-D spectrum history,
        `stream_process_GUI_Waterfall.py:312-339`)."""
        import tkinter as tk

        try:
            from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg

            fig = self.ctl.waterfall()
            top = tk.Toplevel(self.root)
            top.title("Spectrum Waterfall")
            canvas = FigureCanvasTkAgg(fig, master=top)
            canvas.draw()
            canvas.get_tk_widget().pack(fill="both", expand=True)
        except Exception as e:
            print(f"Waterfall unavailable: {e}")

    def apply_changes(self) -> None:
        try:
            kw = dict(
                cutoff=float(self._fields["cutoff"].get()),
                numtaps=int(self._fields["numtaps"].get()),
                samplerate=int(self._fields["samplerate"].get()),
                upsample_factor=int(self._fields["upsample_factor"].get()),
                blocksize=int(self._fields["blocksize"].get()),
                window_type=self._window_var.get(),
                filter_type=self._type_var.get(),
                min_phase=self._minphase_var.get(),
            )
            self.ctl.set_field(**kw)
            self.ctl.apply_changes()
            self._rate_label.configure(text=f"{self.ctl.upsampled_rate} Hz")
            self.draw_response()
        except Exception as e:
            print(f"Error applying changes: {e}")

    def reset(self) -> None:
        self.ctl.reset_to_defaults()
        for var, band in zip(self._gain_vars, self.ctl.engine.cfg.eq_bands):
            var.set(band.gain)
        self._rate_label.configure(text=f"{self.ctl.upsampled_rate} Hz")
        self.draw_response()

    def _save_preset(self) -> None:
        name = self._preset_var.get()
        if name:
            self.ctl.save_preset(name)
            self._preset_box.configure(values=self.ctl.preset_names)

    def _load_preset(self) -> None:
        name = self._preset_var.get()
        if name in self.ctl.preset_names:
            self.ctl.load_preset(name)
            for var, g in zip(self._gain_vars, self.ctl.get_gains()):
                var.set(g)

    def _delete_preset(self) -> None:
        self.ctl.delete_preset(self._preset_var.get())
        self._preset_box.configure(values=self.ctl.preset_names)
        self._preset_var.set("")

    def mainloop(self) -> None:
        self.root.mainloop()


if __name__ == "__main__":
    EqualizerGUI().mainloop()
