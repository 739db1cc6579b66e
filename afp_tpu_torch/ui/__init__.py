"""L5 control plane of the port (counterpart of `afp_tpu/ui/`): the
headless equalizer controller; the tkinter view lives in `ui.gui`."""
from .controller import DEFAULT_CONFIG, EqualizerController

__all__ = ["EqualizerController", "DEFAULT_CONFIG"]
