"""L4 visualization of the port (counterpart of `afp_tpu/viz/`): response
plots and waterfall rendering, numpy and matplotlib only.  matplotlib is
imported inside the drawing functions, so the package imports without it;
:func:`matplotlib_available` says whether a figure can be drawn."""
import importlib.util

from .plot_filter import ResponseData, compute_response, plot_filter_response
from .waterfall import plot_waterfall

__all__ = ["plot_filter_response", "plot_waterfall", "ResponseData",
           "compute_response", "matplotlib_available"]


def matplotlib_available() -> bool:
    """True when matplotlib is installed (the plots need it; the arrays
    they draw do not)."""
    return importlib.util.find_spec("matplotlib") is not None
