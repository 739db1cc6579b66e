"""L1 filter-design layer (cold path, host float64) — the port's numpy-only
copy of `afp_tpu/design/`, so the port imports nothing of `afp_tpu`.  Results
are bit-identical to the reference's (`tests/test_torch_pipeline.py`).

Covers the reference's design stack: `fir_filter.py` → `filter_methods.py` →
`window_types.py`, plus working Remez and minimum-phase conversion.
"""
from .api import create_fir_filter, design_fir_filter, get_window, to_minimum_phase
from .firwin import FILTER_TYPES, design_windowed_sinc
from .freqz import freqz, freqz_torch
from .minphase import is_symmetric, minimum_phase, normalize_peak
from .remez import RemezError, remez
from .windows import WINDOW_NAMES
from . import windows

__all__ = [
    "create_fir_filter",
    "design_fir_filter",
    "get_window",
    "to_minimum_phase",
    "design_windowed_sinc",
    "FILTER_TYPES",
    "freqz",
    "freqz_torch",
    "minimum_phase",
    "is_symmetric",
    "normalize_peak",
    "remez",
    "RemezError",
    "WINDOW_NAMES",
    "windows",
]
