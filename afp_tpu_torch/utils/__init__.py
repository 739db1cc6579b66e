"""Host utilities of the port: logging (copy of `afp_tpu/utils/log.py`)."""
from .log import RateLimited, get_logger

__all__ = ["RateLimited", "get_logger"]
