"""Host runtime of the port (counterpart of `afp_tpu/runtime/`): device-ring
serving.  The dispatcher, audio bridge, host ring and ASRC frontend are
ROADMAP.md §1 items 5 and 12."""
from .serving import RingServer

__all__ = ["RingServer"]
