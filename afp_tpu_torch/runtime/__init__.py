"""Host runtime of the port (counterpart of `afp_tpu/runtime/`): device-ring
serving, the native host ring and pacer, the block dispatcher and simulated
stream, the optional sound-card bridge, the block framer and device
enumeration.  The host ASRC frontend is ROADMAP.md §1 item 10, through item
5's frontend."""
from .audio import AudioStream, audio_available
from .devices import format_devices, list_devices
from .dispatcher import BlockDispatcher, FaultInjector, SimulatedStream
from .framer import BlockFramer
from .host import BlockRing, Pacer, native_available
from .serving import RingServer

__all__ = [
    "AudioStream", "audio_available",
    "BlockFramer",
    "BlockRing", "Pacer", "native_available",
    "BlockDispatcher", "SimulatedStream", "FaultInjector",
    "RingServer",
    "list_devices", "format_devices",
]
