"""Host runtime of the port (counterpart of `afp_tpu/runtime/`): device-ring
serving, the native host ring and pacer, the block dispatcher and simulated
stream, the optional sound-card bridge, the block framer, the host ASRC
frontend and device enumeration."""
from .asrc import AsrcFrontend
from .audio import AudioStream, audio_available
from .devices import format_devices, list_devices
from .dispatcher import BlockDispatcher, FaultInjector, SimulatedStream
from .framer import BlockFramer
from .host import BlockRing, Pacer, native_available
from .serving import RingServer

__all__ = [
    "AsrcFrontend",
    "AudioStream", "audio_available",
    "BlockFramer",
    "BlockRing", "Pacer", "native_available",
    "BlockDispatcher", "SimulatedStream", "FaultInjector",
    "RingServer",
    "list_devices", "format_devices",
]
