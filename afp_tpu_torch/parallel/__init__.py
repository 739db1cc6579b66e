"""The parallel layer (counterpart of `afp_tpu/parallel/`): stream-axis
data parallelism, time-axis halo exchange and long-signal filtering,
kernel parallelism for long FIRs, and the mesh.

One Python process drives every shard of a mesh (the reference's single
controller); the collectives are explicit device-to-device copies and
sums (`collectives.py`).  `afp_tpu`'s ``P`` and ``NamedSharding`` have no
counterpart: the shard layout is structural in each entry point.
"""
from .dp import RingLayout, ShardedPipeline, ShardedState, shard_seed
from .halo import halo_convolve, halo_convolve_sharded
from .kp import KernelParallelConv
from .long import filter_long_signal
from .mesh import Mesh, make_mesh, make_multislice_mesh

__all__ = [
    "ShardedPipeline",
    "ShardedState",
    "RingLayout",
    "shard_seed",
    "halo_convolve",
    "halo_convolve_sharded",
    "KernelParallelConv",
    "filter_long_signal",
    "make_mesh",
    "make_multislice_mesh",
    "Mesh",
]
