"""Device meshes (counterpart of `afp_tpu/parallel/mesh.py`).

The scaling model is the reference's: concurrent audio streams are
independent, so **stream-axis data parallelism** (the ``'streams'`` axis)
is the primary mesh axis; a ``'time'`` axis shards one long signal with a
halo exchange, and a ``'kernel'`` axis shards the taps of one long FIR.

The port's mesh is its own small class, not jax's: an ndarray of
``torch.device`` objects with axis names.  One Python process drives every
entry of it (the reference's single-controller model: one program over
global arrays, no NCCL or MPI), and the collectives are explicit
device-to-device copies (`parallel/collectives.py`).  Entries may repeat a
device: ``make_mesh(4, devices=["cuda:0"] * 4)`` is four shards on one
card, and ``devices=["cpu"] * 8`` the tests' eight CPU shards, the
counterpart of the reference's eight virtual CPU devices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_multislice_mesh"]


class Mesh:
    """An ndarray of ``torch.device`` with one name per axis.

    ``shape[name]`` is the size of axis `name`; ``devices`` is the array.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).flat]
        arr.flat[:] = flat
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D device array needs {arr.ndim} "
                             f"distinct axis names, got {axis_names}")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """Axis name → size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def along(self, *axes: str) -> list:
        """The devices of the sub-mesh over `axes` (in that order, flattened
        row-major), at index 0 of every other axis: the devices one program
        over those axes runs on (the other axes replicate its work in the
        reference's shard_map)."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r} (axes "
                                 f"{self.axis_names})")
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        arr = np.transpose(self.devices, order + rest)
        arr = arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr
        return list(np.asarray(arr, dtype=object).reshape(-1))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def _devices(devices, prog: str) -> list:
    """The explicit device list, or every CUDA card torch sees."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise ValueError(f"{prog}: no CUDA device; pass devices= (e.g. "
                         "['cpu'] * n) to build a mesh elsewhere")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("streams",),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first `n_devices` of `devices` (default: the CUDA
    cards, all of them when `n_devices` is None).

    1-D by default (pure stream DP).  Pass ``axis_names=('streams',
    'time')`` and a `shape` for a 2-D stream×time mesh.  `devices` may
    repeat a device (several shards on one card); asking for more entries
    than there are raises."""
    devs = _devices(devices, "make_mesh")
    if n_devices is None:
        n_devices = len(devs)
    if n_devices < 1 or n_devices > len(devs):
        raise ValueError(f"make_mesh: {n_devices} devices asked, "
                         f"{len(devs)} available")
    devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != len(devs):
        raise ValueError(f"shape {tuple(shape)} needs {int(np.prod(shape))} "
                         f"devices, have {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def make_multislice_mesh(n_slices: Optional[int] = None,
                         devices_per_slice: Optional[int] = None,
                         devices: Optional[Sequence] = None) -> Mesh:
    """2-D ``('slice', 'streams')`` mesh: the flat device list partitioned
    into `n_slices` contiguous groups of `devices_per_slice` (default: as
    many as fit).

    Streams are independent, so the batch shards over both axes jointly
    and the hot path holds no collective on either (`ShardedPipeline`).
    torch devices carry no slice index, so this is the reference's
    single-slice branch (`afp_tpu/parallel/mesh.py:84-94`), with its
    errors."""
    devs = _devices(devices, "make_multislice_mesh")
    if n_slices is None:
        raise ValueError(
            "n_slices required when devices carry no slice_index "
            "(single-slice platform / CPU harness)")
    per = devices_per_slice or len(devs) // n_slices
    if per < 1 or n_slices * per > len(devs):
        raise ValueError(
            f"{n_slices}×{per} mesh needs {n_slices * per} devices, "
            f"have {len(devs)}")
    arr = np.empty((n_slices, per), dtype=object)
    for i in range(n_slices):
        arr[i, :] = devs[i * per:(i + 1) * per]
    return Mesh(arr, ("slice", "streams"))
