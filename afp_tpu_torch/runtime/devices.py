"""Device enumeration (counterpart of `afp_tpu/runtime/devices.py`, which
lists JAX's devices): the CUDA devices torch sees, with name, memory,
compute capability and count.

The reference lists PortAudio endpoints (`list_audio_devices.py:4-6`:
index, name, channel counts); the port's devices are its accelerator
cards.  ``platform='cpu'`` lists the host itself, for runs that were asked
to stay on the CPU.
"""
from __future__ import annotations

import os
from typing import List

import torch

__all__ = ["list_devices", "format_devices", "torch_device"]


def torch_device(prog: str) -> str:
    """The device an entry point (the CLI, an example) runs on: the card,
    or the CPU under ``AFP_FORCE_CPU`` (the reference's switch).  No card
    and no switch exits non-zero: nothing carries on on the CPU."""
    if os.environ.get("AFP_FORCE_CPU"):
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device (torch.cuda."
                         "is_available() is False); set AFP_FORCE_CPU=1 to "
                         "run on the CPU")
    return "cuda"


def list_devices(platform: str = "cuda") -> List[dict]:
    """One dict per device of `platform` ('cuda' or 'cpu'): index, kind
    (the device's name), platform, count, and for a card its memory in
    bytes and compute capability."""
    if platform == "cpu":
        return [{"index": 0, "kind": "cpu", "platform": "cpu", "count": 1}]
    if platform != "cuda":
        raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    out = []
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        out.append({"index": i, "kind": p.name, "platform": "cuda",
                    "count": n, "memory_bytes": p.total_memory,
                    "compute_capability": (p.major, p.minor),
                    "multiprocessors": p.multi_processor_count})
    return out


def format_devices(platform: str = "cuda") -> str:
    """One line per device; a line saying so when there is none."""
    lines = []
    for d in list_devices(platform):
        extra = ""
        if d.get("memory_bytes"):
            cc = ".".join(map(str, d["compute_capability"]))
            extra = (f", {d['memory_bytes'] / 2**30:.1f} GiB, compute "
                     f"capability {cc}, {d['multiprocessors']} SMs")
        lines.append(f"{d['index']}: {d['kind']} ({d['platform']}, "
                     f"{d['count']} device{'s' * (d['count'] != 1)}{extra})")
    return "\n".join(lines) or f"no {platform} devices"
