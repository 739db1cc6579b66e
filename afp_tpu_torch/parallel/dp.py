"""Stream-axis data parallelism (counterpart of `afp_tpu/parallel/dp.py`).

The batch of concurrent streams is split over the mesh's 'streams' axis (and
its 'slice' axis, where there is one) in contiguous row ranges: shard i
holds rows ``[i·b, (i+1)·b)``, b = batch / n_shards, and runs its own
:class:`~afp_tpu_torch.engine.pipeline.Pipeline` at batch b on its mesh
device.  The pipeline step is batch-size-agnostic and streams are
independent, so the hot path holds no collective: one process launches
each shard's kernels in turn, and the only cross-device traffic is the
controller's own (blocks in, outputs gathered on the mesh's first device).

Parameters split by field, never by shape (`dp.py:57-82`): per-stream
EQ gains [B, n_bands], a per-stream ``H_main`` [B, F] and the per-tile
``casc_assign`` [B / bt] split with their rows (a shard must hold whole
tiles); everything else is shared, one copy per device.  The [B] AGC
vectors are refused: `afp_tpu`'s ShardedPipeline replicates them whole
into every shard (`dp.py:69-72`) and fails to broadcast them against the
shard's batch.

The dither key: each shard's state carries its own seed,
:func:`shard_seed` of ``(seed, shard index)``, fixed at :meth:`init_state`
(the reference folds the shard index into its key there, `dp.py:234-256`),
so shards draw decorrelated noise and every entry point (step, run,
chunked ring dispatches) walks each shard's ``(seed_i, step)`` key
exactly as a lone pipeline does: chained steps ≡ run ≡ ring dispatches,
bit for bit.

Every shard launches on its device's current stream: shards on different
cards run concurrently since launches are asynchronous, and shards that
share a card run in shard order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..engine.config import StreamConfig
from ..engine.pipeline import DeviceParams, Pipeline
from .mesh import Mesh

__all__ = ["ShardedPipeline", "ShardedState", "RingLayout", "shard_seed"]

_M64 = (1 << 64) - 1
#: the AGC knobs that may be per-stream [B] vectors (`engine/batch.py`)
_AGC_FIELDS = ("agc_target", "agc_max_gain", "agc_a_att", "agc_a_rel")


def shard_seed(seed: int, shard: int) -> int:
    """Shard `shard`'s dither seed: splitmix64's output function of the
    64-bit word ``(seed mod 2^32) · 2^32 + shard``, its low 32 bits (the
    kernels' Philox key takes 32-bit seeds).  Distinct shards of one seed
    get unrelated seeds; the same ``(seed, shard)`` always the same."""
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | int(shard))
         + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


class ShardedState(NamedTuple):
    """The carried state of a :class:`ShardedPipeline`: shard i's
    `StreamState` on mesh device i."""

    shards: tuple

    def gather(self, field: str):
        """A per-stream field of every shard, concatenated on the batch
        axis on shard 0's device (a pair tail as its (hi, lo) pair)."""
        parts = [getattr(s, field) for s in self.shards]
        if isinstance(parts[0], tuple):
            return tuple(_cat(list(p), 0) for p in zip(*parts))
        return _cat(parts, 0)


def _cat(parts, dim: int) -> torch.Tensor:
    home = parts[0].device
    return torch.cat([p.to(home) for p in parts], dim=dim)


class RingLayout(NamedTuple):
    """Where a sharded pipeline's [S, B, T] serving rings live: the rows
    ``rows[i] = (start, stop)`` of every slot, contiguous on
    ``devices[i]`` (the port's counterpart of `dp.py:225-229`'s
    ``ring_sharding``), so each shard's ring kernels read and write their
    own ring in place."""

    devices: tuple
    rows: tuple

    def zeros(self, slots: int, block: int, dtype) -> tuple:
        """One zeroed [slots, b, block] ring per shard."""
        return tuple(torch.zeros((slots, r1 - r0, block), dtype=dtype,
                                 device=d)
                     for d, (r0, r1) in zip(self.devices, self.rows))

    def split(self, ring) -> tuple:
        """A global [S, B, T] ring (a tensor, or a numpy array) as per-shard
        contiguous rings on their devices."""
        ring = torch.as_tensor(ring)
        return tuple(ring[:, r0:r1].to(d).contiguous()
                     for d, (r0, r1) in zip(self.devices, self.rows))

    def gather(self, rings) -> torch.Tensor:
        """Per-shard rings as one global [S, B, T] ring on shard 0's
        device."""
        return _cat(list(rings), 1)


class ShardedPipeline:
    """A Pipeline whose batch axis is sharded over a mesh's 'streams' axis
    (jointly with 'slice' on a multi-slice mesh).

    ``cfg.batch`` is the global stream count and must divide over the
    shards; ``agc_link_group`` must divide the per-shard batch.  Blocks
    and outputs are global ([B, L], [N, B, L]; outputs on the mesh's first
    device); params are one global :class:`DeviceParams`, split per shard
    on first use (one split is kept per bank object: swap banks by passing
    a new one, never by writing into one).  The state passed in is left
    intact.  Usage::

        mesh = make_mesh(4, devices=["cuda:0"] * 4)
        sp = ShardedPipeline(cfg, mesh)
        params = sp.device_params(PipelineParams.design(sp.cfg))
        state = sp.init_state()
        state, out = sp.step(params, state, blocks)   # blocks: [B, L]

    `td_precision` and `agc_one_kernel` are `Pipeline`'s.
    """

    def __init__(self, cfg: StreamConfig, mesh: Mesh, td_precision="B3",
                 agc_one_kernel: bool = False):
        cfg = cfg.validate()
        if "streams" not in mesh.axis_names:
            raise ValueError("mesh must have a 'streams' axis")
        axes = (("slice", "streams") if "slice" in mesh.axis_names
                else ("streams",))
        self.devices = mesh.along(*axes)
        n = len(self.devices)
        if cfg.batch % n:
            raise ValueError(
                f"global batch {cfg.batch} must divide over {n} devices")
        self.mesh = mesh
        self.n_shards = n
        self.cfg = cfg
        self.local_cfg = dataclasses.replace(cfg, batch=cfg.batch // n)
        self.pipelines = [Pipeline(self.local_cfg, d, td_precision,
                                   agc_one_kernel) for d in self.devices]
        #: shard 0's pipeline: the per-shard flags and the bank designer
        self.pipeline = self.pipelines[0]
        b = self.local_cfg.batch
        self.ring_layout = RingLayout(
            tuple(self.devices), tuple((i * b, (i + 1) * b) for i in range(n)))
        self._split_params = (None, None)  # (bank, its per-shard banks)

    # ---- Pipeline-duck-typed surface (RingServer, the CLI) ----

    @property
    def batch(self) -> int:
        return self.cfg.batch

    @property
    def block(self) -> int:
        return self.pipeline.block

    @property
    def out_block(self) -> int:
        return self.pipeline.out_block

    @property
    def device(self) -> torch.device:
        """The mesh's first device: where outputs and banks are gathered."""
        return self.devices[0]

    @property
    def in_dtype(self) -> torch.dtype:
        return self.pipeline.in_dtype

    @property
    def out_dtype(self) -> torch.dtype:
        return self.pipeline.out_dtype

    @property
    def supports_ring_step(self) -> bool:
        return self.pipeline.supports_ring_step

    @property
    def supports_fold(self) -> bool:
        return self.pipeline.supports_fold

    @property
    def _pair_ingest(self) -> bool:
        return self.pipeline._pair_ingest

    @property
    def _i16_ingest(self) -> bool:
        return self.pipeline._i16_ingest

    def device_params(self, p, cfg: StreamConfig | None = None,
                      agc=None) -> DeviceParams:
        """The global bank (`Pipeline.device_params`) on the mesh's first
        device."""
        return self.pipeline.device_params(p, cfg=cfg, agc=agc)

    def refresh_dynamic(self, cfg: StreamConfig) -> None:
        """Absorb a dynamic-only change of the global config in every
        shard."""
        if cfg.static_key() != self.cfg.static_key():
            raise ValueError("refresh_dynamic requires an identical static_key")
        for p in self.pipelines:
            p.refresh_dynamic(dataclasses.replace(cfg,
                                                  batch=self.local_cfg.batch))
        self.cfg = cfg

    def init_state(self, seed: int = 0) -> ShardedState:
        """Per-shard states at zero history, shard i dithering under
        ``shard_seed(seed, i)``."""
        return ShardedState(tuple(p.init_state(seed=shard_seed(seed, i))
                                  for i, p in enumerate(self.pipelines)))

    # ---- splitting and running ----

    def shard_params(self, params: DeviceParams) -> tuple:
        """`params` split per shard by field (module docstring), each part
        on its shard's device; shared fields are one tensor per device."""
        if params is self._split_params[0]:
            return self._split_params[1]
        vec = [f for f in _AGC_FIELDS
               if getattr(params, f) is not None and getattr(params, f).ndim]
        if vec:
            raise ValueError(
                f"per-stream AGC vectors {vec} are not supported under a "
                "mesh: afp_tpu's ShardedPipeline replicates them whole into "
                "every shard and fails to broadcast them against the shard's "
                "batch; run per-stream AGC policies on one Pipeline")
        B, b = self.batch, self.local_cfg.batch
        rows = {f for f in ("eq_gains", "H_main")
                if getattr(params, f).ndim == 2}
        tiles = None
        if params.casc_assign is not None:
            n_tiles = len(params.casc_assign)
            if B % n_tiles or b % (B // n_tiles):
                raise ValueError(
                    f"casc_assign has {n_tiles} tiles for batch {B}: a shard "
                    f"of {b} streams must hold whole tiles")
            tiles = b // (B // n_tiles)
        shared: dict = {}
        out = []
        for i, dev in enumerate(self.devices):
            fields = {}
            for name, v in zip(params._fields, params):
                if v is None or name in _AGC_FIELDS:
                    fields[name] = v  # AGC scalars stay 0-d host tensors
                elif name in rows:
                    if v.shape[0] != B:
                        raise ValueError(f"per-stream {name} must have {B} "
                                         f"rows, got {tuple(v.shape)}")
                    fields[name] = v[i * b:(i + 1) * b].to(dev).contiguous()
                elif name == "casc_assign":
                    fields[name] = v[i * tiles:(i + 1) * tiles].to(dev)
                else:
                    if (name, dev) not in shared:
                        shared[name, dev] = v.to(dev)
                    fields[name] = shared[name, dev]
            out.append(DeviceParams(**fields))
        self._split_params = (params, tuple(out))
        return self._split_params[1]

    def _split(self, x, axis: int) -> list:
        """Shard i's rows of `x` along its batch `axis` (a view; the shard's
        pipeline moves it to its device), a (hi, lo) pair half by half."""
        if isinstance(x, (tuple, list)):
            return list(zip(*(self._split(h, axis) for h in x)))
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.ndim <= axis or x.shape[axis] != self.batch:
            raise ValueError(f"axis {axis} must be the global batch "
                             f"{self.batch}, got shape {tuple(x.shape)}")
        b = self.local_cfg.batch
        lead = (slice(None),) * axis
        return [x[lead + (slice(i * b, (i + 1) * b),)]
                for i in range(self.n_shards)]

    def _rings(self, rings, name: str):
        """Per-shard rings, as `ring_layout` allocates them (None passes)."""
        if rings is None:
            return [None] * self.n_shards
        if not isinstance(rings, (tuple, list)) or len(rings) != self.n_shards:
            raise ValueError(
                f"{name}: a sharded pipeline takes one ring per shard "
                f"({self.n_shards}), as ring_layout.zeros/split make them")
        return list(rings)

    def _each(self, fn) -> list:
        """``fn(i)`` for every shard, in shard order."""
        return [fn(i) for i in range(self.n_shards)]

    def _states(self, res) -> ShardedState:
        return ShardedState(tuple(r[0] for r in res))

    def step(self, params: DeviceParams, state: ShardedState, blocks):
        """[B, L] in → (state, [B, L'] out); under pair ingest `blocks` may
        be the f32 block or its bf16 (hi, lo) pair."""
        ps, xs = self.shard_params(params), self._split(blocks, 0)
        res = self._each(lambda i: self.pipelines[i].step(
            ps[i], state.shards[i], xs[i]))
        return self._states(res), _cat([r[1] for r in res], 0)

    def run(self, params: DeviceParams, state: ShardedState, blocks):
        """[N, B, L] in → (state, [N, B, L'] out); pair tuples as
        :meth:`step`."""
        ps, xs = self.shard_params(params), self._split(blocks, 1)
        res = self._each(lambda i: self.pipelines[i].run(
            ps[i], state.shards[i], xs[i]))
        return self._states(res), _cat([r[1] for r in res], 1)

    def process_signal(self, params: DeviceParams, state: ShardedState,
                       signal, fold="auto"):
        """[B, T] → (state, [B, T'']) with `Pipeline.process_signal`'s
        semantics per shard: the fold is decided once, at the per-shard
        batch (`dp.py:279-324`), and each shard folds its own streams'
        blocks.  No collective."""
        ps, sigs = self.shard_params(params), self._split(signal, 0)
        use_fold = self.pipeline._fold_decision(fold, ps[0])
        res = self._each(lambda i: self.pipelines[i].process_signal(
            ps[i], state.shards[i], sigs[i], fold=use_fold))
        return self._states(res), _cat([r[1] for r in res], 0)

    def run_ring(self, params: DeviceParams, state: ShardedState,
                 ring_hi, ring_lo, out_ring, n_steps: int, start: int = 0):
        """`Pipeline.run_ring` per shard over its own rings (sequences of
        one ring per shard, `ring_layout`), written in place; returns the
        state and the output rings.  No collective."""
        if not self.supports_ring_step:
            raise ValueError(
                "run_ring requires a ring-capable pipeline — pair ingest, "
                "the fused AGC chain, or the f32 conv ring, waterfall "
                "disabled (see Pipeline.supports_ring_step)")
        return self._ring("run_ring", params, state, ring_hi, ring_lo,
                          out_ring, n_steps, start)

    def run_ring_mega(self, params: DeviceParams, state: ShardedState,
                      ring_hi, ring_lo, out_ring, n_steps: int, start: int = 0):
        """`Pipeline.run_ring_mega` per shard (one K4, K12 or K13 launch
        each), as :meth:`run_ring`."""
        if not self.supports_ring_step or self.cfg.agc_enabled:
            raise ValueError("run_ring_mega requires pair ingest or the "
                             "f32 conv ring (no AGC) with the waterfall "
                             "disabled (see supports_ring_step)")
        return self._ring("run_ring_mega", params, state, ring_hi, ring_lo,
                          out_ring, n_steps, start)

    def check_ring_params(self, params: DeviceParams,
                          form: str = "ring_step") -> None:
        """Refuse params that the shards' rings cannot serve: per-stream EQ
        gains are served on one Pipeline's AGC ring only
        (`Pipeline.check_ring_params`), never over a mesh's rings."""
        if params.eq_gains.ndim == 2:
            raise ValueError(
                f"{form} over a mesh does not support per-stream EQ gains: "
                "they are served on one Pipeline's AGC ring only")

    def _ring(self, form: str, params, state, ring_hi, ring_lo, out_ring,
              n_steps: int, start: int):
        self.check_ring_params(params, form)
        ps = self.shard_params(params)
        rh, rl, ro = (self._rings(r, n) for r, n in (
            (ring_hi, "ring_hi"), (ring_lo, "ring_lo"), (out_ring, "out_ring")))
        res = self._each(lambda i: getattr(self.pipelines[i], form)(
            ps[i], state.shards[i], rh[i], rl[i], ro[i], n_steps, start))
        return self._states(res), tuple(r[1] for r in res)

