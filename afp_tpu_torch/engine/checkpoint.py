"""Engine-state checkpoint / resume (counterpart of
`afp_tpu/engine/checkpoint.py`, SURVEY.md §5.4).

A snapshot of a streaming job, so it can stop and resume mid-stream bit for
bit: the config, the parameter bank (every `DeviceParams` field: complex64
spectra, taps, gains, AGC knobs and banks), the carried state (conv tail,
dither ``(seed, step)``, AGC gain, the input histories of the compat ASRC
and the literal chain's ``up``/``down`` resamplers, the waterfall ring),
the framer residuals
of `StreamEngine.process_frames` and the exact ASRC frontend's host
accumulators, resampler history and undelivered engine blocks.  One
``.npz`` with the meta as embedded JSON.

The port writes its own layout (``"format": "afp_tpu_torch"``, version 2;
version 1, without the resamplers and the frontend, still loads): named
arrays, the tail in the pipeline's own form (f32, raw int16, or the bf16
pair stored as uint16 bit views).  A resumed stream equals the
uninterrupted one bit for bit, dither on: the Philox key is the state's
``(seed, step)``.

It also reads `afp_tpu`'s v1/v2 ``.npz`` (positional pytree leaves of its
`StreamState` ``(asrc, up, conv_tail, down, agc_gain, key, wf)``, each
`PolyResampler` flattened to ``(hist, h)``, and `DeviceParams`; the
``conv_pair`` flag, bf16 leaves as uint16 views and the frontend's
``asrc_in``/``asrc_out``/``asrc_hist``/``asrc_outq``,
`afp_tpu/engine/checkpoint.py:39-159`).  The conv tail is converted pair ↔
f32 where the layouts differ, as `afp_tpu` does (`:129-147`); the tail, the
AGC gain, the resampler histories, the waterfall ring, the parameters, the
framer residuals and the frontend restore bit for bit.  The JAX PRNG ``key`` has no Philox
counterpart, so such a restore re-keys the dither from the checkpoint's
seed at step 0: the same distribution, other bits.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .config import StreamConfig
from .engine import StreamEngine

__all__ = ["save_checkpoint", "load_checkpoint"]

FORMAT = "afp_tpu_torch"
#: version of the port's own layout (2: the resamplers and the frontend)
_FORMAT_VERSION = 2
#: the port's layouts this module reads
_PORT_VERSIONS = (1, 2)
#: the carried resamplers, in `afp_tpu`'s StreamState order around the tail
_RESAMPLERS = ("asrc", "up", "down")
#: `afp_tpu`'s layouts this module reads
_REFERENCE_VERSIONS = (1, 2)
#: `afp_tpu`'s `DeviceParams` leaves that are always present, in field order
_REFERENCE_PARAMS = ("H_bands", "H_main", "eq_gains", "agc_target",
                     "agc_max_gain", "agc_a_att", "agc_a_rel")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as an npz-safe array: bf16 as its uint16 bit view (numpy
    has no bf16 of torch's)."""
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).cpu().numpy().view(np.uint16)
    return t.detach().cpu().numpy()


def _bf16(a: np.ndarray) -> torch.Tensor:
    """A uint16 bit view back as a bf16 tensor on the host."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)


def save_checkpoint(path: str, engine: StreamEngine) -> None:
    """Snapshot a StreamEngine to `path` (.npz) in the port's layout.

    The snapshot is taken under the engine's swap lock, so a concurrent
    ``apply_config`` can never tear the state/params pair; checkpoint from
    the control thread between blocks (the dispatcher's cadence)."""
    with engine._swap_lock:
        state, params = engine.state, engine.params
        arrays = {}
        tail = state.conv_tail
        if isinstance(tail, tuple):
            arrays["tail_hi"], arrays["tail_lo"] = map(_to_numpy, tail)
        else:
            arrays["tail"] = _to_numpy(tail)
        if state.agc_gain is not None:
            arrays["agc_gain"] = _to_numpy(state.agc_gain)
        for r in _RESAMPLERS:
            if getattr(state, r) is not None:
                arrays[f"rs_{r}"] = _to_numpy(getattr(state, r).hist)
        if state.wf is not None:
            arrays["wf"] = _to_numpy(state.wf)
        names = [n for n in params._fields if getattr(params, n) is not None]
        for n in names:
            arrays[f"param_{n}"] = _to_numpy(getattr(params, n))
        meta = {
            "format": FORMAT,
            "version": _FORMAT_VERSION,
            "config": engine.cfg.to_dict(),
            "seed": engine._seed,
            "pipeline": engine._pipe_kw,
            "state_seed": state.seed,
            "state_step": state.step,
            "params": names,
            "has_framer": engine._in_framer is not None,
        }
        if engine._in_framer is not None:
            arrays["framer_in"] = engine._in_framer.get_state()
            arrays["framer_out"] = engine._out_framer.get_state()
        _save_frontend(engine, arrays, meta)
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _save_frontend(engine: StreamEngine, arrays: dict, meta: dict) -> None:
    """The exact ASRC frontend's accumulators and resampler history, and
    the engine blocks drained but not yet delivered, under `afp_tpu`'s
    names (`afp_tpu/engine/checkpoint.py:72-76`)."""
    if engine._asrc_frontend is None:
        return
    meta["has_asrc"] = True
    arrays.update(engine._asrc_frontend.get_state())
    if engine._asrc_outq:
        arrays["asrc_outq"] = np.stack(list(engine._asrc_outq))


def _restore_frontend(engine: StreamEngine, meta: dict, z) -> None:
    if not meta.get("has_asrc"):
        return
    if engine._asrc_frontend is None:
        raise ValueError("the checkpoint holds an ASRC frontend, but its "
                         "config builds none")
    engine._asrc_frontend.set_state(
        {k: z[k] for k in ("asrc_in", "asrc_out", "asrc_hist")})
    if "asrc_outq" in z:
        engine._asrc_outq.extend(np.asarray(z["asrc_outq"]))


def _reference_params(cfg: StreamConfig, leaves: list) -> dict:
    """`afp_tpu`'s positional `DeviceParams` leaves by field name: the seven
    fields always present, then, on 'td_mxu', ``casc_bands`` and
    ``casc_main``, its wide band matrix ``casc_wide`` where it has one (the
    port's K11 reads the band taps instead), and a filter bank's
    ``casc_bank``/``casc_assign`` (an integer last leaf)."""
    if len(leaves) < len(_REFERENCE_PARAMS):
        raise ValueError(f"expected at least {len(_REFERENCE_PARAMS)} "
                         f"parameter leaves, got {len(leaves)}")
    out = dict(zip(_REFERENCE_PARAMS, leaves))
    rest = leaves[len(_REFERENCE_PARAMS):]
    if rest and np.issubdtype(rest[-1].dtype, np.integer):
        out["casc_bank"], out["casc_assign"] = rest[-2], rest[-1]
        rest = rest[:-2]
    if cfg.conv_strategy == "td_mxu":
        if len(rest) not in (2, 3):
            raise ValueError("unexpected 'td_mxu' parameter leaves: "
                             f"{[a.shape for a in rest]}")
        out["casc_bands"], out["casc_main"] = rest[0], rest[1]
    elif rest:
        raise ValueError(f"unexpected parameter leaves: {[a.shape for a in rest]}")
    return out


def _restore_framers(engine: StreamEngine, z) -> None:
    from ..runtime.framer import BlockFramer

    # residuals ride the transport dtypes (raw int16 under pcm16 ingest and
    # emit='pcm16'): a float framer would silently convert them
    engine._in_framer = BlockFramer(engine.cfg.batch, dtype=engine._in_dtype)
    engine._out_framer = BlockFramer(engine.cfg.batch, dtype=engine._out_dtype)
    engine._in_framer.set_state(z["framer_in"])
    engine._out_framer.set_state(z["framer_out"])


def load_checkpoint(path: str, device="cuda") -> StreamEngine:
    """Restore a StreamEngine on `device` from a checkpoint of the port or
    of `afp_tpu` (see the module docstring).  Every tensor moves to the
    device once, here."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta_json"]).decode())
        cfg = StreamConfig.from_dict(meta["config"])
        if meta.get("format") == FORMAT:
            if meta["version"] not in _PORT_VERSIONS:
                raise ValueError(
                    f"unsupported {FORMAT} checkpoint version {meta['version']}")
            engine = StreamEngine(cfg, device=device, seed=meta["seed"],
                                  **meta["pipeline"])
            pipe = engine.pipeline
            tail = ((_bf16(z["tail_hi"]), _bf16(z["tail_lo"]))
                    if "tail_hi" in z else z["tail"])
            state = pipe.state_from_numpy(
                tail, meta["state_seed"], meta["state_step"],
                z["agc_gain"] if "agc_gain" in z else None,
                {r: z[f"rs_{r}"] for r in _RESAMPLERS if f"rs_{r}" in z},
                z["wf"] if "wf" in z else None)
            params = pipe.params_from_numpy(
                {n: z[f"param_{n}"] for n in meta["params"]})
        else:
            if meta["version"] not in _REFERENCE_VERSIONS:
                raise ValueError(
                    f"unsupported checkpoint version {meta['version']}")
            engine = StreamEngine(cfg, device=device, seed=meta["seed"])
            bf16 = set(meta.get("bf16_leaves", ()))

            def leaf(name):
                return _bf16(z[name]) if name in bf16 else z[name]

            st = [leaf(f"state_{i}") for i in range(meta["n_state_leaves"])]
            # the leaves in StreamState order: the compat ASRC's and the
            # up resampler's (hist, h), the conv tail (a pair in conv-pair
            # mode), the down resampler's (hist, h), the AGC gain when on,
            # the JAX key, which has no Philox counterpart, and the
            # waterfall ring when on (`afp_tpu/engine/checkpoint.py:49`)
            carried = list(engine.pipeline._resamplers())
            n_tail = 2 if meta.get("conv_pair") else 1
            if len(st) != (2 * len(carried) + n_tail + cfg.agc_enabled + 1
                           + cfg.waterfall_enabled):
                raise ValueError(f"unexpected state leaves for this config: "
                                 f"{[tuple(a.shape) for a in st]}")
            hist = {}
            for r in ("asrc", "up"):
                if r in carried:
                    hist[r], st = st[0], st[2:]
            tail, st = (tuple(st[:2]) if n_tail == 2 else st[0]), st[n_tail:]
            if "down" in carried:
                hist["down"], st = st[0], st[2:]
            state = engine.pipeline.state_from_numpy(
                tail, meta["seed"], 0, st[0] if cfg.agc_enabled else None,
                hist, st[-1] if cfg.waterfall_enabled else None)
            params = engine.pipeline.params_from_numpy(_reference_params(
                cfg, [z[f"param_{i}"] for i in range(meta["n_param_leaves"])]))
        if meta.get("has_framer"):
            _restore_framers(engine, z)
        _restore_frontend(engine, meta, z)
    engine.state, engine.params = state, params
    return engine
