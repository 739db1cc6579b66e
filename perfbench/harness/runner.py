"""One run of one cell: set-up, the measured window, the reference check,
and the result line's content.

The cell names a configuration and a traffic mix; the mix names its loop
(`perfbench/loops/<loop>.py`).  A loop module has ``SPANS`` (the host spans
it opens) and ``Session(ctx)``, whose constructor builds the program's
objects and warms up every shape the window uses, whose ``window(seconds)``
drives the program for the measured window and returns its counts and
end-to-end numbers, and whose ``close()`` frees the program's state.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

from . import check, peaks, traffic
from .bench import Bench
from .trace import Tracer, breakdown

__all__ = ["Context", "run_cell", "stream_config", "cell_parts"]


@dataclass
class Context:
    """What a loop is handed: the configuration as the program runs it,
    the inputs, and where the outputs go."""

    stream: dict  # StreamConfig fields, the wire applied
    serving: dict  # the configuration's serving knobs
    device: object  # torch.device
    pool: np.ndarray  # [pool_blocks, batch, block] input blocks
    dither_seed: int  # the program's stream seed (keys its dither)
    keeper: check.Keeper
    tracer: Tracer

    def block_of(self, k: int) -> np.ndarray:
        """Input block k of the stream: the pool, cycled."""
        return self.pool[k % len(self.pool)]

    def program_config(self):
        return stream_config(self.stream)


def stream_config(stream: dict):
    """The program's `StreamConfig` of the configuration's fields."""
    from afp_tpu_torch.engine import StreamConfig

    return StreamConfig.from_dict(dict(stream)).validate()


def cell_parts(bench: Bench, name: str, shrink: dict | None = None):
    """(cell, configuration file, mix, loop module, stream fields, serving
    knobs) of the cell `name`; `shrink` overrides fields (CPU tests only)."""
    cell = bench.workload(name)
    conf = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    stream = {**conf["stream"], **traffic.WIRES[mix["wire"]]}
    serving = dict(conf.get("serving", {}))
    if shrink:
        stream.update(shrink.get("stream", {}))
        serving.update(shrink.get("serving", {}))
    return cell, conf, mix, bench.loop(mix["loop"]), stream, serving


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", bench: Bench | None = None,
             shrink: dict | None = None) -> dict:
    """Run the cell once; return the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with a trace the
    ``breakdown``, and last ``check``: each number compared beside its
    limit)."""
    import torch

    bench = bench or Bench()
    cell, conf, mix, loop, stream, serving = cell_parts(bench, name, shrink)
    e2e, per_layer = bench.metrics_of(name)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
    log(f"set-up: imports and the CUDA context by {time.perf_counter() - t_start:.3f} s")
    t = time.perf_counter()
    pool = traffic.make_pool(mix, int(stream["batch"]), int(stream["blocksize"]),
                             float(stream["samplerate"]), seed, dev)
    log(f"set-up: pool of {pool.shape} {pool.dtype} in {time.perf_counter() - t:.3f} s")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rows = check.sample_rows(int(stream["batch"]), seed)
    tracer = Tracer(trace)
    ctx = Context(stream=stream, serving=serving, device=dev, pool=pool,
                  dither_seed=int(seed) % (1 << 31),
                  keeper=check.Keeper(rows, seed), tracer=tracer)
    t = time.perf_counter()
    session = loop.Session(ctx)
    if cuda:
        torch.cuda.synchronize()
    log(f"set-up: program built and warmed in {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t_start

    with tracer:
        with tracer.span("window"):
            res = session.window(float(seconds))
        if cuda:
            torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    data = None
    if trace:
        data = tracer.collect(loop.SPANS)
        data.blocks = res["returned"]
        data.least_bytes = peaks.least_bytes(
            int(stream["batch"]), int(stream["blocksize"]),
            stream.get("ingest", "f32"), stream.get("emit", "f32"))
        data.extra = res.get("extra", {})
    session.close()
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    from perfbench.reference.chain import reference_blocks

    ks, prog = ctx.keeper.kept()
    ref = (reference_blocks(ctx.block_of, rows, ks, stream, ctx.dither_seed)
           if ks else np.zeros(prog.shape))
    correct, nums = check.compare(prog, ref, conf["limits"], res["unanswered"],
                                  ctx.keeper.nonfinite)
    log(f"reference: {len(ks)} blocks x {len(rows)} rows in "
        f"{time.perf_counter() - t:.3f} s")

    metrics = {}
    if not trace:
        for m in e2e:
            v = setup_s if m["name"] == "setup_s" else res["e2e"][m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in per_layer:
            v = bench.reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
               "count": 1, "memory_peak_bytes": peak}
    if cuda:
        devinfo["power_limit"] = _power_limit()
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": devinfo}
    if trace:
        devinfo["busy_s"] = data.busy_us() / 1e6
        devinfo["window_s"] = (data.window[1] - data.window[0]) / 1e6
        out["breakdown"] = breakdown(data)
    for k, v in res.get("report", {}).items():
        log(f"window: {k} = {v}")
    out["check"] = nums
    return out
