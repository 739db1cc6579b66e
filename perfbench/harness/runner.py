"""One run of one cell: set-up, the measured window, the reference check,
and the result line's content.

The cell names a configuration and a traffic mix; the mix names its loop
(`perfbench/loops/<loop>.py`).  A loop module has ``SPANS`` (the host spans
it opens) and ``Session(ctx)``, whose constructor builds the program's
objects and warms up every shape the window uses, whose ``window(seconds)``
drives the program for the measured window and returns its counts and
end-to-end numbers, and whose ``close()`` frees the program's state.

The configuration names its plain reference (`Bench.reference`), which
works the kept outputs out again once the window has closed.  A cell on
several cards is handed all of them (`Context.devices`); its memory peak is
the fullest card's, and its traced idle readings are averaged per card.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass

import numpy as np

from . import check, peaks, traffic
from .bench import Bench
from .trace import Tracer, breakdown

__all__ = ["Context", "run_cell", "stream_config", "cell_parts"]


@dataclass
class Context:
    """What a loop is handed: the configuration as the program runs it and
    as its file states it, the run's seed, the cell's cards, the inputs,
    and where the outputs go."""

    stream: dict  # StreamConfig fields, the wire applied
    serving: dict  # the configuration's serving knobs
    devices: list  # torch.device of each card: cuda:0 … (CPU: chips × cpu)
    pool: np.ndarray  # [pool_blocks, batch, block] input blocks
    dither_seed: int  # the program's stream seed (keys its dither)
    keeper: check.Keeper
    tracer: Tracer
    config: dict  # the whole configuration file
    seed: int  # the run's --seed

    @property
    def device(self):
        """The cell's first card."""
        return self.devices[0]

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


def _synchronize(devs) -> None:
    import torch

    for d in devs:
        torch.cuda.synchronize(d)


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
    chips = int(cell["chips"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    devs = ([torch.device("cuda", i) for i in range(chips)] if cuda
            else [dev] * chips)
    if cuda:
        torch.cuda.init()
    log(f"set-up: imports and the CUDA context by {time.perf_counter() - t_start:.3f} s")
    t = time.perf_counter()
    pool = traffic.make_pool(mix, int(stream["batch"]), int(stream["blocksize"]),
                             float(stream["samplerate"]), seed, devs[0])
    log(f"set-up: pool of {pool.shape} {pool.dtype} in {time.perf_counter() - t:.3f} s")
    if cuda:
        _synchronize(devs)
        torch.cuda.empty_cache()
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
    rows = check.sample_rows(int(stream["batch"]), seed)
    tracer = Tracer(trace)
    ctx = Context(stream=stream, serving=serving, devices=devs, pool=pool,
                  dither_seed=int(seed) % (1 << 31),
                  keeper=check.Keeper(rows, seed), tracer=tracer,
                  config=conf, seed=int(seed))
    t = time.perf_counter()
    session = loop.Session(ctx)
    if cuda:
        _synchronize(devs)
    log(f"set-up: program built and warmed in {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t_start

    with tracer:
        with tracer.span("window"):
            res = session.window(float(seconds))
        if cuda:
            _synchronize(devs)
    card_peaks = [int(torch.cuda.max_memory_allocated(d)) if cuda else 0
                  for d in devs]
    peak = max(card_peaks)
    log(f"memory: peak bytes a card {card_peaks}")
    data = None
    if trace:
        data = tracer.collect(loop.SPANS, cards=chips)
        log(f"trace: {len(data.device_ops)} device operations, by card "
            f"{dict(sorted(Counter(data.op_cards).items()))}")
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
    reference = bench.reference(conf)
    ks, prog = ctx.keeper.kept()
    ref = (reference.reference_blocks(ctx.block_of, rows, ks, stream,
                                      ctx.dither_seed, config=conf,
                                      seed=ctx.seed)
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
               "kind": torch.cuda.get_device_name(devs[0]) if cuda else "cpu",
               "count": chips, "memory_peak_bytes": peak}
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
