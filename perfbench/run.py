#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card of this machine:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with a trace ``breakdown``, and last ``check``, each number the comparison
with the reference measured beside its limit; the same numbers end standard
error.  Without a CUDA card, with fewer cards than the cell asks for, without
the program beside this folder, or with JAX or the JAX package loaded once
the window has closed, it prints no result and exits non-zero.  Every
cache and build directory lies inside the checkout (`build/`).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "afp_tpu")


def _setup_paths() -> None:
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()

    from perfbench.harness.bench import Bench
    from perfbench.harness.runner import log, run_cell

    bench = Bench(ROOT)
    chips = int(bench.workload(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import afp_tpu_torch  # noqa: F401  (the program: absent → no result)

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, device="cuda", bench=bench)
    bad = forbidden_modules()
    if bad:
        log(f"no result: {', '.join(bad)} loaded in the run's process")
        return 3
    for name, v in out["check"].items():
        log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
