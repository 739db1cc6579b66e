"""Finds every piece of a cell by its name, from the checkout's files alone.

* the cell: an entry of ``workloads`` in ``BENCHMARK.json`` at the root;
* its configuration: the ``file`` that ``configs`` gives for its name
  (``perfbench/configs/<config>.json``);
* the configuration's plain reference: ``perfbench/reference/<module>.py``,
  the module its ``"reference"`` key names (``chain`` without one);
* its traffic mix: ``perfbench/traffic/<traffic>.json``, data read by the
  one general generator (`harness/traffic.py`), which names its loop;
* the loop that drives the program: ``perfbench/loops/<loop>.py``;
* a per-layer metric's reader: ``perfbench/metrics/<metric>.py``.

A later change adds a configuration (with a reference of its own), a mix,
a loop, a metric or a cell by adding files and entries; nothing here names
one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["Bench", "BENCH_DIR", "ROOT"]

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
#: the reference of a configuration that names none
DEFAULT_REFERENCE = "chain"


def _load_module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {tag} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark as its files under `root` (a checkout) describe it."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.dir = self.root / BENCH_DIR.name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {[w['name'] for w in self.spec['workloads']]})")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def reference(self, conf: dict):
        """The plain reference module that the configuration file `conf`
        names under ``reference`` (default ``chain``).  Every reference has
        ``reference_blocks(block_of, rows, blocks, stream, dither_seed,
        precision="float64", *, config, seed)``: `config` the whole
        configuration file, `seed` the run's ``--seed``."""
        name = conf.get("reference", DEFAULT_REFERENCE)
        return _load_module(self.dir / "reference" / f"{name}.py", "reference")

    def traffic(self, name: str) -> dict:
        path = self.dir / "traffic" / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no traffic mix file {path}")
        return json.loads(path.read_text())

    def loop(self, name: str):
        return _load_module(self.dir / "loops" / f"{name}.py", "loop")

    def reader(self, metric: str):
        """The `read(trace)` function of a per-layer metric."""
        return _load_module(self.dir / "metrics" / f"{metric}.py", "metric").read

    def metrics_of(self, workload: str) -> tuple[list, list]:
        """(end-to-end, per-layer) metric entries that `workload` reports:
        those that list it under ``workloads``, or list no cells at all."""
        def mine(m):
            return "workloads" not in m or workload in m["workloads"]
        return ([m for m in self.spec["end_to_end"] if mine(m)],
                [m for m in self.spec["per_layer"] if mine(m)])
