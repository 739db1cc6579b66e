"""Every piece of a cell is found by its name, and a new configuration,
traffic mix, loop, per-layer metric and cell are added by new files and
new entries alone; `BENCHMARK.json` keeps to the benchmark's contract."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from perfbench.harness.bench import Bench
from perfbench.harness.runner import run_cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_file_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]] \
        + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
    bench = Bench(ROOT)
    for w in SPEC["workloads"]:
        mine_e2e, mine_layer = bench.metrics_of(w["name"])
        assert {m["name"] for m in mine_e2e} > {"setup_s"} and mine_layer
        for m in mine_layer:  # a per-layer metric moves one the cell reports
            assert m["moves"] in {x["name"] for x in mine_e2e}


HELD = json.loads((Path(__file__).parent / "held_back.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"] + HELD["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell, bench):
    w = bench.workload(cell)
    conf = bench.config(w["config"])
    assert {"stream", "limits", "source", "reduced", "assumed"} <= set(conf)
    mix = bench.traffic(w["traffic"])
    loop = bench.loop(mix["loop"])
    assert hasattr(loop, "Session") and hasattr(loop, "SPANS")
    for m in bench.metrics_of(cell)[1]:
        assert callable(bench.reader(m["name"]))


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_mix_loop_metric_and_cell_need_only_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / BENCH.name)
    d = tmp_path / BENCH.name
    conf = json.loads((d / "configs" / "c5_headline.json").read_text())
    conf.update(name="c5_quiet", source="https://example.org/deployment")
    conf["stream"].update(cutoff=8000.0)
    (d / "configs" / "c5_quiet.json").write_text(json.dumps(conf))
    mix = json.loads((d / "traffic" / "serve_closed.json").read_text())
    mix.update(loop="ring_burst", level_dbfs=[-60.0, -50.0])
    (d / "traffic" / "quiet_bursts.json").write_text(json.dumps(mix))
    (d / "loops" / "ring_burst.py").write_text(
        (d / "loops" / "ring_closed.py").read_text())
    (d / "metrics" / "blocks_seen.serve.py").write_text(
        "def read(trace):\n    return float(trace.blocks) if trace.blocks else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "c5_quiet", "source": "https://example.org",
                            "file": "perfbench/configs/c5_quiet.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "c5q.burst", "config": "c5_quiet",
                              "traffic": "quiet_bursts", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "audio_xrt":
            m["workloads"].append("c5q.burst")
    spec["per_layer"].append({"name": "blocks_seen.serve", "unit": "blocks",
                              "better": "higher", "source": "program_counter",
                              "layer": "serving pump", "moves": "audio_xrt",
                              "workloads": ["c5q.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(tmp_path)
    shrink = {"stream": {"batch": 8, "blocksize": 512}}
    out = run_cell("c5q.burst", 5, 0.2, False, t_start=time.perf_counter(),
                   device="cpu", bench=bench, shrink=shrink)
    assert out["correct"] and set(out["metrics"]) == {"audio_xrt", "setup_s"}
    out = run_cell("c5q.burst", 5, 0.2, True, t_start=time.perf_counter(),
                   device="cpu", bench=bench, shrink=shrink)
    assert out["correct"] and out["metrics"]["blocks_seen.serve"]["value"] > 0
    after = _digest(tmp_path / BENCH.name)
    assert {k: v for k, v in after.items() if k in before} == before
