"""Every piece of a cell is found by its name, and a new configuration
(with a plain reference of its own), traffic mix, loop, per-layer metric
and cell, on one card or on four, are added by new files and new entries
alone; `BENCHMARK.json` keeps to the benchmark's contract."""
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
        assert len(w["why"]) <= 200
    assert_chips_rule(SPEC)
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


def assert_chips_rule(spec: dict) -> None:
    """A cell takes 1 card or 4, and at most a quarter of the cells
    (rounded down, and one always) take 4."""
    chips = [w["chips"] for w in spec["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


def test_the_chips_rule():
    def spec(*chips):
        return {"workloads": [{"chips": c} for c in chips]}
    assert_chips_rule(spec(1, 1, 1))
    assert_chips_rule(spec(4, 1, 1))  # one always may
    assert_chips_rule(spec(4, 4, 1, 1, 1, 1, 1, 1))  # 25% of 8
    for bad in (spec(2, 1), spec(4, 4, 1, 1), spec(8)):
        with pytest.raises(AssertionError):
            assert_chips_rule(bad)


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


def _copy(tmp_path: Path) -> tuple[Path, dict]:
    """A checkout's benchmark copied into `tmp_path`: (its folder, the
    digest of every file in it)."""
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path / BENCH.name, _digest(tmp_path / BENCH.name)


def _unchanged(d: Path, before: dict) -> bool:
    after = _digest(d)
    return {k: v for k, v in after.items() if k in before} == before


def _add_cell(tmp_path: Path, conf_name: str, conf: dict, cell: dict) -> Bench:
    """The configuration `conf` and the cell `cell` (which reports
    `audio_xrt`) added to the copy's files and `BENCHMARK.json`."""
    (tmp_path / BENCH.name / "configs" / f"{conf_name}.json").write_text(
        json.dumps(conf))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": conf_name, "source": "https://example.org",
                            "file": f"perfbench/configs/{conf_name}.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({**cell, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "audio_xrt":
            m["workloads"].append(cell["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp_path)


SHRINK = {"stream": {"batch": 8, "blocksize": 512}}


def test_a_new_config_mix_loop_metric_and_cell_need_only_new_files(tmp_path):
    d, before = _copy(tmp_path)
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
    out = run_cell("c5q.burst", 5, 0.2, False, t_start=time.perf_counter(),
                   device="cpu", bench=bench, shrink=SHRINK)
    assert out["correct"] and set(out["metrics"]) == {"audio_xrt", "setup_s"}
    out = run_cell("c5q.burst", 5, 0.2, True, t_start=time.perf_counter(),
                   device="cpu", bench=bench, shrink=SHRINK)
    assert out["correct"] and out["metrics"]["blocks_seen.serve"]["value"] > 0
    assert _unchanged(d, before)


#: a reference that checks the keywords every reference is handed, then
#: gives the chain's output negated: a run against it is not correct
NEGATED = """

_chain_blocks = reference_blocks


def reference_blocks(*a, config, seed, **k):
    assert config["reference"] == "c5_negated" and seed == {seed}
    return -_chain_blocks(*a, config=config, seed=seed, **k)
"""


@pytest.mark.parametrize("module, correct", [("c5_own", True),
                                             ("c5_negated", False)])
def test_a_configuration_brings_its_own_reference(tmp_path, module, correct):
    d, before = _copy(tmp_path)
    text = (d / "reference" / "chain.py").read_text()
    seed = 2**31 + 11
    if not correct:
        text += NEGATED.format(seed=seed)
    (d / "reference" / f"{module}.py").write_text(text)
    conf = json.loads((d / "configs" / "c5_headline.json").read_text())
    conf.update(name=module, reference=module)
    bench = _add_cell(tmp_path, module, conf, {
        "name": f"{module}.serve", "config": module, "traffic": "serve_closed",
        "chips": 1})
    assert bench.reference(conf).__file__.endswith(f"{module}.py")
    out = run_cell(f"{module}.serve", seed, 0.2, False,
                   t_start=time.perf_counter(), device="cpu", bench=bench,
                   shrink=SHRINK)
    assert out["correct"] is correct, out["check"]
    if not correct:
        assert out["check"]["err_db"]["value"] > out["check"]["err_db"]["limit"]
    assert _unchanged(d, before)


#: the closed loop over `RingServer`, serving a `ShardedPipeline` over a
#: mesh of the cell's cards, as many as the configuration's `shards`
SHARDED_LOOP = ("from afp_tpu_torch.engine import Pipeline",
                "from afp_tpu_torch.parallel import ShardedPipeline, make_mesh")
SHARDED_PIPE = ("self.pipe = Pipeline(ctx.program_config(), ctx.device)",
                "if len(ctx.devices) != int(ctx.config['shards']):\n"
                "            raise ValueError('the cards are not the shards')\n"
                "        self.pipe = ShardedPipeline(ctx.program_config(), make_mesh(\n"
                "            len(ctx.devices), devices=ctx.devices))")

#: a reference of C5 over shards: shard i holds rows [i·b, (i+1)·b) of the
#: batch and is a lone chain at batch b whose dither is keyed by
#: splitmix64's `shard_seed(seed, i)` over its own rows
SHARDED_REFERENCE = '''"""C5 over `config["shards"]` contiguous row ranges, each a lone chain."""
import numpy as np

from perfbench.reference.chain import reference_blocks as lone_blocks

_M64 = (1 << 64) - 1


def shard_seed(seed, shard):
    z = ((((int(seed) & 0xFFFFFFFF) << 32) | int(shard)) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & 0xFFFFFFFF


def reference_blocks(block_of, rows, blocks, stream, dither_seed,
                     precision="float64", *, config, seed):
    n = int(config["shards"])
    b = int(stream["batch"]) // n
    rows = np.asarray(rows)
    out = np.empty((len(blocks), len(rows), int(stream["blocksize"])))
    for i in range(n):
        mine = np.flatnonzero(rows // b == i)
        if mine.size:
            out[:, mine] = lone_blocks(
                lambda k, i=i: np.asarray(block_of(k))[i * b:(i + 1) * b],
                rows[mine] - i * b, blocks, {**stream, "batch": b},
                shard_seed(dither_seed, i), precision, config=config, seed=seed)
    return out
'''


#: (mix, dither, reference, whether the reference keys the dither as the
#: shards do): the chain keys it by the run's seed over the global rows, so
#: its dithered readings sit 1-2 steps off; the limit of 12 steps, set
#: between the program and the bfloat16 control, cannot see that
FOUR_CARDS = [("serve_closed", "off", "chain", None),
              ("serve_closed_pcm16", "tpdf", "c5_shards", True),
              ("serve_closed_pcm16", "tpdf", "chain", False)]


@pytest.mark.parametrize("mix, dither, reference, keyed", FOUR_CARDS)
def test_a_cell_on_four_cards_needs_only_new_files(tmp_path, mix, dither,
                                                   reference, keyed):
    d, before = _copy(tmp_path)
    loop = (d / "loops" / "ring_closed.py").read_text()
    for a, b in (SHARDED_LOOP, SHARDED_PIPE):
        assert a in loop
        loop = loop.replace(a, b)
    (d / "loops" / "ring_sharded.py").write_text(loop)
    (d / "reference" / "c5_shards.py").write_text(SHARDED_REFERENCE)
    mix = json.loads((d / "traffic" / f"{mix}.json").read_text())
    mix.update(loop="ring_sharded")
    (d / "traffic" / "serve_sharded.json").write_text(json.dumps(mix))
    conf = json.loads((d / "configs" / "c5_headline.json").read_text())
    conf.update(name="c5_dp4", shards=4, reference=reference)
    conf["stream"].update(dither_kind=dither)
    bench = _add_cell(tmp_path, "c5_dp4", conf, {
        "name": "c5.serve.dp4", "config": "c5_dp4", "traffic": "serve_sharded",
        "chips": 4})
    assert_chips_rule(bench.spec)
    for trace in (False, True):
        out = run_cell("c5.serve.dp4", 2**31 + 13, 0.2, trace,
                       t_start=time.perf_counter(), device="cpu", bench=bench,
                       shrink=SHRINK)
        assert out["correct"], out["check"]
        assert out["device"]["count"] == 4
        assert out["attempted"] > 0 and out["failed"] == 0
        if keyed is not None:
            assert (out["check"]["err_lsb"]["value"] < 1.0) is keyed, out["check"]
    assert "busy_s" in out["device"] and "breakdown" in out
    assert _unchanged(d, before)
