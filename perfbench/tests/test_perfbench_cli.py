"""The command as the driver runs it: without a card it exits non-zero and
prints no result (a CPU run never writes a device metric); on a card
(marker `cuda`) a short run prints one result line that keeps to the
contract."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _run(cwd: Path, *args: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=1200, env=env)


def _cuda() -> bool:
    import torch
    return torch.cuda.is_available()


def test_without_a_card_no_result(tmp_path):
    if _cuda():
        pytest.skip("this machine has a CUDA card")
    p = _run(ROOT, "--workload", "c5.serve.f32", "--seed", str(2**31 + 3),
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(tmp_path, "--workload", "c8.live", "--seed", "1", "--seconds", "1",
             "--trace", "0", env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(trace):
    if not _cuda():
        pytest.skip("needs a CUDA card")
    p = _run(ROOT, "--workload", "c8.serve.pcm16", "--seed", str(2**31 + 5),
             "--seconds", "2", "--trace", trace)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "check" and r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace == "1":
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        assert 0 < r["metrics"]["chain_roofline.serve"]["value"] <= 100
    else:
        assert r["metrics"]["audio_xrt"]["value"] > 0
    tail = p.stderr.strip().splitlines()[-len(r["check"]):]
    assert all(line.startswith("check ") for line in tail)
