"""A whole run of each cell on the CPU at a tiny size, the look for a card
skipped: sound, `correct` comes out true; with the timed path broken
underneath, false.  The faults a cell can have: a step that returns its
state unchanged, half of the batch left out, and an answer altered where
it is produced (no cell spans chips, so no exchange can be left out)."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench.harness.runner import run_cell

SHRINK = {
    "c5.serve.f32": ({"batch": 8, "blocksize": 512}, 0.3),
    "c5.serve.pcm16": ({"batch": 8, "blocksize": 512}, 0.3),
    "c8.serve.pcm16": ({"batch": 8, "blocksize": 1024}, 0.3),
    "c8.live": ({"batch": 8, "blocksize": 1024}, 0.1),
}
SEED = 2**31 + 77


def run(cell, bench):
    stream, seconds = SHRINK[cell]
    return run_cell(cell, SEED, seconds, False, t_start=time.perf_counter(),
                    device="cpu", bench=bench, shrink={"stream": stream})


def _alter(out: torch.Tensor) -> None:
    """Alter produced outputs in place: 0.1% louder, or 64 steps up."""
    if out.dtype == torch.int16:
        out.copy_(torch.clamp(out.to(torch.int32) + 64, -32768, 32767).to(torch.int16))
    else:
        out.mul_(1.001)


def _drop_half(out: torch.Tensor) -> None:
    """The second half of the batch left out (rows axis -2)."""
    out[..., out.shape[-2] // 2:, :] = 0


def plant(monkeypatch, fault: str) -> None:
    from afp_tpu_torch.engine import Pipeline

    for name in ("run_ring", "run_ring_mega", "step"):
        orig = getattr(Pipeline, name)

        def wrapped(self, params, state, *a, _orig=orig, _name=name, **k):
            new_state, out = _orig(self, params, state, *a, **k)
            if _name == "step":
                written = out
            else:  # the ring slots this dispatch wrote
                n, start = a[3], k.get("start", a[4] if len(a) > 4 else 0)
                written = out[start:start + n]
            if fault == "state_unchanged":
                return state, out
            if fault == "half_batch":
                _drop_half(written)
            elif fault == "altered":
                _alter(written)
            return new_state, out

        monkeypatch.setattr(Pipeline, name, wrapped)


@pytest.mark.parametrize("cell", sorted(SHRINK))
def test_a_sound_run_is_correct(cell, bench):
    out = run(cell, bench)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 or cell == "c8.live"  # the CPU misses live deadlines
    assert list(out["check"])[-1] == "nonfinite"
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", sorted(SHRINK))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch, bench):
    plant(monkeypatch, fault)
    out = run(cell, bench)
    assert not out["correct"], (fault, out["check"])
