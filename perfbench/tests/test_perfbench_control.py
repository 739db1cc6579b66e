"""The control, the reference put in the program's place in bfloat16, is
refused by each cell's comparison (`perfbench/control.py`; on the card it
runs at the cells' own sizes)."""
from __future__ import annotations

import pytest

from perfbench.control import control_reading

SHRINK = {
    "c5.serve.f32": {"batch": 32, "blocksize": 512},
    "c5.serve.pcm16": {"batch": 32, "blocksize": 512},
    "c8.serve.pcm16": {"batch": 32, "blocksize": 1024},
    "c8.live": {"batch": 32, "blocksize": 1024},
}


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
@pytest.mark.parametrize("cell", sorted(SHRINK))
def test_the_control_is_not_correct(cell, seed, bench):
    r = control_reading(bench, cell, seed, 40, device="cpu",
                        shrink={"stream": SHRINK[cell]})
    assert r["correct"] is False
    name = "err_lsb" if "pcm16" in cell else "err_db"
    assert r["check"][name]["value"] > r["check"][name]["limit"]
