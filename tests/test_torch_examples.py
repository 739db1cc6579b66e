"""The port's examples (`afp_tpu_torch/examples/`) run headless on the CPU
under ``AFP_FORCE_CPU=1``, at `tests/test_examples.py`'s small arguments,
each in a fresh interpreter whose import system refuses jax and
`afp_tpu`; without the switch and without a card they exit non-zero."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

#: run one example as ``python -m afp_tpu_torch.examples.<name>`` with jax
#: and the JAX package blocked
_RUN = """
import runpy, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "afp_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
name, sys.argv = sys.argv[1], [sys.argv[1]] + sys.argv[2:]
runpy.run_module(f"afp_tpu_torch.examples.{name}", run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "afp_tpu"))
assert not bad, bad
"""

EXAMPLES = [
    ["eq_stream", "--streams", "2"],
    ["eq_stream", "--bands", "3", "--streams", "2"],
    ["agc_stream", "--streams", "2"],
    ["presets_stream"],
    ["waterfall_stream"],
    ["baseline_stream", "--streams", "2", "--blocks", "5"],
    ["per_stream_banks", "--streams", "4", "--blocks", "4"],
    ["live_audio"],  # no PortAudio here: prints the devices, exits 0
    ["ring_serving", "--streams", "2", "--blocks", "6", "--chunk", "2"],
    ["long_kernel_parallel", "--taps", "3000", "--block", "1024"],
]

#: the examples that write files take --out-dir
WRITES = {"eq_stream", "presets_stream", "waterfall_stream", "baseline_stream"}


def run(argv, env, tmp_path):
    if argv[0] in WRITES:
        argv = argv + ["--out-dir", str(tmp_path)]
    return subprocess.run([sys.executable, "-c", _RUN, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("argv", EXAMPLES, ids=lambda a: " ".join(a))
def test_example_runs(argv, tmp_path):
    r = run(argv, {**os.environ, "AFP_FORCE_CPU": "1"}, tmp_path)
    print(r.stdout[-1500:])
    assert r.returncode == 0, r.stderr[-2000:]
    if argv[0] == "waterfall_stream":
        assert (tmp_path / "waterfall.png").stat().st_size > 1000
    if argv[0] == "presets_stream":
        assert "resume max diff: 0.0" in r.stdout
    if argv[0] == "long_kernel_parallel":
        err = float(r.stdout.split("worst rel err")[1].split("dB")[0])
        print(f"long_kernel_parallel: {err} dB (bound -100)")
        assert "per-device FFT 2048 vs single-device 4096" in r.stdout
        assert err <= -100.0


def test_examples_refuse_without_a_card_or_the_switch(tmp_path):
    """No card here: without AFP_FORCE_CPU an example exits non-zero
    before any work."""
    env = {k: v for k, v in os.environ.items() if k != "AFP_FORCE_CPU"}
    r = run(["live_audio"], env, tmp_path)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
