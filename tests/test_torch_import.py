"""The port imports no jax and nothing of `afp_tpu`: in a fresh interpreter
whose import system refuses both, the package, its subpackages and every
module of the CLI slice import, and a small pipeline, with and without
AGC, and a short `stream` through the CLI run end to end on the CPU."""
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys

BLOCKED = ("jax", "jaxlib", "afp_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import importlib
for mod in MODS:
    importlib.import_module(mod)
EXTRA
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""

_RUN = """
import numpy as np
from afp_tpu_torch.engine import StreamConfig, StreamEngine
for agc in (False, True):
    eng = StreamEngine(StreamConfig(blocksize=256, batch=2, numtaps=31,
                                    conv_strategy="td_mxu", agc_enabled=agc,
                                    agc_window_size=128), device="cpu")
    out = eng.process_block(np.full((2, 256), 0.1, np.float32))
    assert out.shape == (2, 256) and eng.metrics.underruns == 0
import os
os.environ["AFP_FORCE_CPU"] = "1"
from afp_tpu_torch.cli import main
assert main(["stream", "--tone", "440", "--blocks", "3", "--lockstep",
             "--blocksize", "256", "--numtaps", "33", "--agc"]) == 0
"""


def _probe(mods, extra=""):
    return subprocess.run(
        [sys.executable, "-c",
         _PROBE.replace("MODS", repr(mods)).replace("EXTRA", extra)],
        cwd=REPO, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("mods,extra", [
    (["afp_tpu_torch", "afp_tpu_torch.engine", "afp_tpu_torch.runtime",
      "afp_tpu_torch.ops", "afp_tpu_torch.ops.agc", "afp_tpu_torch.ops.cuda",
      "afp_tpu_torch.ops.cuda.agc_rms", "afp_tpu_torch.ops.cuda.agc_scan",
      "afp_tpu_torch.design", "afp_tpu_torch.utils",
      "afp_tpu_torch.utils.wavio", "afp_tpu_torch.engine.presets",
      "afp_tpu_torch.engine.checkpoint", "afp_tpu_torch.runtime.devices",
      "afp_tpu_torch.runtime.framer", "afp_tpu_torch.runtime.host",
      "afp_tpu_torch.runtime.dispatcher", "afp_tpu_torch.runtime.audio",
      "afp_tpu_torch.cli", "afp_tpu_torch.__main__"], ""),
    (["afp_tpu_torch.engine"], _RUN)], ids=["import", "run"])
def test_imports_without_jax(mods, extra):
    r = _probe(mods, extra)
    print(r.stdout, r.stderr[-2000:])
    assert r.returncode == 0 and r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("mod,blocked", [("jax.numpy", "jax"),
                                         ("afp_tpu.design", "afp_tpu")])
def test_the_blocker_blocks(mod, blocked):
    """The probe itself refuses jax and afp_tpu (so the tests above prove
    something)."""
    r = _probe([mod])
    assert r.returncode != 0 and f"blocked: {blocked}" in r.stderr
