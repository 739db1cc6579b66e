"""The port imports no jax and nothing of `afp_tpu`: in a fresh interpreter
whose import system refuses both, the package, its subpackages and every
module of the CLI, multirate and observation slices (the spectrum, the
plots, the controller, the GUI, the examples) import, and a small
pipeline, with and without AGC, a short `stream` through the CLI, the
multirate paths (the ASRC, the literal chain, the parallel AGC,
``--samplerate``) and the observation paths (the carried waterfall, the
serving tap, the controller, the CLI's plots) run end to end on the
CPU, and so does the parallel layer (a sharded pipeline and its server,
the halo exchange, a long signal, the kernel-parallel FIR, ``--mesh``).
`afp_tpu.parallel`'s names are all there but ``P`` and ``NamedSharding``
(jax's sharding types: the port's shard layout is structural)."""
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

#: the multirate slice: the exact ASRC frontend, compat ASRC, the literal
#: chain with upsampled output, the parallel AGC, and the CLI's
#: --samplerate
_RUN_MULTIRATE = """
import numpy as np
from afp_tpu_torch.engine import StreamConfig, StreamEngine
for over, n_out in ((dict(source_samplerate=48000), None),
                    (dict(source_samplerate=88200, asrc_mode="compat"), 256),
                    (dict(output_rate="upsampled"), 512),
                    (dict(agc_enabled=True, agc_mode="parallel",
                          agc_window_size=128), 256)):
    eng = StreamEngine(StreamConfig(blocksize=256, batch=2, numtaps=31,
                                    **over), device="cpu")
    out = eng.process_signal(np.full((2, 8192), 0.1, np.float32))
    assert out.shape[1] > 0 and eng.metrics.underruns == 0
    if n_out:
        assert out.shape[1] == 32 * n_out
import os, tempfile
os.environ["AFP_FORCE_CPU"] = "1"
from afp_tpu_torch.cli import main
from afp_tpu_torch.utils import read_wav, write_wav
d = tempfile.mkdtemp()
write_wav(d + "/in.wav", np.full((1, 4800), 0.1, np.float32), 48000)
assert main(["process", d + "/in.wav", d + "/out.wav", "--samplerate",
             "44100", "--blocksize", "256", "--numtaps", "33"]) == 0
assert read_wav(d + "/out.wav")[0].shape == (1, 4410)
"""


#: the observation slice: the carried waterfall, the serving tap, the
#: controller and the CLI's plots
_RUN_OBSERVE = """
import numpy as np
from afp_tpu_torch.engine import Pipeline, StreamConfig, StreamEngine
from afp_tpu_torch.runtime import RingServer
from afp_tpu_torch.ui import EqualizerController
eng = StreamEngine(StreamConfig(blocksize=256, batch=2, numtaps=31,
                                waterfall_enabled=True), device="cpu")
eng.process_signal(np.full((2, 1024), 0.1, np.float32))
assert eng.waterfall_ring().shape == (2, 50, 129)
srv = RingServer(Pipeline(StreamConfig(blocksize=256, batch=2, numtaps=31,
                                       conv_strategy="td_mxu"), "cpu"),
                 slots=8, chunk=2, spectrum_every=1)
list(srv.stream(iter(np.full((4, 2, 256), 0.1, np.float32))))
assert srv.waterfall_ring.shape == (50, 129)
ctl = EqualizerController(StreamEngine(StreamConfig(blocksize=256, numtaps=31),
                                       device="cpu"))
ctl.show_spectrum = True
ctl.update_spectrum(np.full((1, 256), 0.1, np.float32))
assert ctl.spectrum_peak is not None
import os, tempfile
os.environ["AFP_FORCE_CPU"] = "1"
from afp_tpu_torch.cli import main
from afp_tpu_torch.utils import write_wav
d = tempfile.mkdtemp()
write_wav(d + "/in.wav", np.full((1, 2048), 0.1, np.float32), 44100)
assert main(["process", d + "/in.wav", d + "/out.wav", "--blocksize", "256",
             "--numtaps", "33", "--spectrum-plot", d + "/s.png",
             "--waterfall-plot", d + "/w.png"]) == 0
assert main(["design", "--numtaps", "33", "--plot", d + "/r.png",
             "--taps-out", d + "/h.txt"]) == 0
assert all(os.path.getsize(d + f) > 1000 for f in ("/s.png", "/w.png", "/r.png"))
"""


#: the parallel slice on 4 CPU shards
_RUN_PARALLEL = """
import numpy as np
from afp_tpu_torch.engine import Pipeline, PipelineParams, StreamConfig
from afp_tpu_torch.parallel import (KernelParallelConv, ShardedPipeline,
                                    filter_long_signal, halo_convolve,
                                    make_mesh)
from afp_tpu_torch.runtime import RingServer
cfg = StreamConfig(blocksize=256, batch=4, numtaps=31, conv_strategy="td_mxu")
sp = ShardedPipeline(cfg, make_mesh(4, devices=["cpu"] * 4))
params = sp.device_params(PipelineParams.design(sp.cfg))
st, y = sp.run(params, sp.init_state(), np.full((2, 4, 256), 0.1, np.float32))
assert y.shape == (2, 4, 256)
srv = RingServer(sp, params, slots=4, chunk=2, max_inflight=1)
assert len(list(srv.stream(iter(np.full((4, 4, 256), 0.1, np.float32))))) == 4
t = make_mesh(4, ("time",), devices=["cpu"] * 4)
assert halo_convolve(np.ones(1024, np.float32), np.ones(9, np.float32), t).shape == (1024,)
pipe = Pipeline(StreamConfig(blocksize=256, batch=1, numtaps=31), "cpu")
y = filter_long_signal(pipe, pipe.device_params(PipelineParams.design(pipe.cfg)),
                       np.full((1, 4096), 0.1, np.float32), t)
assert y.shape == (1, 4096)
kp = KernelParallelConv(np.ones(100), 256, make_mesh(4, ("kernel",), devices=["cpu"] * 4))
assert kp.step(kp.init_state(), np.ones((1, 256), np.float32))[1].shape == (1, 256)
import os, tempfile
os.environ["AFP_FORCE_CPU"] = "1"
from afp_tpu_torch.cli import main
from afp_tpu_torch.utils import write_wav
d = tempfile.mkdtemp()
write_wav(d + "/in.wav", np.full((2, 1024), 0.1, np.float32), 44100)
assert main(["process", d + "/in.wav", d + "/out.wav", "--blocksize", "256",
             "--numtaps", "33", "--mesh", "2"]) == 0
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
      "afp_tpu_torch.cli", "afp_tpu_torch.__main__",
      "afp_tpu_torch.ops.resample", "afp_tpu_torch.ops.convolve",
      "afp_tpu_torch.runtime.asrc"], ""),
    (["afp_tpu_torch.engine"], _RUN),
    (["afp_tpu_torch.engine"], _RUN_MULTIRATE),
    (["afp_tpu_torch.ops.spectrum", "afp_tpu_torch.viz",
      "afp_tpu_torch.viz.plot_filter", "afp_tpu_torch.viz.waterfall",
      "afp_tpu_torch.ui", "afp_tpu_torch.ui.controller",
      "afp_tpu_torch.ui.gui", "afp_tpu_torch.examples",
      *(f"afp_tpu_torch.examples.{m}" for m in (
          "agc_stream", "baseline_stream", "eq_stream", "live_audio",
          "per_stream_banks", "presets_stream", "ring_serving",
          "waterfall_stream"))], _RUN_OBSERVE),
    (["afp_tpu_torch.parallel", "afp_tpu_torch.parallel.mesh",
      "afp_tpu_torch.parallel.collectives", "afp_tpu_torch.parallel.dp",
      "afp_tpu_torch.parallel.halo", "afp_tpu_torch.parallel.long",
      "afp_tpu_torch.parallel.kp",
      "afp_tpu_torch.examples.long_kernel_parallel"], _RUN_PARALLEL)],
    ids=["import", "run", "multirate", "observe", "parallel"])
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


def test_parallel_names_match_afp_tpu():
    """`afp_tpu_torch.parallel` exports `afp_tpu.parallel`'s names, less
    jax's sharding types ``P`` and ``NamedSharding``."""
    import afp_tpu.parallel as ref
    import afp_tpu_torch.parallel as port

    assert set(ref.__all__) - set(port.__all__) == {"P", "NamedSharding"}
    assert all(hasattr(port, n) for n in port.__all__)
