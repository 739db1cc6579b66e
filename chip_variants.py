"""Patched copies of the port's package, for the chip sweeps
(`chip_conv_sweep.py`, `chip_agc_ablate.py`).

A copy is a directory under ``build/`` holding a package (this checkout's
`afp_tpu_torch/` or another checkout's), this checkout's `chip_smoke.py`,
this module and the sweep's script, with some of the copy's sources
rewritten; the checkout's own package is never changed.  A sweep builds
every copy at once, one process each (``script --build``), then runs
``script --measure`` in each copy in a process of its own; each prints one
JSON object as its last line.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def make_copy(dst: Path, src: Path, script: str, rewrite=None) -> Path:
    """`dst`: the package of the checkout at `src`, with the smoke, this
    module and `script` from this checkout; then ``rewrite(dst)`` edits
    the copy (and may raise to refuse it)."""
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copytree(src / "afp_tpu_torch", dst / "afp_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in ("chip_smoke.py", Path(__file__).name, script):
        shutil.copy2(ROOT / f, dst / f)
    if rewrite is not None:
        rewrite(dst)
    return dst


def replace_once(path: Path, old: str, new: str) -> None:
    """Replace `old` by `new` in the file at `path`; ValueError unless
    `old` occurs exactly once."""
    text = path.read_text()
    if text.count(old) != 1:
        raise ValueError(f"{path.name}: {old[:60]!r} occurs {text.count(old)} times")
    path.write_text(text.replace(old, new))


def child(dst: Path, script: str, mode: str) -> dict:
    """Run the copy of `script` in `dst` with `mode`; its last line is JSON."""
    r = subprocess.run([sys.executable, script, mode], cwd=dst,
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"{dst} {mode} failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def build_all(dirs, script: str) -> list:
    """``script --build`` in every copy at once; their JSON lines in order."""
    with ThreadPoolExecutor(len(dirs)) as pool:
        return list(pool.map(lambda d: child(d, script, "--build"), dirs))
