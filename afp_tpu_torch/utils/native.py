"""Build the port's host C++ libraries with g++ on first use.

A library is compiled into ``build/afp_tpu_torch/`` at the root of the
checkout, named after its stem and a hash of its source and flags (an
edited source rebuilds; an unchanged one loads at once), and written
atomically, so a concurrent loader sees all of it or none.  Sources are
only read.  Nothing here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "build_library"]

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "afp_tpu_torch"


def build_library(source: Path, flags: tuple, stem: str) -> Path:
    """Compile `source` with ``g++`` (``$CXX`` if set) and `flags` into
    ``BUILD_DIR/<stem>_<hash>.so`` if that file is missing, linking
    ``-lpthread``; return its path.  Raises RuntimeError with the
    compiler's diagnostics when the build fails."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(source.read_bytes())
    out = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        lib = Path(tmpdir) / out.name
        r = subprocess.run([cxx, *flags, "-o", str(lib), str(source),
                            "-lpthread"], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(
                f"native build failed (exit {r.returncode}):\n{r.stderr}")
        os.replace(lib, out)
    return out
