"""Build and load the port's CUDA kernels.

Each `ops/csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled with nvcc for Hopper (sm_90a) into a shared library under
`navlab_dpe_sdr_tpu_torch/build/` (listed in .gitignore) and loaded with
ctypes. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt, never served stale. Nothing is
compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# -fmad=false keeps each scored point's f32 arithmetic identical, op for
# op, to the plain PyTorch version it is held against (ops/score.py).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# Kernel launches since the last reset, keyed by kernel name
# ("score_argmax", "score_surface", "correlate_window", "track_chunk").
# Each wrapper adds one right after its kernel launches, and nowhere else.
_launches: dict[str, int] = {}


def count_launch(kernel: str) -> None:
    _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset} (0 for none)."""
    return {k: _launches.get(k, 0) for k in (
        "score_argmax", "score_surface", "correlate_window", "track_chunk")}


def reset_launch_counts() -> None:
    _launches.clear()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the
    toolkit's default location. Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not already built) -> the library path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src.name} "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first call."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
