"""Build and load the port's CUDA kernels.

Each `ops/csrc/<name>.cu` (package data: it ships with an installed
package) exposes a plain C interface. At first use it is compiled with nvcc
for Hopper (sm_90a) into a shared library and loaded with ctypes. The
library goes to `navlab_dpe_sdr_tpu_torch/build/` (listed in .gitignore)
when the package directory is writable, and otherwise to a per-user cache
directory ($XDG_CACHE_HOME, else ~/.cache, under
navlab_dpe_sdr_tpu_torch/build). The library's file name carries a hash of
the source and the flags, so an edited source is rebuilt, never served
stale. Nothing is compiled when a module is imported.
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
PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PACKAGE_DIR / "build"        # in a checkout (.gitignore)

# -fmad=false keeps each scored point's f32 arithmetic identical, op for
# op, to the plain PyTorch version it is held against (ops/score.py).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# Kernel launches since the last reset, keyed by kernel and mode: K1
# "score_argmax" (per block) and "score_argmax_sum" (block-summed), and
# "score_argmax_factored" and "score_argmax_sum_factored" where the same
# ran on a product grid's factors, K2
# "score_surface", K3 "correlate_window" (one window) and
# "correlate_windows" (the windows mode), K4 "track_chunk" (m = 1),
# "track_chunk_coherent" (m > 1) and "track_chunk_batched" (batch_k > 1),
# K5 "windowed_correlate" (one call: its one cluster launch), and the soft
# LNAV decode's bit loop "navbits_loop" (one a decode attempt that takes the
# soft path).
# Each wrapper adds one right after its kernel launches, and nowhere else;
# receivers of a fleet launch from threads of their own, so the count is
# kept under a lock.
KERNEL_MODES = ("score_argmax", "score_argmax_sum", "score_argmax_factored",
                "score_argmax_sum_factored", "score_surface",
                "correlate_window", "correlate_windows", "track_chunk",
                "track_chunk_coherent", "track_chunk_batched",
                "windowed_correlate", "navbits_loop")
_launches: dict[str, int] = {}
_count_lock = threading.Lock()


def count_launch(kernel: str) -> None:
    with _count_lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1


def launch_counts() -> dict[str, int]:
    """{kernel mode: launches since the last reset} (0 for none)."""
    with _count_lock:
        return {k: _launches.get(k, 0) for k in KERNEL_MODES}


def reset_launch_counts() -> None:
    with _count_lock:
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


def build_dir() -> Path:
    """Where the libraries go: `build/` beside the package's modules when
    the package directory is writable (a checkout), else the per-user cache
    (an installed package)."""
    if os.access(PACKAGE_DIR, os.W_OK):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "navlab_dpe_sdr_tpu_torch" / "build"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not already built) -> the library path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    out = out_dir / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed building {src.name} "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half
    return out


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first call;
    `bind(lib)` (its ctypes signatures) runs once, before any caller sees
    the library, so threads launching at once never find it half bound."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            bind(lib)
            _libs[name] = lib
        return lib
