"""The PyTorch port's package contract: no jax and nothing of the JAX
package anywhere in it, explicit devices, and kernels that launch or raise
(never fall back)."""

import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import navlab_dpe_sdr_tpu_torch as port
from navlab_dpe_sdr_tpu_torch.device import resolve_device
from navlab_dpe_sdr_tpu_torch.ops import _build, score

torch.set_num_threads(2)

PORT_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(port.__path__,
                                          port.__name__ + "."))
REPO = pathlib.Path(port.__file__).resolve().parent.parent
HOST_LAYERS = ("constants", "io.handoff", "io.rawfile", "io.scenario",
               "io.synth", "libgnss.cacode", "libgnss.dataparser",
               "libgnss.ephemeris", "libgnss.frames", "libgnss.iono",
               "libgnss.lnav", "libgnss.naveng", "libgnss.satcache",
               "libgnss.satpos", "libgnss.tropo", "models.ekf", "models.grid",
               "io.frontend", "io.netsource", "runtime.nativelib",
               "io.printer", "io.mapplot", "libgnss.rinex", "libgnss.filters",
               "runtime.flow")


def test_port_modules_listed():
    for name in ("device", "ops._build", "ops.dpe", "ops.dpe_real",
                 "ops.score", "models.dpe", "ops.acquisition", "ops.track",
                 "ops.tracking", "models.scalar", "models.vector",
                 "models.fleet", "models.montecarlo", "cli", "console",
                 "__main__", "parallel.mesh", "parallel.launch",
                 "tracing") + HOST_LAYERS:
        assert f"navlab_dpe_sdr_tpu_torch.{name}" in PORT_MODULES


def test_importing_the_port_leaves_jax_out():
    """Every module of the port, chip_smoke and profile_dispatch (their
    main() runs only under __main__), in a fresh interpreter: neither jax
    nor the JAX package may come along."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES + ['chip_smoke', 'profile_dispatch']!r}"
            ":\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.startswith('jax') or "
            "k == 'navlab_dpe_sdr_tpu' or "
            "k.startswith('navlab_dpe_sdr_tpu.'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_module_of_the_jax_package():
    """No import statement of the port, of chip_smoke.py or of
    profile_dispatch.py names navlab_dpe_sdr_tpu (only
    navlab_dpe_sdr_tpu_torch), or jax."""
    pat = re.compile(r"^\s*(from|import)\s+(navlab_dpe_sdr_tpu|jax|jaxlib)"
                     r"(\.|\s|$)", re.M)
    files = sorted(pathlib.Path(port.__path__[0]).rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "profile_dispatch.py"]
    assert len(files) > 25
    names = {str(f.relative_to(REPO)) for f in files}
    for f in ("cli.py", "console.py", "__main__.py"):
        assert f"navlab_dpe_sdr_tpu_torch/{f}" in names
    bad = [str(f.relative_to(REPO)) for f in files
           if pat.search(f.read_text())]
    assert not bad, bad


def test_importing_main_runs_nothing():
    """`import navlab_dpe_sdr_tpu_torch.__main__` (as the import test above
    does) must not start the CLI: with an argv that would exit non-zero
    (`dpe` on a missing file), the import returns and prints nothing."""
    code = ("import sys\n"
            "sys.argv = ['x', '--device', 'cpu', 'dpe', '/nonexistent.dat', "
            "'--handoff', '/nonexistent.csv']\n"
            "import navlab_dpe_sdr_tpu_torch.__main__ as m\n"
            "print(m.main.__module__)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout == "navlab_dpe_sdr_tpu_torch.cli\n"


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_receiver_defaults_to_cuda_and_never_to_cpu():
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu_torch.models.grid import uniform_grid
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEReceiver

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is moot")
    _, hand, arr = make_scenario()
    rf = SampleFile(samples=np.zeros(50000, DTYPE_IQ16), fs=2.5e6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DPEReceiver(rf, hand, grid=uniform_grid(n=3), eph=arr)


def test_score_argmax_refuses_other_devices():
    t = torch.zeros((1, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        score.score_argmax(t, t, t, t, None, t, t)
    with pytest.raises(ValueError, match="cpu or cuda"):
        score.score_surface(t, t, t, t, None, t, t)


def test_scalar_receiver_defaults_to_cuda_and_never_to_cpu():
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
    from navlab_dpe_sdr_tpu_torch.ops.tracking import init_state

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is moot")
    rf = SampleFile(samples=np.zeros(50000, DTYPE_IQ16), fs=2.5e6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScalarReceiver(rf, [1, 2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(rc=[0.0], ri=[0.0], fc=[1.023e6], fi=[0.0])


def test_build_names_sources_in_the_repo():
    for name in ("score_argmax", "track_chunk"):
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parent == _build.CSRC.parent.parent


def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path):
    """An installed package whose directory is not writable builds into
    $XDG_CACHE_HOME/navlab_dpe_sdr_tpu_torch/build, from the sources
    shipped as package data (pyproject.toml)."""
    import os
    import tomllib
    from pathlib import Path

    real_access = os.access
    monkeypatch.setattr(_build.os, "access", lambda p, mode: (
        False if Path(p) == _build.PACKAGE_DIR and mode == os.W_OK
        else real_access(p, mode)))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    want = tmp_path / "navlab_dpe_sdr_tpu_torch" / "build"
    assert _build.build_dir() == want
    # a stand-in compiler that writes the library nvcc would
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    for name in ("score_argmax", "track_chunk", "windowed_correlate"):
        lib = _build.build(name)
        assert lib.parent == want and lib.is_file(), lib
        assert lib.name.startswith(f"lib{name}_")
    monkeypatch.undo()
    assert _build.build_dir() == _build.BUILD_DIR

    with open(Path(__file__).resolve().parent.parent / "pyproject.toml",
              "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    globs = data["navlab_dpe_sdr_tpu_torch"]
    shipped = {p.resolve() for g in globs
               for p in _build.PACKAGE_DIR.glob(g)}
    # the kernels' sources and the native host runtime's copied sources
    native = _build.PACKAGE_DIR / "runtime" / "native"
    want = {p.resolve() for p in (*_build.CSRC.glob("*.cu"),
                                  *native.glob("*.cpp"))}
    assert shipped == want
    assert len(shipped) == 5
