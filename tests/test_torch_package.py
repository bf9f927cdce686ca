"""The PyTorch port's package contract: no jax anywhere in it, explicit
devices, and kernels that launch or raise (never fall back)."""

import pkgutil
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


def test_port_modules_listed():
    for name in ("device", "ops._build", "ops.dpe", "ops.dpe_real",
                 "ops.score", "models.dpe", "ops.acquisition", "ops.track",
                 "ops.tracking", "models.scalar"):
        assert f"navlab_dpe_sdr_tpu_torch.{name}" in PORT_MODULES


def test_importing_the_port_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k.startswith('jaxlib'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


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
    from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu.models.grid import uniform_grid
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
    from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
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
