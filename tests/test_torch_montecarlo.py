"""The port's Monte-Carlo harness (models/montecarlo.py) against the JAX
package's, on the CPU at small sizes.

Each sweep runs in both packages on the same seeded capture or scenario with
a small grid. Fixes come from equal argmaxes filtered in float64 on the
host, so the per-run errors agree to 1e-6 m and the rounded rows (`MCRun`,
`SensPoint`), the shift file, the summary and the XECEF logs are equal. The
weak-signal survey lands within one fine-lattice step of the JAX solve (its
U/clock ridge is flat to float32, ROADMAP Queue 3), so its error is held to
that step.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.models import montecarlo as jmc
from navlab_dpe_sdr_tpu.models.grid import uniform_grid
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu_torch.models import montecarlo as tmc

torch.set_num_threads(2)

FS = 2.5e6
GRID = dict(n=5, pos_spacing=15.0, vel_spacing=1.0)


@pytest.fixture(autouse=True)
def f32_taps():
    old = jreal.SCORE_TAP_DTYPE
    jreal.SCORE_TAP_DTYPE = jnp.float32
    yield
    jreal.SCORE_TAP_DTYPE = old


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """12 blocks of the 8-PRN scenario in a capture file, and its handoff."""
    sim, hand, _ = make_scenario(nav_data=True)
    n = 50000 * 12
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    path = tmp_path_factory.mktemp("mc") / "cap.dat"
    samples.tofile(path)
    return str(path), hand


def _both(run):
    """run(module, kw) for the JAX module and the port (device="cpu")."""
    return run(jmc, {}), run(tmc, dict(device="cpu"))


def _same_runs(jr, tr):
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert b.row() == a.row()
        assert (b.shift_enu, b.dt_m, b.radius_m, b.spacing) == (
            a.shift_enu, a.dt_m, a.radius_m, a.spacing)
        np.testing.assert_allclose(b.errs, a.errs, rtol=0, atol=1e-6)


def test_perturbation_sweep_matches_jax(capture, tmp_path):
    path, hand = capture
    out = {}

    def run(mod, kw):
        d = tmp_path / mod.__name__.split(".")[0]
        res = mod.perturbation_sweep(
            path, hand, runs=2, blocks=10, bottom=30.0, span=10.0, seed=3,
            grid=uniform_grid(**GRID), out_dir=str(d), fs=FS, verbose=False,
            **kw)
        summary = mod.convergence_summary(res)
        mod.save_summary(str(d / "summary.json"), summary, res)
        out[mod] = (d, summary, mod.format_summary(summary))
        return res

    jr, tr = _both(run)
    _same_runs(jr, tr)
    assert all(30.0 <= abs(np.linalg.norm(r.shift_enu[:2])) for r in tr)
    (jd, js, jf), (td, ts, tf) = out[jmc], out[tmc]
    assert ts == js and tf == jf
    assert (td / "shifts.csv").read_text() == (jd / "shifts.csv").read_text()
    assert json.loads((td / "summary.json").read_text()) == json.loads(
        (jd / "summary.json").read_text())
    for idx in range(2):
        a = np.loadtxt(jd / f"run{idx:03d}_XFile.csv", delimiter=",")
        b = np.loadtxt(td / f"run{idx:03d}_XFile.csv", delimiter=",")
        assert a.shape == b.shape == (10, 9)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)


def test_spacing_sweep_matches_jax(capture):
    path, hand = capture
    jr, tr = _both(lambda mod, kw: mod.spacing_sweep(
        path, hand, [10.0, 20.0], blocks=8, grid_n=5, style="uniform",
        fs=FS, verbose=False, **kw))
    _same_runs(jr, tr)
    assert [r.spacing for r in tr] == [10.0, 20.0]


def test_cn0_sweep_matches_jax(tmp_path):
    outs = {}

    def run(mod, kw):
        outs[mod] = tmp_path / f"{mod.__name__.split('.')[0]}.csv"
        return mod.cn0_sweep([45.0, 30.0], blocks=16, blocks_per_fix=8,
                             grid=uniform_grid(**GRID), coherent=True,
                             out_path=str(outs[mod]), verbose=False, **kw)

    jp, tp = _both(run)
    for a, b in zip(jp, tp):
        assert b.cn0_dbhz == a.cn0_dbhz and b.held == a.held
        np.testing.assert_allclose(
            [b.per_block_med_m, b.integrated_med_m, b.coherent_med_m],
            [a.per_block_med_m, a.integrated_med_m, a.coherent_med_m],
            rtol=0, atol=1e-6)
    assert outs[tmc].read_text() == outs[jmc].read_text()
    assert outs[tmc].read_text().splitlines()[0].split(",") == \
        tmc.SENS_HEADER


def test_weak_sweep_matches_jax(tmp_path):
    """One level, 2 batches of 16 blocks, the noise envelope calibrated
    once: the closed-loop integrated errors equal, the survey within one
    fine-lattice step (1 m) of the JAX solve."""
    outs = {}

    def run(mod, kw):
        outs[mod] = tmp_path / f"{mod.__name__.split('.')[0]}.csv"
        return mod.weak_sweep([40.0], blocks=32, blocks_per_fix=16,
                              grid=uniform_grid(**GRID), fine_n=5,
                              fine_spacing=1.0, out_path=str(outs[mod]),
                              verbose=False, **kw)

    (a,), (b,) = _both(run)
    assert b.cn0_dbhz == a.cn0_dbhz and b.held == a.held
    np.testing.assert_allclose(b.integrated_med_m, a.integrated_med_m,
                               rtol=0, atol=1e-6)
    assert abs(b.survey_err_m - a.survey_err_m) <= 1.0 * np.sqrt(3) + 1e-6
    np.testing.assert_allclose(b.survey_sigma_m, a.survey_sigma_m,
                               rtol=1e-2)
    head = outs[tmc].read_text().splitlines()[0]
    assert head.split(",") == tmc.WEAK_HEADER == jmc.WEAK_HEADER


def test_sweeps_default_to_cuda_and_never_to_cpu(capture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is moot")
    path, hand = capture
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmc.perturbation_sweep(path, hand, runs=1, blocks=1, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmc.cn0_sweep([45.0], blocks=1, verbose=False)
