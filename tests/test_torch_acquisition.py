"""Port FFT acquisition (ops/acquisition.py) vs the JAX reference on the
same complex64 samples: the same found flags, code phases and Doppler bins,
peak metrics within rtol 1e-4 (float32 FFTs of two libraries: the metrics
are ratios of peak to trimmed mean, measured equal to ~3e-7)."""

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import synth_simple
from navlab_dpe_sdr_tpu.ops import acquisition as jacq
from navlab_dpe_sdr_tpu_torch.ops import acquisition as tacq

torch.set_num_threads(2)

FS = 2.5e6
FCAID = F_CA / F_L1


@pytest.fixture(scope="module")
def scenario_10ms():
    sim, hand, _ = make_scenario(nav_data=True)
    return sim.generate(25000), hand


def _check(ref, out):
    assert [r.prn for r in out] == [r.prn for r in ref]
    for a, b in zip(ref, out):
        assert a.found == b.found, a.prn
        assert b.rc == a.rc and b.fi == a.fi and b.fc == a.fc, a.prn
        assert abs(b.ri - a.ri) < 1e-6, a.prn
        np.testing.assert_allclose(b.cppm, a.cppm, rtol=1e-4)
        np.testing.assert_allclose(b.cppr, a.cppr, rtol=1e-4)


@pytest.mark.parametrize("coherent", [True, False])
def test_acquire_matches_jax(scenario_10ms, coherent):
    iq, hand = scenario_10ms
    ref = jacq.acquire(iq, hand.prn_list, FS, FCAID, coherent=coherent)
    out = tacq.acquire(iq, hand.prn_list, FS, FCAID, coherent=coherent,
                       device="cpu")
    _check(ref, out)
    assert all(r.found for r in out)


def test_acquire_absent_prn_and_truth():
    """Single-PRN truth (tests/test_acquisition.py's signal) and an absent
    PRN, against the JAX search and the truth."""
    rc_true, fi_true = 512.25, 1750.0
    sig = synth_simple(7, FS, 25000, rc=rc_true, ri=0.42, fi=fi_true,
                       cn0_dbhz=45.0, seed=3)
    out = tacq.acquire(sig, [7, 21], FS, FCAID, device="cpu")
    _check(jacq.acquire(sig, [7, 21], FS, FCAID), out)
    assert out[0].found and not out[1].found
    assert abs((out[0].rc - rc_true + L_CA / 2) % L_CA - L_CA / 2) < 0.6
    assert abs(out[0].fi - fi_true) < 12.0


def test_acquire_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA path is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tacq.acquire(np.zeros(25000, np.complex64), [1], FS, FCAID)
