"""The frozen synthesizer against the port's, and the run's noise."""

import numpy as np
import pytest
import torch

from benchmark.frozen.io import scenario as frozen_scenario
from benchmark.harness import capture

KW = dict(nav_data=True, cn0_dbhz=47.0)


@pytest.mark.parametrize("start", [0, 2_500_017])
def test_frozen_signal_is_the_ports(start):
    """The frozen copy's noiseless piece plus the synthesizer's own noise
    (the same generator, seeded as it seeds it) is the port's
    CaptureSimulator's output, bit for bit; and the frozen copy with its
    noise is too. (A simulator built with sigma = 0 would scale the
    signal to nothing as well: its amplitudes are sigma times the C/N0's
    share.)"""
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario

    n = 25_000
    sim, hand, _ = frozen_scenario.make_scenario(**KW)
    port, port_hand, _ = make_scenario(**KW)
    want = port.generate(n, start_sample=start)
    assert np.array_equal(sim.generate(n, start_sample=start), want)
    clean = sim.generate(n, start_sample=start, noise=False)
    rng = np.random.default_rng(sim.seed + start)
    v = clean.view(np.float32).reshape(n, 2).copy()
    scale = np.float32(sim.sigma / np.sqrt(2.0))
    for j in range(2):
        noise = rng.standard_normal(n, dtype=np.float32)
        noise *= scale
        v[:, j] += noise
    assert np.array_equal(v.view(np.complex64).reshape(n), want)
    assert hand.prn_list == port_hand.prn_list
    assert np.array_equal(hand.rc, port_hand.rc)


def test_device_noise_sigma_and_seed():
    """sigma / sqrt(2) a component, independent of the signal, the same
    from the same seed, other from another."""
    n, S = 400_000, 50_000
    zero = np.zeros(n, np.complex64)
    a = capture.add_noise(zero, 2**31 + 5, 32.0, torch.device("cpu"), S)
    b = capture.add_noise(zero, 2**31 + 5, 32.0, torch.device("cpu"), S)
    c = capture.add_noise(zero, 2**31 + 6, 32.0, torch.device("cpu"), S)
    assert a.dtype == torch.int16 and a.shape == (n // S, S, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    x = a.reshape(-1, 2).double()
    sd = x.std(dim=0)
    assert torch.allclose(sd, torch.full((2,), 32.0 / np.sqrt(2.0),
                                         dtype=torch.float64), rtol=0.01)
    assert abs(float((x[:, 0] * x[:, 1]).mean()) / 512.0) < 0.01
    sig = (np.arange(n) % 7).astype(np.complex64)
    d = capture.add_noise(sig, 2**31 + 5, 32.0, torch.device("cpu"), S)
    assert torch.equal((d.reshape(-1, 2)[:, 0].long()
                        - a.reshape(-1, 2)[:, 0].long()).abs().max()
                       <= 7, torch.tensor(True))
