"""The cold-start slice's CUDA kernels against their plain PyTorch versions
on the card: K3 (correlate_window), K4 (track_chunk), K2 (score_surface),
and the receivers that run them. Marked `cuda`; they skip without a card.

The kernels do the plain versions' f32 operations in the same order (sums
included, -fmad=false), so every comparison is equality, bit for bit. This
file imports nothing of JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py
"""

import copy

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu.models.grid import spread_grid, uniform_grid
from navlab_dpe_sdr_tpu_torch.models import dpe as tdpe
from navlab_dpe_sdr_tpu_torch.models import scalar as tscalar
from navlab_dpe_sdr_tpu_torch.ops import acquisition as tacq
from navlab_dpe_sdr_tpu_torch.ops import _build, score, track, tracking

FS = 2.5e6
S = 2500
FCAID = F_CA / F_L1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def capture():
    """0.6 s of the 8-PRN scenario as int16 I/Q."""
    sim, hand, arr = make_scenario(nav_data=True)
    n = int(0.6 * FS)
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr


def _seeded_state(hand, device):
    return tracking.init_state(rc=hand.rc, ri=hand.ri, fc=hand.fc,
                               fi=hand.fi, cp=hand.cp, device=device)


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_correlate_window_kernel_equals_plain(dtype, dev):
    rng = np.random.default_rng(9)
    tab = torch.from_numpy(ca_table(range(1, 9)).astype(np.float32)).to(dev)
    st = tracking.init_state(rc=rng.random(8) * 1023.0, ri=rng.random(8),
                             fc=F_CA + rng.standard_normal(8),
                             fi=rng.standard_normal(8) * 1000.0, device=dev)
    raw = torch.from_numpy(np.round(rng.standard_normal((S, 2)) * 64.0)
                           .astype(np.float32)).to(dtype).to(dev)
    before = _build.launch_counts()["correlate_window"]
    out = track.correlate_window(raw, st.rc, st.dfc, st.ri, st.fi, tab, FS)
    assert _build.launch_counts()["correlate_window"] == before + 1
    rf = raw.float()
    plain, _ = track.correlate_window_plain(
        rf[:, 0], rf[:, 1], st.rc, st.dfc, st.ri, st.fi, tab,
        track.window_times(S, FS, dev), FS)
    assert torch.equal(out, plain)


def test_track_chunk_kernel_equals_plain(capture, dev):
    samples, hand, _ = capture
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    raw = torch.from_numpy(samples[:200 * S].view(np.int16)
                           .reshape(200, S, 2).copy()).to(dev)
    st0 = _seeded_state(hand, dev)
    before = _build.launch_counts()
    sk, lfk, lik = tracking.track_chunk_packed(st0, raw, tab, FS, FCAID)
    after = _build.launch_counts()
    # K3's body runs inside K4: only K4's count moves
    assert after["track_chunk"] == before["track_chunk"] + 1
    assert after["correlate_window"] == before["correlate_window"]
    sp, lfp, lip = tracking.track_chunk_plain(st0, raw, tab, FS, FCAID)
    assert torch.equal(lik, lip) and torch.equal(lfk, lfp)
    for k in tracking.TrackState._fields:
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k


@pytest.mark.parametrize("interp,l_power", [("quadratic", 1),
                                            ("linear", 2)])
def test_score_surface_kernel_equals_plain(interp, l_power, dev):
    rng = np.random.default_rng(4)
    g = spread_grid()
    win = np.abs(rng.standard_normal((1, 8, 12))).astype(np.float32) + 0.1
    win[:, :, 5:8] += [4.0, 10.0, 4.0]
    los = rng.standard_normal((1, 8, 3))
    los /= np.linalg.norm(los, axis=2, keepdims=True)
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in
            (win, los, 6.0 + rng.standard_normal((1, 8)) * 0.4,
             np.full((1, 8), FS / 2.99792458e8), np.full((1, 8), 2.2e7),
             g.d_enu, g.dt_m)]
    before = _build.launch_counts()["score_surface"]
    k = score.score_surface(*args, interp=interp, l_power=l_power)
    assert _build.launch_counts()["score_surface"] == before + 1
    p = score.score_surface_plain(*args, interp=interp, l_power=l_power)
    assert torch.equal(k, p)


def test_acquire_on_card_matches_cpu(capture, dev):
    samples, hand, _ = capture
    iq = (samples["i"][:25000] + 1j * samples["q"][:25000]).astype(
        np.complex64)
    cpu = tacq.acquire(iq, hand.prn_list, FS, FCAID, device="cpu")
    card = tacq.acquire(iq, hand.prn_list, FS, FCAID, device=dev)
    for a, b in zip(cpu, card):
        assert (a.found, a.rc, a.fi) == (b.found, b.rc, b.fi)
        np.testing.assert_allclose(b.cppm, a.cppm, rtol=1e-4)


def test_scalar_receiver_on_card_equals_plain(capture, dev):
    """The receiver's chunked K4 tracking (pinned uploads on a copy stream)
    logs exactly what the plain tracker logs on the same card tensors."""
    samples, hand, _ = capture
    rx = tscalar.ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                                hand.prn_list, device=dev)
    rx.state = st0 = _seeded_state(hand, dev)
    rx.track(400, chunk_ms=150)
    raw = torch.from_numpy(samples[:400 * S].view(np.int16)
                           .reshape(400, S, 2).copy()).to(dev)
    _, logf, logi = tracking.track_chunk_plain(st0, raw, rx.code_table, FS,
                                               FCAID)
    rows = {k: i for i, k in enumerate(tracking.LOG_F_ROWS)}
    for ci, prn in enumerate(hand.prn_list):
        ch = rx.channels[prn]
        np.testing.assert_array_equal(ch.col("cp"),
                                      logi[:, 0, ci].cpu().numpy())
        for k in ("iP", "qP", "rc", "fi"):
            np.testing.assert_array_equal(
                ch.col(k), logf[:, rows[k], ci].cpu().numpy(), err_msg=k)


def test_per_block_step_on_card_matches_cpu(capture, dev):
    """Three per-block steps (the windowed correlator, then K2 twice) on
    the card and on the CPU: the same fixes."""
    samples, hand, arr = capture
    grid = uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
    runs = []
    for device in ("cpu", dev):
        rx = tdpe.DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                              copy.deepcopy(hand), grid=grid,
                              eph=copy.deepcopy(arr), device=device)
        before = _build.launch_counts()["score_surface"]
        rx.run(3)
        launched = _build.launch_counts()["score_surface"] - before
        assert launched == (6 if rx.device.type == "cuda" else 0)
        runs.append(rx)
    for a, b in zip(*(r.fixes for r in runs)):
        np.testing.assert_allclose(b.x_ecef, a.x_ecef, rtol=0, atol=1e-6)
