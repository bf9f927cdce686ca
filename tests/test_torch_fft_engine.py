"""The port's FFT DPE engine (ops/dpe.py, DPEConfig(engine="fft")) against
the JAX package's, on the CPU.

The same seeded numpy inputs go through both: the batched correlator at the
peak-placement cases of tests/test_dpe.py (code and carrier arrays within
1e-5 of the reference's peak, flips equal), the manifold scorer on complex
windows (surfaces rtol 1e-5, sinc 2e-5; argmax equal or a tie within
1e-6), the fused
device step, and the receiver's per-block run from a perturbed handoff
(argmaxes and flips equal, so fixes equal to 1e-6 m). The FFTs round
differently in pocketfft (torch) and XLA's CPU FFT, hence the 1e-5; the
scorer's interpolation is the port's plain `score_points` form against the
JAX weight tensor. The JAX receiver's refusals of the engine (batched and
integrated modes) and its warning for the full EKF hold in both packages.
"""

import copy
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import synth_simple
from navlab_dpe_sdr_tpu.libgnss import frames
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_code
from navlab_dpe_sdr_tpu.models import dpe as jmodel
from navlab_dpe_sdr_tpu.models.grid import uniform_grid
from navlab_dpe_sdr_tpu.ops import dpe as jdpe
from navlab_dpe_sdr_tpu_torch.models import dpe as tmodel
from navlab_dpe_sdr_tpu_torch.ops import dpe as tdpe

torch.set_num_threads(2)

FS = 2.5e6
S = 50000
FPTS = 8 * (1 << 17)
N_BLOCKS = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _correlate_both(sig, prn, rc, fc, idx_next, fi, ri):
    """(JAX BlockScores as numpy, port BlockScores as numpy) of one channel."""
    chips = ca_code(prn)[None, :]
    cf = jdpe.nominal_code_fft(chips, FS, S)
    np.testing.assert_array_equal(tdpe.nominal_code_fft(chips, FS, S), cf)
    parts = jdpe.replica_shift_parts(np.array([rc]), np.array([fc - F_CA]),
                                     FS, S / FS, S)
    for a, b in zip(parts, tdpe.replica_shift_parts(
            np.array([rc]), np.array([fc - F_CA]), FS, S / FS, S)):
        np.testing.assert_array_equal(a, b)
    t = (np.arange(S) / FS).astype(np.float32)
    ins = (sig.astype(np.complex64), cf, *parts,
           np.array([idx_next], np.int32), np.array([fi], np.float32),
           np.array([ri], np.float32), t)
    ref = jdpe.batch_correlate(*(jnp.asarray(a) for a in ins), FPTS)
    out = tdpe.batch_correlate(*(_t(a) for a in ins), FPTS)
    return ([np.asarray(x) for x in ref], [x.numpy() for x in out])


def _close(out, ref):
    """Code and carrier arrays within 1e-5 of the reference's peak; flips
    equal."""
    for k in (0, 1):
        assert out[k].dtype == np.complex64 and out[k].shape == ref[k].shape
        rel = np.abs(out[k] - ref[k]).max() / np.abs(ref[k]).max()
        assert rel < 1e-5, (k, rel)
    np.testing.assert_array_equal(out[2], ref[2])


@pytest.mark.parametrize("d_chips", [-1.5, 0.0, 2.25])
def test_batch_correlate_code_peak_matches_jax(d_chips):
    prn, rc_sig, fi = 9, 400.0, 1500.0
    fc = F_CA + fi * F_CA / F_L1
    sig = synth_simple(prn, FS, S, rc=rc_sig, ri=0.2, fc=fc, fi=fi,
                       cn0_dbhz=48.0, seed=1)
    ref, out = _correlate_both(sig, prn, rc_sig + d_chips, fc, S, fi, 0.2)
    _close(out, ref)
    lo = S // 2 - 1250
    peaks = [lo + int(np.argmax(np.abs(r[0][0])[lo:lo + 2500]))
             for r in (ref, out)]
    assert peaks[0] == peaks[1]
    assert abs(peaks[1] - (S / 2 + (FS / fc) * d_chips)) <= 1.6


@pytest.mark.parametrize("d_hz", [-30.0, 0.0, 55.0])
def test_batch_correlate_carrier_peak_matches_jax(d_hz):
    prn, rc, fi_sig = 4, 100.0, -800.0
    fc = F_CA + fi_sig * F_CA / F_L1
    sig = synth_simple(prn, FS, S, rc=rc, fc=fc, fi=fi_sig, cn0_dbhz=48.0,
                       seed=2)
    ref, out = _correlate_both(sig, prn, rc, fc, S, fi_sig - d_hz, 0.0)
    _close(out, ref)
    peaks = [int(np.argmax(np.abs(r[1][0]))) for r in (ref, out)]
    assert peaks[0] == peaks[1]
    assert abs(peaks[1] - (FPTS / 2 + (FPTS / FS) * d_hz)) <= 1.5


def test_batch_correlate_flip_selection_matches_jax():
    prn, rc, fi = 6, 250.0, 300.0
    fc = F_CA + fi * F_CA / F_L1
    bits = np.ones(60)
    bits[1:] = -1.0
    sig = synth_simple(prn, FS, S, rc=rc, fc=fc, fi=fi, cn0_dbhz=50.0,
                       bits=bits, seed=3)
    idx_next = int(np.floor((20 * L_CA - rc) * FS / fc)) + 1
    ref, out = _correlate_both(sig, prn, rc, fc, idx_next, fi, 0.0)
    _close(out, ref)
    assert bool(out[2][0]) and bool(ref[2][0])
    lo = S // 2 - 1250
    assert abs(lo + int(np.argmax(np.abs(out[0][0])[lo:lo + 2500]))
               - S / 2) <= 1.5


def _windows(seed, c=8, cw=16, vw=48):
    rng = np.random.default_rng(seed)

    def win(w):
        z = (rng.standard_normal((c, w)) + 1j * rng.standard_normal((c, w)))
        z[:, w // 2 - 1:w // 2 + 2] *= [3.0, 8.0, 3.0]
        return z.astype(np.complex64)

    los = rng.standard_normal((c, 3))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    params = [los, np.full(c, 2.2e7) + rng.standard_normal(c) * 1e6,
              cw / 2.0 + rng.standard_normal(c) * 0.4,
              np.full(c, FS / 2.99792458e8),
              vw / 2.0 + rng.standard_normal(c) * 0.4,
              np.full(c, -(FPTS / FS) * F_L1 / 2.99792458e8)]
    grid = uniform_grid(n=9, pos_spacing=12.0, vel_spacing=0.8)
    offs = [grid.d_enu, grid.dt_m, grid.dv_enu, grid.dtdot]
    return (win(cw), win(vw), [p.astype(np.float32) for p in params],
            [o.astype(np.float32) for o in offs])


def _argmax_or_tie(arg_t, arg_j, surf_t):
    if arg_t != arg_j:
        a, b = surf_t[arg_t], surf_t[arg_j]
        assert abs(a - b) <= 1e-6 * abs(a), (arg_t, arg_j, a, b)


@pytest.mark.parametrize("l_power", [1, 2])
@pytest.mark.parametrize("interp", ["quadratic", "linear", "sinc"])
def test_score_manifolds_matches_jax(interp, l_power):
    """Surfaces rtol 1e-5; sinc 2e-5, as tests/test_torch_integrate.py
    holds it: its whole-window sums of alternating taps go through
    `torch.sinc` and `jnp.sinc`, which round differently."""
    rtol = 2e-5 if interp == "sinc" else 1e-5
    code_w, carr_w, params, offs = _windows(17)
    ref = jdpe.score_manifolds(
        jnp.asarray(code_w), jnp.asarray(carr_w),
        jdpe.ManifoldParams(*(jnp.asarray(p) for p in params)),
        *(jnp.asarray(o) for o in offs), l_power=l_power, interp=interp)
    out = tdpe.score_manifolds(
        _t(code_w), _t(carr_w), tdpe.ManifoldParams(*(_t(p) for p in params)),
        *(_t(o) for o in offs), l_power=l_power, interp=interp)
    for k in (0, 2):
        surf_t, surf_j = out[k].numpy(), np.asarray(ref[k])
        assert surf_t.dtype == np.float32 and surf_t.shape == surf_j.shape
        np.testing.assert_allclose(surf_t, surf_j, rtol=rtol, atol=0)
        _argmax_or_tie(int(out[k + 1]), int(ref[k + 1]), surf_t)


def _scenario_block():
    """One block of the 8-PRN scenario with the handoff's channel state."""
    sim, hand, arr = make_scenario(nav_data=True)
    iq = sim.generate(S)
    raw = (np.round(iq.real) + 1j * np.round(iq.imag)).astype(np.complex64)
    return raw, hand


def test_dpe_device_step_matches_jax():
    raw, hand = _scenario_block()
    from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table

    c = len(hand.prn_list)
    cf = jdpe.nominal_code_fft(ca_table(hand.prn_list), FS, S)
    m_int, m_frac = jdpe.replica_shift_parts(
        hand.rc, hand.fc - F_CA, FS, 0.02, S)
    _, _, params, offs = _windows(5, c=c, cw=24, vw=40)
    fpts = 8 * (1 << S.bit_length())
    ins = (raw, cf, m_int, m_frac, np.full(c, S // 3, np.int32),
           hand.fi.astype(np.float32), hand.ri.astype(np.float32),
           (np.arange(S) / FS).astype(np.float32),
           np.full(c, S // 2 - 12, np.int32),
           np.full(c, fpts // 2 - 20, np.int32))
    ref = jdpe.dpe_device_step(
        *(jnp.asarray(a) for a in ins),
        jdpe.ManifoldParams(*(jnp.asarray(p) for p in params)),
        *(jnp.asarray(o) for o in offs), carr_fftpts=fpts, code_win=24,
        carr_win=40)
    out = tdpe.dpe_device_step(
        *(_t(a) for a in ins), tdpe.ManifoldParams(*(_t(p) for p in params)),
        *(_t(o) for o in offs), carr_fftpts=fpts, code_win=24, carr_win=40)
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    for k in (0, 2):
        surf_t = out[k].numpy()
        np.testing.assert_allclose(surf_t, np.asarray(ref[k]), rtol=1e-5,
                                   atol=0)
        _argmax_or_tie(int(out[k + 1]), int(ref[k + 1]), surf_t)


@pytest.fixture(scope="module")
def scenario():
    """N_BLOCKS blocks of the 8-PRN scenario, the handoff 40 m off truth,
    a 7^4 grid at 15 m / 1 m/s spacing."""
    sim, hand, arr = make_scenario(nav_data=True)
    n = S * N_BLOCKS
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([25.0, -30.0, 10.0]))
    grid = uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
    return samples, hand, arr, grid, truth


def _receiver(pkg, scenario, **cfg):
    samples, hand, arr, grid, _ = scenario
    kw = dict(device="cpu") if pkg is tmodel else {}
    return pkg.DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                           copy.deepcopy(hand), grid=grid,
                           config=pkg.DPEConfig(engine="fft", **cfg),
                           eph=copy.deepcopy(arr), **kw)


@pytest.mark.parametrize("cfg", [dict(ekf_mode="alpha", ekf_alpha=0.3),
                                 dict(use_argmax=False)])
def test_fft_receiver_run_matches_jax(scenario, cfg):
    """Per-block run on the FFT engine: flips equal, peaks within rtol
    1e-5, every fix within 1e-6 m of the JAX receiver's (equal argmaxes,
    offsets filtered in float64 on the host); the score-weighted mean within
    1e-5 (a float64 sum over f32 surfaces that agree to ~1e-6 here, the
    FFTs rounding differently)."""
    atol = 1e-6 if cfg.get("use_argmax", True) else 1e-5
    runs = [_receiver(pkg, scenario, **cfg) for pkg in (jmodel, tmodel)]
    for rx in runs:
        rx.run(N_BLOCKS)
    (rj, rt), truth = runs, scenario[4]
    assert len(rt.fixes) == N_BLOCKS
    np.testing.assert_array_equal(np.stack(rt.flip_log),
                                  np.stack(rj.flip_log))
    for fj, ft in zip(rj.fixes, rt.fixes):
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=atol)
        np.testing.assert_allclose([ft.pos_score, ft.vel_score],
                                   [fj.pos_score, fj.vel_score], rtol=1e-5)
    if "ekf_mode" in cfg:      # the argmax run pulls in from 40 m off
        err = np.linalg.norm(rt.fixes[-1].x_ecef[:3] - truth[:3])
        assert err < 25.0, err


def test_fft_engine_refusals_and_warning_match_jax(scenario):
    """Both packages: batched and integrated modes refuse engine='fft' (it
    is the per-block oracle), the full EKF warns that it keeps its static
    R, and refine is refused (no score windows)."""
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, scenario)
        with pytest.raises(ValueError, match="batched mode runs on engine="):
            rx.run_batched(4, lookahead=4)
        with pytest.raises(ValueError, match="integrated mode runs on"):
            rx.run_integrated(1, 4)
        with pytest.raises(ValueError, match="integrated mode runs on"):
            rx.run_survey(1, 4, envelope=None)
        assert rx.mc == 0
        with pytest.warns(UserWarning, match="static default R"):
            _receiver(pkg, scenario, ekf_mode="full")
        with pytest.raises(ValueError, match="score windows"):
            _receiver(pkg, scenario, refine="newton")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _receiver(pkg, scenario, ekf_mode="alpha")
