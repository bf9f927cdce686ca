"""The port's cold-start slice vs the JAX package: ScalarReceiver
(acquire -> track -> LNAV -> handoff), its .mat checkpoints, and the short
chain into the per-block DPE step.

Tracking tolerances are test_torch_tracking.py's free-running ones (the XLA
scan decides ~1 sample per window differently, so the loops carry
independent noise responses). The chain is seeded from the scenario's exact
handoff state with cp = hand.cp, so the scenario's ephemeris anchors hold in
each receiver's own cp frame (the fleet note in the verify skill). Handoffs
then agree to the tracker's tolerance (rc within 1e-3 chips; the scalar fix
within 0.1 m, measured 0.02 m), and each package's DPE receiver, run from
its own handoff, takes the same argmaxes.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.models import dpe as jdpe
from navlab_dpe_sdr_tpu.models import scalar as jscalar
from navlab_dpe_sdr_tpu.models.grid import uniform_grid
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu.ops import tracking as jt
from navlab_dpe_sdr_tpu_torch.models import dpe as tdpe
from navlab_dpe_sdr_tpu_torch.models import scalar as tscalar
from navlab_dpe_sdr_tpu_torch.ops import tracking as tt

torch.set_num_threads(2)

FS = 2.5e6
SECONDS = 2.2


@pytest.fixture(autouse=True)
def f32_taps():
    old = jreal.SCORE_TAP_DTYPE
    jreal.SCORE_TAP_DTYPE = jnp.float32
    yield
    jreal.SCORE_TAP_DTYPE = old


@pytest.fixture(scope="module")
def capture():
    sim, hand, arr = make_scenario(nav_data=True)
    n = int(SECONDS * FS)
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr


def _receiver(pkg, samples, hand, seeded: bool):
    kw = dict(device="cpu") if pkg is tscalar else {}
    rx = pkg.ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                            hand.prn_list, **kw)
    if seeded:
        init = dict(rc=hand.rc, ri=hand.ri, fc=hand.fc, fi=hand.fi,
                    cp=hand.cp)
        rx.state = (tt.init_state(**init, device="cpu") if pkg is tscalar
                    else jt.init_state(**init))
    return rx


def _check_logs(jrx, trx, rows=slice(None)):
    """The free-running tracking tolerances on the absorbed logs."""
    for prn in jrx.prn_list:
        a, b = jrx.channels[prn], trx.channels[prn]
        for k in ("cp", "lock"):
            np.testing.assert_array_equal(b.col(k)[rows], a.col(k)[rows],
                                          err_msg=f"{prn} {k}")
        drc = np.abs(b.col("rc")[rows] - a.col("rc")[rows])
        assert np.minimum(drc, 1023.0 - drc).max() < 1e-3, prn
        assert np.abs(b.col("fi")[rows] - a.col("fi")[rows]).max() < 1.0
        pa = np.hypot(a.col("iP")[rows], a.col("qP")[rows])
        pb = np.hypot(b.col("iP")[rows], b.col("qP")[rows])
        assert (np.abs(pa - pb) / pa.max()).max() < 0.02, prn


def test_acquire_and_track_match_jax(capture):
    samples, hand, _ = capture
    rxs = []
    for pkg in (jscalar, tscalar):
        rx = _receiver(pkg, samples, hand, seeded=False)
        res = rx.acquire(verbose=False, engine="fft")
        assert all(r.found for r in res)
        rx.track(300, chunk_ms=200)
        rxs.append((rx, res))
    (jrx, jres), (trx, tres) = rxs
    for a, b in zip(jres, tres):
        assert (b.rc, b.fi) == (a.rc, a.fi)
        np.testing.assert_allclose(b.cppm, a.cppm, rtol=1e-4)
    assert trx.mcount == jrx.mcount == 300
    assert trx._m_samp == jrx._m_samp
    _check_logs(jrx, trx)
    for prn in hand.prn_list:
        np.testing.assert_array_equal(trx.channels[prn].cp_sign[5:],
                                      jrx.channels[prn].cp_sign[5:])


def test_save_state_resumes_across_packages(capture, tmp_path):
    """A JAX checkpoint resumes in the port with equal logs and carry; the
    port's checkpoint loads back into the JAX receiver unchanged."""
    samples, hand, arr = capture
    jrx = _receiver(jscalar, samples, hand, seeded=True)
    jrx.track(300, chunk_ms=150)
    jrx.set_ephemerides({e.prn: copy.deepcopy(e) for e in arr.ephs})
    jrx.save_state(str(tmp_path / "jax"))

    trx = _receiver(tscalar, samples, hand, seeded=False)
    trx.load_state(str(tmp_path / "jax"))
    assert trx.mcount == jrx.mcount and trx._m_samp == jrx._m_samp
    assert trx.rawfile.sample_pos == jrx.rawfile.sample_pos
    back = tt.state_to_numpy(trx.state)
    for k, v in jrx.state._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    for prn in hand.prn_list:
        a, b = jrx.channels[prn], trx.channels[prn]
        for k in tscalar.LOG_FIELDS:
            np.testing.assert_array_equal(b.col(k), a.col(k), err_msg=k)
        np.testing.assert_array_equal(b.cp_sign, a.cp_sign)
        assert b.ephemeris.sqrt_A == a.ephemeris.sqrt_A

    jrx.track(200, chunk_ms=200)
    trx.track(200, chunk_ms=200)
    _check_logs(jrx, trx, rows=slice(300, None))

    trx.save_state(str(tmp_path / "port"))
    jback = _receiver(jscalar, samples, hand, seeded=False)
    jback.load_state(str(tmp_path / "port"))
    for k, v in tt.state_to_numpy(trx.state).items():
        # the JAX load_state keeps scipy's 2-D [1, C] vectors
        np.testing.assert_array_equal(
            np.asarray(getattr(jback.state, k)).reshape(v.shape), v,
            err_msg=k)
    assert jback.mcount == 500


def test_short_chain_into_dpe_matches_jax(capture):
    """Seeded track 2 s -> handoff with the scenario ephemerides -> 4
    per-block DPE fixes, in each package from its own handoff."""
    samples, hand, arr = capture
    grid = uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
    out = {}
    for spkg, dpkg in ((jscalar, jdpe), (tscalar, tdpe)):
        rx = _receiver(spkg, samples, hand, seeded=True)
        rx.track(2000)
        rx.set_ephemerides({e.prn: copy.deepcopy(e) for e in arr.ephs})
        h = rx.save_handoff("")
        kw = dict(device="cpu") if dpkg is tdpe else {}
        drx = dpkg.DPEReceiver(SampleFile(samples=samples.copy(), fs=FS), h,
                               grid=grid, eph=rx.eph_array(),
                               config=dpkg.DPEConfig(), **kw)
        drx.run(4)
        out[spkg] = (h, drx, rx)
    (hj, dj, rj), (ht, dt, rt) = out[jscalar], out[tscalar]
    _check_logs(rj, rt)
    np.testing.assert_array_equal(ht.cp, hj.cp)
    assert ht.bytes_read == hj.bytes_read == 2000 * 2500 * 4
    drc = np.abs(ht.rc - hj.rc)
    assert np.minimum(drc, 1023.0 - drc).max() < 1e-3
    assert np.abs(ht.x_ecef[:3] - hj.x_ecef[:3]).max() < 0.1
    assert np.linalg.norm(ht.x_ecef[:3] - hand.x_ecef[:3]) < 15.0
    assert len(dt.fixes) == len(dj.fixes) == 4
    for fj, ft in zip(dj.fixes, dt.fixes):
        assert fj.mc == ft.mc
        # within 0.1 m on a 15 m lattice: the same argmaxes
        np.testing.assert_allclose(ft.x_ecef[:3], fj.x_ecef[:3], rtol=0,
                                   atol=0.1)
        assert np.linalg.norm(ft.x_ecef[:3] - hand.x_ecef[:3]) < 15.0
    for a, b in zip(dj.flip_log, dt.flip_log):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_unported_scalar_modes_raise(capture):
    """What the receiver still refuses: the all-real acquisition engine
    (not ported by design), more than 10 ms a coherent window, batch_k
    with coherent windows, spans that are no multiple of the update, and
    tracking before acquisition."""
    samples, hand, _ = capture
    rx = _receiver(tscalar, samples, hand, seeded=True)
    for call in (lambda: rx.acquire(engine="real", verbose=False),
                 lambda: rx.acquire(engine="real", deep_ms=400,
                                    verbose=False)):
        with pytest.raises(NotImplementedError, match="Not to port"):
            call()
    with pytest.raises(ValueError, match="coh_ms must be in 1..10"):
        rx.track(22, coh_ms=11)
    with pytest.raises(ValueError, match="1 ms cadence only"):
        rx.track(8, coh_ms=4, batch_k=2)
    with pytest.raises(ValueError, match="not a multiple of coh_ms"):
        rx.track(10, coh_ms=4)
    with pytest.raises(ValueError, match="not a multiple of batch_k"):
        rx.track(10, batch_k=4)
    assert rx.mcount == 0
    with pytest.raises(RuntimeError, match="acquire"):
        _receiver(tscalar, samples, hand, seeded=False).track(10)


@pytest.mark.slow
def test_cold_start_chain_end_to_end():
    """The full cold start in the port on the CPU: a 38 s capture, acquire,
    track to the LNAV decode, 8/8 ephemerides equal to the scenario's,
    scalar PVT and the first per-block DPE fix within 15 m."""
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n = int(38.0 * FS)
    samples = np.empty(n, DTYPE_IQ16)
    step = int(FS)
    for s0 in range(0, n, step):
        iq = sim.generate(min(step, n - s0), start_sample=s0)
        samples["i"][s0:s0 + len(iq)] = np.clip(np.round(iq.real), -32768,
                                               32767)
        samples["q"][s0:s0 + len(iq)] = np.clip(np.round(iq.imag), -32768,
                                               32767)
    rx = tscalar.ScalarReceiver(SampleFile(samples=samples, fs=FS),
                                hand.prn_list, device="cpu")
    assert all(r.found for r in rx.acquire(verbose=False))
    rx.track(30_000)
    signal_ms = 30_000
    good = rx.decode_ephemerides(verbose=False)
    while len(good) < len(hand.prn_list) and signal_ms < 36_000:
        rx.track(2_000)
        signal_ms += 2_000
        good = rx.decode_ephemerides(verbose=False)
    assert sorted(good) == sorted(hand.prn_list)
    for e in arr.ephs:
        dec = rx.channels[e.prn].ephemeris
        assert abs(dec.sqrt_A - e.sqrt_A) < 1e-3
        assert abs(dec.t_oe - e.t_oe) < 1e-9
        assert abs(dec.M_0 - e.M_0) < 1e-8
    _, _, x_ecef, _, _ = rx.nav_solution()
    assert np.linalg.norm(x_ecef[:3] - hand.x_ecef[:3]) < 15.0
    h = rx.save_handoff("")
    drx = tdpe.DPEReceiver(SampleFile(samples=samples, fs=FS), h,
                           eph=rx.eph_array(), device="cpu")
    fix = drx.run(1)[0]
    assert np.linalg.norm(fix.x_ecef[:3] - hand.x_ecef[:3]) < 15.0
