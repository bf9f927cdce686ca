"""The port's integrated, survey, refined and full-EKF modes vs the JAX
package, on the CPU at small sizes (inputs from numpy seeds).

Scorer: `score_argmax(block_sum=True)` and `score_joint_argmax` against the
JAX `_score_axis_accumulate` (scanned in 1000-point chunks) and
`score_joint_argmax`: best within rtol 1e-5 (XLA sums the blocks in an
order of its own; 2e-5 for sinc, whose whole-window sums also differ in
order), argmax equal. `dpe_scan_integrate` against the JAX function on the
same packed inputs: head indices and flips equal, peaks rtol 1e-4 (the
correlators differ at 1e-7 and the peaks sum 8 channels x N blocks),
windows within 1e-4 of their largest tap.

Receiver: one seeded capture and one handoff go to both receivers. Argmax
indices are lattice offsets, so equal argmaxes give fixes equal to 1e-6 m;
where device float32 windows enter the host solve (Newton polish, the full
EKF's score-curvature R, the weighted mean) fixes agree to 1e-3 m. The
survey's `x_ecef` is held to one fine-lattice step (the U/clock ridge is
flat to float32 there and the two scorers break the tie differently; two
steps with sinc zoom passes), its covariances to rtol 1e-3; `_collect`
tuples of the JAX run go through the port's `_survey_solve` to hold the
host solve apart from the device side.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import C
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import CaptureSimulator
from navlab_dpe_sdr_tpu.libgnss import frames
from navlab_dpe_sdr_tpu.models import dpe as jmodel
from navlab_dpe_sdr_tpu.models.grid import spread_grid, uniform_grid
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu_torch.models import dpe as tmodel
from navlab_dpe_sdr_tpu_torch.ops import dpe_real as treal
from navlab_dpe_sdr_tpu_torch.ops import score as tscore

torch.set_num_threads(2)

FS = 2.5e6
N_BLOCKS = 18


@pytest.fixture(autouse=True)
def f32_taps():
    old = jreal.SCORE_TAP_DTYPE
    jreal.SCORE_TAP_DTYPE = jnp.float32
    yield
    jreal.SCORE_TAP_DTYPE = old


def _to_iq16(iq):
    samples = np.empty(iq.shape[0], DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples


# -- the block-summed scorer --------------------------------------------------

def _inputs(seed=7, n=5, c=8, w=24, g=3001, with_r0=True):
    rng = np.random.default_rng(seed)
    win = np.abs(rng.standard_normal((n, c, w))).astype(np.float32) + 0.1
    win[:, :, w // 2 - 1:w // 2 + 2] += [4.0, 10.0, 4.0]
    los = rng.standard_normal((n, c, 3)).astype(np.float32)
    los /= np.linalg.norm(los, axis=2, keepdims=True)
    centers = (np.full((n, c), w / 2.0)
               + rng.standard_normal((n, c)) * 0.4).astype(np.float32)
    coefs = np.full((n, c), 0.00834, np.float32)
    r0 = np.full((n, c), 2.2e7, np.float32) if with_r0 else None
    o3 = (rng.standard_normal((g, 3)) * 60).astype(np.float32)
    o1 = (rng.standard_normal(g) * 40).astype(np.float32)
    return win, los, centers, coefs, r0, o3, o1


def _jax_accumulate(args, interp, l_power, weighted):
    res = jreal._score_axis_accumulate(
        *(None if a is None else jnp.asarray(a) for a in args), interp,
        l_power, chunk=1000, weighted=weighted)
    return [np.asarray(r) for r in res]


def _port_sum(args, interp, l_power, weighted):
    res = tscore.score_argmax(
        *(None if a is None else torch.from_numpy(a) for a in args),
        interp=interp, l_power=l_power, weighted=weighted, block_sum=True)
    return [r.numpy() for r in res]


def _check_sum(out, ref, weighted, rtol):
    assert out[0].shape == () and out[0].dtype == np.float32
    assert out[1].shape == () and out[1].dtype == np.int32
    assert int(out[1]) == int(ref[1])
    np.testing.assert_allclose(out[0], ref[0], rtol=rtol)
    if weighted:
        assert out[2].shape == (4,) and out[3].shape == ()
        np.testing.assert_allclose(out[3], ref[3], rtol=1e-4)
        np.testing.assert_allclose(out[2] / out[3], ref[2] / ref[3],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("interp", ["quadratic", "linear", "sinc"])
@pytest.mark.parametrize("l_power", [1, 2])
@pytest.mark.parametrize("with_r0", [True, False])
def test_block_sum_matches_jax_accumulate(with_r0, l_power, interp,
                                          weighted):
    args = _inputs(with_r0=with_r0)
    ref = _jax_accumulate(args, interp, l_power, weighted)
    out = _port_sum(args, interp, l_power, weighted)
    _check_sum(out, ref, weighted, 2e-5 if interp == "sinc" else 1e-5)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 50])
@pytest.mark.parametrize("interp", ["quadratic", "linear"])
def test_block_sum_matches_jax_accumulate_over_n(interp, n):
    """N = 1 (one block: no sum), 2, 7, 8 (the integrated fix) and 50 (a
    survey batch): the plain block sum, which the card's kernel is held to
    bit for bit, against the JAX `_score_axis_accumulate` at the tolerance
    above."""
    args = _inputs(seed=100 + n, n=n, w=12, g=2003)
    ref = _jax_accumulate(args, interp, 1, True)
    out = _port_sum(args, interp, 1, True)
    _check_sum(out, ref, True, 1e-5)


@pytest.mark.parametrize("layout", ["twice over", "twice in a row",
                                    "twice in a row, one point on"])
def test_block_sum_tie_goes_to_first_copy(layout):
    """Every grid point laid out twice, so that its copies tie exactly
    (across the JAX scan's chunks and the kernel's tiles; among a thread's
    points; across threads): the port's plain block sum takes the first
    copy of the point the single layout takes, as the JAX
    `_score_axis_accumulate` does."""
    win, los, centers, coefs, r0, o3, o1 = _inputs(seed=57, n=8, w=12,
                                                   g=1001)
    k = int(_port_sum((win, los, centers, coefs, r0, o3, o1), "quadratic",
                      1, False)[1])
    if layout == "twice over":
        o3, o1, first = np.concatenate([o3, o3]), np.concatenate([o1, o1]), k
    else:
        o3, o1, first = np.repeat(o3, 2, axis=0), np.repeat(o1, 2), 2 * k
        if layout != "twice in a row":
            o3 = np.concatenate([o3[-1:], o3])
            o1 = np.concatenate([o1[-1:], o1])
            first = 0 if k == 1000 else 2 * k + 1
    args = (win, los, centers, coefs, r0, o3, o1)
    ref = _jax_accumulate(args, "quadratic", 1, False)
    out = _port_sum(args, "quadratic", 1, False)
    _check_sum(out, ref, False, 1e-5)
    assert int(out[1]) == first


@pytest.mark.parametrize("interp", ["quadratic", "sinc"])
@pytest.mark.parametrize("has_r0", [True, False])
def test_score_joint_argmax_matches_jax(has_r0, interp):
    """Epochs with their own geometry (B = 6), the survey's call."""
    args = _inputs(seed=31, n=6, w=12, g=4097, with_r0=True)
    best, arg = jreal.score_joint_argmax(
        *(jnp.asarray(a) for a in args), interp=interp, has_r0=has_r0,
        chunk=1000)
    got = treal.score_joint_argmax(*(torch.from_numpy(a) for a in args),
                                   interp=interp, has_r0=has_r0)
    assert int(got[1]) == int(arg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(best),
                               rtol=2e-5 if interp == "sinc" else 1e-5)


@pytest.mark.parametrize("interp", ["quadratic", "linear", "sinc"])
def test_block_sum_odd_sizes(interp):
    """Odd G, C, W and N; and a plain scan whose chunks do not divide G
    gives the same bits."""
    args = _inputs(seed=11, n=3, c=5, w=9, g=777)
    ref = _jax_accumulate(args, interp, 1, True)
    out = _port_sum(args, interp, 1, True)
    _check_sum(out, ref, True, 2e-5 if interp == "sinc" else 1e-5)
    small = tscore.score_argmax_plain(
        *(None if a is None else torch.from_numpy(a) for a in args),
        interp=interp, weighted=True, chunk=100, block_sum=True)
    assert int(small[1]) == int(out[1])
    assert float(small[0]) == float(out[0])


def test_block_sum_exact_tie_takes_first_index():
    """The grid twice over (second copy 700 points on, across a JAX chunk
    boundary): the summed scores tie exactly and the first copy wins."""
    win, los, centers, coefs, r0, o3, o1 = _inputs(seed=3, g=700)
    args = (win, los, centers, coefs, r0, np.concatenate([o3, o3]),
            np.concatenate([o1, o1]))
    ref = _jax_accumulate(args, "quadratic", 1, False)
    out = _port_sum(args, "quadratic", 1, False)
    assert int(out[1]) == int(ref[1]) < 700


def test_block_sum_is_the_sum_of_the_surfaces():
    """S(g) is the f32 sum over n of the per-block surface, in ascending
    n: best and arg are those of that sum, bit for bit."""
    args = [None if a is None else torch.from_numpy(a)
            for a in _inputs(seed=5, n=7, g=2000)]
    surf = tscore.score_surface(*args)
    tot = surf[0]
    for i in range(1, surf.shape[0]):
        tot = tot + surf[i]
    best, arg = tscore.score_argmax(*args, block_sum=True)
    assert int(arg) == int(tot.argmax()) and float(best) == float(tot.max())


def test_score_rejects_unknown_interp():
    args = [None if a is None else torch.from_numpy(a)
            for a in _inputs(g=10)]
    with pytest.raises(ValueError, match="interp"):
        tscore.score_argmax(*args, interp="cubic", block_sum=True)


# -- the receivers on one capture --------------------------------------------

@pytest.fixture(scope="module")
def scenario():
    """18 blocks of the 8-PRN scenario; the handoff starts 52 m off truth
    so the argmaxes move; a 7^4 grid at 15 m / 1 m/s spacing."""
    sim, hand, arr = make_scenario(nav_data=True)
    samples = _to_iq16(sim.generate(50000 * N_BLOCKS))
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    grid = uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
    return samples, hand, arr, grid, truth


def _receiver(pkg, scenario, **cfg):
    samples, hand, arr, grid, _ = scenario
    kw = dict(device="cpu") if pkg is tmodel else {}
    return pkg.DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                           copy.deepcopy(hand), grid=grid,
                           config=pkg.DPEConfig(**cfg),
                           eph=copy.deepcopy(arr), **kw)


def _capture(samples, pkg):
    blocks = samples.view(np.int16).reshape(-1, 50000, 2)
    return jnp.asarray(blocks) if pkg is jmodel else torch.from_numpy(blocks)


def _both(scenario, run, **cfg):
    out = []
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, scenario, **cfg)
        out.append((rx, run(rx, pkg)))
    return out


def _assert_same_fixes(jrx, trx, atol):
    assert len(trx.fixes) == len(jrx.fixes) > 0
    for fj, ft in zip(jrx.fixes, trx.fixes):
        assert fj.mc == ft.mc and fj.rx_time == ft.rx_time
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=atol)
        np.testing.assert_allclose(ft.pos_score, fj.pos_score, rtol=1e-4)
        np.testing.assert_allclose(ft.vel_score, fj.vel_score, rtol=1e-4)
    assert len(trx.flip_log) == len(jrx.flip_log)
    for a, b in zip(jrx.flip_log, trx.flip_log):
        np.testing.assert_array_equal(np.asarray(a).astype(bool),
                                      np.asarray(b).astype(bool))


@pytest.mark.parametrize("coherent,return_windows,use_argmax",
                         [(False, False, True), (False, True, False),
                          (True, True, True), (True, False, False)])
def test_dpe_scan_integrate_matches_jax(scenario, coherent, return_windows,
                                        use_argmax):
    samples = scenario[0]
    rx = _receiver(jmodel, scenario)
    preps = rx._prepare_batch(6)
    pk = jreal.pack_params(np.stack([p[0] for p in preps]),
                           np.stack([p[1] for p in preps]), 2)
    kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
              n_periods=rx.S // rx.period, n_blocks=6, l_power=1,
              interp="quadratic", code_win=rx.code_win,
              carr_win=rx.carr_win, coherent=coherent,
              return_windows=return_windows, use_argmax=use_argmax)
    ref = [np.asarray(r) for r in jreal.dpe_scan_integrate(
        _capture(samples, jmodel), jnp.asarray(pk), rx._chips_f32,
        rx._base0, rx._time_idc, rx._d_enu, rx._dt_m, rx._dv_enu,
        rx._dtdot, **kw)]
    d = tmodel.device_state(rx.grid, rx._chips_np, rx.S, FS, "cpu")
    out = [r.numpy() for r in treal.dpe_scan_integrate(
        _capture(samples, tmodel), pk, d.chips, d.time_idc, d.d_enu, d.dt_m,
        d.dv_enu, d.dtdot, **kw)]
    assert len(out) == len(ref) == (4 if return_windows else 2)
    assert out[0].shape == ref[0].shape == ((4,) if use_argmax else (12,))
    for i in range(2):
        assert (treal.unpack_row_indices(out[0][None])[i]
                == jreal.unpack_row_indices(ref[0][None])[i])
    np.testing.assert_allclose(out[0][[1, 3]], ref[0][[1, 3]], rtol=1e-4)
    if not use_argmax:
        np.testing.assert_allclose(out[0][4:], ref[0][4:], rtol=1e-4,
                                   atol=1e-4)
    assert out[1].shape == ref[1].shape == (6, 8)
    np.testing.assert_array_equal(out[1], ref[1])
    for wo, wr in zip(out[2:], ref[2:]):
        assert wo.shape == wr.shape
        assert np.abs(wo - wr).max() < 1e-4 * np.abs(wr).max()


def test_integrated_head_carries_indices_above_2_pow_24(monkeypatch):
    """A dense 75^4 manifold has 31.6 M points, more than float32 counts:
    the argmax goes into the head (and the batched rows) as bits."""
    big_p, big_v = 2 ** 24 + 12345, 31_640_624
    results = iter([(torch.tensor(3.5), torch.tensor(big_p, dtype=torch.int32)),
                    (torch.tensor(1.5), torch.tensor(big_v, dtype=torch.int32))])
    monkeypatch.setattr(treal, "score_argmax", lambda *a, **k: next(results))
    monkeypatch.setattr(
        treal, "batch_correlate",
        lambda *a, **k: treal.RealBlockOut(torch.ones(2, 3, 4),
                                           torch.ones(2, 3, 5),
                                           torch.zeros(2, 3, dtype=torch.bool)))
    pk = treal.pack_params(np.ones((2, 11, 3)), np.ones((2, 3, 3), np.int32),
                           0)
    z = torch.zeros(1)
    head, flips = treal.dpe_scan_integrate(
        torch.zeros(2, 8, 2, dtype=torch.int16), pk, z, z, z, z, z, z,
        carr_fftpts=8, period=4, n_periods=2, n_blocks=2)
    pa, va = treal.unpack_row_indices(head.numpy()[None])
    assert (int(pa[0]), int(va[0])) == (big_p, big_v)
    assert head[1] == 3.5 and head[3] == 1.5 and flips.shape == (2, 3)
    assert int(np.float32(big_p)) != big_p          # a cast would round it
    rows = treal.pack_rows(
        treal.RealBlockOut(torch.ones(1, 3, 4), torch.ones(1, 3, 5),
                           torch.zeros(1, 3, dtype=torch.bool)),
        torch.tensor([big_p]), torch.tensor([3.5]), torch.tensor([big_v]),
        torch.tensor([1.5]), return_windows=False)
    pa, va = treal.unpack_row_indices(rows.numpy())
    assert (int(pa[0]), int(va[0])) == (big_p, big_v)


@pytest.mark.parametrize("coherent", [False, True])
def test_run_integrated_matches_jax(scenario, coherent):
    """Three fixes of 4 blocks from a device-resident capture, then one
    from the file (the prefetcher): argmaxes, flips and fixes equal."""
    samples = scenario[0]

    def run(rx, pkg):
        rx.run_integrated(3, 4, raw_blocks_dev=_capture(samples, pkg),
                          coherent=coherent)
        rx.rawfile.seek_bytes(12 * 50000 * 4)
        rx.run_integrated(1, 4, coherent=coherent)

    (jrx, _), (trx, _) = _both(scenario, run, ekf_mode="alpha")
    assert len(trx.fixes) == 4 and trx.mc == 16
    _assert_same_fixes(jrx, trx, 1e-6)


def test_run_integrated_coast_and_weighted_match_jax(scenario):
    """feedback=False records lattice fixes and leaves the state on its
    prediction; use_argmax=False applies the weighted mean of the
    integrated surfaces (f32 device sums: 1e-3 m)."""
    (jrx, _), (trx, _) = _both(
        scenario, lambda rx, pkg: rx.run_integrated(3, 4, feedback=False))
    _assert_same_fixes(jrx, trx, 1e-6)
    np.testing.assert_array_equal(trx.ekf.x, scenario[1].x_ecef)
    (jrx, _), (trx, _) = _both(
        scenario, lambda rx, pkg: rx.run_integrated(3, 4), use_argmax=False)
    _assert_same_fixes(jrx, trx, 1e-3)


def test_run_integrated_coherent_newton_matches_jax(scenario):
    (jrx, _), (trx, _) = _both(
        scenario, lambda rx, pkg: rx.run_integrated(3, 4, coherent=True),
        refine="newton")
    _assert_same_fixes(jrx, trx, 1e-3)
    # the polish moves the fixes off the 15 m lattice
    r = frames.ecef_to_enu_matrix(scenario[4][0:3])
    enu = np.stack([r @ (f.x_ecef[0:3] - scenario[1].x_ecef[0:3])
                    for f in trx.fixes])
    frac = np.minimum(np.mod(np.abs(enu), 15.0),
                      15.0 - np.mod(np.abs(enu), 15.0))
    assert frac.max() > 1e-3, enu


@pytest.mark.parametrize("cfg", [dict(refine="newton"),
                                 dict(ekf_mode="full"),
                                 dict(refine="newton", ekf_mode="full")])
def test_run_batched_refined_and_full_ekf_match_jax(scenario, cfg):
    """The rows carry the windows: the Newton polish and the adaptive R
    run on them on the host."""
    samples = scenario[0]

    def run(rx, pkg):
        rx.run_batched(12, lookahead=4, raw_blocks_dev=_capture(samples, pkg),
                       pipeline=True, pipeline_depth=2)
        rx.run_batched(6, lookahead=6, raw_blocks_dev=_capture(samples, pkg),
                       start_block=12, group_k=3)

    (jrx, _), (trx, _) = _both(scenario, run, **cfg)
    assert len(trx.fixes) == 14
    _assert_same_fixes(jrx, trx, 1e-3)
    if "ekf_mode" in cfg:
        np.testing.assert_allclose(trx.ekf.P, jrx.ekf.P, rtol=1e-3,
                                   atol=1e-6)


@pytest.mark.parametrize("cfg", [dict(ekf_mode="full"),
                                 dict(refine="newton"),
                                 dict(interp="sinc"),
                                 dict(interp="sinc", use_argmax=False)])
def test_run_per_block_modes_match_jax(scenario, cfg):
    """`step`/`run` with the full EKF (its R from the score curvature), the
    Newton polish, and sinc interpolation."""
    (jrx, _), (trx, _) = _both(scenario, lambda rx, pkg: rx.run(6), **cfg)
    exact = cfg == dict(interp="sinc")
    _assert_same_fixes(jrx, trx, 1e-6 if exact else 1e-3)
    if cfg.get("ekf_mode") == "full":
        np.testing.assert_allclose(trx.ekf.P, jrx.ekf.P, rtol=1e-3,
                                   atol=1e-6)
        assert 1.0 < np.trace(trx.ekf.P[:4, :4]) and np.trace(trx.ekf.P) < 300
        np.testing.assert_allclose(trx.ekf.rts_smooth(), jrx.ekf.rts_smooth(),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["step", "batched", "refined", "integrated",
                                  "coast"])
def test_flip_log_rows_are_bool_in_every_mode(scenario, mode):
    """One bool row [C] per fix, the flip decision, whichever mode wrote
    it (the device's bool in `step`, the packed f32 rows of the batched,
    refined and integrated modes); the values are the JAX receiver's."""
    samples = scenario[0]
    runs = {
        "step": lambda rx, pkg: rx.run(3),
        "batched": lambda rx, pkg: rx.run_batched(
            6, lookahead=3, raw_blocks_dev=_capture(samples, pkg)),
        "refined": lambda rx, pkg: rx.run_batched(
            6, lookahead=3, raw_blocks_dev=_capture(samples, pkg)),
        "integrated": lambda rx, pkg: rx.run_integrated(2, 3),
        "coast": lambda rx, pkg: rx.run_integrated(2, 3, feedback=False)}
    cfg = dict(refine="newton") if mode == "refined" else {}
    (jrx, _), (trx, _) = _both(scenario, runs[mode], **cfg)
    assert len(trx.flip_log) == len(jrx.flip_log) > 0
    for a, b in zip(jrx.flip_log, trx.flip_log):
        assert b.dtype == np.bool_ and b.shape == (8,), (b.dtype, b.shape)
        np.testing.assert_array_equal(b, np.asarray(a) != 0)


def test_noise_envelope_matches_jax(scenario):
    (_, je), (_, te) = _both(
        scenario, lambda rx, pkg: rx.noise_envelope(blocks_per_fix=4,
                                                    n_batches=2, seed=5))
    for a, b in zip(je, te):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-4)
        np.testing.assert_allclose(b.mean(), 1.0, rtol=1e-6)


def test_integrated_dpe_converges_on_the_spread_grid():
    """`tests/test_dpe_real.py::test_integrated_dpe_beats_per_block` at its
    size (48 blocks, K = 8, the 25^4 spread grid, 52 m off): the port's
    fixes equal the JAX receiver's and settle below 8 m."""
    sim, hand, arr = make_scenario(nav_data=True)
    samples = _to_iq16(sim.generate(50000 * 48))
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    sc = (samples, hand, arr, spread_grid(), truth)
    (jrx, _), (trx, _) = _both(sc, lambda rx, pkg: rx.run_integrated(6, 8))
    _assert_same_fixes(jrx, trx, 1e-6)
    errs = [float(np.linalg.norm(f.x_ecef[:3] - truth[:3]))
            for f in trx.fixes]
    assert np.median(errs[2:]) < 8.0, errs


# -- the survey ---------------------------------------------------------------

@pytest.fixture(scope="module")
def survey_runs():
    """`tests/test_survey.py::test_survey_static_with_clock_drift` at its
    size: 64 blocks at 45 dB-Hz with a drifting clock, 8 batches of 8,
    fine_n = 21. The JAX side collects once and solves on that."""
    _, hand, arr = make_scenario(nav_data=True)
    drift = 2e-8
    sim = CaptureSimulator(arr, hand.x_ecef, tow0=hand.rx_time, fs=FS,
                           cn0_dbhz=45.0, nav_data=True, seed=21,
                           clock_drift=drift)
    samples = _to_iq16(sim.generate(50000 * 64))
    truth = hand.x_ecef.copy()
    hand = copy.deepcopy(hand)
    hand.x_ecef[7] = -drift * C
    sc = (samples, hand, arr, spread_grid(), truth)
    jrx = _receiver(jmodel, sc)
    collect = []
    jrx.run_integrated(8, 8, coherent=True, _collect=collect)
    jres = jrx._survey_solve(collect, 64, 0.25, 21, 0.02)
    trx = _receiver(tmodel, sc)
    tres = trx.run_survey(n_batches=8, blocks_per_fix=8, fine_n=21)
    return dict(jrx=jrx, jres=jres, collect=collect, trx=trx, tres=tres,
                truth=truth, drift=drift, scenario=sc)


def _assert_survey_close(tres, jres, step=0.25, vstep=0.02):
    assert (tres.n_blocks, tres.n_batches) == (jres.n_blocks, jres.n_batches)
    assert tres.t_ref == jres.t_ref
    # one fine-lattice step per ENU/clock axis
    np.testing.assert_allclose(tres.d_enu_t, jres.d_enu_t, rtol=0,
                               atol=step + 1e-9)
    np.testing.assert_allclose(tres.x_ecef[:4], jres.x_ecef[:4], rtol=0,
                               atol=step * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(tres.x_ecef[4:], jres.x_ecef[4:], rtol=0,
                               atol=vstep * np.sqrt(3) + 1e-9)
    np.testing.assert_allclose(tres.pos_score, jres.pos_score, rtol=1e-5)
    np.testing.assert_allclose(tres.vel_score, jres.vel_score, rtol=1e-5)
    for name in ("cov_pos", "cov_vel", "sigma_pos", "sigma_vel"):
        np.testing.assert_allclose(getattr(tres, name), getattr(jres, name),
                                   rtol=1e-3, atol=1e-12)


def test_run_survey_matches_jax(survey_runs):
    s = survey_runs
    _assert_same_fixes(s["jrx"], s["trx"], 1e-6)
    _assert_survey_close(s["tres"], s["jres"])
    # and it is a survey: the bounds of the JAX package's own test
    res, truth = s["tres"], s["truth"]
    assert isinstance(res, tmodel.SurveyResult)
    assert res.n_batches == 8 and res.n_blocks == 64
    enu = frames.ecef_to_enu_matrix(truth[0:3]) @ (res.x_ecef[0:3]
                                                    - truth[0:3])
    assert abs(enu[0]) < 1.5 and abs(enu[1]) < 1.5, enu
    assert np.linalg.norm(enu) < 6.0, enu
    assert abs(res.x_ecef[7] - (-s["drift"] * C)) < 0.5
    assert np.linalg.norm(res.x_ecef[4:7]) < 0.5
    assert np.all(res.sigma_pos > 0) and np.all(res.sigma_vel > 0)
    assert res.sigma_pos[2] == max(res.sigma_pos[:3])
    assert np.isfinite(res.pos_score) and np.isfinite(res.vel_score)


@pytest.mark.parametrize("zoom_interp", [None, "sinc"])
def test_survey_solve_on_jax_collect(survey_runs, zoom_interp):
    """The JAX run's windows, geometry, times and predictions, as numpy
    arrays, through the port's host solve and scorer."""
    s = survey_runs
    jres = s["jrx"]._survey_solve(s["collect"], 64, 0.25, 21, 0.02,
                                  zoom_interp)
    tres = s["trx"]._survey_solve(s["collect"], 64, 0.25, 21, 0.02,
                                  zoom_interp)
    # sinc: two steps. Its whole-window sums differ at 1e-6 between the
    # packages, and the ridge's float32 ties reach that far.
    steps = 2 if zoom_interp == "sinc" else 1
    _assert_survey_close(tres, jres, step=0.25 * steps, vstep=0.02 * steps)


def test_survey_weak_signal_path_matches_jax(scenario):
    """Noncoherent collection, coasting, and the noise envelope from a
    throwaway receiver (the default on that path)."""
    (jrx, jres), (trx, tres) = _both(
        scenario, lambda rx, pkg: rx.run_survey(
            n_batches=3, blocks_per_fix=4, fine_n=9, fine_spacing=1.0,
            vel_fine_spacing=0.05, coherent=False, feedback=False))
    _assert_same_fixes(jrx, trx, 1e-6)
    _assert_survey_close(tres, jres, step=1.0, vstep=0.05)
    np.testing.assert_array_equal(trx.ekf.x, scenario[1].x_ecef)


# -- refusals -----------------------------------------------------------------

def test_batch_modes_refuse_score_dumps(scenario, tmp_path):
    """The batched and integrated paths never form the score surfaces: a
    dump directory is refused, as the JAX receiver refuses it."""
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, scenario, dump_scores_to=str(tmp_path))
        for call in (lambda: rx.run_batched(4, lookahead=4),
                     lambda: rx.run_integrated(1, 4),
                     lambda: rx.run_survey(1, 4)):
            with pytest.raises(ValueError, match="dump_scores_to"):
                call()
        assert rx.mc == 0 and not list(tmp_path.iterdir())


def test_constructor_refusals_match_jax(scenario):
    samples, hand, arr, grid, _ = scenario

    def build(pkg, **cfg):
        kw = dict(device="cpu") if pkg is tmodel else {}
        return pkg.DPEReceiver(SampleFile(samples=samples, fs=FS),
                               copy.deepcopy(hand), grid=grid,
                               config=pkg.DPEConfig(**cfg), eph=arr, **kw)

    for pkg in (jmodel, tmodel):
        with pytest.raises(ValueError, match="weighted-mean"):
            build(pkg, refine="newton", use_argmax=False)
        with pytest.raises(ValueError, match="score windows"):
            build(pkg, refine="newton", engine="fft")
        # the FFT engine: per-block only, and the full EKF keeps static R
        with pytest.warns(UserWarning, match="static default R"):
            build(pkg, engine="fft", ekf_mode="full")
        rx = build(pkg, engine="fft")
        with pytest.raises(ValueError, match="batched mode runs on"):
            rx.run_batched(4, lookahead=4)
        with pytest.raises(ValueError, match="integrated mode runs on"):
            rx.run_integrated(1, 4)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        build(tmodel, mesh=object())
    with pytest.raises(ValueError, match="interp"):
        build(tmodel, interp="cubic")
