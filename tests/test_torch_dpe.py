"""The port's DPE receiver vs the JAX receiver on the synthetic scenario:
the fused batched dispatch (`dpe_batch_blocks`), `run_batched` end to end, a
JAX -> port resume through the handoff, and the per-block `step`/`run`
(argmax and score-weighted mean, score dumps) with its scorer
`score_surface` (K2's contract).

Fixes are lattice offsets (argmax mode) filtered on the host in float64, so
equal argmaxes give fixes equal to 1e-6 m; the weighted mean is a float64
host sum over f32 scores that agree to ~1e-7, so its fixes agree to 1e-6 m
as well."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.libgnss import frames
from navlab_dpe_sdr_tpu.models import dpe as jmodel
from navlab_dpe_sdr_tpu.models.grid import uniform_grid
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu_torch.models import dpe as tmodel
from navlab_dpe_sdr_tpu_torch.ops import dpe_real as treal

torch.set_num_threads(2)

FS = 2.5e6
N_BLOCKS = 18


@pytest.fixture(autouse=True)
def f32_taps():
    old = jreal.SCORE_TAP_DTYPE
    jreal.SCORE_TAP_DTYPE = jnp.float32
    yield
    jreal.SCORE_TAP_DTYPE = old


@pytest.fixture(scope="module")
def scenario():
    """18 blocks of the 8-PRN scenario; the handoff starts 50 m off truth
    so the argmaxes move; a 7^4 grid at 15 m / 1 m/s spacing."""
    sim, hand, arr = make_scenario(nav_data=True)
    n = 50000 * N_BLOCKS
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    truth = hand.x_ecef.copy()
    hand.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3],
                                          np.array([30.0, -40.0, 15.0]))
    grid = uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
    return samples, hand, arr, grid, truth


def _receiver(pkg, scenario, handoff=None, use_argmax=True, cfg=None,
              **kw):
    samples, hand, arr, grid, _ = scenario
    cfg = pkg.DPEConfig(**{**dict(ekf_mode="alpha", ekf_alpha=0.3,
                                  use_argmax=use_argmax), **(cfg or {})})
    if pkg is tmodel:
        kw.setdefault("device", "cpu")
    if handoff is None:
        handoff, kw["eph"] = copy.deepcopy(hand), copy.deepcopy(arr)
    return pkg.DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                           handoff, grid=grid, config=cfg, **kw)


def _capture(samples, pkg):
    blocks = samples.view(np.int16).reshape(-1, 50000, 2)
    return jnp.asarray(blocks) if pkg is jmodel else torch.from_numpy(blocks)


@pytest.mark.parametrize("group_k,use_argmax", [(1, True), (3, True),
                                                (1, False)])
def test_dpe_batch_blocks_matches_jax(scenario, group_k, use_argmax):
    samples = scenario[0]
    rx = _receiver(jmodel, scenario)
    preps = rx._prepare_batch(6)
    fpk = np.stack([p[0] for p in preps])
    ipk = np.stack([p[1] for p in preps])
    pk = jreal.pack_params(fpk, ipk, 2)
    kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
              n_periods=rx.S // rx.period, n_blocks=6, l_power=1,
              interp="quadratic", return_windows=True,
              code_win=rx.code_win, carr_win=rx.carr_win, group_k=group_k,
              use_argmax=use_argmax)
    ref = np.asarray(jreal.dpe_batch_blocks(
        _capture(samples, jmodel), jnp.asarray(pk), rx._chips_f32,
        rx._base0, rx._time_idc, rx._d_enu, rx._dt_m, rx._dv_enu,
        rx._dtdot, **kw))
    d = tmodel.device_state(rx.grid, rx._chips_np, rx.S, FS, "cpu")
    out = treal.dpe_batch_blocks(
        _capture(samples, tmodel), pk, d.chips, d.time_idc, d.d_enu,
        d.dt_m, d.dv_enu, d.dtdot, **kw).numpy()
    assert out.shape == ref.shape == (6 // group_k, ref.shape[1])
    for i in range(2):
        np.testing.assert_array_equal(treal.unpack_row_indices(out)[i],
                                      jreal.unpack_row_indices(ref)[i])
    np.testing.assert_allclose(out[:, [1, 3]], ref[:, [1, 3]], rtol=1e-4)
    c = fpk.shape[2]
    np.testing.assert_array_equal(out[:, 4:4 + c], ref[:, 4:4 + c])
    base = 4 + c
    if not use_argmax:
        np.testing.assert_allclose(out[:, base:base + 8],
                                   ref[:, base:base + 8],
                                   rtol=1e-4, atol=1e-4)
        base += 8
    wins_o, wins_r = out[:, base:], ref[:, base:]
    assert np.abs(wins_o - wins_r).max() < 1e-4 * np.abs(wins_r).max()


def test_run_batched_matches_jax(scenario):
    """Three pipelined per-block batches at depth 2 (the first drain comes
    after the third dispatch) then a grouped K=3 batch: every fix equal to
    the JAX receiver's."""
    samples, *_, truth = scenario
    runs = []
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, scenario)
        cap = _capture(samples, pkg)
        rx.run_batched(12, lookahead=4, raw_blocks_dev=cap, pipeline=True,
                       pipeline_depth=2)
        rx.run_batched(6, lookahead=6, raw_blocks_dev=cap, start_block=12,
                       pipeline=True, pipeline_depth=2, group_k=3)
        runs.append(rx)
    jrx, trx = runs
    assert len(trx.fixes) == len(jrx.fixes) == 14
    for fj, ft in zip(jrx.fixes, trx.fixes):
        assert fj.mc == ft.mc
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ft.pos_score, fj.pos_score, rtol=1e-4)
    for a, b in zip(jrx.flip_log, trx.flip_log):
        np.testing.assert_array_equal(a, b)
    # the receiver started 52 m off: it must have moved toward truth
    err = np.linalg.norm(trx.fixes[-1].x_ecef[:3] - truth[:3])
    assert err < 40.0, err


def test_receiver_hands_its_grid_factors_to_the_scorer(scenario,
                                                      monkeypatch):
    """The receiver finds each manifold's product-grid factors once, at its
    build, on the uploaded offsets (the 7^4 grid: L = 7), and hands them
    to every scorer call of its batched and integrated dispatches."""
    from navlab_dpe_sdr_tpu_torch.ops import score as tscore

    rx = _receiver(tmodel, scenario)
    d = rx._dev
    for f, off in ((rx._pos_factors, (d.d_enu, d.dt_m)),
                   (rx._vel_factors, (d.dv_enu, d.dtdot))):
        want = tscore.grid_factors(*off)
        assert f is not None and f.o1u.shape == (7,)
        assert torch.equal(f.o3u, want.o3u) and torch.equal(f.o1u, want.o1u)
    seen, inner = [], treal.score_argmax

    def record(*a, **kw):
        seen.append(kw.get("factors"))
        return inner(*a, **kw)

    monkeypatch.setattr(treal, "score_argmax", record)
    cap = _capture(scenario[0], tmodel)
    rx.run_batched(4, lookahead=4, raw_blocks_dev=cap, pipeline=True,
                   pipeline_depth=2)
    rx.run_integrated(1, blocks_per_fix=4, raw_blocks_dev=cap,
                      start_block=4)
    assert len(seen) == 4
    for f, want in zip(seen, [rx._pos_factors, rx._vel_factors] * 2):
        assert f is want


def test_handoff_resume_from_jax_receiver(scenario):
    """The JAX receiver runs 6 blocks; its save_handoff() starts a port
    receiver (reading the same SampleFile from the handoff's byte offset)
    whose next 6 fixes equal the uninterrupted JAX run's."""
    full = _receiver(jmodel, scenario)
    full.run_batched(12, lookahead=6)
    first = _receiver(jmodel, scenario)
    first.run_batched(6, lookahead=6)
    h = first.save_handoff()
    assert h.bytes_read == 6 * 50000 * 4
    resumed = _receiver(tmodel, scenario, handoff=h)
    resumed.run_batched(6, lookahead=6)
    assert [f.mc for f in resumed.fixes] == list(range(1, 7))
    for fa, fb in zip(full.fixes[6:], resumed.fixes):
        np.testing.assert_allclose(fb.x_ecef, fa.x_ecef, rtol=0, atol=1e-6)
    # and the port's own checkpoint lands where the JAX one does (channel
    # phases differ at the 1e-6 level: each receiver anchors its own
    # satellite-state cache, as a JAX -> JAX resume does too)
    h2 = resumed.save_handoff()
    h1 = full.save_handoff()
    np.testing.assert_allclose(h2.x_ecef, h1.x_ecef, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(h2.cp, h1.cp)
    assert (h2.bytes_read, h2.rx_time) == (h1.bytes_read, h1.rx_time)


def _rereference(e, dt: float):
    """The same Kepler orbit re-referenced to toe+dt (a new ephemeris set
    with zero orbit discontinuity), as tests/test_eph_manager.py builds
    it."""
    import dataclasses

    from navlab_dpe_sdr_tpu.constants import MU

    n = np.sqrt(MU / (e.sqrt_A ** 2) ** 3) + e.delta_n
    e2 = dataclasses.replace(e)
    e2.t_oe = e.t_oe + dt
    e2.M_0 = e.M_0 + n * dt
    e2.OMEGA_0 = e.OMEGA_0 + e.OMEGADOT * dt
    e2.i_0 = e.i_0 + e.IDOT * dt
    e2.IODE = (e.IODE + 1) % 256
    return e2


def test_run_batched_ephemeris_cutover_matches_jax(scenario):
    """A closest-toe set switch inside the first batch sends the port down
    the exact per-block prep path (_prepare_block), as the JAX receiver:
    fixes equal."""
    from navlab_dpe_sdr_tpu.libgnss.ephemeris import EphManager

    samples, hand, arr, grid, _ = scenario
    runs = []
    for pkg in (jmodel, tmodel):
        table = {e.prn: [copy.deepcopy(e), _rereference(e, 2 * 120.0 + 0.16)]
                 for e in arr.ephs}
        mgr = EphManager(table, hand.prn_list, fit_interval_s=7200.0)
        kw = dict(device="cpu") if pkg is tmodel else {}
        rx = pkg.DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                             copy.deepcopy(hand), grid=grid,
                             config=pkg.DPEConfig(ekf_mode="alpha"),
                             eph_manager=mgr, **kw)
        rx.run_batched(12, lookahead=6, raw_blocks_dev=_capture(samples, pkg))
        assert mgr.current_idx == [1] * len(hand.prn_list)
        runs.append(rx)
    for fj, ft in zip(*(r.fixes for r in runs)):
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=1e-6)


def test_unported_configs_raise(scenario):
    """A mesh that is not the port's parallel.mesh.Mesh raises TypeError (the
    mesh itself runs: tests/test_torch_mesh.py); the all-real acquisition
    engine is not ported by design; coherent windows stop at 10 ms."""
    from navlab_dpe_sdr_tpu_torch.models import scalar as tscalar
    from navlab_dpe_sdr_tpu_torch.ops import tracking as ttrk

    samples, hand, arr, grid, _ = scenario
    for cfg in (dict(mesh=object()), dict(engine="fft", mesh=object())):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            tmodel.DPEReceiver(SampleFile(samples=samples, fs=FS),
                               copy.deepcopy(hand), grid=grid,
                               config=tmodel.DPEConfig(**cfg), eph=arr,
                               device="cpu")
    srx = tscalar.ScalarReceiver(SampleFile(samples=samples, fs=FS),
                                 hand.prn_list, device="cpu")
    srx.state = ttrk.init_state(rc=hand.rc, ri=hand.ri, fc=hand.fc,
                                fi=hand.fi, device="cpu")
    with pytest.raises(NotImplementedError, match="Not to port"):
        srx.acquire(engine="real", verbose=False)
    with pytest.raises(ValueError, match="coh_ms must be in 1..10"):
        srx.track(22, coh_ms=11)


def test_device_capture_bounds_are_checked(scenario):
    rx = _receiver(tmodel, scenario)
    cap = _capture(scenario[0], tmodel)
    with pytest.raises(ValueError, match="holds 18 blocks"):
        rx.run_batched(6, lookahead=6, raw_blocks_dev=cap, start_block=15)


@pytest.mark.parametrize("use_argmax", [True, False])
def test_run_per_block_matches_jax(scenario, use_argmax, tmp_path):
    """Six per-block steps (`run`), with score dumps: fixes, flips and the
    dumped [G] surfaces equal to the JAX receiver's."""
    samples, *_, truth = scenario
    runs = []
    for pkg in (jmodel, tmodel):
        out = tmp_path / pkg.__name__.split(".")[0]
        out.mkdir()
        rx = _receiver(pkg, scenario, use_argmax=use_argmax)
        rx.cfg.dump_scores_to = str(out)
        fixes = rx.run(6)
        assert len(fixes) == 6 and [f.mc for f in fixes] == list(range(1, 7))
        runs.append((rx, out))
    (jrx, jout), (trx, tout) = runs
    for fj, ft in zip(jrx.fixes, trx.fixes):
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ft.pos_score, fj.pos_score, rtol=1e-5)
        np.testing.assert_allclose(ft.vel_score, fj.vel_score, rtol=1e-5)
    for a, b in zip(jrx.flip_log, trx.flip_log):
        np.testing.assert_array_equal(b, np.asarray(a))
    for mc in range(1, 7):
        dj = np.load(jout / f"scores_{mc:06d}.npz")
        dt = np.load(tout / f"scores_{mc:06d}.npz")
        for k in ("pos", "vel"):
            assert dt[k].shape == dj[k].shape == (7 ** 4,)
            np.testing.assert_allclose(dt[k], dj[k], rtol=1e-5)
            assert int(np.argmax(dt[k])) == int(np.argmax(dj[k]))
    err = np.linalg.norm(trx.fixes[-1].x_ecef[:3] - truth[:3])
    assert err < 60.0, err


def test_per_block_resume_from_jax_handoff(scenario):
    """JAX per-block steps, save_handoff, the port continues: the same fixes
    as the uninterrupted JAX run."""
    full = _receiver(jmodel, scenario)
    full.run(6)
    first = _receiver(jmodel, scenario)
    first.run(3)
    resumed = _receiver(tmodel, scenario, handoff=first.save_handoff())
    resumed.run(3)
    for fa, fb in zip(full.fixes[3:], resumed.fixes):
        np.testing.assert_allclose(fb.x_ecef, fa.x_ecef, rtol=0, atol=1e-6)


def _surface_inputs(seed=3, c=8):
    """tests/test_pallas_score.py's windows: 64 data taps with a central
    peak; indices stay inside [1, 62] over the spread grid, so the
    128-lane padding of the Pallas kernel never comes into play."""
    from navlab_dpe_sdr_tpu.models.grid import spread_grid

    rng = np.random.default_rng(seed)
    g = spread_grid()
    win = np.abs(rng.standard_normal((c, 64))).astype(np.float32) + 0.1
    for i in range(c):
        win[i, 30:35] += [3, 8, 12, 8, 3]
    los = rng.standard_normal((c, 3))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    return (g, win, los, np.full(c, 2.2e7),
            np.full(c, 32.0) + rng.standard_normal(c) * 0.3,
            np.full(c, 0.00834))


def _t32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("manifold", ["pos", "vel"])
def test_score_surface_matches_pallas_interpret(manifold):
    """K2's contract against `score_manifold_pallas(interpret=True)`: the
    same scores to f32 rounding of another summation order, argmax equal."""
    from navlab_dpe_sdr_tpu.ops import pallas_score as jps

    from navlab_dpe_sdr_tpu_torch.ops import score as tscore

    g, win, los, r0, center, coef = _surface_inputs()
    if manifold == "pos":
        o3, o1 = g.d_enu, g.dt_m
        cand, winp, par = jps.pack_pos_inputs(o3, o1, win, los, r0, center,
                                              coef)
    else:
        o3, o1 = g.dv_enu[:20000], g.dtdot[:20000]
        cand, winp, par = jps.pack_vel_inputs(o3, o1, win, los, center, coef)
    ref = np.asarray(jps.score_manifold_pallas(
        jnp.asarray(cand), jnp.asarray(winp), jnp.asarray(par),
        quad_range=manifold == "pos", interpret=True))
    out = tscore.score_surface(
        _t32(win[None]), _t32(los[None]), _t32(center[None]),
        _t32(coef[None]), _t32(r0[None]) if manifold == "pos" else None,
        _t32(o3), _t32(o1))[0].numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=1e-4)
    assert int(np.argmax(out)) == int(np.argmax(ref))


@pytest.mark.parametrize("interp,l_power", [("quadratic", 1),
                                            ("quadratic", 2),
                                            ("linear", 1)])
def test_score_manifolds_mag_matches_jax(interp, l_power):
    """Both manifolds of one block (`score_manifolds_mag`): surfaces within
    rtol 1e-5, argmaxes equal."""
    from navlab_dpe_sdr_tpu.ops import dpe as jdpe_ops

    from navlab_dpe_sdr_tpu_torch.ops import dpe as tdpe_ops

    g, win, los, r0, center, coef = _surface_inputs(seed=5)
    cwin, vwin = win[:, 24:40], win[:, 8:56]          # 16 and 48 taps
    pc, vc = center - 24.0, center - 8.0
    vcoef = np.full(8, -0.98)
    jp = jdpe_ops.ManifoldParams(*(jnp.asarray(np.asarray(a, np.float32))
                                   for a in (los, r0, pc, coef, vc, vcoef)))
    tp = tdpe_ops.ManifoldParams(*(_t32(a) for a in
                                   (los, r0, pc, coef, vc, vcoef)))
    grid = [g.d_enu, g.dt_m, g.dv_enu[:40000], g.dtdot[:40000]]
    ref = jreal.score_manifolds_mag(jnp.asarray(cwin), jnp.asarray(vwin), jp,
                                    *(jnp.asarray(np.float32(a))
                                      for a in grid),
                                    l_power=l_power, interp=interp)
    out = treal.score_manifolds_mag(_t32(cwin), _t32(vwin), tp,
                                    *(_t32(a) for a in grid),
                                    l_power=l_power, interp=interp)
    for i in (0, 2):
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-5)
        assert int(out[i + 1]) == int(ref[i + 1])


# -- modes that only the JAX package's own tests set (ROADMAP Queue 1, item
# 16): per block and through run_batched, both packages on the same capture

# tests/test_atmos.py's Klobuchar set, the ionosphere eight times as strong
ION_ALPHA = tuple(8 * a for a in (0.1118e-7, 0.2235e-7, -0.5960e-7,
                                  -0.1192e-6))
ION_BETA = (0.1167e6, 0.1802e6, -0.1311e6, -0.4588e6)


def _both(scenario, cfg, per_block: bool, duty=None):
    """(JAX receiver, port receiver) after 6 per-block steps or
    run_batched(12, lookahead=6) (fixes from the SampleFile, through the
    read-ahead thread), each with DPEConfig(**cfg); with duty = (T, T_big)
    the SampleFile is duty cycled first."""
    out = []
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, scenario, cfg=cfg)
        if duty is not None:
            rx.rawfile.set_block(*duty, verbose=False)
        if per_block:
            rx.run(6)
        else:
            rx.run_batched(12, lookahead=6)
        out.append(rx)
    return out


def _same(jrx, trx, atol=1e-6):
    assert [f.mc for f in trx.fixes] == [f.mc for f in jrx.fixes]
    assert [f.rx_time for f in trx.fixes] == [f.rx_time for f in jrx.fixes]
    for fj, ft in zip(jrx.fixes, trx.fixes):
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=atol)
    for a, b in zip(jrx.flip_log, trx.flip_log):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("per_block", [True, False],
                         ids=["per-block", "batched"])
def test_duty_cycled_matches_jax(scenario, per_block):
    """SampleFile.set_block(0.02, 0.04): 20 ms processed out of every 40 ms
    (tests/test_modes.py:150). Per block, `step` crosses each 20 ms gap
    (`_advance_gap`): the cursor ends 6 x 40 ms on and every fix within
    1e-6 m of JAX's. `run_batched` ignores the duty cycle in the JAX
    receiver and reads contiguous blocks (a reference-side caveat, ROADMAP
    Queue 3, not a behaviour held as correct): the batched case only
    checks that both packages do the same, cursor and fixes."""
    jrx, trx = _both(scenario, {}, per_block, duty=(0.02, 0.04))
    assert trx.rawfile.sample_pos == jrx.rawfile.sample_pos
    step = int(0.04 * FS) if per_block else int(0.02 * FS)
    assert trx.rawfile.sample_pos == (6 if per_block else 12) * step
    _same(jrx, trx)


@pytest.mark.parametrize("per_block", [True, False],
                         ids=["per-block", "batched"])
def test_atmospheric_correction_matches_jax(scenario, per_block):
    """DPEConfig(ion_alpha=, ion_beta=, tropo=True) (tests/test_atmos.py:68's
    model, the port's `_atmos_m` per block and in `_prepare_batch`): fixes
    within 1e-6 m of JAX's, and metres away from the uncorrected run's, so
    the correction is applied."""
    cfg = dict(ion_alpha=ION_ALPHA, ion_beta=ION_BETA, tropo=True)
    jrx, trx = _both(scenario, cfg, per_block)
    _same(jrx, trx)
    plain = _receiver(tmodel, scenario)
    plain.run(6) if per_block else plain.run_batched(12, lookahead=6)
    moved = max(np.linalg.norm(a.x_ecef[:3] - b.x_ecef[:3])
                for a, b in zip(plain.fixes, trx.fixes))
    assert moved > 1.0, moved


@pytest.mark.parametrize("per_block", [True, False],
                         ids=["per-block", "batched"])
@pytest.mark.parametrize("cfg", [dict(use_sat_cache=False),
                                 dict(doppler_sign=-1.0)],
                         ids=["no-sat-cache", "doppler-sign"])
def test_config_switches_match_jax(scenario, cfg, per_block):
    """DPEConfig(use_sat_cache=False) (satellite states from the orbit
    model every block, no Hermite cache) and doppler_sign=-1.0 (the
    opposite spectrum convention; on this capture it loses the signal, the
    same way in both packages): fixes within 1e-6 m of JAX's."""
    _same(*_both(scenario, cfg, per_block))


@pytest.mark.parametrize("per_block", [True, False],
                         ids=["per-block", "batched"])
def test_full_ekf_process_noise_matches_jax(scenario, per_block):
    """The full EKF with ekf_q_pos=3, ekf_q_accel=2: the measurement cells
    equal in both packages, the fixes within 1e-3 m (its adaptive R is a
    float64 function of float32 windows, ROADMAP Queue 3), and away from
    the default process noise's run, so the settings reach the filter."""
    cfg = dict(ekf_mode="full", ekf_q_pos=3.0, ekf_q_accel=2.0)
    jrx, trx = _both(scenario, cfg, per_block)
    _same(jrx, trx, atol=1e-3)
    default = _receiver(tmodel, scenario, cfg=dict(ekf_mode="full"))
    default.run(6) if per_block else default.run_batched(12, lookahead=6)
    moved = max(np.linalg.norm(a.x_ecef[:3] - b.x_ecef[:3])
                for a, b in zip(default.fixes, trx.fixes))
    assert moved > 1e-2, moved
