"""The port under receiver dynamics, held to the JAX package on the CPU.

tests/test_dynamics.py's scenarios (a receiver moving at ~14 m/s, the same
one accelerating at ~5.4 m/s^2, an oscillator drifting 5e-8 s/s, a 250 Hz/s
Doppler ramp), each synthesized once with that test's seed and handed to
both packages as the same int16 array with the same handoff and ephemeris
objects. The handoff starts 50 m off the true position and 2 m/s off the
true velocity, so both manifolds' argmaxes move; the grid is a 7^4 one at
15 m / 1 m/s (the spread grid runs on the card, chip_smoke.py phase 28).

Fixes are lattice offsets (argmax mode) or float64 host means of scores
that agree to ~1e-7 (weighted mean), filtered in float64, so every fix
agrees to 1e-6 m and 1e-6 m/s: per block (K5 at N = 1 and K2's plain
version), batched over pipeline depth x group_k (the coast between
feedbacks: depth x lookahead x group_k blocks of prediction), and the
clock ramp. The full EKF's adaptive R is a float64 function of the float32
score windows, which the two packages' correlators give to ~1e-6 of their
maximum: with the port's own windows its fixes stay within 1e-3 m (the
limit of tests/test_torch_integrate.py's full-EKF tests), and with the JAX
run's windows R agrees to rtol 1e-6 and the fixes, forward and RTS-
smoothed, to 1e-6 (ROADMAP Queue 3). The tracker under the Doppler ramp
keeps the tracking tests' two tiers: tight against the JAX scan run op by
op, structural against the compiled scan (ROADMAP Queue 3,
"Reference-side caveats").
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import C, F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import CaptureSimulator
from navlab_dpe_sdr_tpu.libgnss import frames
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_code
from navlab_dpe_sdr_tpu.models import dpe as jmodel
from navlab_dpe_sdr_tpu.models.grid import spread_grid, uniform_grid
from navlab_dpe_sdr_tpu.ops import dpe_real as jreal
from navlab_dpe_sdr_tpu.ops import tracking as jt
from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile as TSampleFile
from navlab_dpe_sdr_tpu_torch.models import dpe as tmodel
from navlab_dpe_sdr_tpu_torch.ops import score as tscore
from navlab_dpe_sdr_tpu_torch.ops import tracking as tt

torch.set_num_threads(2)

FS = 2.5e6
S = 50000
T = 0.02
N_BLOCKS = 40
VEL = np.array([10.0, -8.0, 5.0])          # ECEF m/s (~13.7 m/s)
ACC = np.array([4.0, 3.0, -2.0])           # ECEF m/s^2 (~5.4 m/s^2)
DRIFT = 5e-8                               # s/s
POS_OFF_ENU = np.array([30.0, -40.0, 15.0])
VEL_OFF_ENU = np.array([2.0, 0.0, 0.0])


@pytest.fixture(autouse=True)
def f32_taps():
    old = jreal.SCORE_TAP_DTYPE
    jreal.SCORE_TAP_DTYPE = jnp.float32
    yield
    jreal.SCORE_TAP_DTYPE = old


def _to_iq(iq):
    samples = np.empty(iq.shape[0], DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples


def _synth(seed, vel=None, acc=None, drift=0.0):
    """(samples, handoff off truth, ephemerides, truth state): N_BLOCKS
    blocks of tests/test_dynamics.py's scenario with its seed."""
    _, hand, arr = make_scenario(nav_data=True)
    truth = hand.x_ecef.copy()
    if vel is not None:
        truth[4:7] = vel
    sim = CaptureSimulator(arr, truth, tow0=hand.rx_time, fs=FS,
                           cn0_dbhz=47.0, nav_data=True, accel_ecef=acc,
                           seed=seed, clock_drift=drift)
    samples = _to_iq(sim.generate(S * N_BLOCKS))
    h = copy.deepcopy(hand)
    h.x_ecef = truth.copy()
    if drift:
        # a real handoff carries the scalar loops' drift estimate
        # (test_dpe_tracks_clock_drift)
        h.x_ecef[7] = -drift * C
    r_e2n = frames.ecef_to_enu_matrix(truth[0:3])
    h.x_ecef[0:3] = frames.enu_to_ecef(truth[0:3], POS_OFF_ENU)
    h.x_ecef[4:7] += r_e2n.T @ VEL_OFF_ENU
    return samples, h, arr, truth


@pytest.fixture(scope="module")
def moving():
    return _synth(11, vel=VEL)


@pytest.fixture(scope="module")
def maneuver():
    return _synth(7, vel=VEL, acc=ACC)


@pytest.fixture(scope="module")
def drifting():
    return _synth(12, drift=DRIFT)


GRID = uniform_grid(n=7, pos_spacing=15.0, vel_spacing=1.0)
# the velocity manifold's centre: no offset in velocity or drift
VEL_CENTRE = int(np.flatnonzero((np.abs(GRID.dv_enu).sum(axis=1) == 0)
                                & (GRID.dtdot == 0))[0])


def _receiver(pkg, scen, grid=GRID, **cfg):
    samples, hand, arr, _ = scen
    cfg.setdefault("ekf_mode", "alpha")
    cfg.setdefault("ekf_alpha", 0.3)
    if pkg is tmodel:
        rf = TSampleFile(samples=samples.copy(), fs=FS)
        kw = dict(device="cpu")
    else:
        rf, kw = SampleFile(samples=samples.copy(), fs=FS), {}
    return pkg.DPEReceiver(rf, copy.deepcopy(hand), grid=grid,
                           eph=copy.deepcopy(arr),
                           config=pkg.DPEConfig(**cfg), **kw)


def _capture(samples, pkg):
    blocks = samples.view(np.int16).reshape(-1, S, 2)
    return jnp.asarray(blocks) if pkg is jmodel else torch.from_numpy(blocks)


def _record(rx, name, pick=lambda a, kw, out: out):
    """Wrap rx.<name>: every call's pick(args, kwargs, result) is appended
    to the returned list."""
    seen, inner = [], getattr(rx, name)

    def rec(*a, **kw):
        out = inner(*a, **kw)
        seen.append(pick(a, kw, out))
        return out

    setattr(rx, name, rec)
    return seen


def _same_fixes(jrx, trx, n):
    assert len(trx.fixes) == len(jrx.fixes) == n
    for fj, ft in zip(jrx.fixes, trx.fixes):
        assert (fj.mc, fj.rx_time) == (ft.mc, ft.rx_time)
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=1e-6)


def _vel_argmaxes(out_dir):
    return [int(np.argmax(np.load(out_dir / f"scores_{mc:06d}.npz")["vel"]))
            for mc in range(1, N_BLOCKS + 1)]


def _truth_at(truth, t_el, acc=None):
    p = truth[0:3] + truth[4:7] * t_el
    return p if acc is None else p + 0.5 * acc * t_el ** 2


@pytest.mark.parametrize("use_argmax", [True, False])
def test_moving_receiver_per_block_matches_jax(moving, use_argmax,
                                               tmp_path):
    """(a) tests/test_dynamics.py:25's receiver, per block (`run`): every
    fix, velocity state included, within 1e-6 of the JAX receiver's; the
    velocity argmax leaves the grid's centre in both packages, block by
    block the same cell."""
    runs = []
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, moving, use_argmax=use_argmax)
        out = tmp_path / pkg.__name__.split(".")[0]
        out.mkdir()
        rx.cfg.dump_scores_to = str(out)
        rx.run(N_BLOCKS)
        runs.append((rx, _vel_argmaxes(out)))
    (jrx, jva), (trx, tva) = runs
    _same_fixes(jrx, trx, N_BLOCKS)
    assert tva == jva
    assert tva[0] != VEL_CENTRE and jva[0] != VEL_CENTRE
    for a, b in zip(jrx.flip_log, trx.flip_log):
        np.testing.assert_array_equal(b, np.asarray(a))
    # the port follows the moving truth: the handoff's 2 m/s error shrinks
    # (the weighted mean over a 7^4 grid is biased toward its centre, so
    # the position is checked in argmax mode)
    truth, f = moving[3], trx.fixes[-1]
    assert np.linalg.norm(f.x_ecef[4:7] - VEL) < 1.5, f.x_ecef[4:7]
    if use_argmax:
        err = np.linalg.norm(f.x_ecef[0:3] - _truth_at(truth, N_BLOCKS * T))
        assert err < 20.0, err


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("group_k", [1, 5])
def test_moving_receiver_batched_matches_jax(moving, depth, group_k):
    """(b) the envelope's cells at the CPU's size: run_batched with
    lookahead 5 at pipeline depth 1, 2, 4 x group_k 1, 5 (K5, then K1 per
    block or coherent_sum + K1): predictions coast depth x 5 blocks between
    feedbacks on a receiver moving 0.27 m a block. Every fix within 1e-6 m
    of the JAX receiver's; the velocity argmax leaves the centre."""
    runs = []
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, moving)
        va = _record(rx, "_apply_measurement", lambda a, kw, out: a[1])
        rx.run_batched(N_BLOCKS, lookahead=5,
                       raw_blocks_dev=_capture(moving[0], pkg),
                       pipeline=True, pipeline_depth=depth, group_k=group_k)
        runs.append((rx, va))
    (jrx, jva), (trx, tva) = runs
    _same_fixes(jrx, trx, N_BLOCKS // group_k)
    assert tva == jva
    assert tva[0] != VEL_CENTRE
    for a, b in zip(jrx.flip_log, trx.flip_log):
        np.testing.assert_array_equal(b, np.asarray(a))


def _full_ekf_runs(maneuver, run):
    """The maneuver through the full EKF: the JAX receiver, then the port
    twice, each measurement's adaptive R recorded with the windows it came
    from. The port's own windows are held to JAX's at the correlator's
    parity tolerance (1e-4 of each channel's window maximum,
    tests/test_torch_correlate.py); its first run computes R from them, its
    second from the JAX run's windows of the same measurement. Returns
    (jax rx, its Rs, port rx, its Rs, held port rx, its Rs)."""
    jrx = _receiver(jmodel, maneuver, ekf_mode="full")
    jin = _record(jrx, "_adaptive_r", lambda a, kw, out: (
        np.asarray(a[0], np.float32), np.asarray(a[1], np.float32),
        np.asarray(out)))
    run(jrx, jmodel)
    out = [jrx, [r for *_, r in jin]]
    for held in (False, True):
        trx = _receiver(tmodel, maneuver, ekf_mode="full")
        inner, rs = trx._adaptive_r, []

        def port_r(code_mag, carr_mag, *rest, inner=inner, rs=rs, held=held):
            jc, jv, _ = jin[len(rs)]
            for own, ref in ((code_mag, jc), (carr_mag, jv)):
                scale = np.abs(ref).max(axis=-1, keepdims=True)
                assert (np.abs(own - ref) / scale).max() < 1e-4
            if held:
                code_mag, carr_mag = jc, jv
            rs.append(inner(code_mag, carr_mag, *rest))
            return rs[-1]

        trx._adaptive_r = port_r
        run(trx, tmodel)
        out += [trx, rs]
    return out


def _hold_full_ekf(jrx, jrs, trx, trs, hrx, hrs):
    """Every measurement's argmaxes are the same lattice cells in both
    packages (a fix's difference is the filter's, not the scorer's). With
    its own float32 windows the port's fixes stay within 1e-3 m of JAX's
    (tests/test_torch_integrate.py's full-EKF limit): R is a float64
    function of windows that agree to ~1e-6 of their maximum, and the
    velocity coupling carries that into the states (ROADMAP Queue 3).
    With the JAX run's windows, the adaptive R to rtol 1e-6 and every fix
    within 1e-6 m."""
    assert len(trs) == len(hrs) == len(jrs) == len(jrx.fixes)
    for f_j, f_t in zip(jrx.fixes, trx.fixes):
        assert f_t.mc == f_j.mc
        np.testing.assert_allclose(f_t.x_ecef, f_j.x_ecef, rtol=0, atol=1e-3)
    _same_fixes(jrx, hrx, len(jrx.fixes))
    for rj, rh in zip(jrs, hrs):
        np.testing.assert_allclose(rh, rj, rtol=1e-6, atol=0)


def test_maneuver_full_ekf_batched_matches_jax(maneuver):
    """(c) tests/test_dynamics.py:55's maneuver through the full EKF,
    run_batched(lookahead=10), held as _hold_full_ekf says; the measurement
    cells (argmaxes) equal in every block."""
    cells = {}

    def run(rx, pkg):
        cells.setdefault(pkg, []).append(_record(
            rx, "_apply_measurement", lambda a, kw, out: a[0:2]))
        rx.run_batched(N_BLOCKS, lookahead=10,
                       raw_blocks_dev=_capture(maneuver[0], pkg))

    runs = _full_ekf_runs(maneuver, run)
    _hold_full_ekf(*runs)
    (jcells,), (tcells, hcells) = cells[jmodel], cells[tmodel]
    assert tcells == hcells == jcells
    assert len(jcells) == N_BLOCKS and jcells[0][1] != VEL_CENTRE


def _own_scores(pkg, rows, pk, i, cells, code_win, grid):
    """Each package's own float32 scorer (JAX `_score_chunk`, the port's
    `score_points`) on the position windows of row i of a dispatch's packed
    rows, at the grid indices `cells`."""
    c = pk.shape[2]
    win = rows[i:i + 1, 4 + c:4 + c + c * code_win].reshape(1, c, code_win)
    f = pk[i:i + 1, :11]
    args = [win, f[:, 3:6].transpose(0, 2, 1), f[:, 7], f[:, 8], f[:, 6],
            grid.d_enu[cells], grid.dt_m[cells]]
    args = [np.ascontiguousarray(a, np.float32) for a in args]
    if pkg is jmodel:
        s = jreal._score_chunk(*(jnp.asarray(a) for a in args), "quadratic",
                               1)
    else:
        s = tscore.score_points(*(torch.from_numpy(a) for a in args),
                                "quadratic", 1)
    return np.asarray(s)[0].astype(np.float64)


@pytest.fixture(scope="module")
def maneuver60():
    """tests/test_dynamics.py:55's own input: the maneuver's 60 blocks
    from the truth handoff."""
    _, hand, arr = make_scenario(nav_data=True)
    truth = hand.x_ecef.copy()
    truth[4:7] = VEL
    sim = CaptureSimulator(arr, truth, tow0=hand.rx_time, fs=FS,
                           cn0_dbhz=47.0, nav_data=True, accel_ecef=ACC,
                           seed=7)
    h = copy.deepcopy(hand)
    h.x_ecef = truth.copy()
    return _to_iq(sim.generate(S * 60)), h, arr, truth


@pytest.mark.parametrize("case", ["7^4", "spread"])
def test_maneuver_alpha_batched_matches_jax(case, request):
    """(c) the maneuver through run_batched(lookahead=10) under the alpha
    filter (the path whose card run chip_smoke.py phase 29 traces block by
    block), on the 7^4 grid (the `maneuver` fixture) and on the spread grid
    (tests/test_dynamics.py:55's own input and grid): the measurement cells
    equal in every block and every fix within 1e-6 m of the JAX
    receiver's, up to the first block whose cells part; there both
    packages' windows (each dispatch returns them here) must hold a
    float32 tie: each package's own scorer puts the other's position cell
    within 1e-6 of its own cell's score. On these captures the runs part
    at block 21 on the 7^4 grid (cells 1200 and 1249) and at block 14 on
    the spread grid (cells 195286 and 195235), and the fixes part from
    there (ROADMAP Queue 3). `pytest -s` prints the parting and both
    packages' RMS error."""
    if case == "spread":
        scen, grid, n = request.getfixturevalue("maneuver60"), \
            spread_grid(), 60
    else:
        scen, grid, n = request.getfixturevalue("maneuver"), GRID, N_BLOCKS
    runs = []
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, scen, grid=grid)
        cells = _record(rx, "_apply_measurement", lambda a, kw, out: a[0:2])
        dispatches, inner = [], pkg.dpe_real_ops.dpe_batch_blocks

        def with_windows(*a, inner=inner, seen=dispatches, **kw):
            out = inner(*a, **dict(kw, return_windows=True))
            seen.append((np.asarray(a[1]), np.asarray(out)))
            return out

        pkg.dpe_real_ops.dpe_batch_blocks = with_windows
        try:
            rx.run_batched(n, lookahead=10,
                           raw_blocks_dev=_capture(scen[0], pkg))
        finally:
            pkg.dpe_real_ops.dpe_batch_blocks = inner
        runs.append((rx, cells, dispatches))
    (jrx, jcells, jdisp), (trx, tcells, tdisp) = runs
    assert len(tcells) == len(jcells) == n
    part = next((k for k, (a, b) in enumerate(zip(jcells, tcells))
                 if a != b), n)
    rms = [_rms(rx, scen) for rx in (trx, jrx)]
    print(f"\nmaneuver alpha, {case} grid: first parting at block "
          f"{part + 1 if part < n else None} (cells port / JAX "
          f"{tcells[part] if part < n else None} / "
          f"{jcells[part] if part < n else None}); RMS port {rms[0]:.3f} m, "
          f"JAX {rms[1]:.3f} m")
    if part == n:
        _same_fixes(jrx, trx, n)
        return
    for fj, ft in zip(jrx.fixes[:part], trx.fixes[:part]):
        np.testing.assert_allclose(ft.x_ecef, fj.x_ecef, rtol=0, atol=1e-6)
    (jpa, jva), (tpa, tva) = jcells[part], tcells[part]
    assert jva == tva and jpa != tpa, (part, jcells[part], tcells[part])
    d, i = divmod(part, 10)
    np.testing.assert_array_equal(tdisp[d][0], jdisp[d][0])  # same inputs
    for pkg, (pk, rows), own, other in (
            (jmodel, jdisp[d], jpa, tpa), (tmodel, tdisp[d], tpa, jpa)):
        s_own, s_other = _own_scores(pkg, rows, pk, i, [own, other],
                                     trx.code_win, grid)
        assert s_other >= s_own - 1e-6 * abs(s_own), (pkg.__name__, part,
                                                      s_own, s_other)


def _rms(rx, scen):
    """RMS distance of rx's fixes from the accelerating truth."""
    truth, t0 = scen[3], scen[1].rx_time
    e = [np.linalg.norm(f.x_ecef[0:3] - _truth_at(truth, f.rx_time - t0, ACC))
         for f in rx.fixes]
    return float(np.sqrt(np.mean(np.square(e))))


def test_maneuver_rts_smoother_matches_jax(maneuver, tmp_path):
    """(c) tests/test_dynamics.py:136: per-block `run` under the full EKF,
    then `ekf.rts_smooth()`, held as _hold_full_ekf says (the score
    surfaces' argmaxes equal); with the JAX windows the smoothed states
    within 1e-6 relative. The smoother uses past and future blocks, so it
    lands nearer the accelerating truth than the forward filter."""
    dumps = []

    def run(rx, pkg):
        out = tmp_path / f"run{len(dumps)}"
        out.mkdir()
        rx.cfg.dump_scores_to = str(out)
        rx.run(N_BLOCKS)
        dumps.append(out)

    jrx, jrs, trx, trs, hrx, hrs = _full_ekf_runs(maneuver, run)
    _hold_full_ekf(jrx, jrs, trx, trs, hrx, hrs)
    for k in ("pos", "vel"):
        arg = [[int(np.argmax(np.load(d / f"scores_{mc:06d}.npz")[k]))
                for mc in range(1, N_BLOCKS + 1)] for d in dumps]
        assert arg[0] == arg[1] == arg[2], k
    jxs, txs, hxs = (rx.ekf.rts_smooth() for rx in (jrx, trx, hrx))
    assert hxs.shape == jxs.shape == (N_BLOCKS, 8)
    np.testing.assert_allclose(hxs, jxs, rtol=1e-6, atol=0)
    np.testing.assert_allclose(txs, jxs, rtol=0, atol=1e-3)

    truth, t0 = maneuver[3], maneuver[1].rx_time
    times = [f.rx_time - t0 for f in trx.fixes]

    def rms(states):
        e = [np.linalg.norm(x[0:3] - _truth_at(truth, t, ACC))
             for x, t in zip(states, times[10:])]
        return float(np.sqrt(np.mean(np.square(e))))

    fwd = rms([f.x_ecef for f in trx.fixes[10:]])
    smo = rms(txs[10:])
    assert smo < fwd, (smo, fwd)


def test_clock_drift_per_block_matches_jax(drifting):
    """(d) tests/test_dynamics.py:94: the 5e-8 s/s oscillator, per block
    with x[7] from the truth: fixes within 1e-6 m, the fitted clock-bias
    slope equal to 1e-6 relative, and ramping as the drift says."""
    runs = []
    for pkg in (jmodel, tmodel):
        rx = _receiver(pkg, drifting)
        rx.run(N_BLOCKS)
        runs.append(rx)
    jrx, trx = runs
    _same_fixes(jrx, trx, N_BLOCKS)
    x0 = drifting[1].x_ecef[3]
    t = (np.arange(N_BLOCKS) + 1) * T
    slopes = [np.polyfit(t, [f.x_ecef[3] - x0 for f in rx.fixes], 1)[0]
              for rx in runs]
    np.testing.assert_allclose(slopes[1], slopes[0], rtol=1e-6)
    # the dt axis ramps the bias at -drift * C once the handoff's 50 m and
    # 2 m/s are pulled in (blocks 10 on), within the JAX test's 50 %
    expect = -DRIFT * C
    late = np.polyfit(t[10:], [f.x_ecef[3] - x0 for f in trx.fixes[10:]],
                      1)[0]
    assert abs(late - expect) < 0.5 * abs(expect), (late, expect)


# -- (e) the tracker under a Doppler ramp --------------------------------------

RAMP_STEPS = 1200       # tests/test_dynamics.py:178's 1.2 s
OP_BY_OP_STEPS = 100    # the tight tier: the JAX scan run op by op
FDOT, FI0 = 250.0, 120.0
# (update, channel, sign) where the compiled JAX scan's signs depart from
# the port's: there the compiled scan departs from its own op-by-op run,
# which equals the port's over all 1200 updates (fi within 1.5e-5 Hz;
# ROADMAP Queue 3, "Reference-side caveats")
COMPILED_SIGN_DEPARTURES = {"pll": {(198, 0, 1)}, "fll": set()}


def _ramp_signal():
    """tests/test_dynamics.py:178's signal: PRN 5 at 45 dB-Hz, Doppler
    120 Hz + 250 Hz/s, seed 0; float32 [steps, 2500, 2]."""
    n = 2500 * RAMP_STEPS
    t = np.arange(n) / FS
    fi_t = FI0 + FDOT * t
    ph = FI0 * t + 0.5 * FDOT * t * t
    rc_t = np.cumsum(np.full(n, F_CA) / FS * (1.0 + fi_t / F_L1))
    chips = ca_code(5)[np.mod(np.floor(rc_t), L_CA).astype(np.int64)]
    amp = 32 * np.sqrt(10 ** (45.0 / 10) / FS)
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * (
        32 / np.sqrt(2))
    iq = amp * chips * np.exp(2j * np.pi * ph) + noise
    raw = np.stack([iq.real, iq.imag], -1).astype(np.float32)
    return raw.reshape(RAMP_STEPS, 2500, 2), ca_code(5)[None, :].astype(
        np.float32)


@pytest.fixture(scope="module")
def ramp():
    return _ramp_signal()


def _check_logs(jlog, tlog, fi_tol, prompt_tol, n, departures=()):
    """The tracking tests' free-run limits over the first n updates: cp,
    ncp, lock equal, signs equal after update 5 (but at `departures`),
    rc within 1e-3 chips, fi within fi_tol Hz, |prompt| within prompt_tol
    of the peak."""
    for k in ("cp", "ncp", "lock"):
        np.testing.assert_array_equal(np.asarray(getattr(jlog, k))[:n],
                                      getattr(tlog, k).numpy()[:n],
                                      err_msg=k)
    differ = np.argwhere(np.asarray(jlog.signs)[:n] != tlog.signs.numpy()[:n])
    differ = {tuple(int(i) for i in d) for d in differ if d[0] >= 5}
    assert differ <= set(departures), sorted(differ)
    drc = np.abs(np.asarray(jlog.rc, np.float64)[:n] - tlog.rc.numpy()[:n])
    assert np.minimum(drc, 1023.0 - drc).max() < 1e-3
    dfi = np.abs(np.asarray(jlog.fi)[:n] - tlog.fi.numpy()[:n])
    assert dfi.max() < fi_tol, dfi.max()
    pj = np.hypot(np.asarray(jlog.iP), np.asarray(jlog.qP))[:n]
    pt = np.hypot(tlog.iP.numpy(), tlog.qP.numpy())[:n]
    rel = np.abs(pj - pt) / pj.max(axis=0)
    assert rel.max() < prompt_tol, rel.max()


@pytest.mark.parametrize("fll", [False, True], ids=["pll", "fll"])
def test_fll_assist_ramp_matches_jax(ramp, fll):
    """(e) tests/test_dynamics.py:178: one channel, S = 2500, the port's
    track_chunk (its plain path here) against the JAX track_chunk, PLL-only
    (Bn 10 Hz) and FLL-assisted (bn_carr_freq 8 Hz). Against the JAX scan
    run op by op over the first 100 updates: fi within 0.1 Hz, |prompt|
    within 1e-3 of the peak, lock and cp equal; against the compiled scan
    over all 1200: the structural limits (fi 1 Hz, prompt 2 %; the signs
    but where the compiled scan departs from itself). The port's
    PLL loses the ramp (median |fi error| over the last 200 updates above
    100 Hz) and its FLL holds it (under 25 Hz)."""
    raw, tab = ramp
    kw = dict(order=2, bn_carr=10.0, bn_carr_freq=8.0 if fll else 0.0)
    fcaid = F_CA / F_L1
    st = jt.init_state(np.array([0.0]), np.array([0.0]), np.array([F_CA]),
                       np.array([FI0]))
    tst = tt.state_from_numpy({k: np.asarray(v) for k, v in
                               st._asdict().items()}, "cpu")
    _, tlog = tt.track_chunk(tst, torch.from_numpy(raw),
                             torch.from_numpy(tab), FS, fcaid,
                             tt.LoopConfig(**kw))
    with jax.disable_jit():
        _, elog = jt._track_chunk_jit(
            st, jnp.asarray(raw[:OP_BY_OP_STEPS]), jnp.asarray(tab), FS,
            fcaid, loops=jt.LoopConfig(**kw), coh_ms=1, unroll=1,
            strategy="gather")
    _check_logs(elog, tlog, 0.1, 1e-3, OP_BY_OP_STEPS)
    _, jlog = jt.track_chunk(st, jnp.asarray(raw), jnp.asarray(tab), FS,
                             fcaid, jt.LoopConfig(**kw))
    _check_logs(jlog, tlog, 1.0, 0.02, RAMP_STEPS,
                COMPILED_SIGN_DEPARTURES["fll" if fll else "pll"])

    truth = FI0 + FDOT * np.arange(RAMP_STEPS) * 1e-3
    err = float(np.median(np.abs(tlog.fi.numpy()[-200:, 0] - truth[-200:])))
    if fll:
        assert err < 25.0, err
    else:
        assert err > 100.0, err
