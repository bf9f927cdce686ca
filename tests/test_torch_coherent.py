"""The weak-signal cold start in the port vs the JAX package: coherent
tracking (coh_ms = m > 1), the batch_k tracker, open-loop correlation,
deep acquisition, and ScalarReceiver.track(coh_ms, batch_k) /
save_handoff / acquire(deep_ms).

Two tiers, as for the 1 ms tracker (tests/test_torch_tracking.py):
- Against the JAX scan run op by op (jax.disable_jit, each operation as
  written), the port holds tight limits: cp, ncp, lock and every nav-bit
  sign equal, rc within 1e-3 chips, fi within 0.1 Hz, |prompt| within 1e-3
  of the channel's peak (measured 0 chips, <= 6e-5 Hz and <= 5e-7 at
  m = 2, 4, 5, 8; at m = 8 and 27 dB-Hz over 250 updates as well).
- Against the compiled JAX scan, the free-running structural limits
  (cp/ncp/lock equal, signs equal after update 5, rc < 1e-3 chips,
  fi < 1 Hz, prompt < 2 % of peak; measured 1.8e-4 chips, 0.024 Hz and
  0.28 % at coh_ms 4 and 5). At 27 dB-Hz and coh_ms 8 the compiled scan
  departs from its own op-by-op run from update 88 on (lock in 20 updates,
  51 signs, 8 Hz: the loops carry independent noise responses), by exactly
  as much as from the port; there the limits hold over the first 80
  updates, cp/ncp over all 250, and the port's log meets the JAX test's
  own thresholds. At that C/N0 one code period's prompt (1 ms of energy)
  is near zero often enough that its sign flips under the compiled scan's
  arithmetic: 3 of the 720 signs of the first 80 updates differ, so 99 %
  must agree there.

Open-loop E/P/L agree with the op-by-op run within 1e-4 of the prompt peak
(measured 3.4e-7); the compiled scan's own spread is 0.66 % (its time
table is f32(k) * f32(1/fs) inside the scan, one ulp off in ~15 % of the
samples). The CUDA kernels are held to these plain versions on the card in
tests/test_torch_kernels.py.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import F_CA, L_CA
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import synth_simple
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu.models import scalar as jscalar
from navlab_dpe_sdr_tpu.ops import tracking as jt
from navlab_dpe_sdr_tpu.ops.acquisition_real import acquire_real
from navlab_dpe_sdr_tpu_torch.models import scalar as tscalar
from navlab_dpe_sdr_tpu_torch.ops import acquisition as tacq
from navlab_dpe_sdr_tpu_torch.ops import tracking as tt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tracking import (  # noqa: E402
    _as_pairs as _pairs, _check_free_run as _check_track, _close, _port_state,
    _t, _tail_inputs)
from test_tracking import FCAID, FS, S, _make_blocks  # noqa: E402

torch.set_num_threads(2)

# the CLI's coherent-mode loop defaults, as LoopConfig fields
COH_LOOPS = {m: tt.cadence_loops(m)._asdict() for m in range(2, 11)}


# -- the m-scaled tail, identical inputs --------------------------------------

@pytest.mark.parametrize("fll", [0.0, 3.0])
@pytest.mark.parametrize("m", [2, 4, 5, 8])
def test_coherent_tail_matches_jax(m, fll):
    """Polarity hypothesis test, lock detector and C/N0 meter, loop
    filters at m ms: equal to f32 rounding (rtol 2e-6; snr 1e-5), the
    flip decisions, signs and counters exactly."""
    sums, ncp, f = _tail_inputs(100 * m + int(fll), m=m)
    jst = jt.TrackState(**{k: jnp.asarray(v) for k, v in f.items()})
    tst = tt.state_from_numpy(f, "cpu")
    jloops = jt.LoopConfig(order=2, bn_carr_freq=fll)
    tloops = tt.LoopConfig(order=2, bn_carr_freq=fll)
    e_s, p_s, l_s = (sums[:, i] for i in range(3))
    jres = jt._polarity_combine(jst, *(jnp.asarray(x) for x in
                                       (e_s, p_s, l_s)), jnp.asarray(ncp), m)
    tres = tt._polarity_combine(tst, *(_t(x) for x in (e_s, p_s, l_s)),
                                _t(ncp), m)
    assert tres[3].shape == (8, m + 1)
    np.testing.assert_array_equal(np.asarray(jres[3]), tres[3].numpy())
    for name, a, b in zip(("e_r", "p_r", "l_r", "signs", "pa_re", "pa_im"),
                          jres, tres):
        _close(a, b.numpy(), name)

    p_r = np.asarray(jres[1])
    jst1, jlock, jlv, jsnr = jt._lock_snr_update(jst, jnp.asarray(p_r), m)
    tst1, tlock, tlv, tsnr = tt._lock_snr_update(tst, _t(p_r), m)
    np.testing.assert_array_equal(np.asarray(jlock), tlock.numpy())
    _close(jlv, tlv.numpy(), "lockval")
    _close(jsnr, tsnr.numpy(), "snr", rtol=1e-5)
    for k in ("losscount", "lockcount", "snr_fill"):
        np.testing.assert_array_equal(np.asarray(getattr(jst1, k)),
                                      getattr(tst1, k).numpy())

    e_r, l_r = np.asarray(jres[0]), np.asarray(jres[2])
    jst2, jdpc, jdpi = jt._loops_update(jst, jnp.asarray(e_r),
                                        jnp.asarray(p_r), jnp.asarray(l_r),
                                        FCAID, jloops, m)
    tst2, tdpc, tdpi = tt._loops_update(tst, _t(e_r), _t(p_r), _t(l_r),
                                        FCAID, tloops, m)
    _close(jdpc, tdpc.numpy(), "dpc")
    _close(jdpi, tdpi.numpy(), "dpi")
    for k in ("fi", "dfc", "lf_carr_h", "lf_code_h"):
        _close(getattr(jst2, k), getattr(tst2, k).numpy(), k)


@pytest.mark.parametrize("m", range(1, 11))
def test_kernel_params_are_the_m_scaled_constants(m):
    """K4's scalars: lpf formed in float64 then cast, the thresholds
    rounded half to even (m = 4: 12, not 13), the C/N0 denominator
    2 SNR_N m T_MS, the update period m T_MS, the mid-window offset."""
    p = tt.kernel_params(2500 * m, FS, FCAID, tt.LoopConfig(), m)
    f32 = np.float32
    assert p.lpf == f32(1.0 - (1.0 - 0.0247) ** m)
    assert p.one_m_lpf == f32(1.0 - (1.0 - (1.0 - 0.0247) ** m))
    assert p.loss_th == max(1, round(50 / m))
    assert p.lock_th == max(1, round(240 / m))
    assert p.snr_den == f32(2.0 * (20 * m * 1e-3))
    assert p.t_up == f32(m * 1e-3) and p.half_win == f32(m * 0.5e-3)
    assert p.fll_norm == f32(2.0 * np.pi * m * 1e-3)
    assert p.win_s == f32(2500 * m / FS) and (p.m, p.batch_k) == (m, 1)
    if m == 4:
        assert (p.loss_th, p.lock_th) == (12, 60)


# -- whole tracks --------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4, 5, 8])
def test_coherent_track_matches_jax_op_by_op(m):
    """12 updates (<= 96 ms) across nav-bit flips, FLL-assisted pull-in
    from 0.2 chips / 5 Hz off, against the JAX scan run op by op."""
    prn, rc0, fi0 = 3, 100.0, -800.0
    bits = np.where(np.random.default_rng(11).standard_normal(80) > 0,
                    1.0, -1.0)
    raw = _make_blocks(prn, 12 * m, rc0, 0.0, fi0, cn0=50.0, bits=bits,
                       seed=2).reshape(12, m * S)
    tab = ca_table([prn]).astype(np.float32)
    st0 = jt.init_state(rc=[rc0 + 0.2], ri=[0.0], fc=[F_CA + FCAID * fi0],
                        fi=[fi0 + 5.0])
    loops = jt.LoopConfig(**COH_LOOPS[m])
    with jax.disable_jit():
        _, elog = jt._track_chunk_jit(st0, jnp.asarray(_pairs(raw)),
                                      jnp.asarray(tab), FS, FCAID,
                                      loops=loops, coh_ms=m, unroll=1,
                                      strategy="gather")
    _, tlog = tt.track_chunk(_port_state(st0), _t(_pairs(raw)), _t(tab), FS,
                             FCAID, tt.LoopConfig(*loops), coh_ms=m)
    assert tlog.signs.shape == (12, 1, m + 1)
    _check_track(elog, tlog, fi_tol=0.1, prompt_tol=1e-3, sign_from=0)


def _case_362():
    prn, rc0, ri0, fi0 = 7, 500.0, 0.1, 1234.0
    raw = _make_blocks(prn, 1000, rc0, ri0, fi0)
    st0 = jt.init_state(rc=[rc0 + 0.3], ri=[ri0],
                        fc=[F_CA + FCAID * (fi0 + 25)], fi=[fi0 + 25.0])
    loops = jt.LoopConfig(order=2, bn_code=2.0, bn_carr=12.0,
                          bn_carr_freq=3.0)
    return prn, raw.reshape(250, 4 * S), st0, loops, 4, fi0, rc0


def _case_408():
    prn, rc0, fi0 = 3, 100.0, -800.0
    bits = np.where(np.random.default_rng(11).standard_normal(80) > 0,
                    1.0, -1.0)
    raw = _make_blocks(prn, 1000, rc0, 0.0, fi0, cn0=50.0, bits=bits, seed=2)
    st0 = jt.init_state(rc=[rc0], ri=[0.0], fc=[F_CA + FCAID * fi0],
                        fi=[fi0])
    loops = jt.LoopConfig(order=2, bn_code=2.0, bn_carr=10.0)
    return prn, raw.reshape(200, 5 * S), st0, loops, 5, bits, rc0


def _case_441():
    prn, rc0, fi0 = 12, 250.0, 900.0
    raw = _make_blocks(prn, 2000, rc0, 0.0, fi0, cn0=27.0, seed=9)
    st0 = jt.init_state(rc=[rc0], ri=[0.0], fc=[F_CA + FCAID * fi0],
                        fi=[fi0])
    loops = jt.LoopConfig(order=2, bn_code=1.0, bn_carr=6.0)
    return prn, raw.reshape(250, 8 * S), st0, loops, 8, fi0, rc0


def _flatten_signs(log, n):
    ncp = np.asarray(log.ncp)[:, 0]
    signs = np.asarray(log.signs)[:, 0, :]
    return np.array([signs[t, j] for t in range(n) for j in range(ncp[t])])


@pytest.mark.parametrize("case", ["coh4_362", "coh5_408", "coh8_441"])
def test_coherent_track_matches_jax_compiled(case):
    """The sizes of tests/test_tracking.py:362, :408 and :441 against the
    compiled JAX scan, then the JAX tests' own assertions on the port's
    log."""
    make = {"coh4_362": _case_362, "coh5_408": _case_408,
            "coh8_441": _case_441}[case]
    prn, raw, st0, loops, m, extra, rc0 = make()
    tab = ca_table([prn]).astype(np.float32)
    _, jlog = jt.track_chunk(st0, jnp.asarray(raw), jnp.asarray(tab), FS,
                             FCAID, loops, coh_ms=m)
    _, tlog = tt.track_chunk(_port_state(st0), _t(_pairs(raw)), _t(tab), FS,
                             FCAID, tt.LoopConfig(*loops), coh_ms=m)
    n = raw.shape[0]
    if m == 8:
        for k in ("cp", "ncp"):
            np.testing.assert_array_equal(np.asarray(getattr(jlog, k)),
                                          getattr(tlog, k).numpy())
        _check_track(jlog, tlog, rows=slice(0, 80), sign_from=None)
        agree = np.mean(np.asarray(jlog.signs)[5:80]
                        == tlog.signs.numpy()[5:80])
        assert agree >= 0.99, agree
        fi_err_8 = abs(tlog.fi.numpy()[-25:, 0].mean() - extra)
        assert fi_err_8 < 2.0, fi_err_8
        assert tlog.lockval.numpy()[-25:, 0].mean() > 0.0
        return
    _check_track(jlog, tlog)
    if m == 4:
        assert abs(tlog.fi.numpy()[-13:, 0].mean() - extra) < 2.0
        u = np.arange(n)
        rc_true = np.mod(rc0 + FCAID * extra * 4e-3 * u, L_CA)
        err = np.abs(((tlog.rc.numpy()[:, 0] - rc_true) + L_CA / 2) % L_CA
                     - L_CA / 2)
        assert np.mean(err[-50:]) < 0.05
        assert int(tlog.lock.numpy()[-1, 0]) == 1
        assert 30.0 < float(tlog.snr.numpy()[-1, 0]) < 55.0
    else:
        cp_sign = _flatten_signs(tlog, n)
        assert abs(len(cp_sign) - 1000) <= 1
        true_bits = extra[np.clip(np.arange(len(cp_sign)) // 20, 0,
                                  len(extra) - 1)]
        agree = np.mean(cp_sign[200:900] == -true_bits[200:900])
        disagree = np.mean(cp_sign[200:900] == true_bits[200:900])
        assert max(agree, disagree) > 0.995


def test_batched_track_matches_jax():
    """batch_k = 4 on tests/test_tracking.py:286's case: against the JAX
    tracker run op by op (tight limits: cp/ncp/lock/signs equal, fi within
    0.1 Hz, prompt within 1e-3 of peak; measured 6e-5 Hz, 3e-7), against the
    compiled one (the structural limits), and the JAX test's own
    assertions (batched vs the 1 ms loop) on the port."""
    prn, rc0, ri0, fi0 = 5, 250.0, 0.4, 900.0
    raw = _make_blocks(prn, 40, rc0, ri0, fi0)
    tab = ca_table([prn]).astype(np.float32)
    st0 = jt.init_state(rc=[rc0 + 0.2], ri=[ri0], fc=[F_CA + FCAID * fi0],
                        fi=[fi0 + 10.0])
    with jax.disable_jit():
        est, elog = jt.track_chunk_batched(st0, jnp.asarray(raw),
                                           jnp.asarray(tab), FS, FCAID,
                                           batch_k=4, unroll=1)
    _, jlog = jt.track_chunk_batched(st0, jnp.asarray(raw), jnp.asarray(tab),
                                     FS, FCAID, batch_k=4)
    tst, tlog = tt.track_chunk_batched(_port_state(st0), _t(_pairs(raw)),
                                       _t(tab), FS, FCAID, batch_k=4)
    _check_track(elog, tlog, fi_tol=0.1, prompt_tol=1e-3, sign_from=0)
    assert abs(float(est.rc[0]) - float(tst.rc[0])) < 1e-4
    _check_track(jlog, tlog)
    st1, log1 = tt.track_chunk(_port_state(st0), _t(_pairs(raw)), _t(tab),
                               FS, FCAID)
    assert tlog.iP.shape == log1.iP.shape == (40, 1)
    assert abs(float(tst.fi[0]) - float(st1.fi[0])) < 2.0
    assert abs(float(tst.rc[0]) - float(st1.rc[0])) < 0.05
    assert int(tst.cp[0]) == int(st1.cp[0])
    assert (tlog.iP.numpy()[-8:, 0].__abs__().mean()
            > 0.8 * log1.iP.numpy()[-8:, 0].__abs__().mean())
    np.testing.assert_array_equal(log1.signs.numpy()[20:, 0],
                                  tlog.signs.numpy()[20:, 0])


def test_open_loop_matches_jax():
    """20 windows x 8 channels of the scenario at its handoff phases
    (int16 samples): E/P/L within 1e-4 of the prompt peak of the JAX scan
    run op by op; the compiled scan within its own spread (1e-2)."""
    sim, hand, _ = make_scenario(nav_data=True)
    iq = sim.generate(S * 20)
    raw = np.stack([np.round(iq.real), np.round(iq.imag)],
                   -1).astype(np.int16).reshape(20, S, 2)
    tab = ca_table(hand.prn_list).astype(np.float32)
    args = [np.asarray(x, np.float32) for x in
            (hand.rc, np.asarray(hand.fc) - F_CA, hand.ri, hand.fi)]
    with jax.disable_jit():
        ref = jt.track_open_loop(*map(jnp.asarray, args), jnp.asarray(raw),
                                 jnp.asarray(tab), FS, unroll=1)
    comp = jt.track_open_loop(*map(jnp.asarray, args), jnp.asarray(raw),
                              jnp.asarray(tab), FS)
    got = tt.track_open_loop(*map(_t, args), _t(raw), _t(tab), FS)
    peak = np.abs(np.asarray(ref[1])).max()
    for r, c, g in zip(ref, comp, got):
        assert g.shape == (20, 8, 2)
        assert np.abs(np.asarray(r) - g.numpy()).max() < 1e-4 * peak
        assert np.abs(np.asarray(c) - g.numpy()).max() < 1e-2 * peak


def test_deep_acquisition_matches_acquire_real():
    """tests/test_acquisition.py:96's 27 dB-Hz case: found and the code bin
    equal to acquire_real's, fi within one fine bin (9.5 Hz: adjacent bins
    can tie-flip), and the JAX test's truth limits; an absent PRN is not
    found."""
    rc_true, fi_true = 512.25, 1750.0
    fcaid = F_CA / 1.57542e9
    sig = synth_simple(7, FS, 25000 * 20, rc=rc_true, ri=0.42, fi=fi_true,
                       cn0_dbhz=27.0, seed=9)
    dopplers = np.arange(-50, 51) * 50.0
    ref = acquire_real(sig, [7, 21], FS, fcaid=fcaid, dopplers=dopplers,
                       n_coh_ms=10)
    got = tacq.acquire_deep(sig, [7, 21], FS, fcaid, n_coh_ms=10,
                            dopplers=dopplers, device="cpu")
    bin_hz = FS / (8 * (1 << (25000).bit_length()))
    for a, b in zip(ref, got):
        assert b.found == a.found and b.rc == a.rc
        assert abs(b.fi - a.fi) <= bin_hz * 1.001
        np.testing.assert_allclose(b.cppm, a.cppm, rtol=1e-3)
    deep, miss = got
    assert deep.found and not miss.found
    assert abs((deep.rc - rc_true + L_CA / 2) % L_CA - L_CA / 2) < 0.6
    assert abs(deep.fi - fi_true) < 30.0
    assert len(tacq.deep_dopplers(10)) == 241


# -- the receiver --------------------------------------------------------------

@pytest.fixture(scope="module")
def capture():
    """1.3 s of the 8-PRN scenario as int16 I/Q, with its handoff."""
    sim, hand, arr = make_scenario(nav_data=True)
    n = int(1.3 * FS)
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr


def _receivers(samples, hand, loops=None):
    out = []
    for pkg in (jscalar, tscalar):
        kw = dict(device="cpu") if pkg is tscalar else {}
        lc = None if loops is None else (
            jt.LoopConfig(**loops) if pkg is jscalar
            else tt.LoopConfig(**loops))
        rx = pkg.ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                                hand.prn_list, loops=lc, **kw)
        init = dict(rc=hand.rc, ri=hand.ri, fc=hand.fc, fi=hand.fi,
                    cp=hand.cp)
        rx.state = (tt.init_state(**init, device="cpu") if pkg is tscalar
                    else jt.init_state(**init))
        out.append(rx)
    return out


def _check_receiver_logs(jrx, trx):
    """The structural limits on the absorbed logs, cp_sign equal after
    the first 5 periods."""
    for prn in jrx.prn_list:
        a, b = jrx.channels[prn], trx.channels[prn]
        for k in ("cp", "lock"):
            np.testing.assert_array_equal(b.col(k), a.col(k), err_msg=k)
        drc = np.abs(b.col("rc") - a.col("rc"))
        assert np.minimum(drc, L_CA - drc).max() < 1e-3, prn
        assert np.abs(b.col("fi") - a.col("fi")).max() < 1.0
        pa = np.hypot(a.col("iP"), a.col("qP"))
        pb = np.hypot(b.col("iP"), b.col("qP"))
        assert (np.abs(pa - pb) / pa.max()).max() < 0.02, prn
        assert len(b.cp_sign) == len(a.cp_sign)
        np.testing.assert_array_equal(b.cp_sign[5:], a.cp_sign[5:])


def test_receiver_coherent_track_and_handoff_match_jax(capture):
    """track(1200, coh_ms=4) in chunks of 500 ms with the CLI's coherent
    loop defaults, from the handoff state: logs, cp_sign streams and
    window ends equal to the JAX receiver's within the structural limits;
    save_handoff propagated across the last 4 ms window (cp and bytes_read
    equal, rc within 1e-3 chips: 0.29 m of pseudorange, so the fix within
    0.5 m; measured 0.20 m)."""
    samples, hand, arr = capture
    jrx, trx = _receivers(samples, hand, COH_LOOPS[4])
    for rx in (jrx, trx):
        rx.track(1200, chunk_ms=500, coh_ms=4)
        rx.set_ephemerides({e.prn: copy.deepcopy(e) for e in arr.ephs})
    assert trx.mcount == jrx.mcount == 300 and trx.coh_ms == 4
    assert trx._m_samp == jrx._m_samp
    assert trx._m_samp[-1] == 1200 * 2500
    _check_receiver_logs(jrx, trx)
    hj, ht = jrx.save_handoff(""), trx.save_handoff("")
    np.testing.assert_array_equal(ht.cp, hj.cp)
    assert ht.bytes_read == hj.bytes_read == 1200 * 2500 * 4
    drc = np.abs(ht.rc - hj.rc)
    assert np.minimum(drc, L_CA - drc).max() < 1e-3
    assert np.abs(ht.x_ecef[:3] - hj.x_ecef[:3]).max() < 0.5
    assert abs(ht.rx_time - hj.rx_time) < 1e-8
    assert np.linalg.norm(ht.x_ecef[:3] - hand.x_ecef[:3]) < 15.0


def test_receiver_batched_track_matches_jax(capture):
    samples, hand, _ = capture
    jrx, trx = _receivers(samples, hand)
    for rx in (jrx, trx):
        rx.track(600, chunk_ms=301, batch_k=4)     # chunks round to 300
    assert trx.mcount == jrx.mcount == 600 and trx.coh_ms == 1
    _check_receiver_logs(jrx, trx)


def test_receiver_deep_acquire_matches_jax(capture):
    """acquire(deep_ms=100, n_coh_ms=10): the JAX receiver's deep branch
    (acquire_real) and the port's torch.fft search on the same capture;
    the file position is left where it was."""
    samples, hand, _ = capture
    res = []
    for rx in _receivers(samples, hand):
        res.append(rx.acquire(deep_ms=100, n_coh_ms=10, verbose=False))
        assert rx.rawfile.sample_pos == 0
    bin_hz = FS / (8 * (1 << (25000).bit_length()))
    for a, b in zip(*res):
        assert a.found and b.found and b.rc == a.rc
        assert abs(b.fi - a.fi) <= bin_hz * 1.001
    np.testing.assert_allclose(tt.state_to_numpy(rx.state)["rc"],
                               [r.rc for r in res[1]], rtol=1e-6)


@pytest.mark.slow
def test_coherent_cold_start_end_to_end():
    """The weak-signal path's tracking half in the port on the CPU: a 38 s
    capture, acquire, track(36 000, coh_ms=4) with the CLI's coherent loop
    defaults, 8/8 ephemerides equal to the scenario's, the scalar fix within
    15 m (tests/test_scalar_e2e.py:74)."""
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n = int(38.0 * FS)
    samples = np.empty(n, DTYPE_IQ16)
    for s0 in range(0, n, int(FS)):
        iq = sim.generate(min(int(FS), n - s0), start_sample=s0)
        samples["i"][s0:s0 + len(iq)] = np.clip(np.round(iq.real), -32768,
                                               32767)
        samples["q"][s0:s0 + len(iq)] = np.clip(np.round(iq.imag), -32768,
                                               32767)
    rx = tscalar.ScalarReceiver(SampleFile(samples=samples, fs=FS),
                                hand.prn_list,
                                loops=tt.LoopConfig(**COH_LOOPS[4]),
                                device="cpu")
    assert all(r.found for r in rx.acquire(verbose=False))
    rx.track(36_000, coh_ms=4)
    assert sorted(rx.decode_ephemerides(verbose=False)) == sorted(
        hand.prn_list)
    for e in arr.ephs:
        dec = rx.channels[e.prn].ephemeris
        assert abs(dec.sqrt_A - e.sqrt_A) < 1e-3
        assert abs(dec.M_0 - e.M_0) < 1e-8
    _, _, x_ecef, _, _ = rx.nav_solution()
    assert np.linalg.norm(x_ecef[:3] - hand.x_ecef[:3]) < 15.0
    assert np.linalg.norm(x_ecef[4:7]) < 0.5
