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


# -- the coherent/batched kernel's sum order -----------------------------------

def _window_products(m, n_samp, seed):
    """E/P/L x re/im products of one window [1, 2, 3 (m + 2), S] f32, zero
    outside each sum's segment (the boundaries of a seeded rc at fs =
    2.5 MHz), as correlate_window_plain forms them; and the segment of each
    sample."""
    rng = np.random.default_rng(seed)
    n_seg = m + 2
    rc = np.float32(rng.random() * 1023.0)
    ratio = np.float32(FS) / np.float32(F_CA + rng.standard_normal())
    cols = np.arange(n_samp, dtype=np.float32)
    seg = sum((cols >= (np.float32(k * L_CA) - rc) * ratio).astype(int)
              for k in range(1, n_seg))
    bb = (rng.standard_normal((2, n_samp)) * 300.0).astype(np.float32)
    taps = np.where(rng.random((3, n_samp)) < 0.5, -1.0, 1.0).astype(np.float32)
    w = np.stack([taps[t] * (seg == j) for t in range(3) for j in range(n_seg)])
    return (bb[:, None, :] * w[None]).astype(np.float32)[None], seg


def _kernel_window_sum(prod, seg, sums_seg, warps):
    """The window kernel's order, simulated in numpy f32: warp w's lanes
    add their samples w 32 R + i + 32 r in turn, a shuffle tree per warp,
    then only the warps whose chunks meet the sum's segment, in order."""
    n = prod.shape[-1]
    r = -(-n // (32 * warps))
    out = np.zeros(prod.shape[:-1], np.float32)
    for idx in np.ndindex(*prod.shape[:-1]):
        j = sums_seg[idx[-1]]
        tot = None
        for wi in range(warps):
            lo, hi = wi * 32 * r, min((wi + 1) * 32 * r, n)
            if lo >= n or not (seg[lo:hi] == j).any():
                continue
            lanes = np.zeros(32, np.float32)
            for i in range(32):
                for k in range(r):
                    s = lo + i + 32 * k
                    if s < hi:
                        lanes[i] = np.float32(lanes[i] + prod[idx + (s,)])
            for half in (16, 8, 4, 2, 1):
                lanes = (lanes[:half] + lanes[half:2 * half]).astype(np.float32)
            tot = lanes[0] if tot is None else np.float32(tot + lanes[0])
        out[idx] = 0.0 if tot is None else tot
    return out


@pytest.mark.parametrize("m,batch_k", [(m, 1) for m in range(2, 11)]
                         + [(1, 4)])
def test_window_order_sum_is_a_sum(m, batch_k):
    """_window_order_sum over a window's masked products (the segment
    layout of m periods; a batch_k = 4 pass's 1 ms windows) sums to a plain
    torch.sum within f32 rounding, and equals the window kernel's order
    simulated lane by lane, bit for bit."""
    from navlab_dpe_sdr_tpu_torch.ops import track as ttrack
    n_samp = m * S
    prod, seg = _window_products(m, n_samp, seed=m + 10 * batch_k)
    warps = ttrack.window_warps(m, batch_k)
    assert warps == ttrack.WINDOW_LANES // 32 // (batch_k if m == 1 else 1)
    got = ttrack._window_order_sum(torch.from_numpy(prod), warps).numpy()
    want = prod.astype(np.float64).sum(-1)
    scale = np.abs(prod).astype(np.float64).sum(-1)
    assert np.all(np.abs(got - want) <= 4 * n_samp * 2.0 ** -24 * scale + 1e-30)
    sums_seg = np.tile(np.arange(m + 2), 3)
    sim = _kernel_window_sum(prod[0, :1, ::max(1, (m + 2) // 2)],
                             seg, sums_seg[::max(1, (m + 2) // 2)], warps)
    assert np.array_equal(got[0, :1, ::max(1, (m + 2) // 2)], sim)


def test_sum_orders_by_mode(monkeypatch):
    """The 1 ms plain tracker sums in the 1 ms kernel's order
    (_kernel_order_sum) only; the coherent and batch_k plain trackers in the
    window kernel's (_window_order_sum) only."""
    from navlab_dpe_sdr_tpu_torch.ops import track as ttrack
    calls = []
    for name in ("_kernel_order_sum", "_window_order_sum"):
        real = getattr(ttrack, name)
        monkeypatch.setattr(ttrack, name,
                            lambda *a, _n=name, _f=real: (calls.append(_n),
                                                          _f(*a))[1])
    raw = _make_blocks(5, 8, 250.0, 0.4, 900.0)
    tab = _t(ca_table([5]).astype(np.float32))
    st0 = _port_state(jt.init_state(rc=[250.0], ri=[0.4],
                                    fc=[F_CA + FCAID * 900.0], fi=[900.0]))
    seen = {}
    for mode, kw in (("m=1", {}), ("m=2", dict(coh_ms=2))):
        calls.clear()
        m = kw.get("coh_ms", 1)
        tt.track_chunk_plain(st0, _t(_pairs(raw.reshape(8 // m, m * S))), tab,
                             FS, FCAID, tt.cadence_loops(m), **kw)
        seen[mode] = set(calls)
    calls.clear()
    tt.track_chunk_batched_plain(st0, _t(_pairs(raw)), tab, FS, FCAID,
                                 batch_k=4)
    seen["batch_k=4"] = set(calls)
    assert seen == {"m=1": {"_kernel_order_sum"},
                    "m=2": {"_window_order_sum"},
                    "batch_k=4": {"_window_order_sum"}}


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


def _plain_fine_hz(sig, prn, rc, dopplers, n_coh, fcaid):
    """The deep search's fine frequency worked out plainly in float64: the
    coarse Doppler at code phase rc (the largest of the segments' summed
    correlation magnitudes at that code lag), then every segment's
    zero-padded carrier spectrum, code wiped off at rc, within one grid
    step of it, its power summed over the segments."""
    period = int(FS * 1e-3)
    s_fine = n_coh * period
    k_seg = len(sig) // s_fine
    x = np.asarray(sig[:k_seg * s_fine], np.complex128)
    t = np.arange(len(x)) / FS
    chips = ca_table([prn])[0].astype(np.float64)
    code = chips[np.mod(np.floor(np.arange(period) / FS * F_CA),
                        L_CA).astype(int)]
    lag = int(round((L_CA - rc) * FS / F_CA)) % period
    ref = np.roll(code, lag)                    # code[q - lag]
    mags = [np.abs((x * np.exp(-2j * np.pi * d * t)).reshape(
        k_seg, n_coh, period).sum(axis=1) @ ref).sum() for d in dopplers]
    f_coarse = float(dopplers[int(np.argmax(mags))])
    n_fft = 8 * (1 << s_fine.bit_length())
    bin_hz = FS / n_fft
    half = int(np.ceil(float(np.median(np.diff(dopplers))) / bin_hz))
    k = int(round(f_coarse / bin_hz)) + np.arange(-half, half + 1)
    k = k[(k >= np.floor(dopplers.min() / bin_hz))
          & (k < np.ceil(dopplers.max() / bin_hz) + 1)]
    seg = x.reshape(k_seg, s_fine)
    seg = seg - seg.mean(axis=1, keepdims=True)
    fc = F_CA + fcaid * f_coarse
    y = seg * chips[np.mod(np.floor(t * fc + rc), L_CA).astype(int)
                    ].reshape(k_seg, s_fine)
    n = np.arange(s_fine)
    w = np.exp(-2j * np.pi * np.mod(np.outer(k, n), n_fft) / n_fft)
    power = (np.abs(y @ w.T) ** 2).sum(axis=0)
    return float(k[int(np.argmax(power))] * bin_hz), bin_hz


def test_deep_acquisition_matches_acquire_real():
    """tests/test_acquisition.py:96's 27 dB-Hz case: found and the code bin
    equal to acquire_real's, the found PRN's fi within one fine bin of
    acquire_real's (9.5 Hz: adjacent bins can tie-flip), and the JAX test's
    truth limits; an absent PRN is not found. The port searches the fine
    frequency about the coarse Doppler with every segment's power where
    acquire_real takes the first segment's over the whole band, so the
    absent PRN's fi (a noise pick either way) is held within one bin to
    that search worked out plainly in float64 (`_plain_fine_hz`), as the
    found PRN's is too."""
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
        np.testing.assert_allclose(b.cppm, a.cppm, rtol=1e-3)
        plain, plain_bin = _plain_fine_hz(sig, b.prn, b.rc, dopplers, 10,
                                          fcaid)
        assert plain_bin == bin_hz
        assert abs(b.fi - plain) <= bin_hz * 1.001, (b.prn, b.fi, plain)
    deep, miss = got
    assert abs(deep.fi - ref[0].fi) <= bin_hz * 1.001
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


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("n_samp", [S, S + 1])
@pytest.mark.parametrize("n_win", [1, 3, 20])
def test_open_loop_windows_order_matches_jax_op_by_op(n_win, n_samp, dtype):
    """track_open_loop_plain sums in K3's windows-mode order
    (track.WINDOWS_LANES lanes, `_kernel_order_sum`): E/P/L within 1e-4 of
    the prompt peak of the JAX scan run op by op (the limit of
    test_open_loop_matches_jax), for windows of S and S + 1 samples (a
    window that is no multiple of the lanes' 16-byte pairs), int16 and
    float32 samples."""
    sim, hand, _ = make_scenario(nav_data=True)
    iq = sim.generate(n_samp * n_win)
    raw = np.stack([np.round(iq.real), np.round(iq.imag)], -1).reshape(
        n_win, n_samp, 2)
    raw = raw.astype(np.int16) if dtype == "int16" else (
        raw * 0.3).astype(np.float32)
    tab = ca_table(hand.prn_list).astype(np.float32)
    args = [np.asarray(x, np.float32) for x in
            (hand.rc, np.asarray(hand.fc) - F_CA, hand.ri, hand.fi)]
    with jax.disable_jit():
        ref = jt.track_open_loop(*map(jnp.asarray, args), jnp.asarray(raw),
                                 jnp.asarray(tab), FS, unroll=1)
    got = tt.track_open_loop_plain(*map(_t, args), _t(raw), _t(tab), FS)
    peak = np.abs(np.asarray(ref[1])).max()
    for k, r in enumerate(ref):
        assert got[:, :, k].shape == (n_win, 8, 2)
        assert np.abs(np.asarray(r) - got[:, :, k].numpy()).max() \
            < 1e-4 * peak


@pytest.mark.parametrize("lanes", [256, 1280])
def test_kernel_order_sum_simulates_the_lanes(lanes):
    """`_kernel_order_sum(prod, lanes)` (K3's windows mode at 256 lanes, the
    1 ms kernels at 1280) equals the kernel's order simulated lane by lane
    in float32: lane i adds samples i, i + lanes, ... in turn, each warp's
    32 lanes are halved 16, 8, 4, 2, 1, the warps are added in turn."""
    from navlab_dpe_sdr_tpu_torch.ops import track as ttrack
    rng = np.random.default_rng(lanes)
    for n in (S, S + 1):
        prod = (rng.standard_normal((3, n)) * 100).astype(np.float32)
        got = ttrack._kernel_order_sum(torch.from_numpy(prod), lanes).numpy()
        for row in range(prod.shape[0]):
            acc = np.zeros(lanes, np.float32)
            for s0 in range(0, n, lanes):
                part = prod[row, s0:s0 + lanes]
                acc[:part.size] = (acc[:part.size] + part).astype(np.float32)
            tot = None
            for w in range(lanes // 32):
                v = acc[32 * w:32 * w + 32]
                for half in (16, 8, 4, 2, 1):
                    v = (v[:half] + v[half:2 * half]).astype(np.float32)
                tot = v[0] if tot is None else np.float32(tot + v[0])
            assert got[row] == tot, (n, row)
