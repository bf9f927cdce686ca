"""Port tracker (ops/tracking.py, ops/track.py) vs the JAX reference.

- The correlator (K3's plain version) is held to the JAX `_correlate_step`
  with gather replicas, run op by op, at rel < 1e-5 (the sums differ only in
  order), and to the Pallas kernel in interpret mode within one sample's
  weight per window (its const-fold decides ~1 half-chip boundary per window
  differently, ops/tracking.py:307-310).
- The closed-loop tail (polarity, lock/SNR, discriminators, loop filters)
  is fed the same inputs as the JAX functions: equal to f32 rounding.
- Free-running tracks against the JAX scan body run op by op
  (jax.disable_jit: each operation as written, compiled alone): cp, ncp,
  lock equal, signs equal after step 5, rc within 1e-3 chips, fi within
  0.1 Hz and |prompt| within 1e-3 of the channel's peak (measured 6e-5 Hz
  and 3e-7 over 100 ms).
- Free-running 500 ms tracks against the XLA-compiled JAX scan: the same
  integer and rc limits, but fi within 1 Hz and |prompt| within 2 % of the
  peak, measured at ~0.5 Hz and ~0.9 %. Those looser limits are the
  compiled reference's own spread: the compiled scan departs from its op-by-
  op run by as much (0.15 Hz and 0.87 % over 100 ms), which the op-by-op
  test checks too. Compiling the whole body changes its f32 arithmetic
  (fusion, contraction); a time table built as f32(k) * f32(1/fs) alone
  does not close the gap.
The CUDA kernels are held to these plain versions on the card in
tests/test_torch_kernels.py.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu.constants import F_CA
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu.ops import pallas_track as jpt
from navlab_dpe_sdr_tpu.ops import tracking as jt
from navlab_dpe_sdr_tpu_torch.ops import track as ttk
from navlab_dpe_sdr_tpu_torch.ops import tracking as tt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_tracking import FCAID, FS, S, _make_blocks  # noqa: E402

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_state(jstate, device="cpu"):
    return tt.state_from_numpy({k: np.asarray(v) for k, v in
                                jstate._asdict().items()}, device)


def _random_state(seed, c=8):
    rng = np.random.default_rng(seed)
    return dict(rc=rng.random(c) * 1023.0, ri=rng.random(c),
                fc=np.full(c, F_CA) + rng.standard_normal(c),
                fi=rng.standard_normal(c) * 1000.0)


def _as_pairs(raw_complex):
    return np.stack([raw_complex.real, raw_complex.imag],
                    axis=-1).astype(np.float32)


@pytest.mark.parametrize("seed", [3, 11])
def test_correlate_window_matches_jax_step(seed):
    rng = np.random.default_rng(seed)
    c = 8
    tab = ca_table(range(1, c + 1)).astype(np.float32)
    init = _random_state(seed, c)
    raw = (rng.standard_normal((S, 2)) * 64.0).astype(np.float32)
    jst = jt.init_state(**init)
    e_s, p_s, l_s, ncp = jt._correlate_step(
        jst, jnp.asarray(raw[:, 0]), jnp.asarray(raw[:, 1]),
        jnp.asarray(tab), jnp.asarray((np.arange(S) / FS).astype(np.float32)),
        FS, strategy="gather")
    st = tt.init_state(**init, device="cpu")
    out = ttk.correlate_window(_t(raw), st.rc, st.dfc, st.ri, st.fi, _t(tab),
                               FS).numpy()
    assert out.shape == (c, 3, 3, 2)
    for tap, ref in enumerate((e_s, p_s, l_s)):
        ref = np.asarray(ref)
        rel = np.abs(out[:, tap] - ref).max() / np.abs(ref).max()
        assert rel < 1e-5, (tap, rel)
    _, ncp_port = ttk.correlate_window_plain(
        _t(raw[:, 0]), _t(raw[:, 1]), st.rc, st.dfc, st.ri, st.fi, _t(tab),
        ttk.window_times(S, FS, "cpu"), FS)
    np.testing.assert_array_equal(ncp_port.numpy(), np.asarray(ncp))


def test_correlate_window_matches_pallas_interpret():
    """Within 2 raw samples' weight per window of the const-fold kernel."""
    rng = np.random.default_rng(3)
    c = 8
    tab = ca_table(range(1, c + 1)).astype(np.float32)
    init = _random_state(3, c)
    raw = (rng.standard_normal((S, 2)) * 64.0).astype(np.float32)
    jst = jt.init_state(**init)
    r2d, ehi_t, elo_t, frac2 = jpt.prep_constants(tab, S)
    ref = np.asarray(jpt.correlate_window_pallas(
        jnp.asarray(raw.T.copy()), r2d,
        jpt.scal_pack(jst.rc, jst.dfc, jst.ri, jst.fi), ehi_t, elo_t, frac2,
        period=S, fs=FS, interpret=True))
    st = tt.init_state(**init, device="cpu")
    out = ttk.correlate_window(_t(raw), st.rc, st.dfc, st.ri, st.fi, _t(tab),
                               FS).numpy()
    bound = 2.0 * 2.0 * np.abs(raw).max()     # two sample flips of +/-|bb|
    assert np.abs(out - ref).max() < bound
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel < 0.05, rel


def _tail_inputs(seed, c=8, m=1):
    """Random segment sums [C, 3, m + 2, 2], ncp in {m-1, m, m+1} and a
    mid-run carry (rings filled, lock counters about the m ms thresholds);
    at m > 1 channel 0's sums are zero (every flip hypothesis ties)."""
    rng = np.random.default_rng(seed)
    sums = (rng.standard_normal((c, 3, m + 2, 2)) * 3000.0).astype(np.float32)
    if m > 1:
        sums[0] = 0.0
    ncp = rng.integers(m - 1, m + 2, c).astype(np.int32)
    st = jt.init_state(**_random_state(seed, c))
    f = {k: np.asarray(v) for k, v in st._asdict().items()}
    for k in ("p_a_re", "p_a_im", "prev_p_re", "prev_p_im"):
        f[k] = (rng.standard_normal(c) * 2000.0).astype(np.float32)
    for k in ("lf_code_h", "lf_carr_h", "lf_code_h2", "lf_carr_h2"):
        f[k] = (rng.standard_normal(c) * 0.1).astype(np.float32)
    f["lock_i"] = (rng.random(c) * 4000).astype(np.float32)
    f["lock_q"] = (rng.random(c) * 2000).astype(np.float32)
    lock_th, loss_th = max(1, round(240 / m)), max(1, round(50 / m))
    f["lockcount"] = rng.integers(lock_th - 10, lock_th + 10, c).astype(
        np.int32)
    f["losscount"] = rng.integers(max(0, loss_th - 5), loss_th + 5, c).astype(
        np.int32)
    f["lock"] = rng.integers(0, 2, c).astype(np.int32)
    f["snr_z"] = (rng.random((c, 20)) * 1e7).astype(np.float32)
    f["snr_v"] = (rng.random((c, 20)) * 1e12).astype(np.float32)
    return sums, ncp, f


def _close(a, b, what, rtol=2e-6):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    assert np.abs(a - b).max() <= rtol * scale, (what, np.abs(a - b).max(),
                                                 scale)


@pytest.mark.parametrize("fll", [0.0, 3.0])
@pytest.mark.parametrize("boxcar", [False, True])
@pytest.mark.parametrize("order", [2, 3])
def test_loop_tail_matches_jax(order, boxcar, fll):
    sums, ncp, f = _tail_inputs(seed=order * 10 + int(boxcar) + int(fll))
    jst = jt.TrackState(**{k: jnp.asarray(v) for k, v in f.items()})
    tst = tt.state_from_numpy(f, "cpu")
    jloops = jt.LoopConfig(order=order, boxcar=boxcar, bn_carr_freq=fll)
    tloops = tt.LoopConfig(order=order, boxcar=boxcar, bn_carr_freq=fll)
    e_s, p_s, l_s = (sums[:, i] for i in range(3))

    jres = jt._polarity_combine(jst, *(jnp.asarray(x) for x in
                                       (e_s, p_s, l_s)), jnp.asarray(ncp), 1)
    tres = tt._polarity_combine(tst, *(_t(x) for x in (e_s, p_s, l_s)),
                                _t(ncp))
    for name, a, b in zip(("e_r", "p_r", "l_r", "signs", "pa_re", "pa_im"),
                          jres, tres):
        _close(a, b.numpy(), name)

    p_r = np.asarray(jres[1])
    jst1, jlock, jlv, jsnr = jt._lock_snr_update(jst, jnp.asarray(p_r), 1)
    tst1, tlock, tlv, tsnr = tt._lock_snr_update(tst, _t(p_r))
    np.testing.assert_array_equal(np.asarray(jlock), tlock.numpy())
    _close(jlv, tlv.numpy(), "lockval")
    _close(jsnr, tsnr.numpy(), "snr", rtol=1e-5)
    for k in ("lock_i", "lock_q", "snr_z", "snr_v"):
        _close(getattr(jst1, k), getattr(tst1, k).numpy(), k)
    for k in ("losscount", "lockcount", "snr_fill"):
        np.testing.assert_array_equal(np.asarray(getattr(jst1, k)),
                                      getattr(tst1, k).numpy())

    e_r, l_r = np.asarray(jres[0]), np.asarray(jres[2])
    jst2, jdpc, jdpi = jt._loops_update(jst, jnp.asarray(e_r),
                                        jnp.asarray(p_r), jnp.asarray(l_r),
                                        FCAID, jloops, 1)
    tst2, tdpc, tdpi = tt._loops_update(tst, _t(e_r), _t(p_r), _t(l_r),
                                        FCAID, tloops)
    _close(jdpc, tdpc.numpy(), "dpc")
    _close(jdpi, tdpi.numpy(), "dpi")
    for k in ("fi", "dfc", "lf_carr_h", "lf_code_h", "lf_carr_h2",
              "lf_code_h2", "prev_p_re", "prev_p_im"):
        _close(getattr(jst2, k), getattr(tst2, k).numpy(), k)


def _check_free_run(jlog, tlog, fi_tol=1.0, prompt_tol=0.02,
                    rows=slice(None), sign_from=5):
    """The free-running tolerances (module docstring) over log rows
    `rows`, signs from update `sign_from` on (None: not compared); either
    log may be the JAX or the port's."""
    for k in ("cp", "ncp", "lock"):
        np.testing.assert_array_equal(np.asarray(getattr(jlog, k))[rows],
                                      np.asarray(getattr(tlog, k))[rows],
                                      err_msg=k)
    if sign_from is not None:
        np.testing.assert_array_equal(
            np.asarray(jlog.signs)[rows][sign_from:],
            np.asarray(tlog.signs)[rows][sign_from:])
    drc = np.abs(np.asarray(jlog.rc, np.float64)[rows]
                 - np.asarray(tlog.rc)[rows])
    drc = np.minimum(drc, 1023.0 - drc)
    assert drc.max() < 1e-3, drc.max()
    dfi = np.abs(np.asarray(jlog.fi)[rows] - np.asarray(tlog.fi)[rows])
    assert dfi.max() < fi_tol, dfi.max()
    pj = np.hypot(np.asarray(jlog.iP), np.asarray(jlog.qP))[rows]
    pt = np.hypot(np.asarray(tlog.iP), np.asarray(tlog.qP))[rows]
    rel = np.abs(pj - pt) / pj.max(axis=0)
    assert rel.max() < prompt_tol, rel.max(axis=0)


def test_track_chunk_matches_jax_op_by_op():
    """100 ms pull-in (test_pallas_track's signal) against the JAX scan run
    op by op: the tight limits. The compiled scan stays within the loose
    free-run limits of that same op-by-op run."""
    prn, rc0, ri0, fi0 = 5, 250.0, 0.4, 900.0
    raw = _as_pairs(_make_blocks(prn, 100, rc0, ri0, fi0))
    tab = ca_table([prn]).astype(np.float32)
    st0 = jt.init_state(rc=[rc0 + 0.2], ri=[ri0], fc=[F_CA + FCAID * fi0],
                        fi=[fi0 + 10.0])
    with jax.disable_jit():
        _, elog = jt._track_chunk_jit(st0, jnp.asarray(raw), jnp.asarray(tab),
                                      FS, FCAID, loops=jt.LoopConfig(),
                                      coh_ms=1, unroll=1, strategy="gather")
    _, tlog = tt.track_chunk(_port_state(st0), _t(raw), _t(tab), FS, FCAID)
    _check_free_run(elog, tlog, fi_tol=0.1, prompt_tol=1e-3)
    _, jlog = jt.track_chunk(st0, jnp.asarray(raw), jnp.asarray(tab), FS,
                             FCAID)
    _check_free_run(jlog, elog)


def test_track_chunk_matches_jax_single_prn():
    """500 ms pull-in from 0.2 chips / 10 Hz off (test_pallas_track's
    signal), against the XLA scan."""
    prn, rc0, ri0, fi0 = 5, 250.0, 0.4, 900.0
    raw = _as_pairs(_make_blocks(prn, 500, rc0, ri0, fi0))
    tab = ca_table([prn]).astype(np.float32)
    st0 = jt.init_state(rc=[rc0 + 0.2], ri=[ri0], fc=[F_CA + FCAID * fi0],
                        fi=[fi0 + 10.0])
    _, jlog = jt.track_chunk(st0, jnp.asarray(raw), jnp.asarray(tab), FS,
                             FCAID)
    _, tlog = tt.track_chunk(_port_state(st0), _t(raw), _t(tab), FS, FCAID)
    _check_free_run(jlog, tlog)


@pytest.fixture(scope="module")
def scenario_500ms():
    sim, hand, arr = make_scenario(nav_data=True)
    iq = sim.generate(S * 500)
    raw = np.stack([np.clip(np.round(iq.real), -32768, 32767),
                    np.clip(np.round(iq.imag), -32768, 32767)],
                   axis=-1).astype(np.int16).reshape(500, S, 2)
    return raw, hand


def test_track_chunk_matches_jax_scenario(scenario_500ms):
    """The 8-PRN scenario from its exact handoff state, int16 samples."""
    raw, hand = scenario_500ms
    tab = ca_table(hand.prn_list).astype(np.float32)
    init = dict(rc=hand.rc, ri=hand.ri, fc=hand.fc, fi=hand.fi, cp=hand.cp)
    jst1, jlog = jt.track_chunk(jt.init_state(**init), jnp.asarray(raw),
                                jnp.asarray(tab), FS, FCAID)
    tst1, tlog = tt.track_chunk(tt.init_state(**init, device="cpu"),
                                _t(raw), _t(tab), FS, FCAID)
    _check_free_run(jlog, tlog)
    assert tlog.iP.shape == (500, 8) and tlog.signs.shape == (500, 8, 2)
    assert (tlog.lock.numpy()[-1] == 1).all()
    np.testing.assert_array_equal(tst1.cp.numpy(), np.asarray(jst1.cp))


def test_track_chunk_matches_pallas_interpret():
    """K4's own JAX test (tests/test_pallas_track.py:57-75), port side."""
    prn, rc0, ri0, fi0 = 5, 250.0, 0.4, 900.0
    blocks = _make_blocks(prn, 30, rc0, ri0, fi0)
    tab = ca_table([prn]).astype(np.float32)
    st0 = jt.init_state(rc=[rc0 + 0.2], ri=[ri0], fc=[F_CA + FCAID * fi0],
                        fi=[fi0 + 10.0])
    stp, logp = jpt.track_chunk_pallas(st0, jnp.asarray(blocks),
                                       jnp.asarray(tab), FS, FCAID,
                                       interpret=True)
    st1, log1 = tt.track_chunk(_port_state(st0), _t(_as_pairs(blocks)),
                               _t(tab), FS, FCAID)
    assert abs(float(stp.fi[0]) - float(st1.fi[0])) < 0.1
    assert abs(float(stp.rc[0]) - float(st1.rc[0])) < 1e-3
    assert int(stp.cp[0]) == int(st1.cp[0])
    np.testing.assert_allclose(log1.iP.numpy()[-5:, 0],
                               np.asarray(logp.iP)[-5:, 0], rtol=0.02)
    np.testing.assert_array_equal(np.asarray(logp.signs)[5:],
                                  log1.signs.numpy()[5:])


def test_jax_carry_resumes_in_port(scenario_500ms):
    """A JAX TrackState after 250 ms continues in the port: the carry maps
    field for field (state_from_numpy / state_to_numpy), and the next
    250 ms track like the uninterrupted JAX run."""
    raw, hand = scenario_500ms
    tab = ca_table(hand.prn_list).astype(np.float32)
    init = dict(rc=hand.rc, ri=hand.ri, fc=hand.fc, fi=hand.fi, cp=hand.cp)
    jmid, _ = jt.track_chunk(jt.init_state(**init), jnp.asarray(raw[:250]),
                             jnp.asarray(tab), FS, FCAID)
    _, jlog = jt.track_chunk(jmid, jnp.asarray(raw[250:]), jnp.asarray(tab),
                             FS, FCAID)
    tmid = _port_state(jmid)
    back = tt.state_to_numpy(tmid)
    for k, v in jmid._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
        assert back[k].dtype == np.asarray(v).dtype, k
    _, tlog = tt.track_chunk(tmid, _t(raw[250:]), _t(tab), FS, FCAID)
    _check_free_run(jlog, tlog)


def test_packed_log_and_state_layouts():
    st = tt.init_state(**_random_state(5, 3), cp=[7, 8, 9], device="cpu")
    stf, sti, rings = tt.pack_state(st)
    assert (stf.shape, sti.shape, rings.shape) == ((3, 16), (3, 5),
                                                   (3, 2, 20))
    back = tt.unpack_state(stf, sti, rings)
    for k in tt.TrackState._fields:
        assert torch.equal(getattr(back, k), getattr(st, k)), k
    raw = torch.zeros((4, S, 2), dtype=torch.int16)
    tab = _t(ca_table([1, 2, 3]).astype(np.float32))
    _, logf, logi = tt.track_chunk_packed(st, raw, tab, FS, FCAID)
    assert logf.shape == (4, 16, 3) and logi.dtype == torch.int32
    log = tt.unpack_log(logf, logi)
    assert torch.equal(log.cp[0], st.cp)
    assert torch.equal(log.fc[0], tt.F_CA32 + st.dfc)


def test_unported_tracking_modes_raise():
    """What the tracker still refuses: windows of more than 10 code periods
    (two nav-bit boundaries), batch_k with coherent windows, ragged batches
    and windows, and devices other than cpu/cuda."""
    st = tt.init_state(**_random_state(5, 2), device="cpu")
    raw = torch.zeros((4, S, 2), dtype=torch.int16)
    tab = _t(ca_table([1, 2]).astype(np.float32))
    for m in (0, 11):
        with pytest.raises(ValueError, match="coh_ms must be in 1..10"):
            tt.track_chunk(st, torch.zeros((4, m * S or S, 2)), tab, FS,
                           FCAID, coh_ms=m)
    with pytest.raises(ValueError, match="1 ms cadence only"):
        tt.track_chunk_packed(st, torch.zeros((4, 2 * S, 2)), tab, FS, FCAID,
                              coh_ms=2, batch_k=2)
    with pytest.raises(ValueError, match="not divisible by batch_k"):
        tt.track_chunk_batched(st, raw, tab, FS, FCAID, batch_k=3)
    with pytest.raises(ValueError, match="whole code periods"):
        tt.track_chunk(st, torch.zeros((4, S + 1, 2)), tab, FS, FCAID,
                       coh_ms=2)
    meta = torch.zeros((4, S, 2), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tt.track_chunk(st, meta, tab, FS, FCAID)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ttk.correlate_window(meta[0], st.rc, st.dfc, st.ri, st.fi, tab, FS)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tt.track_open_loop(st.rc, st.dfc, st.ri, st.fi, meta, tab, FS)
