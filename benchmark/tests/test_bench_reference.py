"""The reference against the port's plain path on a few CPU blocks: the
host preparation and update, the correlator and the scorer."""

import numpy as np
import pytest
import torch

from benchmark.harness import check, program
from benchmark.reference import device as ref_dev

CONFIG = {
    "name": "ref_test",
    "scenario": {"n_sats": 8, "tow0": 345720.0, "lat": 40.112,
                 "lon": -88.228, "alt": 200.0, "cn0_dbhz": 47.0,
                 "fs": 2500000.0, "nav_data": True, "min_elev_deg": 15.0,
                 "sigma": 32.0, "block_s": 0.02, "seconds": 0.2},
    "grid": {"style": "uniform", "n": 5, "pos_spacing": 5.0,
             "vel_spacing": 0.5},
    "receiver": {"ekf_mode": "alpha", "ekf_alpha": 0.3},
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from benchmark.harness import capture

    old = capture.CACHE_DIR
    capture.CACHE_DIR = tmp_path_factory.mktemp("cache")
    cap = capture.load(CONFIG, 123, torch.device("cpu"))
    yield cap, check.Reference(CONFIG, cap, torch.device("cpu"))
    capture.CACHE_DIR = old


def test_batched_prep_and_drain_follow_the_receiver(setup):
    """From the receiver's state, the reference's block-by-block preparation
    gives the receiver's packed parameters and end state, and its update
    with the receiver's cells the receiver's fixes and state."""
    from navlab_dpe_sdr_tpu_torch.models.dpe import _fetch_async
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real

    cap, R = setup
    rx = program.dpe_receiver(CONFIG, cap, "cpu")
    rr = R.receiver()
    check.start_cache_batched(rr, cap.hand)
    rr.load(program.snapshot(rx))
    preps = rx._prepare_batch(5)
    mine = rr.prepare_batch(5)
    for (f, i, e, t, mc, x), (rf, ri_, re, rt, rmc, rx_) in zip(preps, mine):
        assert np.allclose(f, rf, rtol=2e-7, atol=1e-6)
        assert np.array_equal(i, ri_)
        assert np.array_equal(e, re) and t == rt and mc == rmc
        assert np.array_equal(x, rx_)
    assert check.state_gap_m(program.snapshot(rx), rr.snapshot()) < 1e-5
    fpk = np.stack([p[0] for p in preps])
    ipk = np.stack([p[1] for p in preps])
    rows = dpe_real.dpe_batch_blocks(
        cap.raw, dpe_real.pack_params(fpk, ipk, 0), rx._dev.chips,
        rx._dev.time_idc, rx._dev.d_enu, rx._dev.dt_m, rx._dev.dv_enu,
        rx._dev.dtdot, carr_fftpts=rx.carr_fftpts, period=rx.period,
        n_periods=rx.S // rx.period, n_blocks=5, return_windows=False,
        code_win=rx.code_win, carr_win=rx.carr_win)
    pas, vas = dpe_real.unpack_row_indices(rows.numpy())
    rr.load(program.snapshot(rx))
    fixes = rr.drain(preps, list(zip(pas, vas)), R.grid)
    rx._drain_batch(_fetch_async(rows), preps)
    got = np.array([f.x_ecef for f in rx.fixes])
    assert np.array_equal(got, fixes)
    assert check.state_gap_m(program.snapshot(rx), rr.snapshot()) == 0.0
    assert (R.code_win, R.carr_win) == (rx.code_win, rx.carr_win)


def test_correlator_and_scorer_match_the_plain_path(setup):
    """The direct correlator against the port's plain one (the algebra
    the card's kernel is held to), and the scores and argmax against the
    port's plain scorer, on the receiver's first five blocks."""
    from navlab_dpe_sdr_tpu_torch.ops import correlate, score

    cap, R = setup
    rx = program.dpe_receiver(CONFIG, cap, "cpu")
    preps = rx._prepare_batch(5)
    fpk = np.stack([p[0] for p in preps])
    ipk = np.stack([p[1] for p in preps])
    win = R.correlate(0, fpk, ipk, tf32=False)
    fp = torch.as_tensor(fpk)
    ip = torch.as_tensor(ipk.astype(np.int64))
    raw = cap.raw[:5]
    kw = dict(code_win=rx.code_win, carr_win=rx.carr_win, complex_out=True)
    plain = correlate.windowed_correlate_plain(
        raw[..., 0], raw[..., 1], rx._dev.chips, fp[:, 0], ip[:, 0],
        fp[:, 1], fp[:, 2], rx._dev.time_idc, ip[:, 1], ip[:, 2],
        rx.carr_fftpts, rx.period, rx.S // rx.period, **kw)
    assert torch.equal(plain.flip_used, win.flip)
    for a, b in ((plain.code_re, win.code_re), (plain.carr_im, win.carr_im)):
        scale = torch.hypot(win.code_re, win.code_im).amax(-1, keepdim=True)
        if a.shape[-1] != scale.shape[-1]:
            scale = torch.hypot(win.carr_re, win.carr_im).amax(
                -1, keepdim=True)
        assert float(((a - b).abs() / scale).max()) < 1e-4
    code_mag, carr_mag = win.mags()
    los = fp[:, 3:6].transpose(1, 2)
    want = score.score_surface_plain(code_mag, los, fp[:, 7], fp[:, 8],
                                     fp[:, 6], rx._dev.d_enu, rx._dev.dt_m)
    got = ref_dev.scores(code_mag, los, fp[:, 7], fp[:, 8], fp[:, 6],
                         R.d_enu, R.dt_m)
    assert torch.equal(got, want)
    top, arg = ref_dev.best(code_mag, los, fp[:, 7], fp[:, 8], fp[:, 6],
                            R.d_enu, R.dt_m, chunk=100)
    assert torch.equal(arg, want.argmax(dim=1))
    assert torch.equal(top, want.max(dim=1).values)


def test_tracker_is_the_ports_plain_tracker(setup):
    """The reference's tracker over 60 steps from the truth's channel state
    equals the port's plain tracker bit for bit (the port's K4 is held to
    that on the card)."""
    from navlab_dpe_sdr_tpu_torch.ops import tracking

    from benchmark.reference import tracker as ref_trk

    cap, R = setup
    h = cap.hand
    st = tracking.init_state(rc=h.rc, ri=h.ri, fc=h.fc, fi=h.fi,
                             device="cpu")
    raw = cap.raw.reshape(-1, 2)[:60 * 2500].reshape(60, 2500, 2)
    want_st, want_f, want_i = tracking.track_chunk_plain(
        st, raw, R.chips, R.fs, 1.023e6 / 1.57542e9)
    mine = ref_trk.state_from_numpy(tracking.state_to_numpy(st), "cpu")
    got_st, got_f, got_i = ref_trk.track_chunk_plain(
        mine, raw, R.chips, R.fs, 1.023e6 / 1.57542e9)
    assert torch.equal(got_f, want_f) and torch.equal(got_i, want_i)
    for k in want_st._fields:
        assert torch.equal(getattr(got_st, k), getattr(want_st, k)), k
