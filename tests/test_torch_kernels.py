"""The port's CUDA kernels against their plain PyTorch versions on the
card: K3 (correlate_window, and its windows mode), K4 (track_chunk: 1 ms,
coherent windows of m code periods, the batch_k schedule), K2
(score_surface), K5 (the windowed correlator), K1's sinc interpolation, and
the receivers that run them. Marked `cuda`; they skip without a card.

K2, K3 and K4 do the plain versions' f32 operations in the same order (sums
included: the plain sums follow the kernel's threads per channel,
ops/track.KERNEL_THREADS, WINDOWS_LANES for K3's windows mode and
WINDOW_LANES for the coherent/batched kernel; -fmad=false), so those
comparisons are equality, bit for bit. K5 sums in
its own fixed order (windows within 1e-5 of each channel's window maximum,
flips and code argmaxes equal; across batch splits and channel subsets,
bit for bit), and K1's sinc takes one sine a point-channel (rtol 1e-5
against torch.sinc). This file
imports nothing of JAX or of the JAX package, so it runs on a machine with
the card alone:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_kernels.py
"""

import copy

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch.constants import F_CA, F_L1
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu_torch.models.grid import (_mesh4, spread_grid,
                                                  uniform_grid)
from navlab_dpe_sdr_tpu_torch.models import dpe as tdpe
from navlab_dpe_sdr_tpu_torch.models import scalar as tscalar
from navlab_dpe_sdr_tpu_torch.models import vector as tvector
from navlab_dpe_sdr_tpu_torch.ops import acquisition as tacq
from navlab_dpe_sdr_tpu_torch.ops import _build, score, track, tracking
from navlab_dpe_sdr_tpu_torch.ops import correlate
from navlab_dpe_sdr_tpu_torch.ops import dpe_real

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


@pytest.mark.parametrize("s", [S, S + 1, 1000])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_correlate_window_kernel_equals_plain(dtype, s, dev):
    """S = 2500 is staged by one bulk copy; 2501 int16 samples are 10 004
    bytes, no multiple of 16, and take the 4-byte copies."""
    rng = np.random.default_rng(9)
    fs = s * 1000.0
    tab = torch.from_numpy(ca_table(range(1, 9)).astype(np.float32)).to(dev)
    st = tracking.init_state(rc=rng.random(8) * 1023.0, ri=rng.random(8),
                             fc=F_CA + rng.standard_normal(8),
                             fi=rng.standard_normal(8) * 1000.0, device=dev)
    raw = torch.from_numpy(np.round(rng.standard_normal((s, 2)) * 64.0)
                           .astype(np.float32)).to(dtype).to(dev)
    before = _build.launch_counts()["correlate_window"]
    out = track.correlate_window(raw, st.rc, st.dfc, st.ri, st.fi, tab, fs)
    assert _build.launch_counts()["correlate_window"] == before + 1
    rf = raw.float()
    plain, _ = track.correlate_window_plain(
        rf[:, 0], rf[:, 1], st.rc, st.dfc, st.ri, st.fi, tab,
        track.window_times(s, fs, dev), fs)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("skew", [0, 2])
def test_track_chunk_kernel_equals_plain(capture, skew, dev):
    """skew = 2: the chunk is a view 8 bytes into its buffer, so no window
    is 16-byte aligned and the ring is filled by the 4-byte copies."""
    samples, hand, _ = capture
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    flat = torch.from_numpy(samples[:201 * S].view(np.int16).copy()).to(dev)
    raw = flat[2 * skew:2 * skew + 200 * S * 2].view(200, S, 2)
    assert raw.data_ptr() % 16 == (8 if skew else 0)
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


def test_track_chunk_one_window_chunks_equal_plain(capture, dev):
    """A fleet's align tracks its catch-up milliseconds one [1, S, 2] chunk
    a launch: fewer windows than the ring's slots, the state carried from
    launch to launch. Seven such chunks after 100 tracked ms, kernel chain
    against plain chain, bit for bit at every chunk."""
    samples, hand, _ = capture
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    raw = torch.from_numpy(samples[:107 * S].view(np.int16)
                           .reshape(107, S, 2).copy()).to(dev)
    sk, _, _ = tracking.track_chunk_packed(_seeded_state(hand, dev),
                                           raw[:100], tab, FS, FCAID)
    sp = sk
    before = _build.launch_counts()["track_chunk"]
    for k in range(100, 107):
        sk, lfk, lik = tracking.track_chunk_packed(sk, raw[k:k + 1], tab,
                                                   FS, FCAID)
        sp, lfp, lip = tracking.track_chunk_plain(sp, raw[k:k + 1], tab,
                                                  FS, FCAID)
        assert torch.equal(lik, lip) and torch.equal(lfk, lfp), k
        for f in tracking.TrackState._fields:
            assert torch.equal(getattr(sk, f), getattr(sp, f)), (k, f)
    assert _build.launch_counts()["track_chunk"] == before + 7


def test_track_chunk_clocks_do_not_change_the_logs(capture, dev):
    """The measuring instantiation (clock64() sums) logs what the path's
    does, and fills every word of its buffer."""
    samples, hand, _ = capture
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    raw = torch.from_numpy(samples[:50 * S].view(np.int16)
                           .reshape(50, S, 2).copy()).to(dev)
    st0 = _seeded_state(hand, dev)
    clocks = torch.zeros((len(hand.prn_list), track.N_CLOCKS),
                         dtype=torch.int64, device=dev)
    _, lf, li = tracking.track_chunk_packed(st0, raw, tab, FS, FCAID)
    _, lfc, lic = tracking.track_chunk_packed(st0, raw, tab, FS, FCAID,
                                              clocks=clocks)
    assert torch.equal(lf, lfc) and torch.equal(li, lic)
    assert bool((clocks > 0).all())


@pytest.mark.parametrize("m,batch_k", [(2, 1), (4, 1), (10, 1), (1, 4)])
def test_window_kernel_clocks(capture, m, batch_k, dev):
    """The coherent/batched kernel's clock buffer: [C, 6] int64, every word
    non-negative, each part no larger than the whole loop, the loop's count
    positive; and the measuring instantiation logs what the path's does."""
    samples, hand, _ = capture
    n_upd = 40 if m < 8 else 20
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    raw = torch.from_numpy(samples[:n_upd * m * S].view(np.int16).reshape(
        n_upd, m * S, 2).copy()).to(dev)
    st0 = _seeded_state(hand, dev)
    loops = tracking.cadence_loops(m)
    clocks = torch.full((len(hand.prn_list), track.N_CLOCKS), -1,
                        dtype=torch.int64, device=dev)
    _, lf, li = tracking.track_chunk_packed(st0, raw, tab, FS, FCAID, loops,
                                            coh_ms=m, batch_k=batch_k)
    _, lfc, lic = tracking.track_chunk_packed(st0, raw, tab, FS, FCAID, loops,
                                              coh_ms=m, clocks=clocks,
                                              batch_k=batch_k)
    assert torch.equal(lf, lfc) and torch.equal(li, lic)
    clk = clocks.cpu().numpy()
    assert clk.shape == (len(hand.prn_list), 6)
    assert (clk >= 0).all() and (clk[:, 5] > 0).all()
    assert (clk[:, :5] <= clk[:, 5:6]).all()


@pytest.mark.parametrize("m,dtype", [(2, torch.int16), (4, torch.int16),
                                     (8, torch.int16), (10, torch.int16),
                                     (4, torch.float32), (10, torch.float32)])
def test_coherent_track_kernel_equals_plain(capture, m, dtype, dev):
    """Coherent windows of m code periods (m + 2 segments: 6m + 12 sums,
    one correlation pass a window; at m = 10 and f32 the ring holds the
    fewest passes): logs, signs, logged prompt segments and carry
    bit-equal to the plain tracker's, which sums in the window kernel's
    order."""
    samples, hand, _ = capture
    n_upd = 40 if m < 8 else 20
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    raw = torch.from_numpy(samples[:n_upd * m * S].view(np.int16).reshape(
        n_upd, m * S, 2).copy()).to(dev).to(dtype)
    st0 = _seeded_state(hand, dev)
    loops = tracking.cadence_loops(m)
    before = _build.launch_counts()
    sk, lfk, lik = tracking.track_chunk_packed(st0, raw, tab, FS, FCAID,
                                               loops, coh_ms=m)
    after = _build.launch_counts()
    assert after["track_chunk_coherent"] == before["track_chunk_coherent"] + 1
    assert after["track_chunk"] == before["track_chunk"]
    assert lfk.shape == (n_upd, len(tracking.log_f_rows(m)),
                         len(hand.prn_list))
    sp, lfp, lip = tracking.track_chunk_plain(st0, raw, tab, FS, FCAID,
                                              loops, coh_ms=m)
    assert torch.equal(lik, lip) and torch.equal(lfk, lfp)
    for k in tracking.TrackState._fields:
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k


@pytest.mark.parametrize("batch_k,skew,dtype", [
    (4, 0, torch.int16), (4, 2, torch.int16), (2, 0, torch.int16),
    (3, 0, torch.int16), (5, 0, torch.int16), (6, 2, torch.int16),
    (8, 0, torch.int16), (12, 0, torch.int16), (4, 0, torch.float32),
    (8, 0, torch.float32)])
def test_batched_track_kernel_equals_plain(capture, batch_k, skew, dtype,
                                           dev):
    """The batch_k schedule: windows correlated at the batch-start rates,
    1 ms updates, the frozen-rate carry. The kernel correlates
    track.window_pass(1, batch_k) windows a pass (4 at batch_k = 4, 8, 12;
    3 at 3, 6; 2 at 2; 1 at 5), so batch_k = 6, 8 and 12 span several
    passes a batch; skew = 2 is staged by the 4-byte copies."""
    samples, hand, _ = capture
    n = 240                               # a multiple of every batch_k here
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    flat = torch.from_numpy(samples[:(n + 1) * S].view(np.int16).copy()).to(dev)
    raw = flat[2 * skew:2 * skew + n * S * 2].view(n, S, 2)
    if dtype != torch.int16:
        raw = raw.to(dtype)
    st0 = _seeded_state(hand, dev)
    before = _build.launch_counts()["track_chunk_batched"]
    sk, lfk, lik = tracking.track_chunk_packed(st0, raw, tab, FS, FCAID,
                                               batch_k=batch_k)
    assert _build.launch_counts()["track_chunk_batched"] == before + 1
    sp, lfp, lip = tracking.track_chunk_batched_plain(st0, raw, tab, FS,
                                                      FCAID, batch_k=batch_k)
    assert torch.equal(lik, lip) and torch.equal(lfk, lfp)
    for k in tracking.TrackState._fields:
        assert torch.equal(getattr(sk, k), getattr(sp, k)), k


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("c", [1, 8, 12])
@pytest.mark.parametrize("s", [S, S + 1])
@pytest.mark.parametrize("n_win", [1, 2, 20, 40])
def test_open_loop_kernel_equals_plain(capture, n_win, s, c, dtype, dev):
    """K3's windows mode: W windows x C channels in one launch, bit-equal
    to the plain recurrence and polarity combine (its own sum order,
    track.WINDOWS_LANES), with the phases as four vectors and as the
    columns of one [C, 4] tensor (VectorReceiver.step's one copy)."""
    samples, hand, _ = capture
    prns = (list(hand.prn_list) + [1, 3, 4, 5])[:c]
    tab = torch.from_numpy(ca_table(prns).astype(np.float32)).to(dev)
    raw = torch.from_numpy(samples[:n_win * s].view(np.int16).reshape(
        n_win, s, 2).copy()).to(dev).to(dtype)
    ph = np.stack([np.asarray(x, np.float32) for x in
                   (hand.rc, np.asarray(hand.fc) - F_CA, hand.ri, hand.fi)],
                  axis=1)
    cols = torch.from_numpy(np.resize(ph, (c, 4)).copy()).to(dev)
    want = None
    for args in ([cols[:, i].contiguous() for i in range(4)],
                 [cols[:, i] for i in range(4)]):
        before = _build.launch_counts()["correlate_windows"]
        got = tracking.track_open_loop(*args, raw, tab, FS)
        assert _build.launch_counts()["correlate_windows"] == before + 1
        if want is None:
            want = tracking.track_open_loop_plain(*args, raw, tab, FS)
        for g, w in zip(got, (want[:, :, 0], want[:, :, 1], want[:, :, 2])):
            assert g.shape == (n_win, c, 2)
            assert torch.equal(g, w)


def test_scalar_receiver_coherent_on_card_equals_plain(capture, dev):
    samples, hand, _ = capture
    rx = tscalar.ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                                hand.prn_list, loops=tracking.cadence_loops(4),
                                device=dev)
    rx.state = st0 = _seeded_state(hand, dev)
    rx.track(400, chunk_ms=160, coh_ms=4)
    raw = torch.from_numpy(samples[:400 * S].view(np.int16)
                           .reshape(100, 4 * S, 2).copy()).to(dev)
    _, logf, logi = tracking.track_chunk_plain(st0, raw, rx.code_table, FS,
                                               FCAID, tracking.cadence_loops(4), 4)
    rows = {k: i for i, k in enumerate(tracking.log_f_rows(4))}
    for ci, prn in enumerate(hand.prn_list):
        ch = rx.channels[prn]
        np.testing.assert_array_equal(ch.col("cp"),
                                      logi[:, 0, ci].cpu().numpy())
        for k in ("iP", "qP", "rc", "fi"):
            np.testing.assert_array_equal(
                ch.col(k), logf[:, rows[k], ci].cpu().numpy(), err_msg=k)


def test_vector_receiver_on_card_matches_cpu(capture, dev):
    """Ten 20 ms epochs: one K3 windows-mode launch each; the fixes within
    0.01 m of the CPU receiver's (the card's and the CPU's cos/sin round
    differently)."""
    samples, hand, arr = capture
    runs = []
    for device in ("cpu", dev):
        rx = tvector.VectorReceiver(
            SampleFile(samples=samples.copy(), fs=FS), hand.prn_list,
            copy.deepcopy(arr), hand.x_ecef, hand.rx_time, cp=hand.cp,
            rc=hand.rc, fc=hand.fc, fi=hand.fi, ri=hand.ri, device=device)
        before = _build.launch_counts()["correlate_windows"]
        rx.run(10)
        launched = _build.launch_counts()["correlate_windows"] - before
        assert launched == (10 if rx.device.type == "cuda" else 0)
        runs.append(rx)
    for a, b in zip(*(r.fixes for r in runs)):
        assert np.linalg.norm(a.x_ecef[:3] - b.x_ecef[:3]) < 0.01


def test_deep_acquire_on_card_matches_cpu(capture, dev):
    samples, hand, _ = capture
    iq = (samples["i"][:250000] + 1j * samples["q"][:250000]).astype(
        np.complex64)
    cpu = tacq.acquire_deep(iq, hand.prn_list, FS, FCAID, device="cpu")
    card = tacq.acquire_deep(iq, hand.prn_list, FS, FCAID, device=dev)
    bin_hz = FS / (8 * (1 << (25000).bit_length()))
    for a, b in zip(cpu, card):
        assert (a.found, a.rc) == (b.found, b.rc)
        assert abs(a.fi - b.fi) <= bin_hz * 1.001


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


# -- K5: the windowed correlator ---------------------------------------------

K5_BLOCKS = 50
# channels 0-3 carry a nav-bit boundary at 0 (a degenerate tie: the flip and
# no-flip windows are sign-equal up to the arc), mid-period, an exact
# period multiple and S (none); the others keep the receiver's
K5_BOUNDARIES = (0, 13 * 2500 + 1250, 13 * 2500, 50000)


@pytest.fixture(scope="module")
def k5_inputs():
    """50 blocks of the 8-PRN scenario as int16 [N, S, 2] and the packed
    parameters the batched receiver prepares for them (numpy)."""
    s = 50000
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    iq = sim.generate(K5_BLOCKS * s)
    samples = np.empty(K5_BLOCKS * s, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    rx = tdpe.DPEReceiver(SampleFile(samples=samples, fs=FS),
                          copy.deepcopy(hand), grid=spread_grid(),
                          eph=copy.deepcopy(arr), device="cpu")
    preps = rx._prepare_batch(K5_BLOCKS)
    ipk = np.stack([p[1] for p in preps])
    ipk[:, 0, :len(K5_BOUNDARIES)] = K5_BOUNDARIES
    pk = dpe_real.pack_params(np.stack([p[0] for p in preps]), ipk, 0)
    kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
              n_periods=s // rx.period, code_win=rx.code_win,
              carr_win=rx.carr_win)
    return samples.view(np.int16).reshape(K5_BLOCKS, s, 2), pk, \
        rx._dev.chips.numpy(), kw


def _k5_args(k5_inputs, dev, dtype="int16", fs=FS):
    """args(lo, hi, channels) -> the correlator's arguments for blocks
    lo..hi-1, as batch_correlate passes them (views all). float32: the
    samples as float32 [N, S, 2] times 0.3 (the per-block step uploads a
    complex or arg_pi4 block as float32 pairs; the scale makes the sums
    inexact)."""
    raw_np, pk, chips_np, kw = k5_inputs
    raw = torch.from_numpy(raw_np).to(dev)
    if dtype == "float32":
        raw = raw.float() * 0.3
    fpk, ipk = dpe_real.unpack_params(dpe_real.to_device(pk, dev))
    chips = torch.from_numpy(chips_np).to(dev)
    time_idc = torch.from_numpy(
        (np.arange(raw.shape[1]) / fs).astype(np.float32)).to(dev)

    def args(lo, hi, cs=slice(None)):
        r, f, i = raw[lo:hi], fpk[lo:hi, :, cs], ipk[lo:hi, :, cs]
        return (r[..., 0], r[..., 1], chips[cs], f[:, 0], i[:, 0], f[:, 1],
                f[:, 2], time_idc, i[:, 1], i[:, 2])

    return args, kw


def _hold_k5_to_plain(got, want, keep):
    """Windows within 1e-5 of each channel's window maximum, flips and
    code-window argmaxes equal, over the channels `keep` selects."""
    for name in got._fields[:-1]:
        g, w = getattr(got, name)[:, keep], getattr(want, name)[:, keep]
        rel = ((g - w).abs() / w.abs().amax(-1, keepdim=True)).max().item()
        assert rel < 1e-5, (name, rel)
    assert torch.equal(got.flip_used[:, keep], want.flip_used[:, keep])
    if isinstance(got, correlate.RealBlockOutC):
        mags = [torch.hypot(o.code_re, o.code_im) for o in (got, want)]
    else:
        mags = [o.code_mag for o in (got, want)]
    assert torch.equal(mags[0].argmax(-1)[:, keep],
                       mags[1].argmax(-1)[:, keep])


def _hold_k5_across_splits(args, kw, n, complex_out, parts, channels):
    """The n blocks correlated whole, as each of `parts` grid ranks would
    share them, and over the channel slice `channels`: equal to the bit."""
    whole = correlate.windowed_correlate(*args(0, n), **kw,
                                         complex_out=complex_out)
    for k in parts:
        shares = [correlate.windowed_correlate(*args(lo, hi), **kw,
                                               complex_out=complex_out)
                  for lo, hi in score.even_rows(n, k)]
        for name, f in zip(whole._fields, zip(*shares)):
            assert torch.equal(torch.cat(f), getattr(whole, name)), (k, name)
    sub = correlate.windowed_correlate(*args(0, n, channels), **kw,
                                       complex_out=complex_out)
    for name in whole._fields:
        assert torch.equal(getattr(sub, name),
                           getattr(whole, name)[:, channels]), name


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("complex_out", [False, True])
@pytest.mark.parametrize("n", [K5_BLOCKS, 8, 1])
def test_windowed_correlate_kernel_matches_plain(k5_inputs, n, complex_out,
                                                 dtype, dev):
    """K5 against windowed_correlate_plain on the same card tensors at the
    main path's shapes (N = 50, the integrated fix's 8, the per-block
    step's 1), from int16 pairs and from float32 samples (the kernel's
    other instance, whose block mean is a float sum): windows within 1e-5
    of each channel's window maximum, flips and code-window argmaxes equal,
    but on the degenerate idx_next = 0 channel."""
    args, kw = _k5_args(k5_inputs, dev, dtype)
    before = _build.launch_counts()["windowed_correlate"]
    got = correlate.windowed_correlate(*args(0, n), **kw,
                                       complex_out=complex_out)
    assert _build.launch_counts()["windowed_correlate"] == before + 1
    want = correlate.windowed_correlate_plain(*args(0, n), **kw,
                                              complex_out=complex_out)
    _hold_k5_to_plain(got, want, slice(1, None))
    assert bool(got.flip_used[:, 3].eq(False).all())        # idx_next = S


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("complex_out", [False, True])
def test_windowed_correlate_kernel_is_batch_invariant(k5_inputs, complex_out,
                                                      dtype, dev):
    """A block's K5 windows and flip are the same bits whether it is
    correlated in the whole 50, in a grid rank's share (25 + 25,
    17 + 17 + 16, 13 + 13 + 12 + 12), alone, or over 4 of the 8
    channels; from int16 pairs and from float32 samples."""
    args, kw = _k5_args(k5_inputs, dev, dtype)
    _hold_k5_across_splits(args, kw, K5_BLOCKS, complex_out,
                           (2, 3, 4, K5_BLOCKS), slice(2, 6))


def _k5_at_period(period, n, c, seed=17, code_win=12, carr_win=36):
    """Seeded inputs of n blocks of 20 periods at a front end of period
    kHz: each channel's chips at its code phase on its carrier, under
    noise, as int16 pairs, with the parameters packed as pack_params packs
    them (nav-bit boundaries at random samples past the first eighth of
    the block: one near its start is a near tie of the flip decision)."""
    rng = np.random.default_rng(seed)
    fs, p = period * 1e3, 20
    s = p * period
    carr_fftpts = 8 * (1 << s.bit_length())
    chips = rng.choice([-1.0, 1.0], (c, 1023)).astype(np.float32)
    rc = rng.uniform(0.0, 1023.0, (n, c))
    fi = rng.uniform(-3000.0, 3000.0, (n, c))
    ri = rng.uniform(0.0, 1.0, (n, c))
    t = np.arange(s) / fs
    tau = np.arange(s) % period
    iq = rng.normal(0.0, 20.0, (n, s)) + 1j * rng.normal(0.0, 20.0, (n, s))
    for k in range(n):
        for ch in range(c):
            code = chips[ch, np.floor(tau * 1023.0 / period
                                      + rc[k, ch]).astype(int) % 1023]
            iq[k] += 6.0 * code * np.exp(2j * np.pi * (fi[k, ch] * t
                                                       + ri[k, ch]))
    raw = np.stack([iq.real, iq.imag], axis=-1).round().astype(np.int16)
    fpk = np.zeros((n, dpe_real.FPK_ROWS, c))
    fpk[:, 0], fpk[:, 1], fpk[:, 2] = rc, fi, ri
    ipk = np.stack([rng.integers(s // 8, s + 1, (n, c)),
                    s // 2 - code_win // 2 + rng.integers(-4, 5, (n, c)),
                    carr_fftpts // 2 - carr_win // 2
                    + rng.integers(-12, 13, (n, c))], axis=1)
    kw = dict(carr_fftpts=carr_fftpts, period=period, n_periods=p,
              code_win=code_win, carr_win=carr_win)
    return raw, dpe_real.pack_params(fpk, ipk, 0), chips, kw


@pytest.mark.parametrize("complex_out", [False, True])
@pytest.mark.parametrize("period", [1023, 16368])
def test_windowed_correlate_kernel_takes_odd_and_long_periods(
        period, complex_out, dev):
    """K5 at an odd period (a 1.023 MHz front end: unequal rank tau
    ranges, and the block's integer mean sum stays aligned) and a long one
    (16.368 MHz: a rank's DFT rows take two chunks of twiddles) against its
    plain version, and across block splits and a channel subset, bit for
    bit."""
    inputs = _k5_at_period(period, 4, 4)
    for dtype in ("int16", "float32"):
        args, kw = _k5_args(inputs, dev, dtype, fs=period * 1e3)
        got = correlate.windowed_correlate(*args(0, 4), **kw,
                                           complex_out=complex_out)
        want = correlate.windowed_correlate_plain(*args(0, 4), **kw,
                                                  complex_out=complex_out)
        _hold_k5_to_plain(got, want, slice(None))
        _hold_k5_across_splits(args, kw, 4, complex_out, (2, 4),
                               slice(1, 3))


@pytest.mark.parametrize("code_win,carr_win", [(16, 48), (8, 24), (3, 1)])
def test_windowed_correlate_kernel_takes_other_windows(code_win, carr_win,
                                                       dev):
    """K5 at other window widths than the main path's 12 / 36: the
    defaults 16 / 48 (two carrier passes, 36 bins and 12), the dense
    grid's 8 / 24 (one pass of 24) and 3 / 1 (fewer code windows and bins
    than a cluster has thread blocks), against its plain version and
    across block splits and a channel subset, bit for bit."""
    inputs = _k5_at_period(2500, 4, 4, code_win=code_win, carr_win=carr_win)
    for dtype, complex_out in ((d, x) for d in ("int16", "float32")
                               for x in (False, True)):
        args, kw = _k5_args(inputs, dev, dtype, fs=2500 * 1e3)
        got = correlate.windowed_correlate(*args(0, 4), **kw,
                                           complex_out=complex_out)
        want = correlate.windowed_correlate_plain(*args(0, 4), **kw,
                                                  complex_out=complex_out)
        _hold_k5_to_plain(got, want, slice(None))
        _hold_k5_across_splits(args, kw, 4, complex_out, (2, 4),
                               slice(1, 3))


@pytest.mark.parametrize("complex_out", [False, True])
def test_windowed_correlate_kernel_one_block_equals_its_row(
        k5_inputs, complex_out, dev):
    """A block correlated alone (N = 1, the per-block step's launch)
    equals its row of the N = 50 launch to the bit, from int16 pairs and
    from float32 samples: the first, a middle and the last block."""
    for dtype in ("int16", "float32"):
        args, kw = _k5_args(k5_inputs, dev, dtype)
        whole = correlate.windowed_correlate(*args(0, K5_BLOCKS), **kw,
                                             complex_out=complex_out)
        for b in (0, 17, K5_BLOCKS - 1):
            one = correlate.windowed_correlate(*args(b, b + 1), **kw,
                                               complex_out=complex_out)
            for name in whole._fields:
                assert torch.equal(getattr(one, name),
                                   getattr(whole, name)[b:b + 1]), \
                    (dtype, b, name)


def test_windowed_correlate_kernel_takes_a_25000_sample_period(dev):
    """K5 at a 25 MHz front end (25 000 samples a period, 20 a block: the
    replica and the rank's twiddle rows fit one thread block's shared
    memory) against its plain version, and across a block split and a
    channel subset, bit for bit."""
    inputs = _k5_at_period(25000, 2, 3)
    args, kw = _k5_args(inputs, dev, "int16", fs=25000 * 1e3)
    for complex_out in (False, True):
        got = correlate.windowed_correlate(*args(0, 2), **kw,
                                           complex_out=complex_out)
        want = correlate.windowed_correlate_plain(*args(0, 2), **kw,
                                                  complex_out=complex_out)
        _hold_k5_to_plain(got, want, slice(None))
        _hold_k5_across_splits(args, kw, 2, complex_out, (2,), slice(1, 3))


def test_windowed_correlate_kernel_refuses_a_period_beyond_its_memory(dev):
    """The first period the kernel does not take (its thread block would
    need more shared memory than the card gives one; found by bisection
    on the kernel's own count, above the 25 000 it takes) raises before
    any launch, at 20 periods a block."""
    lib = correlate._lib()
    limit, p, c = lib.windowed_shared_limit(), 20, 1
    lo, hi = 2500, 1 << 20                # taken, refused

    def need(period):
        return lib.windowed_shared_bytes(period)

    assert need(lo) <= limit < need(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if need(mid) <= limit else (lo, mid)
    assert hi > 25000
    period, s = hi, p * hi
    raw = torch.zeros((1, s, 2), dtype=torch.int16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    par = torch.zeros((1, c), **f32)
    before = _build.launch_counts()["windowed_correlate"]
    with pytest.raises(ValueError, match="shared memory"):
        correlate.windowed_correlate(
            raw[..., 0], raw[..., 1], torch.ones((c, 1023), **f32), par,
            par + s, par, par, torch.zeros(s, **f32), par + s // 2, par,
            carr_fftpts=8 * (1 << s.bit_length()), period=period,
            n_periods=p, code_win=12, carr_win=36)
    assert _build.launch_counts()["windowed_correlate"] == before


def _sinc_inputs(rng, manifold, n, width, off3, off1, dev):
    win = np.abs(rng.standard_normal((n, 8, width))).astype(np.float32) + 0.1
    win[:, :, width // 2 - 1:width // 2 + 2] += [4.0, 10.0, 4.0]
    los = rng.standard_normal((n, 8, 3))
    los /= np.linalg.norm(los, axis=2, keepdims=True)
    cen = width / 2.0 + rng.standard_normal((n, 8)) * 0.4
    if manifold == "pos":
        coefs, r0 = np.full((n, 8), FS / 2.99792458e8), np.full((n, 8), 2.2e7)
    else:
        coefs, r0 = np.full((n, 8), -1.1), None
    return [None if a is None else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        for a in (win, los, cen, coefs, r0, off3, off1)]


@pytest.mark.parametrize("manifold,width,spacing", [("pos", 12, 0.25),
                                                     ("vel", 36, 0.02)])
def test_sinc_kernel_holds_to_torch_sinc(manifold, width, spacing, dev):
    """K1's one-sine sinc form against torch.sinc at the survey's zoom
    shape (33^4 points, 25 epochs, block-summed): best within rtol 1e-5,
    argmax equal or a tie within 1e-6; and on a grid where every index is
    an integer (integer centres, zero coefficients), per block and summed,
    within rtol 1e-5."""
    rng = np.random.default_rng(11)
    ax = np.arange(33) - 16.0
    args = _sinc_inputs(rng, manifold, 25, width, *_mesh4(ax * spacing,
                                                          ax * spacing), dev)
    kw = dict(interp="sinc", block_sum=True)
    got = score.score_argmax(*args, **kw)
    want = score.score_argmax_plain(*args, **kw)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    if int(got[1]) != int(want[1]):
        idx = [int(got[1]), int(want[1])]
        at = score.score_points(*args[:5], args[5][idx], args[6][idx],
                                "sinc", 1).sum(dim=0)
        assert abs(float(at[0] - at[1])) <= 1e-6 * abs(float(at[1])), at
    args[2] = torch.round(args[2])
    args[3] = torch.zeros_like(args[3])
    torch.testing.assert_close(score.score_argmax(*args, **kw)[0],
                               score.score_argmax_plain(*args, **kw)[0],
                               rtol=1e-5, atol=0.0)
    one = [None if a is None else a[:1] for a in args[:5]] + args[5:]
    torch.testing.assert_close(
        score.score_surface(*one, interp="sinc"),
        score.score_surface_plain(*one, interp="sinc"), rtol=1e-5, atol=0.0)
