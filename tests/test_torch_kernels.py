"""The cold-start slice's CUDA kernels against their plain PyTorch versions
on the card: K3 (correlate_window, and its windows mode), K4 (track_chunk:
1 ms, coherent windows of m code periods, the batch_k schedule), K2
(score_surface), and the receivers that run them. Marked `cuda`; they skip
without a card.

The kernels do the plain versions' f32 operations in the same order (sums
included: the plain sums follow the kernel's threads per channel,
ops/track.KERNEL_THREADS, and WINDOW_LANES for the coherent/batched kernel;
-fmad=false), so every comparison is equality, bit for bit. This file
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
from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid, uniform_grid
from navlab_dpe_sdr_tpu_torch.models import dpe as tdpe
from navlab_dpe_sdr_tpu_torch.models import scalar as tscalar
from navlab_dpe_sdr_tpu_torch.models import vector as tvector
from navlab_dpe_sdr_tpu_torch.ops import acquisition as tacq
from navlab_dpe_sdr_tpu_torch.ops import _build, score, track, tracking

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
    fewest passes): logs, signs and carry bit-equal to the plain
    tracker's, which sums in the window kernel's order."""
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
    assert lfk.shape == (n_upd, 15 + m, len(hand.prn_list))
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
def test_open_loop_kernel_equals_plain(capture, dtype, dev):
    """K3's windows mode: 20 windows x 8 channels in one launch, bit-equal
    to the plain recurrence and polarity combine."""
    samples, hand, _ = capture
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)).to(dev)
    raw = torch.from_numpy(samples[:20 * S].view(np.int16).reshape(
        20, S, 2).copy()).to(dev).to(dtype)
    args = [torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in
            (hand.rc, np.asarray(hand.fc) - F_CA, hand.ri, hand.fi)]
    before = _build.launch_counts()["correlate_windows"]
    got = tracking.track_open_loop(*args, raw, tab, FS)
    assert _build.launch_counts()["correlate_windows"] == before + 1
    want = tracking.track_open_loop_plain(*args, raw, tab, FS)
    for g, w in zip(got, (want[:, :, 0], want[:, :, 1], want[:, :, 2])):
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
