"""The port's weak-signal path on the CPU: the deep search's fine
frequency at 27 dB-Hz, the LNAV decode from soft prompt values where the
signs are too noisy to frame, and the spans of the path: the deep search
(`scalar.acquire.deep` holding `.coarse` then `.fine`), the coherent
tracker's chunks at coh_ms = 8, and integrated DPE (`dpe.integrate` a fix,
holding `.prepare`, `.dispatch`, `.wait` and `.update` in turn).

Each path runs once untraced and once under `tracing.recording()` on a
0.6 s capture of the scenario and a 5^4 grid on the CPU: the untraced run
leaves the recorder empty, the recorded one nests each span in its parent,
and both give the same bits.
"""

import contextlib
import copy
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from navlab_dpe_sdr_tpu_torch import tracing
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
from navlab_dpe_sdr_tpu_torch.libgnss import dataparser, lnav
from navlab_dpe_sdr_tpu_torch.models import navbits
from navlab_dpe_sdr_tpu_torch.models.grid import uniform_grid
from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
from navlab_dpe_sdr_tpu_torch.constants import F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu_torch.ops import acquisition, tracking

torch.set_num_threads(2)

FS = 2.5e6
SECONDS = 0.6
DEEP_MS, N_COH_MS = 100, 10
COH_MS, TRACK_MS, CHUNK_MS = 8, 160, 80          # two chunks of 10 updates
FIXES, BLOCKS_PER_FIX = 2, 4


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def capture():
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=40.0)
    n = int(SECONDS * FS)
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    return samples, hand, arr


def _weak_start(capture):
    samples, hand, _ = capture
    rx = ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                        hand.prn_list, loops=tracking.cadence_loops(COH_MS),
                        device="cpu")
    res = rx.acquire(deep_ms=DEEP_MS, n_coh_ms=N_COH_MS, verbose=False)
    rx.track(TRACK_MS, chunk_ms=CHUNK_MS, coh_ms=COH_MS)
    return ([(r.rc, r.fi, r.ri, r.cppm, r.found) for r in res],
            {p: rx.channels[p].col("fi") for p in rx.prn_list},
            {p: rx.channels[p].cp_sign for p in rx.prn_list})


def _integrated(capture):
    samples, hand, arr = capture
    rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=FS),
                     copy.deepcopy(hand),
                     grid=uniform_grid(n=5, pos_spacing=15.0,
                                       vel_spacing=1.0),
                     eph=copy.deepcopy(arr),
                     config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                     device="cpu")
    fixes = rx.run_integrated(FIXES, BLOCKS_PER_FIX)
    return (np.array([f.x_ecef for f in fixes]),
            np.array([(f.pos_score, f.vel_score) for f in fixes]),
            np.array(rx.flip_log))


@pytest.fixture(scope="module")
def runs(capture):
    """{path: ((untraced result, records), (recorded result, records))}."""
    out = {}
    for path, run in (("weak_start", _weak_start),
                      ("integrated", _integrated)):
        got = []
        for record in (False, True):
            tracing.clear()
            with tracing.recording() if record else contextlib.nullcontext():
                res = run(capture)
            got.append((res, tracing.spans()))
        out[path] = got
    tracing.clear()
    return out


def _named(recs, name):
    return [s for s in recs if s.name == name]


def _inside(inner, outer):
    return outer.t0 <= inner.t0 <= inner.t1 <= outer.t1


def _in_order(*spans):
    return all(a.t0 <= a.t1 <= b.t0 <= b.t1 for a, b in zip(spans, spans[1:]))


def test_untraced_weak_paths_leave_the_recorder_empty(runs):
    assert runs["weak_start"][0][1] == [] and runs["integrated"][0][1] == []


def test_deep_search_records_coarse_then_fine_inside_it(runs):
    recs = runs["weak_start"][1][1]
    chunks = TRACK_MS // CHUNK_MS
    assert Counter(s.name for s in recs) == {
        "scalar.acquire.deep": 1, "scalar.acquire.deep.coarse": 1,
        "scalar.acquire.deep.fine": 1, "scalar.track.stage": chunks,
        "scalar.track.fetch": chunks, "scalar.track.unpack": chunks}
    (deep,), (coarse,), (fine,) = (_named(recs, n) for n in (
        "scalar.acquire.deep", "scalar.acquire.deep.coarse",
        "scalar.acquire.deep.fine"))
    assert _inside(coarse, deep) and _inside(fine, deep)
    assert _in_order(coarse, fine)
    # the coherent chunks follow the search, each staged, fetched, unpacked
    stages, fetches, unpacks = (_named(recs, n) for n in (
        "scalar.track.stage", "scalar.track.fetch", "scalar.track.unpack"))
    assert _in_order(deep, stages[0])
    for k in range(chunks):
        assert _in_order(stages[k], fetches[k], unpacks[k])


def test_integrated_fix_records_its_four_stages_inside_it(runs):
    recs = runs["integrated"][1][1]
    stages = ("prepare", "dispatch", "wait", "update")
    assert Counter(s.name for s in recs) == {
        "dpe.build.windows": 1, "dpe.build.upload": 1,
        "dpe.integrate": FIXES,
        **{f"dpe.integrate.{k}": FIXES for k in stages}}
    fixes = _named(recs, "dpe.integrate")
    assert _in_order(*fixes)
    for k, fix in enumerate(fixes):
        parts = [_named(recs, f"dpe.integrate.{n}")[k] for n in stages]
        assert all(_inside(p, fix) for p in parts)
        assert _in_order(*parts)


@pytest.mark.parametrize("path", ["weak_start", "integrated"])
def test_recording_changes_no_weak_result(runs, path):
    (quiet, _), (loud, _) = runs[path]
    if path == "weak_start":
        assert quiet[0] == loud[0]
        for a, b in zip(quiet[1:], loud[1:]):
            for p in a:
                np.testing.assert_array_equal(a[p], b[p])
    else:
        for a, b in zip(quiet, loud):
            np.testing.assert_array_equal(a, b)
        assert len(quiet[0]) == FIXES


def test_deep_search_fine_doppler_holds_at_27_dbhz():
    """400 ms of the 8-PRN scenario at 27 dB-Hz searched with 10 ms folds:
    every PRN found, its code phase within a chip (the early-minus-late
    discriminator's reach; the search's grid is 0.41 chip a sample) and its
    Doppler within a quarter cycle of an 8 ms update (31.25 Hz) of the
    truth. The fine
    search over the first segment's spectrum alone, across the whole
    +/-6 kHz band, peaks on noise for most channels at this level."""
    sim, hand, _ = make_scenario(nav_data=True, cn0_dbhz=27.0)
    iq = sim.generate(int(0.4 * FS)).astype(np.complex64)
    res = acquisition.acquire_deep(iq, hand.prn_list, FS, F_CA / F_L1,
                                   n_coh_ms=10, device="cpu")
    code = np.abs(np.mod(np.array([r.rc for r in res]) - hand.rc
                         + L_CA / 2, L_CA) - L_CA / 2)
    dopp = np.abs(np.array([r.fi for r in res]) - hand.fi)
    assert all(r.found for r in res)
    assert code.max() < 1.0 and dopp.max() < 31.25, (code, dopp)



def _soft_stream(seed, offset=807):
    """A channel's soft prompt values at 27 dB-Hz: 15 subframes of the
    scenario's second ephemeris, each bit over 20 code periods of unit
    amplitude on a carrier whose phase turns 0.2 rad a bit (a Doppler 1.6
    Hz off), plus complex Gaussian noise of unit in-phase variance a
    period (2 C/N0 T = 1 at 27 dB-Hz), from period `offset` on."""
    _, _, arr = make_scenario(nav_data=True)
    eph = arr.ephs[1]
    bits = 1 - 2 * lnav.encode_stream(eph, 413994.0, 15)
    clean = np.kron(bits, np.ones(20))[offset:]
    rng = np.random.default_rng(seed)
    turn = np.exp(1j * (0.7 + 0.01 * np.arange(len(clean))))
    noise = rng.standard_normal(clean.shape) + 1j * rng.standard_normal(
        clean.shape)
    return eph, clean * turn + noise


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_soft_bits_decode_where_signs_cannot(seed):
    """At 27 dB-Hz about one period sign in five is wrong: the sign framer
    finds no preamble, while the soft path decodes every word with parity
    and the broadcast ephemeris."""
    eph, soft = _soft_stream(seed)
    signs = np.sign(soft.real)
    assert navbits.sign_disagreement(signs) > navbits.HARD_ERRORS
    with pytest.raises(ValueError, match="preamble"):
        dataparser.parse_ephemerides(signs, cp_offset=0.0, prn=eph.prn)
    got, parity = dataparser.parse_ephemerides(
        navbits.clean_signs(soft), cp_offset=0.0, prn=eph.prn)
    ref, _ = dataparser.parse_ephemerides(
        np.kron(1 - 2 * lnav.encode_stream(eph, 413994.0, 15),
                np.ones(20))[807:], cp_offset=0.0, prn=eph.prn)
    assert parity == navbits.WORDS and got.complete
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert abs(got.sqrt_A - eph.sqrt_A) < 1e-5


def test_soft_bits_repair_one_error_a_word():
    """A wrong bit in each of the 50 words, none in a preamble (noise-free
    otherwise): every word is repaired to pass parity, and the decode
    equals the clean stream's."""
    eph, _ = _soft_stream(0)
    clean = np.kron(1 - 2 * lnav.encode_stream(eph, 413994.0, 15),
                    np.ones(20))[807:]
    ref, _ = dataparser.parse_ephemerides(clean, cp_offset=0.0, prn=eph.prn)
    locs, _ = dataparser.find_subframe_starts(clean)
    bad = clean.copy()
    for w in range(navbits.WORDS):
        b = locs[0] + 20 * (30 * w + 8 + (7 * w) % 22)
        bad[b:b + 20] = -bad[b:b + 20]
    _, parity = dataparser.parse_ephemerides(bad, cp_offset=0.0, prn=eph.prn)
    assert parity < navbits.WORDS
    got, parity = dataparser.parse_ephemerides(
        navbits.clean_signs(bad), cp_offset=0.0, prn=eph.prn)
    assert parity == navbits.WORDS
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_soft_bits_skip_a_garbled_first_subframe():
    """A channel's first seconds, while its loops pull in, may decide
    wrong bits: with three words of the first framed subframe garbled
    beyond one-bit repair, the soft decode frames the next 5 subframes,
    every word passing parity, and decodes what the clean stream gives
    from its second subframe on."""
    eph, soft = _soft_stream(7)
    full = np.kron(1 - 2 * lnav.encode_stream(eph, 413994.0, 15),
                   np.ones(20))[807:]
    locs, _ = dataparser.find_subframe_starts(full)
    bad = soft.copy()
    for w in (2, 5, 8):
        b = locs[0] + 20 * (30 * w + 4)
        bad[b:b + 60] = -bad[b:b + 60] * 50.0      # three bits flipped
    got, parity = dataparser.parse_ephemerides(
        navbits.clean_signs(bad), cp_offset=0.0, prn=eph.prn)
    later = full.copy()
    later[:locs[1] - 40] = 0.0
    ref, _ = dataparser.parse_ephemerides(later, cp_offset=0.0, prn=eph.prn)
    assert parity == navbits.WORDS and got.complete
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_prompt_segments_carry_the_logged_signs(capture):
    """The prompt segment sums K4 logs for each coherent window
    (tracking.log_f_rows), added into their code periods, have the signs
    the tracker logged for every completed period (8 ms updates on the
    0.6 s capture at 40 dB-Hz, where no sum lies near zero); a 1 ms
    cadence logs none, and the soft decode says so."""
    samples, hand, _ = capture
    rx = ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                        hand.prn_list, loops=tracking.cadence_loops(COH_MS),
                        device="cpu")
    rx.acquire(deep_ms=DEEP_MS, n_coh_ms=N_COH_MS, verbose=False)
    rx.track(TRACK_MS, chunk_ms=CHUNK_MS, coh_ms=COH_MS)
    for p in hand.prn_list:
        ch = rx.channels[p]
        segs = ch.col("pseg")
        assert segs.shape == (rx.mcount, COH_MS + 2)
        at = ch.col("cp").astype(np.int64)[:, None] + np.arange(COH_MS + 2)
        soft = np.zeros(int(at.max()) + 1)
        np.add.at(soft, at, -segs.real)
        signs = ch.cp_sign
        np.testing.assert_array_equal(np.sign(soft[:len(signs)]), signs)
    rx1 = ScalarReceiver(SampleFile(samples=samples.copy(), fs=FS),
                         hand.prn_list, device="cpu")
    rx1.acquire(deep_ms=DEEP_MS, n_coh_ms=N_COH_MS, verbose=False)
    rx1.track(20, chunk_ms=20)
    assert not rx1.channels[hand.prn_list[0]].col("pseg").size
    with pytest.raises(ValueError, match="prompt segments"):
        rx1._soft_signs(hand.prn_list[0])


RAMP_FDOT, RAMP_FI0 = 250.0, 120.0      # tests/test_torch_dynamics.py's ramp
SWING_RATE, SWING_S = 28.0, 16.0        # ~5.4 m/s^2 (test_dynamics.py's)


def _dynamic_log(seed, profile, m=8, seconds=36.0, offset=807, rc0=300.0):
    """A channel's coherent log (m ms windows) at 27 dB-Hz under receiver
    dynamics: "ramp", the Doppler ramp scenario (FI0 + 250 Hz/s t), or
    "swing", a user accelerating and braking at ~5.4 m/s^2, FI0 + A
    sin(2 pi t / 16 s) with A 2 pi / 16 s = 28 Hz/s (no quadratic in time
    follows it for long). The tracker's Dopplers are the truth plus its
    noise as the card logs it at 27 dB-Hz (2.6 Hz rms, correlated over
    ~0.2 s: white and AR(0.93) parts of 1.8 Hz each), its carrier phase
    ri their integral (so it wanders off the truth by cycles), and the
    prompt segments carry the scenario's second ephemeris's bits (unit
    amplitude a period, noise of unit in-phase variance a period) in the
    tracker's frame. Returns (ephemeris, soft_periods' arguments, clean
    signs, true Doppler at each window)."""
    _, _, arr = make_scenario(nav_data=True)
    eph = arr.ephs[1]
    bits = 1 - 2 * lnav.encode_stream(eph, 413994.0, 15)
    d = np.kron(bits, np.ones(20))[offset:]
    rng = np.random.default_rng(seed)
    T = m * 1e-3
    u = int(seconds / T)
    if profile == "ramp":
        def f_true(t):
            return RAMP_FI0 + RAMP_FDOT * t

        def phi_true(t):
            return RAMP_FI0 * t + 0.5 * RAMP_FDOT * t * t
    else:
        amp = SWING_RATE * SWING_S / (2 * np.pi)

        def f_true(t):
            return RAMP_FI0 + amp * np.sin(2 * np.pi * t / SWING_S)

        def phi_true(t):
            return RAMP_FI0 * t + amp * SWING_S / (2 * np.pi) * (
                1 - np.cos(2 * np.pi * t / SWING_S))

    t_win = np.arange(u) * T
    ar, z = np.zeros(u), rng.standard_normal(u)
    for k in range(1, u):
        ar[k] = 0.93 * ar[k - 1] + np.sqrt(1 - 0.93 ** 2) * z[k]
    fi = f_true(t_win) + 1.8 * (rng.standard_normal(u) + ar)
    ri = np.mod(np.concatenate([[0.3], 0.3 + np.cumsum(fi[:-1] * T)]), 1.0)
    rc = np.full(u, rc0)
    fc = np.full(u, F_CA)
    cp = np.arange(u) * m
    tau = navbits.segment_middles(rc, fc, m)
    share = np.diff(np.concatenate(
        [np.zeros((u, 1)), np.clip((np.arange(1, m + 2) * L_CA - rc0)
                                   / F_CA, 0, T)[None].repeat(u, 0),
         np.full((u, 1), T)], axis=1), axis=1) / 1e-3    # periods a segment
    at = cp[:, None] + np.arange(m + 2)
    t_mid = t_win[:, None] + tau
    nco = ri[:, None] + fi[:, None] * tau
    noise = (rng.standard_normal(share.shape)
             + 1j * rng.standard_normal(share.shape)) * np.sqrt(share)
    segs = -(share * d[np.minimum(at, len(d) - 1)]
             * np.exp(2j * np.pi * (phi_true(t_mid) - nco)) + noise)
    n = int(cp[-1]) + 1
    return (eph, (segs, cp, t_win, rc, fc, ri, fi, m, n), d[:n],
            f_true(t_win))


@pytest.mark.parametrize("profile,seed", [("ramp", 4), ("swing", 5),
                                          ("swing", 6)])
def test_soft_bits_follow_receiver_dynamics(profile, seed):
    """The Doppler ramp scenario (250 Hz/s, tests/test_torch_dynamics.py)
    and a user swinging at ~5.4 m/s^2 every 16 s, tracked in 8 ms windows
    with the card's Doppler noise: the smooth carrier follows the Doppler
    locally, within 3 Hz of the truth away from the ends (the noise
    smoothed over 6 s to ~0.6 Hz rms, the swing's curvature), where one
    quadratic over the whole log misses the swing by 40 Hz and more; the
    period signs are too noisy for the sign framer, and the soft bits
    decode every word with parity to the broadcast ephemeris."""
    eph, args, clean, truth = _dynamic_log(seed, profile)
    segs, cp, t_win, rc, fc, ri, fi, m, n = args
    f_s = navbits.smooth_doppler(fi, m * 1e-3)
    mid = slice(len(fi) // 10, -len(fi) // 10)
    assert np.abs(f_s - truth)[mid].max() < 3.0
    if profile == "swing":
        quad = np.polyval(np.polyfit(t_win, fi, 2), t_win)
        assert np.abs(quad - truth).max() > 40.0
    soft = navbits.soft_periods(*args)
    signs = np.sign(soft.real)
    assert navbits.sign_disagreement(signs) > navbits.HARD_ERRORS
    got, parity = dataparser.parse_ephemerides(
        navbits.clean_signs(soft), cp_offset=0.0, prn=eph.prn)
    ref, _ = dataparser.parse_ephemerides(clean, cp_offset=0.0, prn=eph.prn)
    assert parity == navbits.WORDS and got.complete
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


# -- the receiver's decode: the gate and the batched soft pass -------------

def test_gate_is_exact_for_the_framer():
    """MIN_FRAME_PERIODS is the shortest stream `_frames` can frame: a
    noise-free stream whose first subframe starts at period 40 (bit edge 0,
    two bits before it) decodes at 30 040 periods and raises the framer's
    own error at 30 039."""
    assert navbits.MIN_FRAME_PERIODS == 30_040
    _, _, arr = make_scenario(nav_data=True)
    eph = arr.ephs[1]
    full = np.kron(1 - 2 * lnav.encode_stream(eph, 413994.0, 15),
                   np.ones(20))
    locs, _ = dataparser.find_subframe_starts(full)
    start = int(locs[1]) - 40
    stream = full[start:start + navbits.MIN_FRAME_PERIODS]
    got, parity = dataparser.parse_ephemerides(
        navbits.clean_signs(stream.astype(np.complex128)), cp_offset=0.0,
        prn=eph.prn)
    assert parity == navbits.WORDS and got.complete
    with pytest.raises(ValueError, match=navbits.NO_FRAME):
        navbits.clean_signs(stream[:-1].astype(np.complex128))


def _soft_channels():
    """Three channels' coherent logs from `_dynamic_log` (the ramp and two
    swings), their streams 35 993, 35 986 and 35 380 periods long: (their
    ephemeris, `soft_periods`' arguments each)."""
    out = []
    for (profile, seed), cut in zip((("ramp", 4), ("swing", 5),
                                     ("swing", 6)), (0, 7, 613)):
        eph, args, _, _ = _dynamic_log(seed, profile)
        out.append(args[:-1] + (args[-1] - cut,))
    return eph, out


def test_soft_pass_equals_the_plain_path_channel_by_channel():
    """`navbits.soft_bits` over three channels of unequal streams at once
    (on the CPU: the pass in torch float64, `_loop` for the kernel) gives
    each channel the bit edge and decisions of its own `bit_edge` and
    `coherent_bits` of `soft_periods`, and its framed signs decode to
    what `clean_signs` decodes, every word passing parity."""
    eph, chans = _soft_channels()
    got = navbits.soft_bits(chans, "cpu")
    for args, (o, bits) in zip(chans, got):
        soft = navbits.soft_periods(*args)
        edge = navbits.bit_edge(soft)
        nb = (len(soft) - edge) // navbits.PERIODS_A_BIT
        plain = navbits.coherent_bits(soft[edge:edge + 20 * nb].reshape(
            nb, 20).sum(axis=1))
        assert o == edge
        np.testing.assert_array_equal(bits, plain)
        mine, parity = dataparser.parse_ephemerides(
            navbits.framed_signs(bits, o, args[-1]), cp_offset=0.0,
            prn=eph.prn)
        ref, _ = dataparser.parse_ephemerides(
            navbits.clean_signs(soft), cp_offset=0.0, prn=eph.prn)
        assert parity == navbits.WORDS and mine.complete
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_soft_pass_smooths_as_the_plain_filter():
    """The pass's smooth carrier (the Savitzky-Golay filter as fixed
    weights) is `smooth_doppler`'s within 1e-9 Hz, down to logs shorter
    than its window."""
    _, chans = _soft_channels()
    fi = np.stack([a[6] for a in chans])
    for u in (len(fi[0]), 500, 2):
        want = np.stack([navbits.smooth_doppler(f[:u], 8e-3) for f in fi])
        got = navbits._smooth(torch.from_numpy(fi[:, :u].copy()), 8e-3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_soft_pass_refuses_a_stream_too_short_to_frame():
    _, chans = _soft_channels()
    short = chans[0][:-1] + (navbits.MIN_FRAME_PERIODS - 1,)
    with pytest.raises(ValueError, match="cannot frame"):
        navbits.soft_bits([chans[1], short], "cpu")


def _filled_receiver(logs):
    """A CPU receiver whose channels hold `logs` ({prn: (soft_periods'
    arguments, cp_sign)}, U = 4 500 windows of 8 ms each) as if tracked."""
    prns = list(logs)
    rx = ScalarReceiver(SampleFile(samples=np.zeros(16, DTYPE_IQ16), fs=FS),
                        prns, device="cpu")
    segs = next(iter(logs.values()))[0][0]
    u, m = len(segs), segs.shape[1] - 2
    rx.mcount, rx.coh_ms = u, m
    rx._m_samp = list((np.arange(u) + 1) * round(FS * 1e-3) * m)
    for p, (args, signs) in logs.items():
        segs, cp, _, rc, fc, ri, fi, _, _ = args
        rx.channels[p].data = {"pseg": [segs], "cp": [cp], "rc": [rc],
                               "fc": [fc], "ri": [ri], "fi": [fi]}
        rx.channels[p].cp_sign = signs
    return rx


def _decode_logs():
    """Five channels: PRN 1 clean signs (the sign framer decodes), PRNs 2
    and 3 soft (the ramp, a swing; streams of unequal length), PRN 4 soft
    but 30 039 periods long (too short to frame), PRN 5 noise alone (the
    soft path takes it and cannot frame)."""
    _, chans = _soft_channels()
    _, _, clean, _ = _dynamic_log(4, "ramp")
    noisy = [np.sign(navbits.soft_periods(*a).real) for a in chans]
    rng = np.random.default_rng(11)
    noise = (rng.standard_normal(chans[0][0].shape)
             + 1j * rng.standard_normal(chans[0][0].shape))
    short = chans[2][:-1] + (navbits.MIN_FRAME_PERIODS - 1,)
    return {1: (chans[0], clean), 2: (chans[0], noisy[0]),
            3: (chans[1], noisy[1]),
            4: (short, noisy[2][:navbits.MIN_FRAME_PERIODS - 1]),
            5: ((noise,) + chans[2][1:],
                np.sign(navbits.soft_periods(noise, *chans[2][1:]).real))}


def test_decode_ephemerides_equals_the_plain_path():
    """On a receiver whose logs were filled without tracking, the batched
    decode takes the same PRNs, with the same ephemerides, and fails the
    same channels with the same errors, as the plain path (`_parse`,
    channel by channel); `decode_counts` counts each channel's outcome,
    and a recorded decode nests its hard and soft spans in `scalar.decode`."""
    rx = _filled_receiver(_decode_logs())
    want, errors = {}, {}
    for p in rx.prn_list:
        try:
            want[p] = rx._parse(p)[0]
        except ValueError as e:
            errors[p] = str(e)
    assert sorted(want) == [1, 2, 3]
    assert errors[4] == errors[5] == navbits.NO_FRAME
    with tracing.recording():
        good = rx.decode_ephemerides(verbose=False)
    assert good == [1, 2, 3]
    for p in good:
        assert dataclasses.asdict(rx.channels[p].ephemeris) \
            == dataclasses.asdict(want[p])
    assert rx.decode_counts == {"hard": 1, "too_short": 1, "soft": 2,
                                "failed": 1}
    recs = tracing.spans()
    assert Counter(s.name for s in recs) == {
        "scalar.decode": 1, "scalar.decode.hard": 1, "scalar.decode.soft": 1}
    (whole,), (hard,), (soft,) = (_named(recs, n) for n in (
        "scalar.decode", "scalar.decode.hard", "scalar.decode.soft"))
    assert _inside(hard, whole) and _inside(soft, whole)
    assert _in_order(hard, soft)
    assert rx.decode_ephemerides(verbose=False) == good
    assert rx.decode_counts == {"hard": 2, "too_short": 2, "soft": 4,
                                "failed": 2}


@pytest.mark.parametrize("n", [navbits.MIN_FRAME_PERIODS - 1,
                               navbits.MIN_FRAME_PERIODS])
def test_gate_keeps_short_streams_from_the_soft_pass(monkeypatch, n):
    """A soft-path channel of 30 039 periods fails with the framer's own
    error and never reaches the pass (made to fail if called), its outcome
    `too_short`; one of 30 040 reaches it."""
    _, chans = _soft_channels()
    args = chans[0][:-1] + (n,)
    signs = np.sign(navbits.soft_periods(*args).real)
    rx = _filled_receiver({7: (args, signs)})
    taken = []

    def soft_bits(channels, device="cpu"):
        taken.append([a[-1] for a in channels])
        if n < navbits.MIN_FRAME_PERIODS:
            raise AssertionError("the soft pass ran on a stream too short")
        return real(channels, device)

    real = navbits.soft_bits
    monkeypatch.setattr(navbits, "soft_bits", soft_bits)
    rx.decode_ephemerides(verbose=False)
    if n < navbits.MIN_FRAME_PERIODS:
        assert taken == [] and rx.decode_counts["too_short"] == 1
        with pytest.raises(ValueError, match=navbits.NO_FRAME):
            rx._parse(7)
    else:
        assert taken == [[n]] and rx.decode_counts["too_short"] == 0


@pytest.mark.parametrize("seed", [1, 2])
def test_cpu_bit_loops_end_where_the_plain_loop_ends(seed):
    """On the CPU `_bit_loops` returns each pass's end (phase, rate) in
    float64, as `_loop` leaves it, beside its decisions."""
    soft = _soft_stream(seed)[1]
    o = navbits.bit_edge(soft)
    nb = (len(soft) - o) // 20
    z, phase, rate = navbits.loop_start(
        soft[o:o + 20 * nb].reshape(nb, 20).sum(axis=1))
    _, p_f, r_f = navbits._loop(z, phase, rate)
    bits, p_b, r_b = navbits._loop(z[::-1], p_f, -r_f)
    out = torch.zeros((1, nb), dtype=torch.int8)
    ends = navbits._bit_loops(torch.from_numpy(z[None].copy()),
                              torch.tensor([nb]),
                              torch.tensor([[phase, rate]],
                                           dtype=torch.float64), out)
    assert ends.dtype == torch.float64
    assert ends[0].tolist() == [p_f, r_f, p_b, r_b]
    np.testing.assert_array_equal(out[0].numpy(), bits[::-1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bit loop kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_bit_loop_kernel_matches_the_plain_loop_on_card(cuda_device):
    """The bit loop kernel over four channels at once (`_soft_stream`
    seeds 1-3 and a `_dynamic_log` stream, unequal bit counts) decides as
    `_loop` forward then backward, each pass ending within 1e-9 of the
    plain loop's phase and rate, in one launch."""
    from navlab_dpe_sdr_tpu_torch.ops import _build

    streams = [_soft_stream(seed)[1] for seed in (1, 2, 3)]
    streams.append(navbits.soft_periods(*_dynamic_log(4, "ramp")[1]))
    sums, start, want, ends = [], [], [], []
    for soft in streams:
        o = navbits.bit_edge(soft)
        nb = (len(soft) - o) // 20
        z, phase, rate = navbits.loop_start(
            soft[o:o + 20 * nb].reshape(nb, 20).sum(axis=1))
        _, p_f, r_f = navbits._loop(z, phase, rate)
        bits, p_b, r_b = navbits._loop(z[::-1], p_f, -r_f)
        sums.append(z)
        start.append((phase, rate))
        want.append(bits[::-1])
        ends.append((p_f, r_f, p_b, r_b))
    nb = np.array([len(z) for z in sums])
    padded = np.zeros((len(sums), nb.max()), np.complex128)
    for c, z in enumerate(sums):
        padded[c, :len(z)] = z
    out = torch.zeros((len(sums), nb.max() + 1), dtype=torch.int8,
                      device=cuda_device)
    before = _build.launch_counts()["navbits_loop"]
    got_ends = navbits._bit_loops(
        torch.from_numpy(padded).to(cuda_device),
        torch.from_numpy(nb).to(cuda_device),
        torch.tensor(start, dtype=torch.float64, device=cuda_device),
        out[:, 1:])
    torch.cuda.synchronize()
    assert _build.launch_counts()["navbits_loop"] == before + 1
    got = out.cpu().numpy()
    assert not got[:, 0].any()
    for c, k in enumerate(nb):
        np.testing.assert_array_equal(got[c, 1:1 + k], want[c])
        assert not got[c, 1 + k:].any()
    np.testing.assert_allclose(got_ends.cpu().numpy(), np.array(ends),
                               rtol=0, atol=1e-9)
