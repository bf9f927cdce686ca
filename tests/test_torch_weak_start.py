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
