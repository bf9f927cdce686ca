"""The reference correlator with given flips (reference/flip_decided.py)
against reference/device.py, and the judgement of float32 ties
(harness/ties.py) on seeded blocks: a flip or a code phase rounding that
ties is taken as the program took it, a wider margin is not."""

import numpy as np
import pytest
import torch

from benchmark.harness import check, ties
from benchmark.reference import device as ref_dev
from benchmark.reference import flip_decided

PERIOD, N_PERIODS, N, C = 128, 2, 3, 2
S = PERIOD * N_PERIODS
CODE_WIN, CARR_WIN = 6, 8
CARR_FFTPTS = 8 * (1 << S.bit_length())
LIMITS = {"window_gap": 2.2e-5, "state_gap_m": 1e-3}


class Ref:
    """What harness/ties.py reads of check.Reference, on seeded blocks
    whose block 1 is silent past its nav-bit boundary (an exact tie of the
    flip decision: the two lag-0 sums are equal)."""

    def __init__(self, seed=5):
        rng = np.random.default_rng(seed)
        self.device = torch.device("cpu")
        self.S, self.period = S, PERIOD
        self.code_win, self.carr_win = CODE_WIN, CARR_WIN
        self.carr_fftpts = CARR_FFTPTS
        self.chips = torch.as_tensor(rng.choice([-1.0, 1.0], (C, 1023)),
                                     dtype=torch.float32)
        self.time_idc = torch.arange(S, dtype=torch.float32) / (PERIOD * 1e3)
        iq = rng.normal(0.0, 20.0, (N * S, 2))
        self.fpk = np.zeros((N, 11, C))
        self.fpk[:, 0] = rng.uniform(0.0, 1023.0, (N, C))
        self.fpk[:, 1] = rng.uniform(-3000.0, 3000.0, (N, C))
        self.fpk[:, 2] = rng.uniform(0.0, 1.0, (N, C))
        self.ipk = np.stack([rng.integers(S // 8, S, (N, C)),
                             S // 2 - CODE_WIN // 2
                             + rng.integers(-2, 3, (N, C)),
                             CARR_FFTPTS // 2 - CARR_WIN // 2
                             + rng.integers(-3, 4, (N, C))], axis=1)
        self.ipk[1, 0] = 200
        iq[S + 200:2 * S] = 0.0
        self.cap = type("Cap", (), {})()
        self.cap.raw = torch.as_tensor(iq.round(), dtype=torch.int16)
        self.rc64 = self.fpk[:, 0].copy()     # the code phases before packing

    def receiver(self):
        """A receiver whose `_pack` is where the code phases are packed."""
        return type("Rx", (), {"_pack": lambda self, rc_mid: rc_mid})()

    def correlate(self, sample0, fpk, ipk, tf32):
        return ties.correlate(self, sample0, fpk, ipk, tf32)[0]

    def args(self):
        fp = torch.as_tensor(self.fpk, dtype=torch.float32)
        ip = torch.as_tensor(self.ipk, dtype=torch.int64)
        raw = self.cap.raw.reshape(N, S, 2)
        return (raw[..., 0], raw[..., 1], self.chips, fp[:, 0], ip[:, 0],
                fp[:, 1], fp[:, 2], self.time_idc, ip[:, 1], ip[:, 2],
                CARR_FFTPTS, PERIOD, N_PERIODS, CODE_WIN, CARR_WIN)


def _equal(a: ref_dev.Windows, b: ref_dev.Windows) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_undecided_equals_the_reference_correlator():
    """With no flips given: device.py's windows and flips, bit for bit."""
    R = Ref()
    want = ref_dev.correlate(*R.args())
    got, margin = flip_decided.correlate(*R.args())
    assert _equal(got, want)
    assert margin.shape == (N, C) and bool((margin >= 0).all())
    assert float(margin[1, 0]) == 0.0          # the silent tail: an exact tie


def test_given_flips_take_each_decision():
    """The reference's own flips change nothing; no flip anywhere is the
    boundary moved past the block (no tail to flip), bit for bit; a flip
    where the reference took none changes that block's windows only."""
    R = Ref()
    own, _ = flip_decided.correlate(*R.args())
    again, _ = flip_decided.correlate(*R.args(), use_flip=own.flip)
    assert _equal(again, own)
    none, _ = flip_decided.correlate(
        *R.args(), use_flip=torch.zeros(N, C, dtype=torch.bool))
    past = list(R.args())
    past[4] = torch.full((N, C), S, dtype=torch.int64)
    moved = ref_dev.correlate(*past)
    assert torch.equal(none.code_re, moved.code_re)
    assert torch.equal(none.carr_im, moved.carr_im)
    other = own.flip.clone()
    other[1, 0] = ~other[1, 0]
    got, _ = flip_decided.correlate(*R.args(), use_flip=other)
    changed = (got.code_re != own.code_re).any(-1)
    assert bool(changed[1, 0]) and int(changed.sum()) == 1


def _judge_one(prog: ref_dev.Windows, calls: list):
    def judge_one(R, rec):
        calls.append(1)
        rx = R.receiver()
        for rc in R.rc64:
            rx._pack(rc)
        w = R.correlate(0, R.fpk, R.ipk, False)
        m, pm = w.mags(), prog.mags()
        return {"window_gap": max(
            float(((pm[i] - m[i]).abs().amax(-1) / m[i].amax(-1)).max())
            for i in range(2))}
    return judge_one


def _program(R, flip_at):
    own, _ = flip_decided.correlate(*R.args())
    flips = own.flip.clone()
    flips[flip_at] = ~flips[flip_at]
    return flip_decided.correlate(*R.args(), use_flip=flips)[0]


def test_a_tie_is_taken_as_the_program_decided_it():
    R = Ref()
    prog = _program(R, (1, 0))
    calls, said = [], []
    plain = _judge_one(prog, [])(R, None)
    assert plain["window_gap"] > LIMITS["window_gap"]
    got = ties.judge(_judge_one(prog, calls), R, None, prog.mags(), LIMITS,
                     said.append)
    assert got["window_gap"] == 0.0 and len(calls) == 2
    assert "(1, 0, 'flip', 0.0)" in said[0]
    assert "correlate" not in vars(R)


@pytest.mark.parametrize("at", [(0, 1), (2, 0)])
def test_a_wider_margin_stays_the_references(at):
    """A flip the program took the other way where the two sums differ by
    more than the window limit keeps failing."""
    R = Ref()
    _, margin = flip_decided.correlate(*R.args())
    assert float(margin[at]) > LIMITS["window_gap"]
    prog = _program(R, at)
    said = []
    got = ties.judge(_judge_one(prog, []), R, None, prog.mags(), LIMITS,
                     said.append)
    assert got["window_gap"] > LIMITS["window_gap"] and not said


def test_an_operation_within_its_limits_is_judged_once():
    R = Ref()
    own, _ = flip_decided.correlate(*R.args())
    calls = []
    got = ties.judge(_judge_one(own, calls), R, None, own.mags(), LIMITS)
    assert got["window_gap"] == 0.0 and len(calls) == 1


# 826.5 puts replica sample 64 of each period (frac_base 0.5) on its chip
# index carry; the float32 value below it does not carry
RC_AT, RC_BELOW = 826.5, float(np.nextafter(np.float32(826.5), np.float32(0)))


def _rc_program(R, rc64):
    """The reference's code phase of block 2, channel 1 set to rc64 (and
    packed as its float32 rounding), and the program's windows from the
    float32 value one below 826.5."""
    R.rc64[2, 1] = rc64
    R.fpk[2, 0, 1] = np.float32(rc64)
    taken = R.fpk.copy()
    taken[2, 0, 1] = RC_BELOW
    R_prog = Ref()
    R_prog.fpk = taken
    return flip_decided.correlate(*R_prog.args())[0]


def test_a_code_phase_rounding_tie_is_taken_as_the_program_took_it():
    """The reference's float64 code phase a hair above the midpoint rounds
    to 826.5; the program's, within the state limit of it, rounded below:
    both are right, the program's is taken."""
    R = Ref()
    rc64 = (RC_AT + RC_BELOW) / 2 + 1e-9
    prog = _rc_program(R, rc64)
    plain = _judge_one(prog, [])(R, None)
    assert plain["window_gap"] > 1e-3
    said = []
    got = ties.judge(_judge_one(prog, []), R, None, prog.mags(), LIMITS,
                     said.append)
    assert got["window_gap"] == 0.0
    assert "(2, 1, 'rc_mid'" in said[0]
    alt, near = ties.other_rounding(np.array([rc64, RC_AT]), 3.4e-6)
    assert alt[0] == RC_BELOW and near.tolist() == [True, False]


def test_a_code_phase_off_by_a_rounding_far_from_a_tie_fails():
    """The reference's code phase 1e-5 chip (3 mm, past the 1 mm state
    limit) above the midpoint, so that it rounds to 826.5: the program's
    value one float32 below is not a tie."""
    R = Ref()
    prog = _rc_program(R, (RC_AT + RC_BELOW) / 2 + 1e-5)
    said = []
    got = ties.judge(_judge_one(prog, []), R, None, prog.mags(), LIMITS,
                     said.append)
    assert got["window_gap"] > 1e-3 and not said


def test_through_the_harness_reference(tmp_path):
    """ties.correlate with no flips given is check.Reference.correlate,
    bit for bit, on a synthesized capture."""
    from benchmark.harness import capture, program
    from benchmark.tests.test_bench_reference import CONFIG

    old = capture.CACHE_DIR
    capture.CACHE_DIR = tmp_path
    try:
        cap = capture.load(dict(CONFIG, scenario=dict(CONFIG["scenario"],
                                                      seconds=0.1)),
                           321, torch.device("cpu"))
    finally:
        capture.CACHE_DIR = old
    R = check.Reference(CONFIG, cap, torch.device("cpu"))
    rr = R.receiver()
    check.start_cache_batched(rr, cap.hand)
    rr.load(program.snapshot(program.dpe_receiver(CONFIG, cap, "cpu")))
    preps = rr.prepare_batch(3)
    fpk = np.stack([p[0] for p in preps])
    ipk = np.stack([p[1] for p in preps])
    want = R.correlate(0, fpk, ipk, False)
    got, margin = ties.correlate(R, 0, fpk, ipk, False)
    assert _equal(got, want) and margin.shape == want.flip.shape


SEED = 2**31 + 977


def _perblock(cell):
    """The tiny copy's spread25.offline_perblock, cut as the tiny copy cuts
    the offline cells."""
    c = cell("spread25.offline_perblock")
    c.workload = dict(c.workload, lookahead=10, warmup_passes=1,
                      judged_dispatches=2)
    return c


@pytest.mark.parametrize("trace", [0, 1])
def test_perblock_cell_runs_and_is_correct(cell, trace):
    from benchmark.harness import main as hm

    r = hm.run_cell(_perblock(cell), SEED, 0.3, bool(trace), "cpu")
    assert r["correct"], r["check"]
    assert r["attempted"] > 0


def test_perblock_windows_off_are_not_correct(cell, monkeypatch):
    """K5's code magnitudes 1e-3 off where they are produced: no flip is
    decided the other way, so no tie excuses it."""
    from benchmark.harness import main as hm
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real

    orig = dpe_real.windowed_correlate

    def off(*a, **kw):
        out = orig(*a, **kw)
        return out._replace(code_mag=out.code_mag * 1.001)
    monkeypatch.setattr(dpe_real, "windowed_correlate", off)
    r = hm.run_cell(_perblock(cell), SEED, 0.3, False, "cpu")
    assert not r["correct"], r["check"]
    assert r["check"]["window_gap"]["value"] > 5e-4
