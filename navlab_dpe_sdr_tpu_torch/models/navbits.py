"""LNAV bits from soft prompt values, for signals too weak for the sign
framer.

`libgnss/dataparser.py` frames the navigation message on the tracker's
per-code-period signs: a preamble is a run of 160 periods with at most 7
signs wrong. Below ~35 dB-Hz a 1 ms sign is wrong too often for that (at
27 dB-Hz about one in five), and the tracker's carrier phase wanders too
far within a bit for its own signs to be summed. Here the bits are decided
from the prompt's complex sum over each code period (`soft`, indexed like
the sign stream), taken against a smooth carrier (`soft_periods`, from the
prompt segment sums that K4 logs for each coherent window and the
tracker's logged Dopplers smoothed locally): the bit edges where the
20-period sums
carry the most energy, each bit's sum turned by a decision-directed phase
loop at the bit rate (`coherent_bits`), the subframes framed on those
bits, and a 30-bit word failing its parity check repaired where one
flipped bit makes it pass. The result is a clean sign stream (each bit
over its 20 periods, zeros before the first edge) that
`dataparser.parse_ephemerides` decodes as it decodes a strong channel's.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import savgol_filter

from ..constants import L_CA
from ..libgnss import dataparser
from ..libgnss import ephemeris as eph_mod

PERIODS_A_BIT = 20
SUBFRAME_BITS = 300
WORDS = 50                # 5 subframes of 10 words
# the sign framer's preamble test: |correlation| > 153 of 160 periods
HARD_ERRORS = (160 - 153) / 2 / 160
LOOP_BN_HZ = 4.0          # the bit decisions' phase loop's noise bandwidth
LOOP_START_BITS = 50      # bits the loop's starting rate and phase come from
SMOOTH_S = 6.0            # the smooth carrier: a local quadratic in the
SMOOTH_ORDER = 2          # logged Dopplers over this many seconds


def smooth_doppler(fi: np.ndarray, dt: float) -> np.ndarray:
    """The tracker's Dopplers fi [Hz], dt [s] apart, smoothed by a local
    polynomial of SMOOTH_ORDER over SMOOTH_S seconds (Savitzky-Golay, fitted
    at the ends): the carrier's own dynamics pass, the loop's noise does
    not."""
    fi = np.asarray(fi, np.float64)
    n = len(fi)
    w = min(int(SMOOTH_S / dt) | 1, n if n % 2 else n - 1)
    if w <= SMOOTH_ORDER:
        return np.full(n, fi.mean() if n else 0.0)
    return savgol_filter(fi, w, SMOOTH_ORDER, mode="interp")


def segment_middles(rc: np.ndarray, fc: np.ndarray, m: int) -> np.ndarray:
    """[U, m + 2] times [s] after each window's start of the middles of its
    m + 2 prompt segments: segment k runs from code boundary k to k + 1,
    boundary k (1..m + 1) at (k L_CA - rc) / fc within the window of m ms
    (rc [chips] and fc [chips/s] the window's start state, [U] each)."""
    k = np.arange(1, m + 2)
    edge = np.clip((k * L_CA - np.asarray(rc, np.float64)[:, None])
                   / np.asarray(fc, np.float64)[:, None], 0.0, m * 1e-3)
    u = len(edge)
    edge = np.concatenate([np.zeros((u, 1)), edge, np.full((u, 1), m * 1e-3)],
                          axis=1)
    return 0.5 * (edge[:, 1:] + edge[:, :-1])


def soft_periods(segs, cp, t_win, rc, fc, ri, fi, m: int,
                 n: int) -> np.ndarray:
    """The prompt's complex sum of each of a channel's first n code periods
    (indexed like its sign stream) against a smooth carrier. segs [U, m + 2]
    are its windows' logged prompt segment sums (in the tracker's carrier
    frame: phase ri + fi tau, tau after the window's start t_win [s]); cp,
    rc, fc, ri, fi [U] its log at each window's start. The smooth carrier
    integrates the locally smoothed Doppler (`smooth_doppler`) from window
    to window; each segment is turned from the tracker's phase to it at
    the segment's middle (`segment_middles`), negated as the logged signs
    are, and added into its code period (cp + k for segment k). The
    tracker's carrier phase wanders by radians within a bit at 27 dB-Hz;
    the smooth carrier's does not."""
    t_win = np.asarray(t_win, np.float64)
    fi = np.asarray(fi, np.float64)
    dt = float(np.median(np.diff(t_win))) if len(t_win) > 1 else m * 1e-3
    f_s = smooth_doppler(fi, dt)
    phi = np.concatenate([[0.0], np.cumsum(f_s[:-1] * np.diff(t_win))])
    tau = segment_middles(rc, fc, m)
    turn = (np.asarray(ri, np.float64) - phi)[:, None] + (fi - f_s)[:, None] \
        * tau
    turned = (-np.asarray(segs, np.complex128)
              * np.exp(2j * np.pi * np.mod(turn, 1.0))).ravel()
    at = (np.asarray(cp, np.int64)[:, None] + np.arange(m + 2)).ravel()
    keep = at < n
    return (np.bincount(at[keep], turned.real[keep], n)
            + 1j * np.bincount(at[keep], turned.imag[keep], n))


def sign_disagreement(signs: np.ndarray) -> float:
    """The share of code-period signs (+/-1) in the minority of their bit,
    at the bit phase where the bits are strongest: an estimate of the
    stream's sign error rate."""
    run = np.concatenate([[0.0], np.cumsum(np.asarray(signs, np.float64))])
    best = max((np.abs(np.diff(run[o::PERIODS_A_BIT])) for o in range(
        PERIODS_A_BIT)), key=lambda a: float(a.sum()))
    if not len(best):
        return 0.0
    return float((PERIODS_A_BIT - best).sum() / (2 * PERIODS_A_BIT
                                                  * len(best)))


def bit_edge(soft: np.ndarray) -> int:
    """The code period (0..19) at which bits start: the phase whose
    20-period sums carry the most energy."""
    soft = np.asarray(soft, np.complex128)
    run = np.concatenate([[0.0], np.cumsum(soft)])
    energy = []
    for o in range(PERIODS_A_BIT):
        ends = run[o::PERIODS_A_BIT]
        energy.append(float((np.abs(np.diff(ends)) ** 2).sum()))
    return int(np.argmax(energy))


def _loop(sums, phase: float, rate: float):
    """One pass of the bits' phase loop over `sums` from (phase, rate)
    [rad, rad a bit]: (decisions, phase and rate after the last bit)."""
    t = PERIODS_A_BIT * 1e-3
    zeta = 0.707
    wn = 8.0 * zeta * LOOP_BN_HZ / (4.0 * zeta * zeta + 1.0)
    k1, k2 = 2.0 * zeta * wn * t, (wn * t) ** 2
    bits = np.empty(len(sums))
    cos, sin, atan2 = math.cos, math.sin, math.atan2
    for b, (re, im) in enumerate(zip(sums.real.tolist(),
                                     sums.imag.tolist())):
        c, s = cos(phase), sin(phase)
        zr, zi = re * c + im * s, im * c - re * s      # sum turned by -phase
        d = 1.0 if zr >= 0.0 else -1.0
        bits[b] = d
        err = atan2(zi * d, zr * d)
        rate += k2 * err
        phase += rate + k1 * err
    return bits, phase - rate, rate


def coherent_bits(sums: np.ndarray) -> np.ndarray:
    """+/-1 decisions of the complex bit sums [nb]: a second-order
    decision-directed phase loop over the bits (one update a 20 ms bit,
    noise bandwidth LOOP_BN_HZ, damping 0.707) follows the carrier phase left
    in them, each bit the sign of its sum turned by the loop's phase. The
    loop runs forward from the rate and phase of the first bits' squared
    sums (which the data's sign does not reach), then backward from where
    it ended; the backward pass, settled from its first bit, decides."""
    sums = np.asarray(sums, np.complex128)
    sums = sums / max(float(np.median(np.abs(sums))), 1e-30)
    sq = sums ** 2
    n0 = min(len(sums), LOOP_START_BITS)
    rate = float(np.angle(np.sum(sq[1:n0] * np.conj(sq[:n0 - 1])))) / 2.0
    phase = float(np.angle(np.sum(
        sq[:n0] * np.exp(-2j * rate * np.arange(n0))))) / 2.0
    _, phase, rate = _loop(sums, phase, rate)
    bits, _, _ = _loop(sums[::-1], phase, -rate)
    return bits[::-1].copy()


def _frames(bits: np.ndarray, o: int) -> list[int]:
    """The first bits of every run of 5 subframes that fits the stream, in
    order, framed where the most subframe starts 300 bits apart hold the
    preamble (either polarity), each with at least 40 code periods before
    it as the sign framer prefers (two bits at the least). Raises
    ValueError where no phase holds three preambles."""
    pre = eph_mod.TLM_PREAMBLE
    nb = len(bits)
    hit = np.zeros(nb, bool)
    c = np.correlate(bits, pre, "valid")
    hit[:len(c)] = np.abs(c) == len(pre)
    score = [int(hit[r::SUBFRAME_BITS].sum()) for r in range(SUBFRAME_BITS)]
    r = int(np.argmax(score))
    starts = [t for t in range(r, nb - 5 * SUBFRAME_BITS + 1, SUBFRAME_BITS)
              if t >= 2 and o + PERIODS_A_BIT * t >= 40]
    if score[r] < 3 or not starts:
        raise ValueError("no 5-subframe preamble pattern found")
    return starts


def _repair_words(bits: np.ndarray, first: int) -> int:
    """Repair in place the 50 words from bit `first` (>= 2): a word failing
    its parity check (with the previous word's last two bits as received)
    takes the single bit flip that makes it pass, if there is one. Returns
    the words passing after the repair."""
    good = 0
    for w in range(WORDS):
        a = first + 30 * w
        word = bits[a:a + 30]
        if eph_mod.check_word_parity(word, bits[a - 2], bits[a - 1]):
            good += 1
            continue
        for k in range(30):
            word[k] = -word[k]
            if eph_mod.check_word_parity(word, bits[a - 2], bits[a - 1]):
                good += 1
                break
            word[k] = -word[k]
    return good


def clean_signs(soft: np.ndarray) -> np.ndarray:
    """A sign stream as long as `soft` (code periods): each coherently
    decided bit over its 20 periods from two bits before the first of 5
    framed subframes on, their preambles written in (each in the polarity
    of its first bit) and their words repaired, zeros elsewhere. The 5
    subframes are the earliest run whose 50 words all pass parity after
    the repair (a channel's first seconds, while its loops pull in, may
    hold wrong bits), or the earliest run where none does. Raises
    ValueError where no 5-subframe preamble pattern frames."""
    soft = np.asarray(soft, np.complex128)
    o = bit_edge(soft)
    nb = (len(soft) - o) // PERIODS_A_BIT
    bits = coherent_bits(soft[o:o + PERIODS_A_BIT * nb].reshape(
        nb, PERIODS_A_BIT).sum(axis=1))
    pre = eph_mod.TLM_PREAMBLE
    picked = None
    for first in _frames(bits, o):
        b = bits.copy()
        for k in range(5):
            a = first + SUBFRAME_BITS * k
            b[a:a + len(pre)] = pre * b[a] * pre[0]
        good = _repair_words(b, first)
        if picked is None or good == WORDS:
            picked = (first, b)
        if good == WORDS:
            break
    first, bits = picked
    end = first + 5 * SUBFRAME_BITS
    out = np.zeros(len(soft))
    out[o + PERIODS_A_BIT * (first - 2):o + PERIODS_A_BIT * end] = np.repeat(
        bits[first - 2:end], PERIODS_A_BIT)
    return out
