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

The receiver decodes its channels together (`soft_bits`): one float64
pass on its device over every channel that reaches the soft path, the
bits' phase loop a hand-written kernel on a CUDA device
(ops/navbits_loop.py), the framing on the host (`framed_signs`). A stream
under MIN_FRAME_PERIODS cannot frame, and gets no soft work. The
per-channel functions (`soft_periods`, `bit_edge`, `coherent_bits`,
`_loop`, `clean_signs`) are the plain reference the pass is held to.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy.signal import savgol_coeffs, savgol_filter

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
# The shortest stream that can frame, in code periods. `_frames` takes a
# run of 5 subframes from bit t on (bits of 20 periods from the bit edge o,
# 0 <= o < 20, nb = (n - o) // 20 of them) only where t >= 2 (two bits
# before it for the parity of its first word), o + 20 t >= 40 and
# t + 1500 <= nb. So nb >= 1502, and n >= o + 20 nb >= 30 040; o = 0 and
# t = 2 frame at exactly 30 040. A shorter stream raises `_frames`' error
# whatever its bits, so the receiver raises it before any soft work.
MIN_FRAME_PERIODS = 5 * SUBFRAME_BITS * PERIODS_A_BIT + 2 * PERIODS_A_BIT
NO_FRAME = "no 5-subframe preamble pattern found"


class TooShort(ValueError):
    """`_frames`' error, raised for a stream under MIN_FRAME_PERIODS before
    any soft work."""

    def __init__(self):
        super().__init__(NO_FRAME)


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


def loop_gains() -> tuple[float, float]:
    """(k1, k2): the bits' phase loop's proportional and integral gains, a
    second-order loop of noise bandwidth LOOP_BN_HZ and damping 0.707
    updated once a bit."""
    t = PERIODS_A_BIT * 1e-3
    zeta = 0.707
    wn = 8.0 * zeta * LOOP_BN_HZ / (4.0 * zeta * zeta + 1.0)
    return 2.0 * zeta * wn * t, (wn * t) ** 2


def _loop(sums, phase: float, rate: float):
    """One pass of the bits' phase loop over `sums` from (phase, rate)
    [rad, rad a bit]: (decisions, phase and rate after the last bit)."""
    k1, k2 = loop_gains()
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


def loop_start(sums: np.ndarray) -> tuple[np.ndarray, float, float]:
    """(the bit sums over their median magnitude, the loop's starting phase
    [rad], its rate [rad a bit]): the rate and phase of the first
    LOOP_START_BITS bits' squared sums, which the data's sign does not
    reach, halved."""
    sums = np.asarray(sums, np.complex128)
    sums = sums / max(float(np.median(np.abs(sums))), 1e-30)
    sq = sums ** 2
    n0 = min(len(sums), LOOP_START_BITS)
    rate = float(np.angle(np.sum(sq[1:n0] * np.conj(sq[:n0 - 1])))) / 2.0
    phase = float(np.angle(np.sum(
        sq[:n0] * np.exp(-2j * rate * np.arange(n0))))) / 2.0
    return sums, phase, rate


def coherent_bits(sums: np.ndarray) -> np.ndarray:
    """+/-1 decisions of the complex bit sums [nb]: a second-order
    decision-directed phase loop over the bits (one update a 20 ms bit,
    noise bandwidth LOOP_BN_HZ, damping 0.707) follows the carrier phase left
    in them, each bit the sign of its sum turned by the loop's phase. The
    loop runs forward from the rate and phase of the first bits' squared
    sums (which the data's sign does not reach), then backward from where
    it ended; the backward pass, settled from its first bit, decides."""
    sums, phase, rate = loop_start(sums)
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
        raise ValueError(NO_FRAME)
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
    """A sign stream as long as `soft` (code periods) from its coherently
    decided bits (`bit_edge`, `coherent_bits`), framed by `framed_signs`.
    Raises ValueError where no 5-subframe preamble pattern frames."""
    soft = np.asarray(soft, np.complex128)
    o = bit_edge(soft)
    nb = (len(soft) - o) // PERIODS_A_BIT
    bits = coherent_bits(soft[o:o + PERIODS_A_BIT * nb].reshape(
        nb, PERIODS_A_BIT).sum(axis=1))
    return framed_signs(bits, o, len(soft))


def framed_signs(bits: np.ndarray, o: int, n: int) -> np.ndarray:
    """A sign stream of n code periods from the +/-1 decisions `bits` of
    the bits starting at period o: each bit over its 20 periods from two
    bits before the first of 5 framed subframes on, their preambles
    written in (each in the polarity of its first bit) and their words
    repaired, zeros elsewhere. The 5 subframes are the earliest run whose
    50 words all pass parity after the repair (a channel's first seconds,
    while its loops pull in, may hold wrong bits), or the earliest run
    where none does. Raises ValueError where no 5-subframe preamble
    pattern frames."""
    bits = np.asarray(bits, np.float64)
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
    out = np.zeros(n)
    out[o + PERIODS_A_BIT * (first - 2):o + PERIODS_A_BIT * end] = np.repeat(
        bits[first - 2:end], PERIODS_A_BIT)
    return out


# -- the receiver's pass: every soft channel at once, in float64 ----------

@functools.lru_cache(maxsize=8)
def _smoother(u: int, dt: float):
    """`smooth_doppler`'s filter over u Dopplers dt [s] apart as fixed
    weights: (w, the interior's convolution weights [w], the least-squares
    projection of w values onto the quadratic's coefficients [3, w], the
    quadratic's basis at the first and at the last w // 2 positions of a
    window [w // 2, 3] each); w 0 where the filter is the mean. The basis
    is centred and scaled for conditioning; the fit is the same."""
    w = min(int(SMOOTH_S / dt) | 1, u if u % 2 else u - 1)
    if w <= SMOOTH_ORDER:
        return 0, None, None, None, None
    h = w // 2
    x = (np.arange(w) - h) / max(h, 1)
    basis = np.vander(x, SMOOTH_ORDER + 1)
    return (w, savgol_coeffs(w, SMOOTH_ORDER), np.linalg.pinv(basis),
            basis[:h], basis[w - h:])


def _smooth(fi: torch.Tensor, dt: float) -> torch.Tensor:
    """`smooth_doppler` of each row of fi [C, U] (float64, any device): the
    Savitzky-Golay interior as one convolution (by FFT: the direct one
    takes ~100 times longer in float64 on a CPU), each end's quadratic fit
    as two small products."""
    u = fi.shape[1]
    w, conv, proj, head, tail = _smoother(u, dt)
    if not w:
        return fi.mean(dim=1, keepdim=True).expand_as(fi).clone()
    as_t = functools.partial(torch.as_tensor, dtype=fi.dtype,
                             device=fi.device)
    size = 1 << (u + w - 2).bit_length()
    mid = torch.fft.irfft(torch.fft.rfft(fi, size)
                          * torch.fft.rfft(as_t(conv), size), size)
    first = fi[:, :w] @ as_t(proj).T @ as_t(head).T
    last = fi[:, -w:] @ as_t(proj).T @ as_t(tail).T
    return torch.cat([first, mid[:, w - 1:u], last], dim=1)


def _bit_loops(sums: torch.Tensor, nb: torch.Tensor, start: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """Each channel's bits' phase loop, forward then backward (as
    `coherent_bits`), over its first nb[c] bit sums sums [C, NB] (complex
    float64) from start [C, 2] (phase, rate): the +/-1 decisions into out
    [C, >= NB] int8, and [C, 4] the (phase, rate) each pass ended at. On a
    CUDA device one launch of ops/navbits_loop.py's kernel; on the CPU
    `_loop`."""
    if sums.device.type == "cuda":
        from ..ops import navbits_loop
        return navbits_loop.bit_loops_cuda(
            torch.view_as_real(sums).contiguous(), nb.to(torch.int32),
            start.contiguous(), out, *loop_gains())
    ends = torch.empty((len(sums), 4), dtype=torch.float64)
    for c, (z, k) in enumerate(zip(sums.numpy(), nb.tolist())):
        phase, rate = start[c].tolist()
        _, phase, rate = _loop(z[:k], phase, rate)
        bits, phase_b, rate_b = _loop(z[:k][::-1], phase, -rate)
        out[c, :k] = torch.from_numpy(bits[::-1].astype(np.int8))
        ends[c] = torch.tensor([phase, rate, phase_b, rate_b],
                               dtype=torch.float64)
    return ends


def soft_bits(channels, device="cpu") -> list[tuple[int, np.ndarray]]:
    """`bit_edge` and `coherent_bits` of `soft_periods` for several
    channels in one float64 pass on `device`: channels is a list of
    `soft_periods`' argument tuples (segs, cp, t_win, rc, fc, ri, fi, m, n)
    sharing t_win and m (a receiver's channels: U windows each). Returns
    each channel's (bit edge o, +/-1 decisions of its (n - o) // 20 bits).

    The logs go up in one copy, the channels padded to the longest stream
    and masked; the smooth carrier, the segments' turn and their sums into
    code periods, the 20 bit-edge energies, the bit sums and their median
    normalisation, the loop's start from the squared sums, and the loop
    (`_bit_loops`) run there; one copy brings back each channel's edge
    and int8 decisions. Raises ValueError for a stream under
    MIN_FRAME_PERIODS (the receiver's gate keeps them out)."""
    dev = torch.device(device)
    _, _, t_win, *_, m, _ = channels[0]
    t_win = np.asarray(t_win, np.float64)
    n = np.array([a[8] for a in channels], np.int64)
    if n.min() < MIN_FRAME_PERIODS:
        raise ValueError(f"soft_bits: a stream of {n.min()} code periods "
                         f"cannot frame (fewer than {MIN_FRAME_PERIODS})")
    c_n, u, k = len(channels), len(t_win), m + 2
    host = np.empty((c_n, u, 2 * k + 5))
    for c, (segs, cp, t_c, rc, fc, ri, fi, m_c, _) in enumerate(channels):
        if m_c != m or len(t_c) != u:
            raise ValueError("soft_bits: channels must share m and t_win")
        host[c, :, :2 * k] = np.asarray(segs, np.complex128).view(
            np.float64).reshape(u, 2 * k)
        host[c, :, 2 * k:] = np.stack([cp, rc, fc, ri, fi], axis=1)
    x = torch.from_numpy(host).to(dev)
    cp, rc, fc, ri, fi = x[..., 2 * k:].unbind(-1)
    seg_re, seg_im = x[..., 0:2 * k:2], x[..., 1:2 * k:2]
    tw = torch.from_numpy(t_win).to(dev)
    dt = float(np.median(np.diff(t_win))) if u > 1 else m * 1e-3
    f_s = _smooth(fi, dt)
    phi = torch.cat([torch.zeros_like(f_s[:, :1]),
                     torch.cumsum(f_s[:, :-1] * (tw[1:] - tw[:-1]), 1)], 1)
    # the segments' middles (segment_middles) and their turn to the
    # smooth carrier
    edge = ((torch.arange(1, m + 2, device=dev) * L_CA - rc[..., None])
            / fc[..., None]).clamp(0.0, m * 1e-3)
    edge = torch.cat([torch.zeros_like(edge[..., :1]), edge,
                      torch.full_like(edge[..., :1], m * 1e-3)], -1)
    tau = 0.5 * (edge[..., 1:] + edge[..., :-1])
    turn = (ri - phi)[..., None] + (fi - f_s)[..., None] * tau
    ang = 2.0 * np.pi * torch.remainder(turn, 1.0)
    cos, sin = torch.cos(ang), torch.sin(ang)
    turned = torch.stack([-(seg_re * cos - seg_im * sin),
                          -(seg_re * sin + seg_im * cos)], -1)
    # into code periods: channel c's period p at row c * width + p, the
    # periods past its stream into a row of their own
    nb_most = int(n.max()) // PERIODS_A_BIT + 1
    width = PERIODS_A_BIT * nb_most
    n_t = torch.from_numpy(n).to(dev)
    at = cp.long()[..., None] + torch.arange(k, device=dev)
    row = torch.where(
        at < n_t[:, None, None],
        at + width * torch.arange(c_n, device=dev)[:, None, None],
        c_n * width)
    soft = torch.zeros((c_n * width + 1, 2), dtype=torch.float64, device=dev)
    soft.index_add_(0, row.reshape(-1), turned.reshape(-1, 2))
    soft = torch.view_as_complex(soft[:-1].view(c_n, width, 2))
    # bit_edge: the energy of the 20-period sums at each phase o, over the
    # bits that end within the stream
    run = torch.cat([torch.zeros_like(soft[:, :1]), torch.cumsum(soft, 1)], 1)
    ends = run[:, :width].view(c_n, nb_most, PERIODS_A_BIT).transpose(1, 2)
    d = ends[..., 1:] - ends[..., :-1]                      # [C, 20, NB - 1]
    last = (torch.arange(PERIODS_A_BIT, device=dev)[:, None]
            + PERIODS_A_BIT * torch.arange(1, nb_most, device=dev))
    energy = torch.where(last <= n_t[:, None, None], d.abs() ** 2,
                         0.0).sum(-1)
    o = energy.argmax(1)
    # the bit sums from each channel's edge, normalised by their median
    nb = torch.div(n_t - o, PERIODS_A_BIT, rounding_mode="floor")
    at = o[:, None] + torch.arange(width - PERIODS_A_BIT, device=dev)
    sums = soft.gather(1, at).view(c_n, nb_most - 1, PERIODS_A_BIT).sum(-1)
    mag = torch.where(torch.arange(nb_most - 1, device=dev) < nb[:, None],
                      sums.abs(), torch.inf).sort(1).values
    med = 0.5 * (mag.gather(1, ((nb - 1) // 2)[:, None])
                 + mag.gather(1, (nb // 2)[:, None]))
    sums = sums / med.clamp(min=1e-30)
    # the loop's start from the first bits' squared sums (nb >= 1501)
    sq = sums[:, :LOOP_START_BITS] * sums[:, :LOOP_START_BITS]
    rate = (sq[:, 1:] * sq[:, :-1].conj()).sum(1).angle() / 2.0
    b = torch.arange(LOOP_START_BITS, device=dev)
    phase = (sq * torch.polar(torch.ones_like(sq.real),
                              (-2.0 * rate)[:, None] * b)
             ).sum(1).angle() / 2.0
    out = torch.zeros((c_n, nb_most), dtype=torch.int8, device=dev)
    out[:, 0] = o.to(torch.int8)
    _bit_loops(sums, nb, torch.stack([phase, rate], 1), out[:, 1:])
    got = out.cpu().numpy()
    edges = got[:, 0].astype(np.int64)
    return [(int(e), got[c, 1:1 + (int(n[c]) - int(e)) // PERIODS_A_BIT
                         ].astype(np.float64))
            for c, e in enumerate(edges)]
