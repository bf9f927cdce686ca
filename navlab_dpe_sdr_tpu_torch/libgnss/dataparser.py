"""Navigation-bit framing: preamble search, subframe lock, LNAV decode.

Takes the per-code-period prompt-sign stream a tracking channel accumulates
(cp_sign) and produces a decoded `Ephemeris` with the (TOW, cp) anchor that
ties receiver code-period counts to GPS time.

Parity: reference pygnss/pythonreceiver/libgnss/dataparser.py:7-70.

The port's own copy of navlab_dpe_sdr_tpu/libgnss/dataparser.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from . import ephemeris as eph_mod
from .ephemeris import TLM_PREAMBLE, assemble_ephemeris

_PREAMBLE_CP = np.kron(TLM_PREAMBLE, np.ones(20))
_SUBFRAME_CP = 6000  # 300 bits x 20 code periods


def find_subframe_starts(cp_sign: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Locate 5 consecutive subframe starts in a +/-1 code-period sign stream.

    Returns (locations, polarities) where locations index into cp_sign and
    polarity is the sign of the preamble correlation at each location.
    Raises ValueError if no 5-subframe pattern is found.
    """
    corr = np.correlate(cp_sign, _PREAMBLE_CP, "valid")
    hits = np.where(np.abs(corr) > 153)[0]
    hit_set = set(hits.tolist())
    best = None
    for t in hits:
        cand = [t + k * _SUBFRAME_CP for k in range(5)]
        if t + 5 * _SUBFRAME_CP > len(cp_sign):
            continue  # full 5 subframes must fit in the stream
        if all(c in hit_set for c in cand):
            locs = np.array(cand)
            if t >= 40:
                return locs, np.sign(corr[locs])
            # keep a <40 pattern as fallback (no D29*/D30* history bits)
            if best is None:
                best = (locs, np.sign(corr[locs]))
    if best is not None:
        return best
    raise ValueError("no 5-subframe preamble pattern found")


def bits_from_cp_signs(cp_sign: np.ndarray, start: int, n_bits: int) -> np.ndarray:
    """Fold 20 code periods per bit -> +/-1 bit stream."""
    seg = cp_sign[start:start + 20 * n_bits].reshape(n_bits, 20)
    return np.sign(np.sum(seg, axis=1)).astype(np.int64)


def parse_ephemerides(cp_sign: np.ndarray, cp_offset: float, prn: int):
    """Decode an Ephemeris from a channel's cp_sign stream.

    cp_sign: +/-1 per code period, indexed by absolute code-period count
      minus cp_offset (i.e. cp_sign[j] is code period cp_offset + j).
    Returns (Ephemeris, parity_ok_count).
    """
    locs, pols = find_subframe_starts(cp_sign)

    bits = bits_from_cp_signs(cp_sign, int(locs[0]), 1500)

    if locs[0] >= 40:
        # previous word's D29*/D30* from the 2 bits before the first preamble
        prev2 = bits_from_cp_signs(cp_sign, int(locs[0]) - 40, 2)
        d29 = int((1 - prev2[0]) // 2)
        d30 = int((1 - prev2[1]) // 2)
    else:
        # no history: D30* equals the preamble polarity (+160 correlation
        # <-> transmitted == source <-> D30* = 0); D29* unknowable — guess
        # D30*, which only risks the first word's parity check, not its bits
        d30 = 0 if pols[0] > 0 else 1
        d29 = d30

    subframe_dicts = []
    cp_of_subframe = []
    parity_ok = 0
    for sf in range(5):
        data_bits = np.empty(300, dtype=np.int64)
        for w in range(10):
            word_pm = bits[sf * 300 + w * 30: sf * 300 + w * 30 + 30]
            d29_pm, d30_pm = 1 - 2 * d29, 1 - 2 * d30
            if eph_mod.check_word_parity(word_pm, d29_pm, d30_pm):
                parity_ok += 1
            data_bits[w * 30:(w + 1) * 30] = eph_mod.word_data_bits(
                word_pm, d30_pm)
            d29 = int((1 - word_pm[28]) // 2)
            d30 = int((1 - word_pm[29]) // 2)
        subframe_dicts.append(eph_mod.decode_subframe(data_bits))
        cp_of_subframe.append(float(cp_offset) + float(locs[sf]))

    eph = assemble_ephemeris(prn, subframe_dicts, cp_of_subframe)
    return eph, parity_ok
