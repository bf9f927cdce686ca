"""LNAV navigation-message encoder (inverse of ephemeris.decode_subframe).

Builds the 50 bps bit stream (subframes 1-5 with TLM/HOW and IS-GPS-200
parity) from an `Ephemeris`, so the synthetic-signal generator can emit
decodable navigation data. The reference repo has no encoder — its demo data
was produced by an external simulator (README.md:91) — so this module is the
test fixture generator for the whole decode path.

The benchmark's frozen copy of navlab_dpe_sdr_tpu_torch/libgnss/lnav.py
(host float64 numpy, no torch): part of the yardstick, which imports nothing
of the program, so that a change to the program cannot move it.
"""

from __future__ import annotations

import numpy as np

from ..constants import PI
from .ephemeris import PARITY_MAT, Ephemeris

_PREAMBLE_BITS = np.array([1, 0, 0, 0, 1, 0, 1, 1])


def _int_to_bits(value: int, width: int) -> np.ndarray:
    value = int(round(value))
    if value < 0:
        value += 1 << width
    return np.array([(value >> (width - 1 - k)) & 1 for k in range(width)],
                    dtype=np.int64)


def _scaled(value: float, factor: float, width: int, signed: bool) -> np.ndarray:
    q = int(round(value / factor))
    lim = 1 << (width - 1) if signed else 1 << width
    if signed:
        q = max(-lim, min(lim - 1, q))
    else:
        q = max(0, min(lim - 1, q))
    return _int_to_bits(q, width)


def encode_word(source24: np.ndarray, d29: int, d30: int) -> np.ndarray:
    """One 30-bit transmitted word from 24 source bits + previous D29*/D30*.

    Transmitted data bits are source XOR D30*; parity D25..D30 follows the
    same multiplicative form as the decoder's checker, guaranteeing
    self-consistency (ephemeris.check_word_parity).
    """
    tx_data = (source24 + d30) % 2
    src_pm = 1 - 2 * source24  # 0/1 -> +1/-1 of SOURCE bits
    dstar_pm = np.array([d29, d30, d29, d30, d30, d29])
    dstar_pm = 1 - 2 * dstar_pm
    # parity in +/-1 arithmetic over source bits:
    # parity_i = dstar_i * prod(src_pm over taps)
    prods = np.ones(6)
    for i in range(6):
        taps = PARITY_MAT[i] == 1
        prods[i] = np.prod(src_pm[taps])
    parity_pm = dstar_pm * prods
    parity_bits = ((1 - parity_pm) // 2).astype(np.int64)
    return np.concatenate([tx_data, parity_bits])


def _tlm_word() -> np.ndarray:
    return np.concatenate([_PREAMBLE_BITS, np.zeros(16, dtype=np.int64)])


def _how_word(tow_sec: float, subframe_id: int) -> np.ndarray:
    # HOW carries the TOW count of the NEXT subframe start:
    # decoder computes TOW = count*6 - 6 (ephemeris.decode_subframe).
    count = int(round(tow_sec / 6.0)) + 1
    return np.concatenate([
        _int_to_bits(count, 17),
        np.zeros(2, dtype=np.int64),          # alert / anti-spoof
        _int_to_bits(subframe_id, 3),
        np.zeros(2, dtype=np.int64),          # parity-solve placeholder
    ])


_2 = lambda p: 2.0 ** p


def subframe_source_bits(eph: Ephemeris, subframe_id: int, tow_sec: float) -> np.ndarray:
    """240 source bits (10 words x 24) for subframes 1-3 (4/5 are filler)."""
    words = [_tlm_word(), _how_word(tow_sec, subframe_id)]
    z24 = lambda: np.zeros(24, dtype=np.int64)

    if subframe_id == 1:
        w3 = np.concatenate([_int_to_bits(eph.weeknumber - 1024, 10),
                             np.zeros(2, dtype=np.int64),
                             _int_to_bits(eph.accuracy, 4),
                             _int_to_bits(eph.health, 1),
                             np.zeros(5, dtype=np.int64),
                             _int_to_bits((eph.IODC >> 8) & 0x3, 2)])
        w7 = np.concatenate([np.zeros(16, dtype=np.int64),
                             _scaled(eph.T_GD, _2(-31), 8, True)])
        w8 = np.concatenate([_int_to_bits(eph.IODC & 0xFF, 8),
                             _scaled(eph.t_oc, _2(4), 16, False)])
        w9 = np.concatenate([_scaled(eph.a_f2, _2(-55), 8, True),
                             _scaled(eph.a_f1, _2(-43), 16, True)])
        w10 = np.concatenate([_scaled(eph.a_f0, _2(-31), 22, True),
                              np.zeros(2, dtype=np.int64)])
        words += [w3, z24(), z24(), z24(), w7, w8, w9, w10]

    elif subframe_id == 2:
        m0 = _scaled(eph.M_0 / PI, _2(-31), 32, True)
        e_bits = _scaled(eph.e, _2(-33), 32, False)
        sqa = _scaled(eph.sqrt_A, _2(-19), 32, False)
        w3 = np.concatenate([_int_to_bits(eph.IODE, 8),
                             _scaled(eph.C_rs, _2(-5), 16, True)])
        w4 = np.concatenate([_scaled(eph.delta_n / PI, _2(-43), 16, True),
                             m0[:8]])
        w5 = m0[8:]
        w6 = np.concatenate([_scaled(eph.C_uc, _2(-29), 16, True), e_bits[:8]])
        w7 = e_bits[8:]
        w8 = np.concatenate([_scaled(eph.C_us, _2(-29), 16, True), sqa[:8]])
        w9 = sqa[8:]
        w10 = np.concatenate([_scaled(eph.t_oe, _2(4), 16, False),
                              np.zeros(8, dtype=np.int64)])
        words += [w3, w4, w5, w6, w7, w8, w9, w10]

    elif subframe_id == 3:
        om0 = _scaled(eph.OMEGA_0 / PI, _2(-31), 32, True)
        i0 = _scaled(eph.i_0 / PI, _2(-31), 32, True)
        om = _scaled(eph.omega / PI, _2(-31), 32, True)
        w3 = np.concatenate([_scaled(eph.C_ic, _2(-29), 16, True), om0[:8]])
        w4 = om0[8:]
        w5 = np.concatenate([_scaled(eph.C_is, _2(-29), 16, True), i0[:8]])
        w6 = i0[8:]
        w7 = np.concatenate([_scaled(eph.C_rc, _2(-5), 16, True), om[:8]])
        w8 = om[8:]
        w9 = _scaled(eph.OMEGADOT / PI, _2(-43), 24, True)
        w10 = np.concatenate([_int_to_bits(eph.IODE, 8),
                              _scaled(eph.IDOT / PI, _2(-43), 14, True),
                              np.zeros(2, dtype=np.int64)])
        words += [w3, w4, w5, w6, w7, w8, w9, w10]

    else:  # subframes 4/5: almanac filler (decoder only reads TOW/id)
        words += [z24() for _ in range(8)]

    return np.concatenate(words)


def encode_stream(eph: Ephemeris, tow_start: float, n_subframes: int,
                  d29: int = 0, d30: int = 0) -> np.ndarray:
    """Transmitted LNAV bit stream (0/1) covering n_subframes x 6 s.

    tow_start must be a multiple of 6 (subframe boundary). Subframe IDs cycle
    1..5 aligned to the GPS frame (TOW mod 30).
    """
    assert tow_start % 6 == 0
    out = []
    for k in range(n_subframes):
        tow = tow_start + 6.0 * k
        sid = int(tow / 6.0) % 5 + 1
        src = subframe_source_bits(eph, sid, tow).reshape(10, 24)
        for w in range(10):
            word = encode_word(src[w], d29, d30)
            d29, d30 = int(word[28]), int(word[29])
            out.append(word)
    return np.concatenate(out)
