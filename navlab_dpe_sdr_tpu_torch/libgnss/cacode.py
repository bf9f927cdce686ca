"""GPS L1 C/A PRN code generation.

Vectorized Gold-code generator: the G1 and G2 maximal-length sequences are
produced once with a bit-matrix LFSR step, and each PRN's code is the G1
sequence XOR a delayed copy of G2 (delay per IS-GPS-200 Table 3-I).

Parity: reference correlator._make_L1_CAcode_chips
(pygnss/pythonreceiver/scalar/correlator.py:474-548) produces identical chips;
this implementation generates all PRNs in one shot instead of one LFSR run per
PRN object.

The port's own copy of navlab_dpe_sdr_tpu/libgnss/cacode.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import functools

import numpy as np

# G2 delays (chips) for PRN 1..37, IS-GPS-200 Table 3-I.
_G2_DELAYS = np.array([
    5, 6, 7, 8, 17, 18, 139, 140, 141, 251,
    252, 254, 255, 256, 257, 258, 469, 470, 471, 472,
    473, 474, 509, 512, 513, 514, 515, 516, 859, 860,
    861, 862, 863, 950, 947, 948, 950,
])

# Pseudolite / WAAS-style extension PRNs used by the reference: G2 register
# initialization given as an octal word (reference correlator.py:527-531).
_EXTRA_PRN_G2_INIT = {133: 0o1731, 135: 0o1216, 138: 0o0450}

SUPPORTED_PRNS = tuple(range(1, 38)) + tuple(sorted(_EXTRA_PRN_G2_INIT))


def _lfsr_sequence(taps: np.ndarray, init: np.ndarray) -> np.ndarray:
    """Run a 10-stage LFSR for 1023 steps.

    Matches the reference convention: the output sequence starts with the 10
    initial register values, followed by 1013 feedback bits; the register
    shifts left (oldest stage drops off the front).
    """
    reg = init.astype(np.int64).copy()
    out = np.empty(1023, dtype=np.int64)
    out[:10] = reg
    for i in range(10, 1023):
        fb = int(reg @ taps) & 1
        out[i] = fb
        reg[:-1] = reg[1:]
        reg[-1] = fb
    return out


@functools.lru_cache(maxsize=1)
def _g1_g2_base() -> tuple[np.ndarray, np.ndarray]:
    tap1 = np.array([1, 0, 0, 0, 0, 0, 0, 1, 0, 0])
    tap2 = np.array([1, 1, 1, 0, 1, 0, 0, 1, 1, 0])
    ones = np.ones(10, dtype=np.int64)
    return _lfsr_sequence(tap1, ones), _lfsr_sequence(tap2, ones)


def _octal_init(word: int) -> np.ndarray:
    """Decode an octal G2 register preset into 10 bits (LSB-first register).

    The reference stores the register so that bit k of the binary expansion
    (MSB first, width 10) lands at register index k (correlator.py:539-548).
    """
    bits = np.array([(word >> (9 - k)) & 1 for k in range(10)], dtype=np.int64)
    return bits


@functools.lru_cache(maxsize=None)
def _chips_cached(prn: int) -> np.ndarray:
    g1, g2base = _g1_g2_base()
    if 1 <= prn <= 37:
        g2 = np.roll(g2base, int(_G2_DELAYS[prn - 1]))
    elif prn in _EXTRA_PRN_G2_INIT:
        tap2 = np.array([1, 1, 1, 0, 1, 0, 0, 1, 1, 0])
        g2 = _lfsr_sequence(tap2, _octal_init(_EXTRA_PRN_G2_INIT[prn]))
        # The reference additionally applies the published delay for these
        # PRNs on top of the register preset (correlator.py:510-512 rolls
        # unconditionally with the returned delay).
        delay = {133: 603, 135: 359, 138: 386}[prn]
        g2 = np.roll(g2, delay)
    else:
        raise ValueError(f"unsupported PRN {prn}")
    chips = np.where((g1 + g2) % 2 == 0, -1, 1)
    return chips.astype(np.int8)


def ca_code(prn: int) -> np.ndarray:
    """Return the 1023-chip C/A code for a PRN over values {-1, +1}."""
    return _chips_cached(int(prn)).copy()


def ca_table(prns) -> np.ndarray:
    """Stacked code table [num_prn, 1023] (int8, +/-1) for a PRN list."""
    return np.stack([_chips_cached(int(p)) for p in prns]).copy()


def ca_bits(prn: int) -> np.ndarray:
    """Code as 0/1 bits (1 where the +/-1 chip is +1)."""
    return (ca_code(prn) > 0).astype(np.int64)


def first_chips_octal(prn: int, n: int = 10) -> int:
    """Octal word of the first n chips — the IS-GPS-200 Table 3-I checksum."""
    bits = ca_bits(prn)[:n]
    word = 0
    for b in bits:
        word = (word << 1) | int(b)
    return int(oct(word)[2:])


def sampled_code(prn: int, fs: float, n_samples: int, code_phase: float = 0.0,
                 fc: float = 1.023e6) -> np.ndarray:
    """C/A code resampled at fs for n_samples starting at code_phase chips."""
    chips = _chips_cached(int(prn))
    idx = (np.arange(n_samples) * (fc / fs) + code_phase) % 1023.0
    return chips[np.floor(idx).astype(np.int64)]
