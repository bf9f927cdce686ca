"""Broadcast ephemeris containers and navigation-message decoding.

- `Ephemeris`: one satellite's subframe-1/2/3 parameter set (float64 scalars),
  the common currency between the RINEX parser, the nav-bit decoder, the
  Kepler propagator and the handoff file.
- `EphArray`: struct-of-arrays view over a list of Ephemeris for vectorized
  satellite-state computation across channels.
- `Word` / `Subframe` / decoding helpers: IS-GPS-200 LNAV parity checking and
  ephemeris field extraction.

Parity: reference pygnss/pythonreceiver/libgnss/ephemeris.py:16-350 (decode,
scale factors) and cudarecv/utils/inc/ephhelper.h:98-195 (eph_t layout).

The benchmark's frozen copy of navlab_dpe_sdr_tpu_torch/libgnss/ephemeris.py
(host float64 numpy, no torch): part of the yardstick, which imports nothing
of the program, so that a change to the program cannot move it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..constants import PI

CLOCK_FIELDS = ("weeknumber", "accuracy", "health", "T_GD", "t_oc", "a_f2",
                "a_f1", "a_f0")
ORBIT_FIELDS = ("C_rs", "delta_n", "M_0", "C_uc", "e", "C_us", "sqrt_A",
                "t_oe", "C_ic", "OMEGA_0", "C_is", "i_0", "C_rc", "omega",
                "OMEGADOT", "IDOT")
ALL_FIELDS = CLOCK_FIELDS + ORBIT_FIELDS


@dataclass
class Ephemeris:
    """One GPS LNAV ephemeris data set for a single PRN."""
    prn: int = 0
    # clock (subframe 1)
    weeknumber: int = 0
    accuracy: int = 0
    health: int = 0
    T_GD: float = 0.0
    t_oc: float = 0.0
    a_f2: float = 0.0
    a_f1: float = 0.0
    a_f0: float = 0.0
    # orbit (subframes 2/3)
    C_rs: float = 0.0
    delta_n: float = 0.0
    M_0: float = 0.0
    C_uc: float = 0.0
    e: float = 0.0
    C_us: float = 0.0
    sqrt_A: float = 0.0
    t_oe: float = 0.0
    C_ic: float = 0.0
    OMEGA_0: float = 0.0
    C_is: float = 0.0
    i_0: float = 0.0
    C_rc: float = 0.0
    omega: float = 0.0
    OMEGADOT: float = 0.0
    IDOT: float = 0.0
    IODE: int = 0
    IODC: int = 0
    # receiver-local timestamp: code-period index `cp` at time-of-week `TOW`
    # (the cross-system anchor carried in the handoff CSV).
    tow_timestamp: float = 0.0
    cp_timestamp: float = 0.0
    complete: bool = False

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


class EphArray:
    """Struct-of-arrays over K Ephemeris objects (fields become float64[K])."""

    def __init__(self, ephs: list[Ephemeris]):
        self.ephs = list(ephs)
        self.prn = np.array([e.prn for e in ephs], dtype=np.int64)
        for name in ALL_FIELDS:
            setattr(self, name,
                    np.array([getattr(e, name) for e in ephs], dtype=np.float64))
        self.tow_timestamp = np.array([e.tow_timestamp for e in ephs])
        self.cp_timestamp = np.array([e.cp_timestamp for e in ephs])

    def __len__(self) -> int:
        return len(self.ephs)


def _week_wrap(dt: np.ndarray | float):
    """Signed seconds-of-week difference (cuchanmgr.cu:26-31)."""
    return np.mod(np.asarray(dt) + 302400.0, 604800.0) - 302400.0


class EphManager:
    """Per-block ephemeris-set selection over all parsed nav records.

    CUDARecv holds a vector<ephSet_t> on device and re-selects the
    closest-toe, valid (healthy, within fit interval) set per block per
    PRN (cuchanmgr.cu:240-306; grouping rinexparse.cpp:20-58); a run
    spanning an ephemeris cutover must pick up the fresh orbits without a
    fix glitch. The receiver-local decode anchors (tow/cp_timestamp) are
    channel state, not orbit state, so they are preserved across set
    switches.
    """

    def __init__(self, table: dict[int, list[Ephemeris]], prn_list,
                 fit_interval_s: float = 7200.0, slop_s: float = 1800.0):
        self.prn_list = [int(p) for p in prn_list]
        self.table = {}
        for p in self.prn_list:
            recs = table.get(p)
            if not recs:
                raise KeyError(f"no ephemeris records for PRN {p}")
            self.table[p] = sorted(recs, key=lambda e: (e.t_oe, e.t_oc))
        self.fit_s = float(fit_interval_s) + float(slop_s)
        self._anchor_tow = np.zeros(len(self.prn_list))
        self._anchor_cp = np.zeros(len(self.prn_list))
        self.current_idx: list[int] | None = None

    def set_anchors(self, tow_timestamp, cp_timestamp) -> None:
        """Channel decode anchors (from the handoff / bit sync), carried
        onto every EphArray this manager builds."""
        self._anchor_tow = np.asarray(tow_timestamp, dtype=np.float64).copy()
        self._anchor_cp = np.asarray(cp_timestamp, dtype=np.float64).copy()

    def _pick(self, recs: list[Ephemeris], tow: float) -> int:
        dts = np.abs(_week_wrap(np.array([e.t_oe for e in recs]) - tow))
        order = [(not (e.health == 0 and dts[i] <= self.fit_s),  # valid first
                  e.health != 0,                                 # healthy next
                  dts[i], i) for i, e in enumerate(recs)]
        return min(order)[3]

    def select(self, tow: float) -> tuple["EphArray", bool]:
        """(EphArray for time-of-week `tow`, whether selection changed)."""
        idx = [self._pick(self.table[p], tow) for p in self.prn_list]
        changed = idx != self.current_idx
        self.current_idx = idx
        ephs = []
        for k, (p, i) in enumerate(zip(self.prn_list, idx)):
            e = dataclasses.replace(self.table[p][i])
            e.tow_timestamp = float(self._anchor_tow[k])
            e.cp_timestamp = float(self._anchor_cp[k])
            ephs.append(e)
        return EphArray(ephs), changed


# ---------------------------------------------------------------------------
# LNAV word / subframe decoding (IS-GPS-200 sections 20.3.2 - 20.3.3).
# ---------------------------------------------------------------------------

# Parity equations for bits D25..D30 over d1..d24 (IS-GPS-200 Table 20-XIV).
PARITY_MAT = np.array([
    [1,1,1,0,1,1,0,0,0,1,1,1,1,1,0,0,1,1,0,1,0,0,1,0],
    [0,1,1,1,0,1,1,0,0,0,1,1,1,1,1,0,0,1,1,0,1,0,0,1],
    [1,0,1,1,1,0,1,1,0,0,0,1,1,1,1,1,0,0,1,1,0,1,0,0],
    [0,1,0,1,1,1,0,1,1,0,0,0,1,1,1,1,1,0,0,1,1,0,1,0],
    [1,0,1,0,1,1,1,0,1,1,0,0,0,1,1,1,1,1,0,0,1,1,0,1],
    [0,0,1,0,1,1,0,1,1,1,1,0,1,0,1,0,0,0,1,0,0,1,1,1],
])

TLM_PREAMBLE = np.array([-1, 1, 1, 1, -1, 1, -1, -1])  # 10001011 in +/-1 (inverted)


def check_word_parity(bits_pm: np.ndarray, d29: int, d30: int) -> bool:
    """Parity-check one 30-bit word given previous word's D29*, D30*.

    bits_pm: 30 values over {-1,+1} in received polarity.
    """
    dstar = np.array([d29, d30, d29, d30, d30, d29])
    p = d30 * PARITY_MAT * bits_pm[0:24]
    parities = np.prod(np.where(p == 0, 1, p), axis=1) * dstar
    return bool(np.all(parities == bits_pm[24:30]))


def word_data_bits(bits_pm: np.ndarray, d30_prev: int) -> np.ndarray:
    """Source data bits (0/1) of one word after polarity removal.

    The data bits d1..d30 are recovered as: bit k = 1 where
    d30_prev * received == -1 (reference ephemeris.py:58-60).
    """
    return np.where(d30_prev * bits_pm == -1, 1, 0).astype(np.int64)


def _bits_to_int(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _bits_to_int_signed(bits: np.ndarray) -> int:
    v = _bits_to_int(bits)
    if bits[0]:
        v -= 1 << len(bits)
    return v


_2_P4 = 2.0 ** 4
_2_N5 = 2.0 ** -5
_2_N19 = 2.0 ** -19
_2_N29 = 2.0 ** -29
_2_N31 = 2.0 ** -31
_2_N33 = 2.0 ** -33
_2_N43 = 2.0 ** -43
_2_N55 = 2.0 ** -55


def decode_subframe(data_bits: np.ndarray) -> dict:
    """Decode one 300-bit subframe (0/1 source bits, words concatenated).

    Returns a dict with 'id', 'TOW' (seconds at subframe start) and the
    ephemeris fields carried by subframes 1-3 (scale factors per IS-GPS-200
    20.3.3.3/20.3.3.4; reference ephemeris.py:108-191).
    """
    w = data_bits.reshape(10, 30)
    out: dict = {}
    out["id"] = _bits_to_int(w[1][19:22])
    out["TOW"] = _bits_to_int(w[1][0:17]) * 6 - 6

    sid = out["id"]
    if sid == 1:
        out["IODC"] = _bits_to_int(np.concatenate([w[2][22:24], w[7][0:8]]))
        out["IODE"] = _bits_to_int(w[7][0:8])
        out["weeknumber"] = _bits_to_int(w[2][0:10]) + 1024
        out["accuracy"] = _bits_to_int(w[2][12:16])
        out["health"] = int(w[2][16])
        out["T_GD"] = _bits_to_int_signed(w[6][16:24]) * _2_N31
        out["t_oc"] = _bits_to_int(w[7][8:24]) * _2_P4
        out["a_f2"] = _bits_to_int_signed(w[8][0:8]) * _2_N55
        out["a_f1"] = _bits_to_int_signed(w[8][8:24]) * _2_N43
        out["a_f0"] = _bits_to_int_signed(w[9][0:22]) * _2_N31
    elif sid == 2:
        out["IODE"] = _bits_to_int(w[2][0:8])
        out["C_rs"] = _bits_to_int_signed(w[2][8:24]) * _2_N5
        out["delta_n"] = _bits_to_int_signed(w[3][0:16]) * _2_N43 * PI
        out["M_0"] = _bits_to_int_signed(np.concatenate([w[3][16:24], w[4][0:24]])) * _2_N31 * PI
        out["C_uc"] = _bits_to_int_signed(w[5][0:16]) * _2_N29
        out["e"] = _bits_to_int(np.concatenate([w[5][16:24], w[6][0:24]])) * _2_N33
        out["C_us"] = _bits_to_int_signed(w[7][0:16]) * _2_N29
        out["sqrt_A"] = _bits_to_int(np.concatenate([w[7][16:24], w[8][0:24]])) * _2_N19
        out["t_oe"] = _bits_to_int(w[9][0:16]) * _2_P4
    elif sid == 3:
        out["IODE"] = _bits_to_int(w[9][0:8])
        out["C_ic"] = _bits_to_int_signed(w[2][0:16]) * _2_N29
        out["OMEGA_0"] = _bits_to_int_signed(np.concatenate([w[2][16:24], w[3][0:24]])) * _2_N31 * PI
        out["C_is"] = _bits_to_int_signed(w[4][0:16]) * _2_N29
        out["i_0"] = _bits_to_int_signed(np.concatenate([w[4][16:24], w[5][0:24]])) * _2_N31 * PI
        out["C_rc"] = _bits_to_int_signed(w[6][0:16]) * _2_N5
        out["omega"] = _bits_to_int_signed(np.concatenate([w[6][16:24], w[7][0:24]])) * _2_N31 * PI
        out["OMEGADOT"] = _bits_to_int_signed(w[8][0:24]) * _2_N43 * PI
        out["IDOT"] = _bits_to_int_signed(w[9][8:22]) * _2_N43 * PI
    return out


def assemble_ephemeris(prn: int, subframe_dicts: list[dict],
                       cp_of_subframe: list[float]) -> Ephemeris:
    """Merge decoded subframes 1-3 (consistent IODE) into an Ephemeris.

    cp_of_subframe: receiver code-period index at the start of each subframe;
    the (TOW, cp) pair of the first decoded subframe becomes the channel's
    time anchor.
    """
    eph = Ephemeris(prn=prn)
    iode = None
    nset = 0
    for sf, cp in zip(subframe_dicts, cp_of_subframe):
        sid = sf.get("id")
        if sid not in (1, 2, 3):
            continue
        if iode is None and "IODE" in sf:
            iode = sf["IODE"]
        if sf.get("IODE") != iode:
            continue
        if nset == 0:
            eph.tow_timestamp = float(sf["TOW"])
            eph.cp_timestamp = float(cp)
        for key, val in sf.items():
            if key in ALL_FIELDS or key in ("IODE", "IODC"):
                setattr(eph, key, val)
        nset += 1
    eph.complete = nset >= 3
    return eph
