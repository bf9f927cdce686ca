"""RINEX 2.x GPS navigation-message reader.

Parses every record in the file into `Ephemeris` objects, grouped per PRN.
Offers both the single-record lookup used by the PyGNSS oracle (first record
for a PRN) and the closest-toe selection CUDARecv's channel manager applies
per block (cuchanmgr.cu:276-292).

Parity: reference pygnss/pythonreceiver/libgnss/rinex.py:4-67 and
cudarecv/utils/src/rinexparse.cpp:20-495.

The port's own copy of navlab_dpe_sdr_tpu/libgnss/rinex.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np

from .ephemeris import Ephemeris


def _f(field: str) -> float:
    field = field.strip().replace("D", "E").replace("d", "e")
    return float(field) if field else 0.0


def _epoch_to_tow(yy: int, mm: int, dd: int, hh: int, mi: int, ss: float) -> float:
    """Calendar epoch -> GPS seconds of week (Sunday 00:00 = 0)."""
    year = yy + 2000 if yy < 80 else yy + 1900
    if yy >= 100:
        year = yy
    d = datetime.date(year, mm, dd)
    dow = (d.weekday() + 1) % 7  # Mon=0 -> GPS Sun=0
    return dow * 86400.0 + hh * 3600.0 + mi * 60.0 + ss


@dataclass
class RinexHeader:
    """RINEX 2 nav header fields (reference rinexparse.cpp:88-133)."""
    ion_alpha: np.ndarray | None = None    # Klobuchar alpha [4]
    ion_beta: np.ndarray | None = None     # Klobuchar beta [4]
    delta_utc: tuple | None = None         # (A0, A1, T, W)
    leap_seconds: int | None = None


def read_header(path: str) -> RinexHeader:
    """Parse the nav-file header: ION ALPHA/BETA (Klobuchar, used by
    libgnss.iono), DELTA-UTC A0/A1/T/W, LEAP SECONDS."""
    hdr = RinexHeader()
    with open(path) as fo:
        for ln in fo:
            label = ln[60:].strip()
            if "END OF HEADER" in label:
                break
            body = ln[:60]
            if label == "ION ALPHA":
                hdr.ion_alpha = np.array([_f(body[2 + 12 * k:2 + 12 * (k + 1)])
                                          for k in range(4)])
            elif label == "ION BETA":
                hdr.ion_beta = np.array([_f(body[2 + 12 * k:2 + 12 * (k + 1)])
                                         for k in range(4)])
            elif label == "DELTA-UTC: A0,A1,T,W":
                hdr.delta_utc = (_f(body[3:22]), _f(body[22:41]),
                                 int(body[41:50]), int(body[50:59]))
            elif label == "LEAP SECONDS":
                hdr.leap_seconds = int(body[:6])
    return hdr


def parse_rinex_nav(path: str) -> dict[int, list[Ephemeris]]:
    """Read a RINEX 2 nav file -> {prn: [Ephemeris, ...]} sorted by t_oe."""
    with open(path) as fo:
        lines = fo.read().splitlines()

    # skip header
    body_start = 0
    for i, ln in enumerate(lines):
        if "END OF HEADER" in ln:
            body_start = i + 1
            break

    out: dict[int, list[Ephemeris]] = {}
    i = body_start
    while i + 7 < len(lines):
        hdr = lines[i]
        if not hdr.strip():
            i += 1
            continue
        try:
            prn = int(hdr[0:2])
        except ValueError:
            i += 1
            continue

        rec = lines[i:i + 8]
        i += 8

        vals = []
        for li, ln in enumerate(rec):
            for col in range(3, 79, 19):
                if li == 0 and col < 22:
                    continue
                vals.append(_f(ln[col:col + 19]) if col < len(ln) else 0.0)

        eph = Ephemeris(prn=prn)
        eph.t_oc = _epoch_to_tow(int(hdr[3:5]), int(hdr[6:8]), int(hdr[9:11]),
                                 int(hdr[12:14]), int(hdr[15:17]), _f(hdr[17:22]))
        (eph.a_f0, eph.a_f1, eph.a_f2,
         iode, eph.C_rs, eph.delta_n, eph.M_0,
         eph.C_uc, eph.e, eph.C_us, eph.sqrt_A,
         t_oe, eph.C_ic, eph.OMEGA_0, eph.C_is,
         eph.i_0, eph.C_rc, eph.omega, eph.OMEGADOT,
         eph.IDOT, _codes_l2, weekno, _l2p,
         accuracy, health, eph.T_GD, iodc) = vals[:27]
        eph.IODE = int(iode)
        eph.t_oe = float(t_oe)
        eph.weeknumber = int(weekno)
        eph.accuracy = int(accuracy)
        eph.health = int(health)
        eph.IODC = int(iodc)
        eph.complete = True
        out.setdefault(prn, []).append(eph)

    for prn in out:
        out[prn].sort(key=lambda e: (e.t_oe, e.t_oc))
    return out


def select_ephemeris(records: list[Ephemeris], tow: float) -> Ephemeris:
    """Pick the record with t_oe closest to tow (healthy preferred)."""
    healthy = [e for e in records if e.health == 0] or records
    toes = np.array([e.t_oe for e in healthy])
    return healthy[int(np.argmin(np.abs(toes - tow)))]


def load_ephemerides(path: str, prn_list, tow: float | None = None) -> dict[int, Ephemeris]:
    """Convenience: one Ephemeris per PRN (closest toe if tow given)."""
    table = parse_rinex_nav(path)
    out = {}
    for prn in prn_list:
        recs = table.get(int(prn))
        if not recs:
            raise KeyError(f"PRN {prn} not in {path}")
        out[int(prn)] = (select_ephemeris(recs, tow) if tow is not None
                         else recs[0])
    return out
