"""Handoff CSV: the scalar->DPE cross-system checkpoint.

Row-keyed CSV carrying receiver fix, file byte offset, per-channel tracking
state and per-channel ephemeris fields. Byte-compatible with the reference
format so our receiver can both consume reference handoffs and produce
handoffs the reference (PyGNSS `load_cudarecv_handoff`, CUDARecv `DPInit`)
would accept.

Parity: reference pygnss/pythonreceiver/receiver.py:804-875 (writer),
receiver.py:129-179 (reader), cudarecv/modules/src/dpinit.cpp:247-400.

The benchmark's frozen copy of navlab_dpe_sdr_tpu_torch/io/handoff.py (host
float64 numpy, no torch): part of the yardstick, which imports nothing of
the program, so that a change to the program cannot move it.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field

import numpy as np

from ..libgnss.ephemeris import ALL_FIELDS, Ephemeris, EphArray

_CHANNEL_ROWS = ("rc", "ri", "fc", "fi", "cp", "cp_timestamp", "TOW")


@dataclass
class Handoff:
    rx_time: float = 0.0
    rx_time_a: float = 0.0
    x_ecef: np.ndarray = field(default_factory=lambda: np.zeros(8))
    bytes_read: int = 0
    prn_list: list = field(default_factory=list)
    rc: np.ndarray = field(default_factory=lambda: np.zeros(0))
    ri: np.ndarray = field(default_factory=lambda: np.zeros(0))
    fc: np.ndarray = field(default_factory=lambda: np.zeros(0))
    fi: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cp: np.ndarray = field(default_factory=lambda: np.zeros(0))
    cp_timestamp: np.ndarray = field(default_factory=lambda: np.zeros(0))
    tow: np.ndarray = field(default_factory=lambda: np.zeros(0))
    eph_fields: dict = field(default_factory=dict)

    def eph_array(self) -> EphArray:
        """Build an EphArray directly from the embedded ephemeris rows."""
        ephs = []
        for i, prn in enumerate(self.prn_list):
            e = Ephemeris(prn=int(prn))
            for name in ALL_FIELDS:
                if name in self.eph_fields:
                    setattr(e, name, float(self.eph_fields[name][i]))
            if "IODE" in self.eph_fields:
                e.IODE = int(self.eph_fields["IODE"][i])
            if "IODC" in self.eph_fields:
                e.IODC = int(self.eph_fields["IODC"][i])
            e.tow_timestamp = float(self.tow[i])
            e.cp_timestamp = float(self.cp_timestamp[i])
            e.complete = True
            ephs.append(e)
        return EphArray(ephs)


def read_handoff(path: str) -> Handoff:
    h = Handoff()
    with open(path, newline="") as fo:
        for row in csv.reader(fo):
            if not row:
                continue
            key, vals = row[0], row[1:]
            if key == "rxTime":
                h.rx_time = float(vals[0])
            elif key == "rxTime_a":
                h.rx_time_a = float(vals[0])
            elif key == "X_ECEF":
                h.x_ecef = np.array([float(v) for v in vals])
            elif key == "bytes_read":
                h.bytes_read = int(vals[0])
            elif key == "prn_list":
                h.prn_list = [int(float(v)) for v in vals]
            elif key in ("rc", "ri", "fc", "fi", "cp", "cp_timestamp"):
                setattr(h, key, np.array([float(v) for v in vals]))
            elif key == "TOW":
                h.tow = np.array([float(v) for v in vals])
            elif key in ("total", "complete"):
                continue
            else:
                try:
                    h.eph_fields[key] = np.array([float(v) for v in vals])
                except ValueError:
                    pass
    return h


def write_handoff(path: str, h: Handoff) -> None:
    with open(path, "w", newline="") as fo:
        w = csv.writer(fo)
        w.writerow(["rxTime", repr(h.rx_time)])
        w.writerow(["rxTime_a", repr(h.rx_time_a)])
        w.writerow(["X_ECEF"] + [repr(float(v)) for v in np.asarray(h.x_ecef).ravel()])
        w.writerow(["bytes_read", h.bytes_read])
        w.writerow(["prn_list"] + [int(p) for p in h.prn_list])
        for key in ("rc", "ri", "fc", "fi", "cp", "cp_timestamp"):
            w.writerow([key] + [repr(float(v)) for v in getattr(h, key)])
        w.writerow(["TOW"] + [repr(float(v)) for v in h.tow])
        for key, vals in h.eph_fields.items():
            w.writerow([key] + [repr(float(v)) for v in vals])
