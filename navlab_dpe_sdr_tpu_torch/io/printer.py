"""Navigation output writers: per-fix CSV rows and raw state logs.

Parity: reference pygnss/printer.py:13-71 (GPS time -> UTC, ECEF, LLA rows)
and CUDARecv's XECEFLogger (datalogger.cu / dpeflow.cpp:213).

The port's own copy of navlab_dpe_sdr_tpu/io/printer.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds its rows byte-equal
to that module's.
"""

from __future__ import annotations

import datetime

import numpy as np

from ..libgnss import frames

GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)
GPS_UTC_LEAP_S = 18.0   # leap seconds (2018-era; reference printer.py:100)


def gps_to_utc(weekno: int, tow: float) -> datetime.datetime:
    return GPS_EPOCH + datetime.timedelta(days=weekno * 7,
                                          seconds=tow - GPS_UTC_LEAP_S)


def header(fo):
    fo.write("{0:>7}, {1:>8}, {2:>13},{3:>14}X,{3:>14}Y,{3:>14}Z,"
             "{4:>8}X,{4:>8}Y,{4:>8}Z,".format(
                 "Count#", "Date", "Time", "WGS84_p", "WGS84_v"))
    fo.write("{:>12},{:>12},{:>12}\n".format("Lat", "Lon", "Alt"))


def write_fix(fo, mc: int, weekno: int, rx_time_a: float,
              x_ecef: np.ndarray) -> None:
    """One CSV row: count, UTC date/time, ECEF pos/vel, LLA."""
    x = np.asarray(x_ecef, dtype=np.float64).reshape(8)
    utc = gps_to_utc(weekno, rx_time_a)
    fo.write(f"{mc:7d}, ")
    fo.write(utc.strftime("%Y%m%d, %H%M%S.%f,"))
    fo.write(("%+15.3f," * 3) % tuple(x[0:3]))
    fo.write(("%+9.3f," * 3) % tuple(x[4:7]))
    lla = frames.ecef_to_lla(x[0:3])
    fo.write("%+12.6f,%+12.6f,%+12.3f\n" % (lla[0], lla[1], lla[2]))


class FixWriter:
    """Streamed nav CSV (header + one row per fix)."""

    def __init__(self, path: str, weekno: int):
        self.fo = open(path, "w")
        self.weekno = weekno
        header(self.fo)

    def write(self, fix) -> None:
        write_fix(self.fo, fix.mc, self.weekno, fix.rx_time_a, fix.x_ecef)

    def close(self):
        self.fo.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
