"""Coordinate frame transforms: ECEF / LLA / ECI / ENU.

Host-side float64 numpy — frame math feeds time-critical scalar bookkeeping
and grid generation, where device f32 precision is insufficient.

Parity: reference pygnss/pythonreceiver/libgnss/utils.py:13-320. The ECI
rotation conventions (including the rotdot velocity terms) are reproduced
exactly, because the DPE measurement model depends on them.

The port's own copy of navlab_dpe_sdr_tpu/libgnss/frames.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from ..constants import OEDot

WGS84_A = 6378137.0
WGS84_INVF = 298.257223563


def ecef_to_lla(pos_ecef: np.ndarray, in_degrees: bool = True) -> np.ndarray:
    """Closed-form ECEF -> geodetic (lat, lon, alt).

    pos_ecef: (3,) or (3, N). Returns array of shape (3,) or (3, N) ordered
    [lat, lon, alt].
    """
    xyz = np.atleast_2d(np.asarray(pos_ecef, dtype=np.float64).T).T
    a = WGS84_A
    f = 1.0 / WGS84_INVF
    b = a * (1.0 - f)
    e2 = (a * a - b * b) / (a * a)
    ep2 = (a * a - b * b) / (b * b)

    x, y, z = xyz[0], xyz[1], xyz[2]
    lon = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    theta = np.arctan2(z * a, p * b)
    st, ct = np.sin(theta), np.cos(theta)
    lat = np.arctan2(z + ep2 * b * st ** 3, p - e2 * a * ct ** 3)
    n = a / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n

    out = np.stack([np.rad2deg(lat) if in_degrees else lat,
                    np.rad2deg(lon) if in_degrees else lon,
                    alt])
    return out[:, 0] if np.ndim(pos_ecef) == 1 else out


def lla_to_ecef(lat_deg, lon_deg, alt) -> np.ndarray:
    """Geodetic (degrees) -> ECEF position. Returns (3,) or (3, N)."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    alt = np.asarray(alt, dtype=np.float64)
    a = WGS84_A
    f = 1.0 / WGS84_INVF
    b = a * (1.0 - f)
    e2 = (a * a - b * b) / (a * a)
    n = a / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    x = (n + alt) * np.cos(lat) * np.cos(lon)
    y = (n + alt) * np.cos(lat) * np.sin(lon)
    z = ((b * b) / (a * a) * n + alt) * np.sin(lat)
    return np.stack([x, y, z])


_ROTDOT = np.array([[0.0, -OEDot, 0.0], [OEDot, 0.0, 0.0], [0.0, 0.0, 0.0]])


def ecef_to_eci(posvel: np.ndarray, t_gps: float, t_c: float) -> np.ndarray:
    """Rotate an 8-state [x y z ct vx vy vz ctdot] from ECEF into the ECI
    frame whose axes coincide with ECEF at t_c.

    posvel: (8,) or (8, N). Velocity gains the earth-rotation term
    rotdot @ rot @ xyz (reference utils.py:173-228).
    """
    pv = np.atleast_2d(np.asarray(posvel, dtype=np.float64).T).T
    otau = OEDot * (t_gps - t_c)
    c, s = np.cos(otau), np.sin(otau)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    out = pv.copy()
    rxyz = rot @ pv[0:3]
    out[0:3] = rxyz
    out[4:7] = rot @ pv[4:7] + _ROTDOT @ rxyz
    return out[:, 0] if np.ndim(posvel) == 1 else out


def ecef_to_eci_batch(posvel: np.ndarray, t_gps: np.ndarray,
                      t_c: float) -> np.ndarray:
    """Vectorized ecef_to_eci over columns with per-column epochs.

    posvel: (8, K); t_gps: (K,). Rotation angle differs per column.
    """
    pv = np.asarray(posvel, dtype=np.float64)
    otau = OEDot * (np.asarray(t_gps, dtype=np.float64) - t_c)
    c, s = np.cos(otau), np.sin(otau)
    out = pv.copy()
    x, y = pv[0], pv[1]
    rx = c * x - s * y
    ry = s * x + c * y
    out[0], out[1] = rx, ry
    vx, vy = pv[4], pv[5]
    rvx = c * vx - s * vy
    rvy = s * vx + c * vy
    out[4] = rvx - OEDot * ry
    out[5] = rvy + OEDot * rx
    return out


def eci_to_ecef(posvel: np.ndarray, t_gps: float, t_c: float) -> np.ndarray:
    """Inverse of ecef_to_eci (reference utils.py:117-170)."""
    pv = np.atleast_2d(np.asarray(posvel, dtype=np.float64).T).T
    otau = OEDot * (t_gps - t_c)
    c, s = np.cos(otau), np.sin(otau)
    rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    out = pv.copy()
    out[0:3] = rot @ pv[0:3]
    out[4:7] = rot @ (pv[4:7] - _ROTDOT @ pv[0:3])
    return out[:, 0] if np.ndim(posvel) == 1 else out


def ecef_to_enu_matrix(ref_ecef: np.ndarray) -> np.ndarray:
    """Rotation matrix R such that ENU = R @ (ECEF - ref)."""
    lat, lon, _ = ecef_to_lla(np.asarray(ref_ecef, dtype=np.float64)[:3],
                              in_degrees=False)
    sl, cl = np.sin(lon), np.cos(lon)
    sp, cp = np.sin(lat), np.cos(lat)
    return np.array([
        [-sl, cl, 0.0],
        [-sp * cl, -sp * sl, cp],
        [cp * cl, cp * sl, sp],
    ])


def ecef_to_enu(ref_ecef: np.ndarray, cur_ecef: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Returns (enu, R_ecef2enu). cur_ecef: (3,) or (3, N) positions."""
    ref = np.asarray(ref_ecef, dtype=np.float64)[:3]
    cur = np.atleast_2d(np.asarray(cur_ecef, dtype=np.float64).T).T[:3]
    r = ecef_to_enu_matrix(ref)
    enu = r @ (cur - ref.reshape(3, 1))
    return (enu[:, 0] if np.ndim(cur_ecef) == 1 else enu), r


def enu_to_ecef(ref_ecef: np.ndarray, d_enu: np.ndarray,
                r_ecef2enu: np.ndarray | None = None) -> np.ndarray:
    """ECEF positions of ENU offsets about ref (reference utils.py:277-301)."""
    ref = np.asarray(ref_ecef, dtype=np.float64)[:3]
    d = np.atleast_2d(np.asarray(d_enu, dtype=np.float64).T).T
    r = ecef_to_enu_matrix(ref) if r_ecef2enu is None else r_ecef2enu
    out = r.T @ d + ref.reshape(3, 1)
    return out[:, 0] if np.ndim(d_enu) == 1 else out


def enu_to_elaz(enu: np.ndarray) -> np.ndarray:
    """ENU offsets -> [elevation, azimuth, distance] (radians, meters)."""
    v = np.atleast_2d(np.asarray(enu, dtype=np.float64).T).T
    e, n, u = v[0], v[1], v[2]
    horz = np.hypot(e, n)
    out = np.stack([np.arctan2(u, horz), np.arctan2(e, n),
                    np.sqrt(e * e + n * n + u * u)])
    return out[:, 0] if np.ndim(enu) == 1 else out
