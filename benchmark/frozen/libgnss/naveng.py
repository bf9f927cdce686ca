"""Navigation engine: pseudorange formation + iterative least-squares PVT.

Host-side float64. The observation model mirrors the reference exactly:
transmit times are reconstructed from code-period counts (cp) and fractional
code phase (rc) against each channel's ephemeris (TOW, cp) anchor, satellite
positions are rotated into a common ECI frame at the receive epoch, and an
8-state [x y z c*dt vx vy vz c*dtdot] solution is estimated.

Parity: reference pygnss/pythonreceiver/scalar/naveng.py:10-224.

The benchmark's frozen copy of navlab_dpe_sdr_tpu_torch/libgnss/naveng.py
(host float64 numpy, no torch): part of the yardstick, which imports nothing
of the program, so that a change to the program cannot move it.
"""

from __future__ import annotations

import numpy as np

from ..constants import C, F_L1, T_CA, F_CA
from . import frames, satpos
from .ephemeris import EphArray
from .iono import klobuchar_delay_m
from .tropo import tropo_delay_m


def transmit_times(cp: np.ndarray, rc: np.ndarray, eph: EphArray) -> np.ndarray:
    """Per-channel GPS transmit time (nominal, before sat clock correction).

    t_tx = TOW_anchor + (cp - cp_anchor) * T_CA + rc / F_CA
    (reference naveng.py:30-34).
    """
    return (eph.tow_timestamp + (np.asarray(cp) - eph.cp_timestamp) * T_CA
            + np.asarray(rc) / F_CA)


def satellite_positions(cp, rc, eph: EphArray, t_c: float | None = None):
    """Clock-corrected satellite 8-states and corrected transmit times.

    If t_c is given, states are rotated into the ECI frame coincident with
    ECEF at t_c (reference naveng.py:90-130).
    """
    t_tx = transmit_times(cp, rc, eph)
    states_ecef, t_tx_corr = satpos.sat_state_at_transmit(eph, t_tx)
    if t_c is None:
        return states_ecef, t_tx_corr
    states_eci = frames.ecef_to_eci_batch(states_ecef, t_tx_corr, t_c)
    return states_eci, t_tx_corr


def least_squares_pvt(sats_eci: np.ndarray, pseudoranges: np.ndarray,
                      pseudorates: np.ndarray | None = None,
                      x0: np.ndarray | None = None,
                      iterations: int = 10) -> np.ndarray:
    """Iterative LS position/clock then linear LS velocity/drift.

    sats_eci: (8, K). Returns 8-state column-free (8,) vector.
    (reference naveng.py:132-224)
    """
    sat_pos = sats_eci[0:3]
    sat_vel = sats_eci[4:7]
    k = sat_pos.shape[1]

    x = np.zeros(4) if x0 is None else np.asarray(x0, dtype=np.float64).copy()
    for _ in range(iterations):
        dvec = sat_pos - x[0:3, None]
        rng = np.linalg.norm(dvec, axis=0)
        b = pseudoranges - (rng + x[3])
        a = np.concatenate([(-dvec / rng).T, np.ones((k, 1))], axis=1)
        dx, *_ = np.linalg.lstsq(a, b, rcond=None)
        x = x + dx
        if np.linalg.norm(dx) < 1.0e-7:
            break

    out = np.zeros(8)
    out[0:4] = x

    if pseudorates is not None:
        dvec = sat_pos - x[0:3, None]
        rng = np.linalg.norm(dvec, axis=0)
        los = (dvec / rng).T                      # (K, 3) unit LOS
        a = np.concatenate([-los, np.ones((k, 1))], axis=1)
        b = pseudorates - np.einsum("kj,jk->k", los, sat_vel)
        dv, *_ = np.linalg.lstsq(a, b, rcond=None)
        out[4:8] = dv
    return out


def atmospheric_delays_m(rx_pos_ecef, sats_pos, gps_tow: float,
                         ion_alpha=None, ion_beta=None,
                         tropo: bool = False) -> np.ndarray:
    """Per-satellite atmospheric group delays [m] at the receiver.

    rx_pos_ecef: (3,) receiver ECEF position; sats_pos: (3, K) satellite
    positions (ECEF or receive-epoch ECI — the el/az difference is
    negligible); gps_tow: receive time of week. ion_alpha/ion_beta: the
    RINEX header ION ALPHA/BETA coefficients (rinex.read_header;
    reference rinexparse.cpp:88-110) enable the Klobuchar model; tropo
    enables the standard-atmosphere model (reference satpos.py:268-277).
    """
    sats_pos = np.asarray(sats_pos, dtype=np.float64)
    k = sats_pos.shape[1]
    delays = np.zeros(k)
    lla = frames.ecef_to_lla(np.asarray(rx_pos_ecef, dtype=np.float64))
    r_e2n = frames.ecef_to_enu_matrix(np.asarray(rx_pos_ecef))
    enu = r_e2n @ (sats_pos - np.asarray(rx_pos_ecef)[0:3, None])  # (3, K)
    for i in range(k):
        el, az, _ = frames.enu_to_elaz(enu[:, i])
        if ion_alpha is not None and ion_beta is not None:
            delays[i] += klobuchar_delay_m(ion_alpha, ion_beta,
                                           lla[0], lla[1], el, az, gps_tow)
        if tropo:
            delays[i] += tropo_delay_m(el)
    return delays


def calculate_nav_soln(cp, rc, fi, eph: EphArray, doppler_sign: float = 1.0,
                       rx_time0: float | None = None,
                       rx_pos0: np.ndarray | None = None,
                       ion_alpha=None, ion_beta=None, tropo: bool = False):
    """Full scalar navigation solution from channel observables.

    Args:
      cp, rc, fi: per-channel code-period count, code phase (chips) and
        carrier Doppler (Hz) at the measurement epoch.
      eph: EphArray (one entry per channel).
      doppler_sign: rawfile ds (sign convention of fi).
      rx_time0: receive-time initialization; default max(t_tx) + 68 ms.
      rx_pos0: optional (4,) position/clock initialization.
      ion_alpha/ion_beta/tropo: optional atmospheric corrections
        (atmospheric_delays_m) subtracted from the pseudoranges after an
        initial solve fixes the el/az geometry, then the solve is rerun.

    Returns (rx_time_a, rx_time, x_ecef(8,), x_eci(8,), sats_eci(8,K)).
    Parity: reference naveng.py:10-88 (+ the corrections its satpos.py
    carries as dead code).
    """
    cp = np.asarray(cp, dtype=np.float64)
    rc = np.asarray(rc, dtype=np.float64)
    fi = np.asarray(fi, dtype=np.float64)

    t_tx = transmit_times(cp, rc, eph)
    clkb, clkd = satpos.sat_clock_correction(eph, t_tx)
    sats_ecef = satpos.sat_state(eph, t_tx - clkb, clkb, clkd)

    rx_time = (max(t_tx) + 0.068) if rx_time0 is None else rx_time0

    doppler = fi * doppler_sign
    pseudoranges = C * (rx_time - t_tx) + C * sats_ecef[3]
    pseudorates = (-C / F_L1) * doppler + C * sats_ecef[7]

    t_tx_corr = t_tx - sats_ecef[3]

    def rotate_all(t_c):
        s = np.empty_like(sats_ecef)
        for k in range(sats_ecef.shape[1]):
            s[:, k] = frames.ecef_to_eci(sats_ecef[:, k], t_gps=t_tx_corr[k],
                                         t_c=t_c)
        return s

    sats_eci = rotate_all(rx_time)
    x0 = None if rx_pos0 is None else np.asarray(rx_pos0).reshape(-1)[:4]
    x_eci = least_squares_pvt(sats_eci, pseudoranges, pseudorates, x0=x0)

    if (ion_alpha is not None and ion_beta is not None) or tropo:
        # el/az geometry from the uncorrected solve (meters of position
        # error move el/az by microradians — one pass suffices)
        delays = atmospheric_delays_m(x_eci[0:3], sats_eci[0:3], rx_time,
                                      ion_alpha, ion_beta, tropo)
        x_eci = least_squares_pvt(sats_eci, pseudoranges - delays,
                                  pseudorates, x0=x_eci[:4])

    rx_time_a = rx_time - x_eci[3] / C
    x_ecef = frames.eci_to_ecef(x_eci, t_gps=rx_time_a, t_c=rx_time)

    # re-rotate everything into the receiver's own ECI epoch
    x_eci = frames.ecef_to_eci(x_ecef, t_gps=rx_time_a, t_c=rx_time_a)
    sats_eci = rotate_all(rx_time_a)

    return rx_time_a, rx_time, x_ecef, x_eci, sats_eci


def gdop(x_eci: np.ndarray, sats_eci: np.ndarray) -> float:
    """Geometric dilution of precision (reference receiver.py:934-953)."""
    los = sats_eci[0:3] - x_eci[0:3, None]
    los = (los / np.linalg.norm(los, axis=0)).T
    g = np.concatenate([-los, np.ones((los.shape[0], 1))], axis=1)
    h = np.linalg.inv(g.T @ g)
    return float(np.sqrt(np.trace(h)))
