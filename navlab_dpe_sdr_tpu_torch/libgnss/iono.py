"""Klobuchar ionospheric delay model (IS-GPS-200 20.3.3.5.2.5).

The reference ships this as dead code (pygnss satpos.py:199-277, never
called) and parses the coefficients in rinexparse.cpp:88-110; here the
model is live: coefficients come from the RINEX header
(`rinex.read_header`) and the correction applies to pseudoranges in two
places — `naveng.calculate_nav_soln(..., ion_alpha, ion_beta)` subtracts
it from the LS observables (via `naveng.atmospheric_delays_m`), and
`models.dpe.DPEConfig.ion_alpha/ion_beta` adds it to every modeled
pseudorange in the DPE channel back-calculation.

All angles in the standard's semicircle units internally; the public API
takes radians/degrees as documented.

The port's own copy of navlab_dpe_sdr_tpu/libgnss/iono.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from ..constants import C


def klobuchar_delay(alpha, beta, lat_deg: float, lon_deg: float,
                    el_rad: float, az_rad: float, gps_tow: float) -> float:
    """Ionospheric group delay [s] for one satellite line of sight.

    alpha/beta: the 4 ION ALPHA / ION BETA coefficients; lat/lon: user
    geodetic position [deg]; el/az: satellite elevation/azimuth [rad];
    gps_tow: GPS time of week [s].
    """
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    e_sc = el_rad / np.pi                 # semicircles
    phi_u = lat_deg / 180.0
    lam_u = lon_deg / 180.0

    psi = 0.0137 / (e_sc + 0.11) - 0.022
    phi_i = np.clip(phi_u + psi * np.cos(az_rad), -0.416, 0.416)
    lam_i = lam_u + psi * np.sin(az_rad) / np.cos(phi_i * np.pi)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)

    t = 4.32e4 * lam_i + gps_tow
    t = np.mod(t, 86400.0)

    f_obliq = 1.0 + 16.0 * (0.53 - e_sc) ** 3
    per = np.polyval(beta[::-1], phi_m)
    per = max(per, 72000.0)
    amp = np.polyval(alpha[::-1], phi_m)
    amp = max(amp, 0.0)

    x = 2.0 * np.pi * (t - 50400.0) / per
    if abs(x) < 1.57:
        return f_obliq * (5e-9 + amp * (1.0 - x * x / 2.0 + x ** 4 / 24.0))
    return f_obliq * 5e-9


def klobuchar_delay_m(alpha, beta, lat_deg, lon_deg, el_rad, az_rad,
                      gps_tow) -> float:
    """Klobuchar delay in meters of pseudorange."""
    return C * klobuchar_delay(alpha, beta, lat_deg, lon_deg, el_rad,
                               az_rad, gps_tow)
