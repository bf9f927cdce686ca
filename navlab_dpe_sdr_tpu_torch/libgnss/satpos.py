"""Broadcast-ephemeris satellite state: Kepler orbit solve, velocity, clock.

Vectorized float64 numpy over satellites and/or times — the full 8-state
[x y z clkb vx vy vz clkd] for K satellites costs a handful of microseconds,
so this stays host-side and feeds the device pipeline as small arrays.

Parity: reference pygnss/pythonreceiver/libgnss/satpos.py:8-198 (Kaplan &
Hegarty position, Remondi/bc_velo velocity, ICD clock model) and
cudarecv/modules/src/cuchanmgr.cu:85-210 (CHM_Get_Sat_Pos device twin).

The port's own copy of navlab_dpe_sdr_tpu/libgnss/satpos.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from ..constants import MU, F_REL, OEDot, PI, HALF_WEEK, SEC_PER_WEEK
from .ephemeris import EphArray, Ephemeris


def correct_week_crossover(t):
    """Wrap time differences into [-302400, 302400] s (half-week)."""
    t = np.where(t > HALF_WEEK, t - SEC_PER_WEEK, t)
    return np.where(t < -HALF_WEEK, t + SEC_PER_WEEK, t)


def _ecc_anomaly(M, e, iters: int = 5):
    """Newton-solve Kepler's equation M = E - e sin E (vectorized).

    GPS eccentricities are < 0.03; Newton from E0 = M converges to <1e-15
    within 4 iterations (quadratic), so 5 matches the reference's
    10-iteration-with-early-exit loop (satpos.py:53-59) at half the host
    cost."""
    E = np.mod(M, 2.0 * PI)
    for _ in range(iters):
        f = M - E + e * np.sin(E)
        dfdE = -1.0 + e * np.cos(E)
        E = np.mod(E - f / dfdE, 2.0 * PI)
    return E


def _fields(eph):
    """View an Ephemeris / EphArray uniformly as broadcastable arrays."""
    return eph


def sat_clock_correction(eph, transmit_time):
    """Satellite clock (bias, drift) in (s, s/s) at nominal transmit time.

    Includes the relativistic term dtr = F e sqrt(A) sin(E) and the group
    delay T_GD (reference satpos.py:132-185).
    """
    e = _fields(eph)
    t = np.asarray(transmit_time, dtype=np.float64)

    a = e.sqrt_A ** 2
    n = np.sqrt(MU / a ** 3) + e.delta_n

    tc = correct_week_crossover(t - e.t_oc)
    clkb = e.a_f2 * tc * tc + e.a_f1 * tc + e.a_f0 - e.T_GD
    tk = correct_week_crossover(t - clkb - e.t_oe)
    E = _ecc_anomaly(np.mod(e.M_0 + n * tk, 2.0 * PI), e.e)
    dtr = F_REL * e.e * e.sqrt_A * np.sin(E)
    tc = t - (clkb + dtr) - e.t_oc
    clkb = e.a_f2 * tc * tc + e.a_f1 * tc + e.a_f0 + dtr - e.T_GD
    clkd = e.a_f1 + 2.0 * e.a_f2 * tc
    return clkb, clkd


def sat_state(eph, ctime, clkb=0.0, clkd=0.0):
    """8-state [x y z clkb vx vy vz clkd] at corrected GPS transmit time.

    eph fields and ctime broadcast together; output shape (8,) + broadcast
    shape. Position per Kaplan & Hegarty p.42, velocity per NGS bc_velo
    (reference satpos.py:8-130).
    """
    e = _fields(eph)
    t = np.asarray(ctime, dtype=np.float64)

    a = e.sqrt_A ** 2
    n = np.sqrt(MU / a ** 3) + e.delta_n
    tk = correct_week_crossover(t - e.t_oe)

    E = _ecc_anomaly(np.mod(e.M_0 + n * tk, 2.0 * PI), e.e)
    sinE, cosE = np.sin(E), np.cos(E)

    v = np.arctan2(np.sqrt(1.0 - e.e ** 2) * sinE / (1.0 - e.e * cosE),
                   (cosE - e.e) / (1.0 - e.e * cosE))
    u = np.mod(v + e.omega, 2.0 * PI)

    cos2u, sin2u = np.cos(2.0 * u), np.sin(2.0 * u)
    d_u = e.C_uc * cos2u + e.C_us * sin2u
    d_r = e.C_rc * cos2u + e.C_rs * sin2u
    d_i = e.C_ic * cos2u + e.C_is * sin2u

    u = u + d_u
    r = a * (1.0 - e.e * cosE) + d_r
    i = e.i_0 + e.IDOT * tk + d_i
    omegak = np.mod(e.OMEGA_0 + (e.OMEGADOT - OEDot) * tk - OEDot * e.t_oe,
                    2.0 * PI)

    x_op, y_op = r * np.cos(u), r * np.sin(u)
    co, so = np.cos(omegak), np.sin(omegak)
    ci, si = np.cos(i), np.sin(i)

    pos = np.stack([
        x_op * co - y_op * so * ci,
        x_op * so + y_op * co * ci,
        y_op * si,
    ])

    # velocity (the 2u harmonics are re-evaluated at the corrected u,
    # matching bc_velo / the reference exactly)
    cos2u, sin2u = np.cos(2.0 * u), np.sin(2.0 * u)
    edot = n / (1.0 - e.e * cosE)
    vdot = sinE * edot * (1.0 + e.e * np.cos(v)) / (np.sin(v) * (1.0 - e.e * cosE))
    udot = vdot + 2.0 * (e.C_us * cos2u - e.C_uc * sin2u) * vdot
    rdot = a * e.e * sinE * edot + 2.0 * (e.C_rs * cos2u - e.C_rc * sin2u) * vdot
    idot = e.IDOT + (e.C_is * cos2u - e.C_ic * sin2u) * 2.0 * vdot

    vx_op = rdot * np.cos(u) - y_op * udot
    vy_op = rdot * np.sin(u) + x_op * udot
    omegadot = e.OMEGADOT - OEDot

    tmpa = vx_op - y_op * ci * omegadot
    tmpb = x_op * omegadot + vy_op * ci - y_op * si * idot

    vel = np.stack([
        tmpa * co - tmpb * so,
        tmpa * so + tmpb * co,
        vy_op * si + y_op * ci * idot,
    ])

    clkb_arr = np.broadcast_to(np.asarray(clkb, dtype=np.float64), t.shape)
    clkd_arr = np.broadcast_to(np.asarray(clkd, dtype=np.float64), t.shape)
    return np.concatenate([pos, clkb_arr[None], vel, clkd_arr[None]], axis=0)


def sat_state_at_transmit(eph, transmit_time):
    """Clock-corrected satellite state and corrected transmit time.

    Computes (clkb, clkd) at nominal transmit time, evaluates the orbit at
    transmit_time - clkb, and returns (state8, transmit_time - clkb) — the
    sequence used by naveng.get_satellite_positions (reference naveng.py:106-118).
    """
    clkb, clkd = sat_clock_correction(eph, transmit_time)
    state = sat_state(eph, np.asarray(transmit_time) - clkb, clkb, clkd)
    return state, np.asarray(transmit_time) - clkb
