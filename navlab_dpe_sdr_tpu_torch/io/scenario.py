"""Self-contained test/bench scenarios: synthetic GPS constellation +
matching handoff initialization.

Builds a plausible 31-satellite constellation from nominal orbital elements,
selects satellites visible from a given site, and derives the exact handoff
state (per-channel code phase / Doppler / cp anchors and the receiver fix)
for a capture started at a chosen epoch — so benchmarks and tests can run
with zero external data.

The port's own copy of navlab_dpe_sdr_tpu/io/scenario.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from ..constants import C, F_CA, F_L1, T_CA, PI
from ..libgnss import frames, satpos
from ..libgnss.ephemeris import EphArray, Ephemeris
from .handoff import Handoff
from .synth import CaptureSimulator


def nominal_constellation(weeknumber: int = 2008, toe: float = 345600.0):
    """31 GPS satellites on nominal near-circular orbits (6 planes)."""
    ephs = []
    prn = 1
    for plane in range(6):
        for slot in range(6):
            if prn > 31:
                break
            e = Ephemeris(prn=prn)
            e.sqrt_A = 5153.7 + 0.01 * plane
            e.e = 0.003 + 0.001 * (slot % 3)
            e.i_0 = 0.9598 + 0.002 * ((plane + slot) % 3)   # ~55 deg
            e.OMEGA_0 = -PI + plane * (PI / 3.0) + 0.05 * slot
            e.omega = 0.4 * slot
            # stagger mean anomalies across planes (Walker-like phasing)
            e.M_0 = np.mod(slot * (2.0 * PI / 6.0) + plane * (PI / 9.0)
                           + PI, 2.0 * PI) - PI
            e.t_oe = toe
            e.t_oc = toe
            e.OMEGADOT = -8.0e-9
            e.IDOT = 2.0e-11 * (1 if slot % 2 else -1)
            e.delta_n = 4.5e-9
            e.C_rs = 25.0 - 3.0 * slot
            e.C_rc = 240.0 + 5.0 * plane
            e.C_uc = 1.2e-6 * (slot - 2)
            e.C_us = 7.5e-6
            e.C_ic = 6.0e-8 * (plane - 2)
            e.C_is = -4.0e-8
            e.a_f0 = 1e-4 * (slot - 2.5) / 2.5
            e.a_f1 = 2.0e-12 * (plane - 2.5)
            e.a_f2 = 0.0
            e.T_GD = 1.0e-8 * (slot - 3)
            e.IODE = 10 + prn
            e.IODC = 10 + prn
            e.weeknumber = weeknumber
            e.complete = True
            ephs.append(e)
            prn += 1
    return ephs


def visible_satellites(ephs, rx_ecef: np.ndarray, tow: float,
                       min_elev_deg: float = 15.0, n: int = 8):
    """Pick the n highest satellites above the elevation mask."""
    elevs = []
    for e in ephs:
        s = satpos.sat_state(e, np.array([tow]))[:, 0]
        enu, _ = frames.ecef_to_enu(rx_ecef[:3], s[0:3])
        el = frames.enu_to_elaz(enu)[0]
        elevs.append(np.rad2deg(el))
    order = np.argsort(elevs)[::-1]
    chosen = [ephs[i] for i in order[:n] if elevs[i] > min_elev_deg]
    return chosen


def make_scenario(n_sats: int = 8, tow0: float = 345600.0 + 120.0,
                  lat: float = 40.112, lon: float = -88.228,
                  alt: float = 200.0, cn0_dbhz: float = 47.0,
                  fs: float = 2.5e6, seed: int = 7,
                  nav_data: bool = True, min_elev_deg: float = 15.0):
    """Returns (CaptureSimulator, Handoff, EphArray) — a ready-to-run DPE
    scenario with exact initialization at capture sample 0.

    n_sats > 8: pick a later tow0 / lower min_elev_deg so enough
    satellites clear the mask (the default epoch sees 11 above 15 deg;
    tow0 += 3600 with a 10 deg mask sees 12 — the C>8 scaling scenario,
    reference batch=numChan generic too, batchcorrscores.cu:1016-1028)."""
    rx_pos = frames.lla_to_ecef(lat, lon, alt)
    rx_state = np.concatenate([rx_pos, np.zeros(5)])

    all_ephs = nominal_constellation(toe=tow0 - 120.0 + 7200.0 * 0)
    chosen = visible_satellites(all_ephs, rx_state, tow0, n=n_sats,
                                min_elev_deg=min_elev_deg)
    assert len(chosen) == n_sats, f"only {len(chosen)} visible"
    # anchor subframes: pretend decode produced (TOW, cp) at a recent 6 s
    # boundary; cp counts are receiver-local
    arr = EphArray(chosen)

    sim = CaptureSimulator(arr, rx_state, tow0=tow0, fs=fs,
                           cn0_dbhz=cn0_dbhz, nav_data=nav_data, seed=seed)
    _, truth = sim.generate(4, return_truth=True)

    hand = Handoff()
    k = len(chosen)
    hand.prn_list = [e.prn for e in chosen]
    hand.rc = np.zeros(k)
    hand.ri = np.zeros(k)
    hand.fc = np.zeros(k)
    hand.fi = np.zeros(k)
    hand.cp = np.full(k, 1000.0)
    hand.cp_timestamp = np.zeros(k)
    hand.tow = np.zeros(k)
    for i, ch in enumerate(truth.channels):
        t_sv0 = ch.t_sv_nodes[0]
        ms_total = np.floor(t_sv0 / T_CA)
        hand.rc[i] = (t_sv0 - ms_total * T_CA) * F_CA
        hand.fi[i] = ch.doppler0
        hand.fc[i] = F_CA * (1.0 + ch.doppler0 / F_L1)
        hand.ri[i] = 0.0
        tow_anchor = np.floor(t_sv0)  # integer second
        eph = chosen[i]
        eph.tow_timestamp = tow_anchor
        eph.cp_timestamp = hand.cp[i] - (ms_total - tow_anchor * 1000.0)
        hand.tow[i] = tow_anchor
        hand.cp_timestamp[i] = eph.cp_timestamp

    arr = EphArray(chosen)  # rebuild so anchors are captured
    hand.x_ecef = rx_state.copy()
    hand.rx_time = tow0
    hand.rx_time_a = tow0
    hand.bytes_read = 0
    from ..libgnss.ephemeris import ALL_FIELDS
    for name in ALL_FIELDS + ("IODE", "IODC"):
        hand.eph_fields[name] = np.array(
            [getattr(e, name) for e in chosen], dtype=np.float64)
    return sim, hand, arr
