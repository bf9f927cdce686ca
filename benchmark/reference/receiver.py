"""The plain reference of the DPE receiver's host side (float64 numpy).

What the receiver derives on the host from its state before each block,
worked out again: the channel prediction to the block's end, the manifold
geometry that the device scores against, the measurement update of the
alpha EKF and the steering of the channel frequencies from the new state.
The formulas follow navlab_dpe_sdr_tpu_torch/models/dpe.py, written block
by block (the receiver's batched preparation vectorizes the same algebra
over the batch), on the benchmark's frozen copies of the orbit, frame and
cache modules. Nothing here imports the program.

A `RefReceiver` holds only the state the receiver carries from block to
block (`STATE`). `load(snapshot)` puts a snapshot of the program's receiver
in it, so the reference can follow the program step by step: from the
program's state before an operation it computes what the operation should
leave, and what it should hand the device.

`round_to` = np.float32 makes the control: every state and every output
of an operation rounded to float32, the precision below the float64 that
the configuration states for the host.
"""

from __future__ import annotations

import numpy as np

from ..frozen.constants import C, F_CA, F_L1, L_CA, T_CA
from ..frozen.libgnss import frames, naveng
from ..frozen.libgnss.satcache import SatStateCache

# the state a receiver carries from block to block, as the harness
# snapshots it from the program's receiver
STATE = ("x", "rc", "ri", "fc", "fi", "cp", "rx_time", "rx_time_a", "mc")


class RefReceiver:
    def __init__(self, eph, fs: float, T: float, code_win: int,
                 carr_win: int, alpha: float, round_to=None):
        self.eph = eph
        self.fs = float(fs)
        self.T = float(T)
        self.S = int(round(T * fs))
        self.carr_fftpts = 8 * (1 << self.S.bit_length())
        self.fcaid = F_CA / F_L1
        self.code_win = int(code_win)
        self.carr_win = int(carr_win)
        self.alpha = float(alpha)
        self.round_to = round_to
        self.cache = None

    # -- state ----------------------------------------------------------------

    def load(self, snap: dict) -> None:
        for k in STATE:
            v = snap[k]
            setattr(self, k, np.array(v, dtype=np.float64) if np.ndim(v)
                    else float(v))
        self.mc = int(snap["mc"])
        self._round()

    def snapshot(self) -> dict:
        return {k: (np.array(getattr(self, k)) if np.ndim(getattr(self, k))
                    else getattr(self, k)) for k in STATE}

    def _round(self) -> None:
        if self.round_to is None:
            return
        for k in STATE[:-1]:
            v = getattr(self, k)
            r = np.asarray(v).astype(self.round_to).astype(np.float64)
            setattr(self, k, r if np.ndim(v) else float(r))

    def start_cache(self, t_tx) -> None:
        """The satellite-state cache, started where the receiver starts it:
        at its first satellite-state lookup, from the earliest transmit
        time of that lookup."""
        self.cache = SatStateCache(self.eph, float(np.min(t_tx)))

    # -- helpers (models/dpe.py, per block) -----------------------------------

    def _sat_states(self, t_tx):
        if self.cache is None:
            self.start_cache(t_tx)
        s8 = self.cache.state_at(t_tx)
        return s8, t_tx - s8[3]

    def _x_eci(self):
        return frames.ecef_to_eci(self.x, t_gps=self.rx_time_a,
                                  t_c=self.rx_time_a)

    def _sats_now(self):
        t_tx = naveng.transmit_times(self.cp, self.rc, self.eph)
        s, t_c = self._sat_states(t_tx)
        return frames.ecef_to_eci_batch(s, t_c, self.rx_time_a)

    def _idx_next_bit(self):
        cp_since = np.mod(self.cp - self.eph.cp_timestamp, 20.0)
        idx = (np.floor((L_CA * (20.0 - cp_since) - self.rc)
                        * (self.fs / self.fc)).astype(np.int64) + 1)
        return np.where((idx > 0) & (idx < self.S), idx, self.S)

    def _predict_channels(self):
        T = self.T
        cp_pred = self.cp + np.floor((self.rc + self.fc * T) / L_CA)
        rc_pred = np.mod(self.rc + self.fc * T, L_CA)
        x_eci = self._x_eci()
        t_tx = (self.eph.tow_timestamp
                + T_CA * (cp_pred - self.eph.cp_timestamp) + rc_pred / F_CA)
        s, t_c = self._sat_states(t_tx)
        sats = frames.ecef_to_eci_batch(s, t_c, self.rx_time_a)
        rng = np.linalg.norm(sats[0:3] - x_eci[0:3, None], axis=0)
        bc_tt = self.rx_time - (rng + x_eci[3] - C * sats[3]) / C
        bc_rc = (bc_tt - self.eph.tow_timestamp
                 - T_CA * (self.cp - self.eph.cp_timestamp)) * F_CA
        self.cp = np.floor(bc_rc / L_CA) + self.cp
        self.rc = np.mod(bc_rc, L_CA)
        self.ri = np.mod(self.ri + self.fi * T, 1.0)

    def _steer(self):
        """Channel frequencies from the current state (the receiver's
        `_update_channels_from_state`)."""
        sats = self._sats_now()
        x_eci = self._x_eci()
        dvec = sats[0:3] - x_eci[0:3, None]
        r0 = np.linalg.norm(dvec, axis=0)
        los = dvec / r0
        losrr = np.sum(los * (x_eci[4:7, None] - sats[4:7]), axis=0)
        self.fi = -F_L1 / C * (-losrr + x_eci[7] - C * sats[7])
        bc_tt = self.rx_time - (r0 + x_eci[3] - C * sats[3]) / C
        bc_rc = (bc_tt - self.eph.tow_timestamp
                 - T_CA * (self.cp - self.eph.cp_timestamp)) * F_CA
        self.fc = F_CA + self.fcaid * self.fi + (bc_rc - self.rc) / self.T

    def _geometry(self):
        """Per-channel scoring geometry at the current epoch (the receiver's
        `_manifold_params`): (los_enu [C, 3], r0, pos_idx_c, pos_coef,
        vel_idx_c, vel_coef, r_e2n)."""
        sats = self._sats_now()
        x_eci = self._x_eci()
        dvec = sats[0:3] - x_eci[0:3, None]
        r0 = np.linalg.norm(dvec, axis=0)
        los = dvec / r0
        r_e2n = frames.ecef_to_enu_matrix(self.x[0:3])
        los_enu = (r_e2n @ los).T
        bc_tt = self.rx_time - (r0 + x_eci[3] - C * sats[3]) / C
        bc_rc0 = (bc_tt - self.eph.tow_timestamp
                  - T_CA * (self.cp - self.eph.cp_timestamp)) * F_CA - self.rc
        pos_idx_c = (self.fs / self.fc) * (-bc_rc0) + self.S / 2.0
        pos_coef = (self.fs / self.fc) * (F_CA / C)
        losrr = np.sum(los * (x_eci[4:7, None] - sats[4:7]), axis=0)
        bc_fi = -F_L1 / C * (-losrr + x_eci[7] - C * sats[7])
        vel_idx_c = ((self.carr_fftpts / self.fs) * (bc_fi - self.fi)
                     + self.carr_fftpts / 2.0)
        vel_coef = np.full(len(self.rc),
                           -(self.carr_fftpts / self.fs) * F_L1 / C)
        return los_enu, r0, pos_idx_c, pos_coef, vel_idx_c, vel_coef, r_e2n

    def _pack(self, rc_mid, fi, ri, idx_next, geo):
        los_enu, r0, pos_c, pos_k, vel_c, vel_k, _ = geo
        pos_start = np.clip(np.round(pos_c).astype(np.int64)
                            - self.code_win // 2, 0, self.S - self.code_win)
        vel_start = np.clip(np.round(vel_c).astype(np.int64)
                            - self.carr_win // 2, 0,
                            self.carr_fftpts - self.carr_win)
        fpk = np.stack([rc_mid, fi.astype(np.float32), ri.astype(np.float32),
                        los_enu[:, 0], los_enu[:, 1], los_enu[:, 2], r0,
                        pos_c - pos_start, pos_k, vel_c - vel_start,
                        vel_k]).astype(np.float32)                # [11, C]
        ipk = np.stack([idx_next, pos_start, vel_start]).astype(np.int64)
        return fpk, ipk

    def _time_update(self):
        self.rx_time += self.T
        self.rx_time_a = self.rx_time - self.x[3] / C

    # -- operations -----------------------------------------------------------

    def prepare_block(self):
        """One block of the batched mode: time update, channel prediction,
        steering from the frozen state, geometry. Returns (fpk [11, C] f32,
        ipk [3, C] int, r_e2n, rx_time, mc, x_pred)."""
        self._time_update()
        rc_mid = np.mod(self.rc + (self.fc - F_CA) * (self.T / 2.0), L_CA)
        fi, ri = self.fi.copy(), self.ri.copy()
        idx_next = self._idx_next_bit()
        self._predict_channels()
        self.mc += 1
        self._steer()
        geo = self._geometry()
        fpk, ipk = self._pack(rc_mid, fi, ri, idx_next, geo)
        out = (fpk, ipk, geo[6], self.rx_time, self.mc, self.x.copy())
        self._round()
        return out

    def prepare_batch(self, n: int):
        return [self.prepare_block() for _ in range(n)]

    def step_prepare(self):
        """The per-block step's host side up to the device call: time
        update, channel prediction, geometry. Returns (fpk, ipk, r_e2n)."""
        self._time_update()
        rc_mid = np.mod(self.rc + (self.fc - F_CA) * (self.T / 2.0), L_CA)
        fi, ri = self.fi.copy(), self.ri.copy()
        idx_next = self._idx_next_bit()
        self._predict_channels()
        self.mc += 1
        geo = self._geometry()
        fpk, ipk = self._pack(rc_mid, fi, ri, idx_next, geo)
        self._round()
        return fpk, ipk, geo[6]

    def measure(self, x_pred, r_e2n, dp4, dv4):
        """The alpha EKF's update with the grid offsets (dp4 ENU + clock,
        dv4 ENU + drift) about the prediction x_pred. Returns the fix."""
        z = np.asarray(x_pred, dtype=np.float64).copy()
        z[0:3] += r_e2n.T @ dp4[0:3]
        z[3] += dp4[3]
        z[4:7] += r_e2n.T @ dv4[0:3]
        z[7] += dv4[3]
        self.x = self.x + self.alpha * (z - self.x)
        self._round()
        return self.x.copy()

    def drain(self, preps, cells, grid, group_k: int = 1):
        """The measurements of one batched dispatch: for each row (one a
        block, or one a group of group_k referenced to its last block) the
        update with the grid cells (pa, va) the scorer chose, then the
        steering from the newest state. Returns the fixes [rows, 8]."""
        fixes = []
        for i, (pa, va) in enumerate(cells):
            fpk, _, r_e2n, rx_time, mc, x_pred = preps[(i + 1) * group_k - 1]
            dp4, dv4 = grid_offsets(grid, pa, va)
            fixes.append(self.measure(x_pred, r_e2n, dp4, dv4))
        self.rx_time_a = self.rx_time - self.x[3] / C
        self._steer()
        self._round()
        return np.array(fixes)

    def step_finish(self, r_e2n, cell, grid):
        """The per-block step after the device: the update about the
        current state with the chosen cells, then the steering."""
        dp4, dv4 = grid_offsets(grid, *cell)
        fix = self.measure(self.x.copy(), r_e2n, dp4, dv4)
        self.rx_time_a = self.rx_time - self.x[3] / C
        self._steer()
        self._round()
        return fix


def grid_offsets(grid, pa: int, va: int):
    return (np.concatenate([grid.d_enu[pa], [grid.dt_m[pa]]]),
            np.concatenate([grid.dv_enu[va], [grid.dtdot[va]]]))


def state_gap_m(a: dict, b: dict) -> float:
    """The largest difference between two receiver states, in metres: the
    EKF state (position and clock in m, velocity and drift in m/s, taken as
    the metres they move in a second), the code phase (chips of the code
    periods and the phase within one, at C / F_CA metres a chip), the
    carrier phase and frequencies (at the L1 wavelength) and the time."""
    lam = C / F_L1
    chip = C / F_CA
    terms = [np.abs(np.asarray(a["x"]) - np.asarray(b["x"])),
             np.abs((np.asarray(a["cp"]) - np.asarray(b["cp"])) * L_CA
                    + np.asarray(a["rc"]) - np.asarray(b["rc"])) * chip,
             np.abs(np.asarray(a["fc"]) - np.asarray(b["fc"])) * chip,
             np.abs(np.asarray(a["fi"]) - np.asarray(b["fi"])) * lam,
             np.abs(np.mod(np.asarray(a["ri"]) - np.asarray(b["ri"]) + 0.5,
                           1.0) - 0.5) * lam,
             np.abs([a["rx_time"] - b["rx_time"]]) * C,
             np.abs([float(a["mc"] != b["mc"])]) * 1e9]
    return float(max(np.max(t) for t in terms))


def auto_windows(d_enu, dt_m, dv_enu, dtdot, fs: float,
                 carr_fftpts: int) -> tuple[int, int]:
    """The narrowest score windows (code, carrier) that read no clamped
    edge anywhere on the grid: W >= 2 span + 4 samples (bins) and a slack
    sample, a multiple of 4 and at least 8 (ops/dpe.py `auto_windows`)."""
    r_min = 1.9e7   # closest GPS range [m]: the curvature term's bound
    dmax = float(np.linalg.norm(d_enu, axis=1).max(initial=0.0))
    span_m = dmax + dmax * dmax / (2.0 * r_min) + float(
        np.abs(dt_m).max(initial=0.0))
    span_code = (fs / C) * 1.001 * span_m
    vmax = float(np.linalg.norm(dv_enu, axis=1).max(initial=0.0))
    span_carr = ((carr_fftpts / fs) * (F_L1 / C)
                 * (vmax + float(np.abs(dtdot).max(initial=0.0))))

    def _w(span):
        w = int(np.ceil(2.0 * span + 5.0))
        return max(8, (w + 3) // 4 * 4)

    return _w(span_code), _w(span_carr)
