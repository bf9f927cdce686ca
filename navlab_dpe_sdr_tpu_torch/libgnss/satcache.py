"""Satellite-state cache: precompute + Hermite interpolation.

CUDARecv carries a SatPos module that precomputes satellite states in rolling
time batches and serves lookups by interpolation (satpos.cu:166-334; not
wired into its DPE flow, kept as the design reference — SURVEY §2.2). This
is that design, made useful: states sampled on a regular grid, cubic Hermite
interpolation between samples (positions + velocities are both available, so
the interpolant is C1 and sub-millimeter over multi-second spacing), serving
the per-block host prep at a fraction of a full Kepler solve.

The port's own copy of navlab_dpe_sdr_tpu/libgnss/satcache.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from . import satpos
from .ephemeris import EphArray


class SatStateCache:
    """Rolling per-channel satellite-state cache over a time horizon."""

    def __init__(self, eph: EphArray, t_start: float, horizon_s: float = 60.0,
                 spacing_s: float = 2.0):
        self.eph = eph
        self.spacing = float(spacing_s)
        self.t0 = float(t_start) - self.spacing
        n = int(np.ceil(horizon_s / self.spacing)) + 3
        times = self.t0 + np.arange(n) * self.spacing        # [N]
        k = len(eph)
        # states[:, c, i] at times[i] for channel c
        self.times = times
        self.states = np.empty((8, k, n))
        for i, t in enumerate(times):
            clkb, clkd = satpos.sat_clock_correction(eph, np.full(k, t))
            self.states[:, :, i] = satpos.sat_state(eph, np.full(k, t) - clkb,
                                                    clkb, clkd)

    def _extend(self, t_needed: float):
        while t_needed > self.times[-2]:
            t_new = self.times[-1] + self.spacing
            k = len(self.eph)
            clkb, clkd = satpos.sat_clock_correction(self.eph,
                                                     np.full(k, t_new))
            s = satpos.sat_state(self.eph, np.full(k, t_new) - clkb, clkb,
                                 clkd)
            self.times = np.append(self.times, t_new)
            self.states = np.concatenate([self.states, s[:, :, None]],
                                         axis=2)

    def state_at(self, t: np.ndarray) -> np.ndarray:
        """Interpolated 8-states at per-channel times t [K] -> [8, K].

        Position/clock via cubic Hermite using the cached velocities/drifts;
        velocity via linear interpolation (sufficient: satellite acceleration
        ~0.6 m/s^2 over the spacing).
        """
        t = np.asarray(t, dtype=np.float64)
        self._extend(float(np.max(t)))
        idx = np.clip(((t - self.t0) // self.spacing).astype(int), 0,
                      len(self.times) - 2)
        k = np.arange(len(self.eph))
        t_a = self.times[idx]
        h = self.spacing
        s = (t - t_a) / h

        p0 = self.states[0:4, k, idx]
        p1 = self.states[0:4, k, idx + 1]
        v0 = self.states[4:8, k, idx]
        v1 = self.states[4:8, k, idx + 1]

        h00 = 2 * s ** 3 - 3 * s ** 2 + 1
        h10 = s ** 3 - 2 * s ** 2 + s
        h01 = -2 * s ** 3 + 3 * s ** 2
        h11 = s ** 3 - s ** 2
        pos = h00 * p0 + h10 * h * v0 + h01 * p1 + h11 * h * v1
        vel = (1 - s) * v0 + s * v1
        return np.concatenate([pos, vel], axis=0)
