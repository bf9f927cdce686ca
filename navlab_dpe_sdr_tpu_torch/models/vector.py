"""Vector tracking (VDLL/VFLL) on torch devices: channels steered open-loop
from the navigation state, the loop closed in the navigation domain.

Port of navlab_dpe_sdr_tpu/models/vector.py (a working re-design of the
reference's vt_init/vt_track, receiver.py:545-720). Epoch flow
(T_epoch = N ms):
 1. steer channel phases/frequencies from X (back-calculation, float64
    numpy, the port's own libgnss copies);
 2. device: open-loop E/P/L correlations of the epoch's N 1 ms windows in
    one call of ops/tracking.track_open_loop (K3's windows mode on the
    card: one launch an epoch). The epoch's samples go up as int16 in one
    copy (the JAX receiver builds an f32 array a millisecond at a time;
    the values are the same);
 3. per channel, on the host in float64: DLL discriminator on the
    bit-folded epoch sums -> range residual; prompt-phase FLL across the
    epoch -> range-rate residual;
 4. least-squares navigation update, X += gain dx.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import C, F_CA, F_L1, L_CA, T_CA
from ..device import resolve_device
from ..io.rawfile import SampleFile, read_windows_raw
from ..libgnss import frames, naveng
from ..libgnss.cacode import ca_table
from ..libgnss.ephemeris import EphArray
from ..ops import tracking as trk_ops


@dataclass
class VTFix:
    mc: int
    rx_time: float
    x_ecef: np.ndarray


class VectorReceiver:
    """EKF/LS vector-tracking receiver on `device` (default "cuda"; a
    missing CUDA device raises)."""

    def __init__(self, rawfile: SampleFile, prn_list, eph: EphArray,
                 x0_ecef: np.ndarray, rx_time: float, cp, rc, fc, fi, ri=None,
                 epoch_ms: int = 20, gain: float = 0.4,
                 residual_clamp_m: float = 60.0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.rawfile = rawfile
        self.prn_list = [int(p) for p in prn_list]
        self.eph = eph
        self.x = np.asarray(x0_ecef, dtype=np.float64).reshape(8).copy()
        self.rx_time = float(rx_time)
        self.epoch_ms = epoch_ms

        self.cp = np.asarray(cp, dtype=np.float64).copy()
        self.rc = np.asarray(rc, dtype=np.float64).copy()
        self.fc = np.asarray(fc, dtype=np.float64).copy()
        self.fi = np.asarray(fi, dtype=np.float64).copy()
        self.ri = (np.zeros_like(self.rc) if ri is None
                   else np.asarray(ri, dtype=np.float64).copy())

        self.gain = float(gain)
        self.residual_clamp_m = float(residual_clamp_m)
        self.code_table = torch.from_numpy(
            ca_table(self.prn_list).astype(np.float32)).to(self.device)
        rawfile.set_block(T_CA, T_CA, verbose=False)
        self.mc = 0
        self.fixes: list[VTFix] = []

    @classmethod
    def from_scalar(cls, scalar_rx, **kw):
        """vt_init equivalent: seed from a tracked ScalarReceiver (of
        either package), on its device unless `device` is given."""
        cp, rc, fi = scalar_rx.observables()
        last = scalar_rx.mcount - 1
        fc = np.array([scalar_rx.channels[p].col("fc")[last]
                       for p in scalar_rx.prn_list])
        ri = np.array([scalar_rx.channels[p].col("ri")[last]
                       for p in scalar_rx.prn_list])
        rx_time_a, rx_time, x_ecef, _, _ = scalar_rx.nav_solution()
        kw.setdefault("device", getattr(scalar_rx, "device", "cuda"))
        return cls(scalar_rx.rawfile, scalar_rx.prn_list,
                   scalar_rx.eph_array(), x_ecef, rx_time,
                   cp=cp, rc=rc, fc=fc, fi=fi, ri=ri, **kw)

    # -- steering (shared math with the DPE channel manager) ---------------

    def _rx_time_a(self):
        return self.rx_time - self.x[3] / C

    def _steer_from_state(self):
        """Back-calculate fi/fc from X (dp_measurement_update_channels)."""
        sats_eci, _ = naveng.satellite_positions(self.cp, self.rc, self.eph,
                                                 t_c=self._rx_time_a())
        x_eci = frames.ecef_to_eci(self.x, t_gps=self._rx_time_a(),
                                   t_c=self._rx_time_a())
        dvec = sats_eci[0:3] - x_eci[0:3, None]
        r0 = np.linalg.norm(dvec, axis=0)
        los = dvec / r0
        rr = x_eci[4:7, None] - sats_eci[4:7]
        bc_psr = -np.sum(los * rr, axis=0) + x_eci[7] - C * sats_eci[7]
        bc_fi = -F_L1 / C * bc_psr / self.rawfile.ds
        bc_pr = r0 + x_eci[3] - C * sats_eci[3]
        bc_tt = self.rx_time - bc_pr / C
        bc_rc = (bc_tt - self.eph.tow_timestamp
                 - T_CA * (self.cp - self.eph.cp_timestamp)) * F_CA
        self.fi = bc_fi
        self.fc = (F_CA + self.rawfile.fcaid * bc_fi
                   + (bc_rc - self.rc) / (self.epoch_ms * 1e-3))
        return sats_eci, los

    def _read_epoch(self, n: int) -> torch.Tensor:
        """The next n 1 ms windows as [n, S, 2] on the device: int16 in one
        copy where the file holds int16 I/Q."""
        host = np.ascontiguousarray(read_windows_raw(self.rawfile, n))
        if not host.flags.writeable:     # a memmap window of a capture file
            host = host.copy()
        return torch.from_numpy(host).to(self.device)

    def _phases_on_device(self):
        """rc, fc - F_CA, ri, fi as float32 [C] on the device, in one copy:
        the columns of one [C, 4] tensor (K3's windows mode reads them by
        their stride)."""
        ph = np.stack([np.asarray(x, np.float32) for x in
                       (self.rc, self.fc - F_CA, self.ri, self.fi)], axis=1)
        dev = torch.from_numpy(ph).to(self.device)
        return dev[:, 0], dev[:, 1], dev[:, 2], dev[:, 3]

    def step(self) -> VTFix:
        n = self.epoch_ms
        sats_eci, los = self._steer_from_state()

        e, p, l = trk_ops.track_open_loop(
            *self._phases_on_device(), self._read_epoch(n), self.code_table,
            self.rawfile.fs)
        epl = torch.stack([e, p, l]).cpu().numpy()        # [3, n, C, 2]
        e, p, l = (x[..., 0] + 1j * x[..., 1] for x in epl)

        # bit-fold: align per-ms correlations by prompt sign before summing
        sgn = np.sign(p.real) + (p.real == 0)
        e_sum = np.sum(e * sgn, axis=0)
        l_sum = np.sum(l * sgn, axis=0)

        # DLL: normalized early-minus-late envelope -> chips
        e_env, l_env = np.abs(e_sum), np.abs(l_sum)
        eps_code = (e_env - l_env) / (2.0 * np.maximum(e_env + l_env, 1e-12))

        # FLL: phase rotation of prompt between consecutive ms
        cross = p.real[:-1] * p.imag[1:] - p.imag[:-1] * p.real[1:]
        dot = p.real[:-1] * p.real[1:] + p.imag[:-1] * p.imag[1:]
        dphi = np.arctan2(np.sum(cross, axis=0), np.sum(np.abs(dot), axis=0))
        eps_f = dphi / (2.0 * np.pi * 1e-3)          # Hz

        # residuals in navigation domain
        dr = -eps_code * (C / self.fc)               # meters (range error)
        drr = -eps_f * (C / F_L1) * self.rawfile.ds  # m/s (range-rate error)

        # clamp residual outliers (bit-fold glitches) and apply a loop gain
        # to damp the navigation-domain feedback
        cl = self.residual_clamp_m
        dr = np.clip(dr, -cl, cl)
        drr = np.clip(drr, -cl / 10.0, cl / 10.0)
        k = len(self.prn_list)
        a = np.concatenate([-los.T, np.ones((k, 1))], axis=1)
        dx_pos, *_ = np.linalg.lstsq(a, dr, rcond=None)
        dx_vel, *_ = np.linalg.lstsq(a, drr, rcond=None)
        self.x[0:4] += self.gain * dx_pos
        self.x[4:8] += self.gain * dx_vel

        # propagate channel phases/counters through the epoch
        t_epoch = n * 1e-3
        adv = self.rc + self.fc * t_epoch
        self.cp += np.floor(adv / L_CA)
        self.rc = np.mod(adv, L_CA)
        self.ri = np.mod(self.ri + self.fi * t_epoch, 1.0)
        self.rx_time += t_epoch
        self.mc += 1

        fix = VTFix(mc=self.mc, rx_time=self.rx_time, x_ecef=self.x.copy())
        self.fixes.append(fix)
        return fix

    def run(self, n_epochs: int):
        for _ in range(n_epochs):
            self.step()
        return self.fixes
