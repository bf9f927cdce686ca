"""Direct Position Estimation receiver on torch devices: the per-block step
and the batched mode.

Port of navlab_dpe_sdr_tpu/models/dpe.py (`step`/`run` and `run_batched`):
host bookkeeping stays float64 numpy, copied verbatim from the JAX
receiver; only the device calls change. Per block, `step` prepares the
channel predictions and manifold geometry, uploads them with the raw block
and runs ops/dpe_real.dpe_device_step_real (the windowed correlator, then
both full score surfaces through K2), then takes the argmax or the
score-weighted mean on the host. Per batched dispatch the host prepares N
blocks (`_prepare_batch`), uploads them as one packed array, runs the fused
correlate + score step (ops/dpe_real.dpe_batch_blocks, K1) and queues one
asynchronous fetch of the packed result rows; `_drain_batch` applies the
measurements at batch boundaries.

The receiver takes the JAX package's numpy objects (Handoff, Grid,
EphArray), so a JAX receiver's `save_handoff()` starts a port receiver
that continues the same run. Configurations outside the ported slices
raise NotImplementedError naming their ROADMAP Queue 1 item.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..constants import C, F_CA, F_L1, L_CA, T_CA
from ..device import resolve_device
from ..io.handoff import Handoff
from ..io.rawfile import SampleFile
from ..libgnss import frames, naveng, satpos
from ..libgnss.cacode import ca_table
from ..libgnss.ephemeris import EphArray
from ..libgnss.satcache import SatStateCache
from ..ops import dpe as dpe_ops
from ..ops import dpe_real as dpe_real_ops
from .ekf import NavEKF
from .grid import Grid, check_grid_size, spread_grid


@dataclass
class DPEFix:
    mc: int
    rx_time: float
    rx_time_a: float
    x_ecef: np.ndarray
    pos_score: float
    vel_score: float


@dataclass
class DPEConfig:
    """Same fields and defaults as the JAX DPEConfig; see
    `_check_config` for the values this slice runs."""
    T: float = 0.02
    l_power: int = 1
    ekf_mode: str = "passthrough"   # "alpha" = fixed-gain smoother,
                                     # "full" = 8-state EKF (not ported)
    ekf_alpha: float = 0.3
    use_argmax: bool = True          # False = score-weighted mean
    interp: str = "quadratic"        # "linear" = exact reference parity
    engine: str = "real"             # "fft" = full-FFT oracle (not ported)
    doppler_sign: float = 1.0
    use_sat_cache: bool = True       # Hermite-interpolated satellite states
    refine: str | None = None        # "newton" sub-grid polish (not ported)
    dump_scores_to: str | None = None  # per-block score dump (npz)
    mesh: object | None = None         # multi-device scoring (not ported)
    ekf_q_accel: float = 1.0
    ekf_q_pos: float = 25.0
    ion_alpha: tuple | None = None     # Klobuchar iono model in the
    ion_beta: tuple | None = None      # channel back-calculation
    tropo: bool = False
    code_win: int | None = None        # score-window widths; None = sized
    carr_win: int | None = None        # to the grid (ops.dpe.auto_windows)


def _check_config(cfg: DPEConfig) -> None:
    """Refuse what this slice does not run — never fall back."""
    unported = [
        (cfg.engine != "real", f"engine={cfg.engine!r}",
         "item 8 (FFT engine)"),
        (cfg.mesh is not None, "mesh", "item 11 (mesh)"),
        (bool(cfg.refine), f"refine={cfg.refine!r}",
         "item 4 (refine and full EKF)"),
        (cfg.ekf_mode == "full", "ekf_mode='full'",
         "item 4 (refine and full EKF)"),
        (cfg.interp not in ("quadratic", "linear"),
         f"interp={cfg.interp!r}", "item 5 (integrated and survey modes)"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP Queue 1 {item}")


class DeviceState(NamedTuple):
    """The receiver's device-resident tensors."""
    chips: torch.Tensor      # [C, 1023] f32 +/-1
    time_idc: torch.Tensor   # [S] f32 block sample times
    d_enu: torch.Tensor      # [Gp, 3] f32 position offsets
    dt_m: torch.Tensor       # [Gp] f32 clock offsets
    dv_enu: torch.Tensor     # [Gv, 3] f32 velocity offsets
    dtdot: torch.Tensor      # [Gv] f32 drift offsets


def device_state(grid: Grid, chips: np.ndarray, S: int, fs: float,
                 device) -> DeviceState:
    """Device tensors from the host-side grid and chip table. time_idc is
    (arange(S)/fs) rounded to float32 on the host, as the JAX receiver
    uploads it (an on-device arange/fs rounds differently)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    return DeviceState(
        chips=f32(chips), time_idc=f32(np.arange(S) / fs),
        d_enu=f32(grid.d_enu), dt_m=f32(grid.dt_m),
        dv_enu=f32(grid.dv_enu), dtdot=f32(grid.dtdot))


class _Fetch(NamedTuple):
    """A device->host copy in flight: the pinned host tensor and the event
    recorded after the copy on the producing stream (None on the CPU)."""
    host: torch.Tensor
    event: torch.cuda.Event | None


def _fetch_async(t: torch.Tensor) -> _Fetch:
    if t.device.type != "cuda":
        return _Fetch(t, None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return _Fetch(host, ev)


def _fetched(f: _Fetch) -> np.ndarray:
    if f.event is not None:
        f.event.synchronize()
    return f.host.numpy()


class DPEReceiver:
    """DPE receiver initialized from a handoff checkpoint, on `device`
    (default "cuda"; a missing CUDA device raises)."""

    def __init__(self, rawfile: SampleFile, handoff: Handoff,
                 grid: Grid | None = None, config: DPEConfig | None = None,
                 eph: EphArray | None = None, eph_manager=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.rawfile = rawfile
        self.cfg = config or DPEConfig()
        _check_config(self.cfg)
        self.grid = check_grid_size(grid or spread_grid())
        self.prn_list = list(handoff.prn_list)
        c = len(self.prn_list)

        # ephemeris: either a fixed per-PRN set, or an EphManager holding
        # every parsed record with per-block closest-toe re-selection
        self.eph_manager = eph_manager
        if eph_manager is not None:
            eph_manager.set_anchors(handoff.tow, handoff.cp_timestamp)
            self.eph, _ = eph_manager.select(float(handoff.rx_time))
        else:
            self.eph = eph if eph is not None else handoff.eph_array()
        if len(self.eph) != c:
            raise ValueError(f"{len(self.eph)} ephemerides for {c} channels")

        # channel state (float64 host)
        self.rc = handoff.rc.astype(np.float64).copy()
        self.ri = handoff.ri.astype(np.float64).copy()
        self.fc = handoff.fc.astype(np.float64).copy()
        self.fi = handoff.fi.astype(np.float64).copy()
        self.cp = handoff.cp.astype(np.float64).copy()

        self.rx_time = float(handoff.rx_time)
        self.ekf = NavEKF(handoff.x_ecef, T=self.cfg.T,
                          mode=self.cfg.ekf_mode, alpha=self.cfg.ekf_alpha,
                          q_accel=self.cfg.ekf_q_accel,
                          q_pos=self.cfg.ekf_q_pos)
        self.rx_time_a = self.rx_time - self.ekf.x[3] / C

        self._bytes_read0 = int(handoff.bytes_read)
        rawfile.seek_bytes(handoff.bytes_read)
        rawfile.set_block(self.cfg.T, self.cfg.T, verbose=False)
        self.S = rawfile.S
        self.carr_fftpts = rawfile.carr_fftpts

        # score-window widths: exact-safe minimum for this grid
        auto_cw, auto_vw = dpe_ops.auto_windows(
            self.grid.d_enu, self.grid.dt_m, self.grid.dv_enu,
            self.grid.dtdot, rawfile.fs, self.carr_fftpts)
        self.code_win = self.cfg.code_win or auto_cw
        self.carr_win = self.cfg.carr_win or auto_vw
        if self.code_win < auto_cw or self.carr_win < auto_vw:
            raise ValueError(
                f"score windows ({self.code_win}, {self.carr_win}) too "
                f"narrow for this grid: outer grid points would score "
                f"clamped window edges (need >= ({auto_cw}, {auto_vw}))")
        if self.code_win > dpe_real_ops.SLIVER_LIMIT:
            raise ValueError(
                f"code_win={self.code_win} exceeds the nav-bit boundary-arc"
                f" correction span ({dpe_real_ops.SLIVER_LIMIT} samples)")
        self.period = int(round(T_CA * rawfile.fs))
        if self.S % self.period:
            raise ValueError(f"block of {self.S} samples is not a whole "
                             f"number of {self.period}-sample code periods")
        self._dev = device_state(self.grid, ca_table(self.prn_list),
                                 self.S, rawfile.fs, self.device)

        self.mc = 0
        self.fixes: list[DPEFix] = []
        self.flip_log: list[np.ndarray] = []
        self._sat_cache: SatStateCache | None = None

    # -- host-side f64 helpers (verbatim from the JAX receiver) ------------

    def _idx_next_bit(self) -> np.ndarray:
        """First sample of the next nav bit; S (=no flip) if out of window.

        Parity: correlator.py:373-379 (idx_next_bit + replica-side flip).
        """
        cp_since = np.mod(self.cp - self.eph.cp_timestamp, 20.0)
        cp_next = 20.0 - cp_since
        idx_next = (np.floor((L_CA * cp_next - self.rc)
                             * (self.rawfile.fs / self.fc)).astype(np.int64)
                    + 1)
        out = np.where((idx_next > 0) & (idx_next < self.S), idx_next, self.S)
        return out.astype(np.int32)

    def _predict_channels(self):
        """Geometry-based (cp, rc) prediction to the block end
        (channel.scalar_time_update_adv:194-245)."""
        T = self.cfg.T
        # frequency-propagated prediction
        cp_pred = self.cp + np.floor((self.rc + self.fc * T) / L_CA)
        rc_pred = np.mod(self.rc + self.fc * T, L_CA)

        x_eci = frames.ecef_to_eci(self.ekf.x, t_gps=self.rx_time_a,
                                   t_c=self.rx_time_a)

        t_tx = (self.eph.tow_timestamp
                + T_CA * (cp_pred - self.eph.cp_timestamp) + rc_pred / F_CA)
        sats_ecef, t_tx_c = self._sat_states(t_tx)
        sats_eci = frames.ecef_to_eci_batch(sats_ecef, t_tx_c,
                                            self.rx_time_a)

        rng = np.linalg.norm(sats_eci[0:3] - x_eci[0:3, None], axis=0)
        bc_pr = (rng + x_eci[3] - C * sats_eci[3]
                 + self._atmos_m(x_eci[0:3], sats_eci[0:3], self.rx_time))
        bc_tt = self.rx_time - bc_pr / C
        bc_cfd = (bc_tt - self.eph.tow_timestamp
                  - T_CA * (self.cp - self.eph.cp_timestamp))
        bc_rc = bc_cfd * F_CA

        self.cp = np.floor(bc_rc / L_CA) + self.cp
        self.rc = np.mod(bc_rc, L_CA)
        self.ri = np.mod(self.ri + self.fi * T, 1.0)

    def _sat_states(self, t_tx):
        """Clock-corrected satellite ECEF states + corrected tx times at
        nominal (satellite-clock) transmit times t_tx. Cached Hermite
        interpolation by default (satpos.cu precompute design)."""
        if self.cfg.use_sat_cache:
            if self._sat_cache is None:
                self._sat_cache = SatStateCache(self.eph, float(np.min(t_tx)))
            s8 = self._sat_cache.state_at(t_tx)
            return s8, t_tx - s8[3]
        clkb, clkd = satpos.sat_clock_correction(self.eph, t_tx)
        s8 = satpos.sat_state(self.eph, t_tx - clkb, clkb, clkd)
        return s8, t_tx - clkb

    def _atmos_m(self, rx_pos, sats_pos, tow):
        """Per-channel atmospheric group delay [m] added to every modeled
        pseudorange (prediction, steering, manifold centers). 0.0 when
        disabled."""
        cfg = self.cfg
        if cfg.ion_alpha is None and not cfg.tropo:
            return 0.0
        return naveng.atmospheric_delays_m(
            np.asarray(rx_pos, dtype=np.float64), sats_pos, tow,
            cfg.ion_alpha, cfg.ion_beta, cfg.tropo)

    def _sats_now(self):
        """Satellite ECI states at the current (cp, rc) epoch."""
        t_tx = naveng.transmit_times(self.cp, self.rc, self.eph)
        sats_ecef, t_tx_c = self._sat_states(t_tx)
        sats_eci = frames.ecef_to_eci_batch(sats_ecef, t_tx_c,
                                            self.rx_time_a)
        return sats_eci, t_tx_c

    def _manifold_params(self, sats_eci):
        """Per-channel float64 scoring centers -> float32 device params."""
        x_eci = frames.ecef_to_eci(self.ekf.x, t_gps=self.rx_time_a,
                                   t_c=self.rx_time_a)
        dvec = sats_eci[0:3] - x_eci[0:3, None]
        r0 = np.linalg.norm(dvec, axis=0)
        los = dvec / r0
        r_e2n = frames.ecef_to_enu_matrix(self.ekf.x[0:3])
        los_enu = (r_e2n @ los).T                   # [C, 3]

        # position manifold center index (code_corr, fftshifted, length S)
        bc_pr = (r0 + x_eci[3] - C * sats_eci[3]
                 + self._atmos_m(x_eci[0:3], sats_eci[0:3], self.rx_time))
        bc_tt = self.rx_time - bc_pr / C
        bc_cfd = (bc_tt - self.eph.tow_timestamp
                  - T_CA * (self.cp - self.eph.cp_timestamp))
        bc_rc0 = bc_cfd * F_CA - self.rc
        pos_idx_c = (self.rawfile.fs / self.fc) * (-bc_rc0) + self.S / 2.0
        pos_coef = (self.rawfile.fs / self.fc) * (F_CA / C)

        # velocity manifold center index (carr_fft, fftshifted)
        rr = x_eci[4:7, None] - sats_eci[4:7]
        losrr = np.sum(los * rr, axis=0)
        bc_psr = -losrr + x_eci[7] - C * sats_eci[7]
        bc_fi = (-F_L1 / C * bc_psr) / self.cfg.doppler_sign
        bc_fi0 = bc_fi - self.fi
        vel_idx_c = ((self.carr_fftpts / self.rawfile.fs) * bc_fi0
                     + self.carr_fftpts / 2.0)
        vel_coef = np.full(len(self.prn_list),
                           -(self.carr_fftpts / self.rawfile.fs)
                           * F_L1 / (C * self.cfg.doppler_sign))

        return los_enu, r0, pos_idx_c, pos_coef, vel_idx_c, vel_coef, r_e2n

    def _maybe_reselect_eph(self):
        """Per-block closest-toe ephemeris-set re-selection (reference
        CHM_ComputeSatStates, cuchanmgr.cu:276-292). On a set switch the
        satellite-state cache is rebuilt from the fresh orbits."""
        if self.eph_manager is None:
            return
        self.eph, changed = self.eph_manager.select(self.rx_time)
        if changed:
            self._sat_cache = None

    def _update_channels_from_state(self):
        """receiver.dp_measurement_update_channels:411-450."""
        sats_eci, _ = self._sats_now()
        x_eci = frames.ecef_to_eci(self.ekf.x, t_gps=self.rx_time_a,
                                   t_c=self.rx_time_a)
        dvec = sats_eci[0:3] - x_eci[0:3, None]
        r0 = np.linalg.norm(dvec, axis=0)
        los = dvec / r0

        rr = x_eci[4:7, None] - sats_eci[4:7]
        losrr = np.sum(los * rr, axis=0)
        bc_psr = -losrr + x_eci[7] - C * sats_eci[7]
        bc_fi = (-F_L1 / C * bc_psr) / self.cfg.doppler_sign
        self.fi = bc_fi

        bc_pr = (r0 + x_eci[3] - C * sats_eci[3]
                 + self._atmos_m(x_eci[0:3], sats_eci[0:3], self.rx_time))
        bc_tt = self.rx_time - bc_pr / C
        bc_cfd = (bc_tt - self.eph.tow_timestamp
                  - T_CA * (self.cp - self.eph.cp_timestamp))
        bc_rc = bc_cfd * F_CA
        self.fc = (F_CA + self.rawfile.fcaid * bc_fi
                   + (bc_rc - self.rc) / self.cfg.T)

    # -- the per-block step --------------------------------------------------

    def _advance_gap(self):
        """Propagate state across the duty-cycle skip T_big - T (the JAX
        receiver's `_advance_gap`)."""
        t_skip = self.rawfile.T_skip
        if t_skip <= 0:
            return
        adv = self.rc + self.fc * t_skip
        self.cp += np.floor(adv / L_CA)
        self.rc = np.mod(adv, L_CA)
        self.ri = np.mod(self.ri + self.fi * t_skip, 1.0)
        self.rx_time += t_skip
        self.rx_time_a = self.rx_time - self.ekf.x[3] / C

    def _upload_block(self, raw_block) -> torch.Tensor:
        """One block as an [S, 2] tensor on the device: int16 (or f32) I/Q
        from read_block_raw, or a complex array as the JAX step takes."""
        if np.iscomplexobj(raw_block):
            raw_block = np.stack([raw_block.real, raw_block.imag],
                                 axis=-1).astype(np.float32)
        return dpe_real_ops.to_device(raw_block, self.device)

    def step(self, raw_block: np.ndarray | None = None) -> DPEFix:
        """One 20 ms block: predict, correlate and score on the device, one
        measurement update (the JAX `DPEReceiver.step`)."""
        self._maybe_reselect_eph()
        rf = self.rawfile
        if raw_block is None:
            if rf.S_skip:
                rf.skip_gap()
                self._advance_gap()
            raw_block = rf.read_block_raw()
        raw = self._upload_block(raw_block)
        # 1. time update
        self.ekf.time_update()
        self.rx_time += self.cfg.T
        self.rx_time_a = self.rx_time - self.ekf.x[3] / C

        # 2. pre-prediction channel state (the replicas use it) and the
        #    nav-bit flip boundary
        rc_snap = self.rc.copy()
        dfc_snap = self.fc - F_CA
        fi_corr = self.fi.astype(np.float32)
        ri_corr = self.ri.astype(np.float32)
        idx_next = self._idx_next_bit()

        # 3. channel prediction to block end (host float64)
        self._predict_channels()
        self.mc += 1

        # 4. manifold geometry (host float64 centers)
        sats_eci, _ = self._sats_now()
        (los_enu, r0, pos_idx_c, pos_coef, vel_idx_c, vel_coef,
         r_e2n) = self._manifold_params(sats_eci)
        pos_start = np.clip(np.round(pos_idx_c).astype(np.int64)
                            - self.code_win // 2, 0,
                            self.S - self.code_win).astype(np.int32)
        vel_start = np.clip(np.round(vel_idx_c).astype(np.int64)
                            - self.carr_win // 2, 0,
                            self.carr_fftpts - self.carr_win).astype(np.int32)
        rc_mid = np.mod(rc_snap + dfc_snap * (self.cfg.T / 2.0), L_CA)

        # 5. one packed upload, the fused device step (K2 for the scores)
        fpk = np.stack([
            rc_mid, fi_corr, ri_corr,
            los_enu[:, 0], los_enu[:, 1], los_enu[:, 2], r0,
            pos_idx_c - pos_start, pos_coef,
            vel_idx_c - vel_start, vel_coef]).astype(np.float32)
        ipk = np.stack([idx_next, pos_start, vel_start]).astype(np.int32)
        fp, ip = dpe_real_ops.unpack_params(dpe_real_ops.to_device(
            dpe_real_ops.pack_params(fpk[None], ipk[None], 0), self.device))
        fp, ip = fp[0], ip[0]
        params = dpe_ops.ManifoldParams(
            los_enu=fp[3:6].T, r0=fp[6], pos_center=fp[7], pos_coef=fp[8],
            vel_center=fp[9], vel_coef=fp[10])
        d = self._dev
        rawf = raw.float()
        (pos_scores, pos_arg, vel_scores, vel_arg, flip_used, _,
         _) = dpe_real_ops.dpe_device_step_real(
            rawf[:, 0], rawf[:, 1], d.chips, fp[0], ip[0], fp[1], fp[2],
            d.time_idc, ip[1], ip[2], params, d.d_enu, d.dt_m, d.dv_enu,
            d.dtdot, carr_fftpts=self.carr_fftpts, period=self.period,
            n_periods=self.S // self.period, l_power=self.cfg.l_power,
            interp=self.cfg.interp, code_win=self.code_win,
            carr_win=self.carr_win)

        if self.cfg.use_argmax:
            pa, va = int(pos_arg), int(vel_arg)
            d_enu = self.grid.d_enu[pa]
            dt = self.grid.dt_m[pa]
            dv_enu = self.grid.dv_enu[va]
            dtdot = self.grid.dtdot[va]
            pos_peak = float(pos_scores[pa])
            vel_peak = float(vel_scores[va])
        else:   # score-weighted mean, host float64 (JAX models/dpe.py:574)
            ps = pos_scores.cpu().numpy().astype(np.float64)
            vs = vel_scores.cpu().numpy().astype(np.float64)
            d_enu = ps @ self.grid.d_enu / ps.sum()
            dt = ps @ self.grid.dt_m / ps.sum()
            dv_enu = vs @ self.grid.dv_enu / vs.sum()
            dtdot = vs @ self.grid.dtdot / vs.sum()
            pos_peak, vel_peak = float(ps.max()), float(vs.max())

        z = self.ekf.x.copy()
        z[0:3] += r_e2n.T @ d_enu
        z[3] += dt
        z[4:7] += r_e2n.T @ dv_enu
        z[7] += dtdot
        self.ekf.measurement_update(z)
        self.rx_time_a = self.rx_time - self.ekf.x[3] / C

        # 6. back-calculate channel frequencies from the updated state
        self._update_channels_from_state()

        if self.cfg.dump_scores_to:
            np.savez(f"{self.cfg.dump_scores_to}/scores_{self.mc:06d}.npz",
                     pos=pos_scores.cpu().numpy(),
                     vel=vel_scores.cpu().numpy())
        self.flip_log.append(flip_used.cpu().numpy())
        fix = DPEFix(mc=self.mc, rx_time=self.rx_time,
                     rx_time_a=self.rx_time_a, x_ecef=self.ekf.x.copy(),
                     pos_score=pos_peak, vel_score=vel_peak)
        self.fixes.append(fix)
        return fix

    def run(self, n_blocks: int):
        for _ in range(n_blocks):
            self.step()
        return self.fixes

    # -- modes outside the ported slices ------------------------------------

    def run_integrated(self, *args, **kwargs):
        raise NotImplementedError(
            "run_integrated is not ported yet: ROADMAP Queue 1 item 5 "
            "(integrated and survey modes)")

    def noise_envelope(self, *args, **kwargs):
        raise NotImplementedError(
            "noise_envelope is not ported yet: ROADMAP Queue 1 item 5 "
            "(integrated and survey modes)")

    def run_survey(self, *args, **kwargs):
        raise NotImplementedError(
            "run_survey is not ported yet: ROADMAP Queue 1 item 5 "
            "(integrated and survey modes)")

    # -- batched mode (deferred feedback) ----------------------------------

    def _prepare_block(self):
        """Host prep for one block: time update, channel prediction,
        manifold geometry — packed for the batched device scan. Does NOT
        apply measurement feedback (the batch does that at its boundary)."""
        self._maybe_reselect_eph()
        self.ekf.time_update()
        self.rx_time += self.cfg.T
        self.rx_time_a = self.rx_time - self.ekf.x[3] / C

        rc_snap = self.rc.copy()
        dfc_snap = self.fc - F_CA
        fi_corr = self.fi.astype(np.float32)
        ri_corr = self.ri.astype(np.float32)
        idx_next = self._idx_next_bit()
        rc_mid = np.mod(rc_snap + dfc_snap * (self.cfg.T / 2.0), L_CA)

        self._predict_channels()
        self.mc += 1
        # steer channel frequencies from the (frozen) predicted state so the
        # within-batch correlations stay coherent
        self._update_channels_from_state()

        sats_eci, _ = self._sats_now()
        (los_enu, r0, pos_idx_c, pos_coef, vel_idx_c, vel_coef,
         r_e2n) = self._manifold_params(sats_eci)
        pos_start = np.clip(np.round(pos_idx_c).astype(np.int64)
                            - self.code_win // 2, 0,
                            self.S - self.code_win).astype(np.int32)
        vel_start = np.clip(np.round(vel_idx_c).astype(np.int64)
                            - self.carr_win // 2, 0,
                            self.carr_fftpts - self.carr_win).astype(np.int32)

        fpk = np.stack([
            rc_mid, fi_corr, ri_corr,
            los_enu[:, 0], los_enu[:, 1], los_enu[:, 2], r0,
            pos_idx_c - pos_start, pos_coef,
            vel_idx_c - vel_start, vel_coef,
        ]).astype(np.float32)                               # [11, C]
        ipk = np.stack([idx_next, pos_start, vel_start]).astype(np.int32)
        return fpk, ipk, r_e2n, self.rx_time, self.mc, self.ekf.x.copy()

    def _prepare_batch(self, n: int):
        """Vectorized host prep for n blocks — [N, C] math throughout.

        Produces exactly what [self._prepare_block() for _ in range(n)]
        produces (same prep tuples, same end-of-batch receiver state), but
        with three whole-batch satellite-state/frame evaluations instead of
        3n small-array ones: with the state frozen across the batch, each
        block's channel back-calculation is a closed-form function of its
        own epoch (the only cross-block recurrence is the carrier-phase
        accumulation, a cumsum).
        """
        if self.eph_manager is not None:
            self._maybe_reselect_eph()
            probe = [self.eph_manager._pick(self.eph_manager.table[p],
                                            self.rx_time + n * self.cfg.T)
                     for p in self.eph_manager.prn_list]
            if probe != self.eph_manager.current_idx:
                # ephemeris set cutover inside this batch: take the exact
                # per-block path so the switch lands on its block boundary
                return [self._prepare_block() for _ in range(n)]

        T = self.cfg.T
        rf = self.rawfile
        eph = self.eph

        # EKF chain: F = I in the slice's modes (passthrough, alpha)
        xs = np.empty((n, 8))
        xs[:] = self.ekf.x
        rx_times = np.empty(n)
        t = self.rx_time
        for k in range(n):            # sequential += T, as the scalar path
            t += T
            rx_times[k] = t
        self.rx_time = t
        rx_a = rx_times - xs[:, 3] / C
        self.rx_time_a = rx_a[-1]
        # otau == 0 at (t_gps == t_c): identity rotation + earth-rate
        # velocity term, per-block (frames.ecef_to_eci contract)
        x_eci = frames.ecef_to_eci(xs.T, t_gps=0.0, t_c=0.0)    # [8, N]

        # ---- stage A: code-phase solve at every block epoch -------------
        # chips since the decode anchor: phi = L_CA*(cp - cpts) + rc
        phi0 = L_CA * (self.cp - eph.cp_timestamp) + self.rc    # [C]
        ks = np.arange(1, n + 1, dtype=np.float64)[:, None]
        # nominal (satellite-clock) transmit times; initial guess propagates
        # the incoming code rate, then two fixed-point refinements
        t_tx = eph.tow_timestamp + (phi0 + self.fc * (ks * T)) / F_CA
        atm = 0.0
        for it in range(2):
            s8, t_tx_c = self._sat_states(t_tx)                 # [8, N, C]
            sats = frames.ecef_to_eci_batch(s8, t_tx_c, rx_a[:, None])
            if it == 0:
                # el/az move microradians over a <=1 s batch: one [C] row
                # of delays from the first block's geometry serves all
                atm = self._atmos_m(xs[0, 0:3],
                                    np.asarray(sats[0:3, 0, :]),
                                    rx_times[0])
            rng = np.linalg.norm(sats[0:3] - x_eci[0:3, :, None], axis=0)
            bc_pr = rng + x_eci[3][:, None] - C * sats[3] + atm
            t_tx = rx_times[:, None] - bc_pr / C                # = bc_tt
        phi = (t_tx - eph.tow_timestamp) * F_CA                 # [N, C]
        cp_rows = eph.cp_timestamp + np.floor(phi / L_CA)
        rc_rows = phi - L_CA * (cp_rows - eph.cp_timestamp)

        # ---- stage B: frequency steering at the solved code phases ------
        t_tx2 = eph.tow_timestamp + phi / F_CA
        s8b, t_tx_c2 = self._sat_states(t_tx2)
        sats2 = frames.ecef_to_eci_batch(s8b, t_tx_c2, rx_a[:, None])
        dvec = sats2[0:3] - x_eci[0:3, :, None]
        r0 = np.linalg.norm(dvec, axis=0)                       # [N, C]
        los = dvec / r0                                         # [3, N, C]
        rr = x_eci[4:7, :, None] - sats2[4:7]
        losrr = np.sum(los * rr, axis=0)
        bc_psr = -losrr + x_eci[7][:, None] - C * sats2[7]
        fi_rows = (-F_L1 / C * bc_psr) / self.cfg.doppler_sign  # [N, C]
        bc_pr2 = r0 + x_eci[3][:, None] - C * sats2[3] + atm
        bc_tt2 = rx_times[:, None] - bc_pr2 / C
        bc_rc2 = ((bc_tt2 - eph.tow_timestamp) * F_CA
                  - L_CA * (cp_rows - eph.cp_timestamp))
        fc_rows = F_CA + rf.fcaid * fi_rows + (bc_rc2 - rc_rows) / T

        # previous-block snapshots (row 0 = incoming channel state)
        rc_prev = np.vstack([self.rc, rc_rows[:-1]])
        cp_prev = np.vstack([self.cp, cp_rows[:-1]])
        fc_prev = np.vstack([self.fc, fc_rows[:-1]])
        fi_prev = np.vstack([self.fi, fi_rows[:-1]])
        ri_prev = np.mod(self.ri + np.concatenate(
            [[np.zeros_like(self.ri)],
             np.cumsum(fi_prev * T, axis=0)[:-1]]), 1.0)        # [N, C]

        # nav-bit flip sample (_idx_next_bit, vectorized over blocks)
        cp_since = np.mod(cp_prev - eph.cp_timestamp, 20.0)
        idx_next = (np.floor((L_CA * (20.0 - cp_since) - rc_prev)
                             * (rf.fs / fc_prev)).astype(np.int64) + 1)
        idx_next = np.where((idx_next > 0) & (idx_next < self.S),
                            idx_next, self.S).astype(np.int32)

        dfc = fc_prev - F_CA
        rc_mid = np.mod(rc_prev + dfc * (T / 2.0), L_CA)

        # manifold geometry (_manifold_params over the batch; bc_fi == the
        # just-steered fi, so the velocity center residual is exactly 0)
        bc_rc0 = bc_rc2 - rc_rows
        pos_idx_c = (rf.fs / fc_rows) * (-bc_rc0) + self.S / 2.0
        pos_coef = (rf.fs / fc_rows) * (F_CA / C)
        vel_idx_c = np.full_like(pos_idx_c, self.carr_fftpts / 2.0)
        vel_coef = np.full_like(pos_idx_c,
                                -(self.carr_fftpts / rf.fs)
                                * F_L1 / (C * self.cfg.doppler_sign))
        pos_start = np.clip(np.round(pos_idx_c).astype(np.int64)
                            - self.code_win // 2, 0,
                            self.S - self.code_win).astype(np.int32)
        vel_start = np.clip(np.round(vel_idx_c).astype(np.int64)
                            - self.carr_win // 2, 0,
                            self.carr_fftpts - self.carr_win).astype(np.int32)

        r_e2ns = [frames.ecef_to_enu_matrix(xs[0, 0:3])] * n
        los_enu = np.einsum("nij,jnc->nic", np.stack(r_e2ns), los)  # [N,3,C]

        fpk_all = np.stack([
            rc_mid, fi_prev, ri_prev,
            los_enu[:, 0], los_enu[:, 1], los_enu[:, 2], r0,
            pos_idx_c - pos_start, pos_coef,
            vel_idx_c - vel_start, vel_coef,
        ], axis=1).astype(np.float32)                           # [N, 11, C]
        ipk_all = np.stack([idx_next, pos_start, vel_start],
                           axis=1).astype(np.int32)             # [N, 3, C]

        # commit end-of-batch channel state (== n x _prepare_block)
        self.cp = cp_rows[-1].copy()
        self.rc = rc_rows[-1].copy()
        self.fi = fi_rows[-1].copy()
        self.fc = fc_rows[-1].copy()
        self.ri = np.mod(ri_prev[-1] + fi_prev[-1] * T, 1.0)
        mc0 = self.mc
        self.mc += n
        return [(fpk_all[k], ipk_all[k], r_e2ns[k], rx_times[k],
                 mc0 + k + 1, xs[k].copy()) for k in range(n)]

    def _apply_measurement(self, pa: int, va: int, r_e2n, rx_time, mc,
                           pos_peak, vel_peak, flip_row, x_pred,
                           wmean=None):
        # offsets are relative to the prediction the scoring used.
        # wmean: optional [8] continuous offsets from the device-side
        # score-weighted-mean estimator (use_argmax=False) — replaces the
        # lattice values, argmax still names the peak cell.
        if wmean is not None:
            dp4 = np.asarray(wmean[0:4], dtype=np.float64)
            dv4 = np.asarray(wmean[4:8], dtype=np.float64)
        else:
            dp4 = np.concatenate([self.grid.d_enu[pa],
                                  [self.grid.dt_m[pa]]])
            dv4 = np.concatenate([self.grid.dv_enu[va],
                                  [self.grid.dtdot[va]]])
        z = np.asarray(x_pred, dtype=np.float64).copy()
        z[0:3] += r_e2n.T @ dp4[0:3]
        z[3] += dp4[3]
        z[4:7] += r_e2n.T @ dv4[0:3]
        z[7] += dv4[3]
        self.ekf.measurement_update(z)
        self.flip_log.append(flip_row)
        fix = DPEFix(mc=mc, rx_time=rx_time,
                     rx_time_a=rx_time - self.ekf.x[3] / C,
                     x_ecef=self.ekf.x.copy(),
                     pos_score=float(pos_peak), vel_score=float(vel_peak))
        self.fixes.append(fix)
        return fix

    def _stage_blocks(self, n: int) -> torch.Tensor:
        """Read the next n blocks from the SampleFile and upload them as
        one [n, S, 2] tensor (synchronous staging: the read-ahead thread
        of the JAX receiver is ROADMAP Queue 1 item 3)."""
        rf = self.rawfile
        try:
            # one bulk slice per batch
            blocks = rf.read_chunk_raw(n).reshape(n, rf.S, -1)
        except (AttributeError, ValueError):
            blocks = np.stack([rf.read_block_raw() for _ in range(n)])
        return dpe_real_ops.to_device(blocks, self.device)

    def _dispatch_batch(self, n, raw_blocks_dev, start_block, done,
                        group_k: int = 1):
        preps = self._prepare_batch(n)
        fpk = np.stack([p[0] for p in preps])                   # [N, 11, C]
        ipk = np.stack([p[1] for p in preps])                   # [N, 3, C]

        if raw_blocks_dev is not None:
            raw_dev = raw_blocks_dev
            start = start_block + done
        else:
            raw_dev = self._stage_blocks(n)                     # [N, S, 2]
            start = 0

        d = self._dev
        rows = dpe_real_ops.dpe_batch_blocks(
            raw_dev, dpe_real_ops.pack_params(fpk, ipk, start), d.chips,
            d.time_idc, d.d_enu, d.dt_m, d.dv_enu, d.dtdot,
            carr_fftpts=self.carr_fftpts, period=self.period,
            n_periods=self.S // self.period, n_blocks=n,
            l_power=self.cfg.l_power, interp=self.cfg.interp,
            return_windows=False, code_win=self.code_win,
            carr_win=self.carr_win, group_k=group_k,
            use_argmax=self.cfg.use_argmax)
        # queue the device->host copy now: it runs as soon as the batch
        # finishes on the device, overlapping the NEXT batch's host prep
        return _fetch_async(rows), preps

    def _drain_batch(self, fetch: _Fetch, preps, group_k: int = 1):
        rows = _fetched(fetch)
        c = len(self.prn_list)
        pas, vas = dpe_real_ops.unpack_row_indices(rows)
        pps = rows[:, 1]
        vps = rows[:, 3]
        flips = rows[:, 4:4 + c]
        base = 4 + c
        wmeans = None
        if not self.cfg.use_argmax:     # weighted-mean cols follow flips
            wmeans = rows[:, base:base + dpe_real_ops.WMEAN_COLS]
        for i in range(rows.shape[0]):
            # group_k > 1: one row per K-block coherent group, referenced
            # to the group's LAST block's prediction
            _, _, r_e2n, rx_time, mc, x_pred = preps[(i + 1) * group_k - 1]
            self._apply_measurement(int(pas[i]), int(vas[i]), r_e2n,
                                    rx_time, mc, pps[i], vps[i], flips[i],
                                    x_pred, wmean=(None if wmeans is None
                                                   else wmeans[i]))
        # steer channel frequencies from the newest state at the current epoch
        self.rx_time_a = self.rx_time - self.ekf.x[3] / C
        self._update_channels_from_state()

    def _check_batch_mode(self, raw_blocks_dev, start_block, n_blocks):
        """Reject a device-resident capture the batched path cannot use,
        instead of silently diverging: torch slicing of the capture would
        silently truncate where it runs out."""
        if raw_blocks_dev is not None:
            if raw_blocks_dev.device != self.device:
                raise ValueError(
                    f"device-resident capture is on {raw_blocks_dev.device}"
                    f", the receiver on {self.device}")
            have = int(raw_blocks_dev.shape[0])
            if start_block < 0 or start_block + n_blocks > have:
                raise ValueError(
                    f"device-resident capture holds {have} blocks; "
                    f"requested blocks {start_block}..{start_block + n_blocks}")

    def save_handoff(self, path: str | None = None):
        """Mid-run checkpoint in the handoff-CSV contract (the same as the
        JAX receiver's): a new receiver of either package built from it
        resumes at the next block with identical channel, EKF, and time
        state. Call between runs."""
        from ..io.handoff import write_handoff
        from ..libgnss.ephemeris import ALL_FIELDS

        h = Handoff()
        h.rx_time = float(self.rx_time)
        h.rx_time_a = float(self.rx_time_a)
        h.x_ecef = np.asarray(self.ekf.x, dtype=np.float64).copy()
        h.bytes_read = int(self._bytes_read0
                           + self.mc * self.S * self.rawfile.datatype.itemsize)
        h.prn_list = list(self.prn_list)
        h.rc = self.rc.copy()
        h.ri = self.ri.copy()
        h.fc = self.fc.copy()
        h.fi = self.fi.copy()
        h.cp = self.cp.copy()
        h.cp_timestamp = np.asarray(self.eph.cp_timestamp,
                                    dtype=np.float64).copy()
        h.tow = np.asarray(self.eph.tow_timestamp, dtype=np.float64).copy()
        for name in ALL_FIELDS + ("IODE", "IODC"):
            h.eph_fields[name] = np.array(
                [getattr(e, name) for e in self.eph.ephs], dtype=np.float64)
        if path:
            write_handoff(path, h)
        return h

    def run_batched(self, n_blocks: int, lookahead: int = 25,
                    raw_blocks_dev: torch.Tensor | None = None,
                    start_block: int = 0, pipeline: bool = False,
                    group_k: int = 1, pipeline_depth: int = 1):
        """High-throughput mode: N blocks per device dispatch.

        Per batch: one packed parameter upload + the fused correlate/score
        dispatch + one asynchronous result fetch. Within a batch,
        predictions propagate from the batch-start fix; EKF measurements and
        channel steering are applied at batch boundaries.

        pipeline=True keeps up to pipeline_depth (>=1) dispatched batches in
        flight before draining the oldest, overlapping host preparation with
        device execution at depth batches of prediction staleness
        (predictions coast depth*lookahead*T seconds between measurement
        feedbacks).

        raw_blocks_dev: optional int16 capture [B, S, 2] on the receiver's
        device covering blocks start_block..; if None, blocks are read from
        the SampleFile and uploaded per batch.

        group_k > 1: coherent-grouped fixes — each group of group_k
        consecutive blocks is coherently summed on the device before
        manifold scoring, one fix per group. Requires lookahead and
        n_blocks to be multiples of group_k.
        """
        if group_k > 1 and (lookahead % group_k or n_blocks % group_k):
            raise ValueError(
                f"group_k={group_k} must divide lookahead={lookahead} "
                f"and n_blocks={n_blocks}")
        self._check_batch_mode(raw_blocks_dev, start_block, n_blocks)
        sizes = []
        left = n_blocks
        while left > 0:
            sizes.append(min(lookahead, left))
            left -= sizes[-1]
        done = 0
        depth = max(1, int(pipeline_depth)) if pipeline else 0
        pending = deque()
        for n in sizes:
            pending.append(self._dispatch_batch(n, raw_blocks_dev,
                                                start_block, done,
                                                group_k=group_k))
            done += n
            if len(pending) > depth:
                self._drain_batch(*pending.popleft(), group_k=group_k)
        while pending:
            self._drain_batch(*pending.popleft(), group_k=group_k)
        return self.fixes
