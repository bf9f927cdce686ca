"""Direct Position Estimation receiver on torch devices: the per-block
step, the batched mode, integrated DPE and the multi-epoch survey solve.

Port of navlab_dpe_sdr_tpu/models/dpe.py on one device with
engine="real": host bookkeeping stays float64 numpy, copied verbatim from
the JAX receiver; only the device calls change. Per block, `step` prepares
the channel predictions and manifold geometry, uploads them with the raw
block and runs ops/dpe_real.dpe_device_step_real (the windowed correlator,
then both full score surfaces through K2), then takes the argmax (with
refine="newton" polished on the score windows) or the score-weighted mean
on the host; ekf_mode="full" weighs the measurement by the score surface's
curvature. Per batched dispatch the host prepares N blocks
(`_prepare_batch`), uploads them as one packed array, runs the fused
correlate + score step (ops/dpe_real.dpe_batch_blocks, K1) and queues one
asynchronous fetch of the packed result rows; `_drain_batch` applies the
measurements at batch boundaries. `run_integrated` takes one fix per batch
from the block-summed scorer (ops/dpe_real.dpe_scan_integrate),
`run_survey` collects every batch's integrated windows and solves one
state against the whole pass (ops/dpe_real.score_joint_argmax). File-mode
runs stage their samples through `_RawPrefetcher`.

engine="fft" runs `step`/`run` through the FFT engine instead
(ops/dpe.dpe_device_step: cuFFT correlation of the whole block, then K2 on
the score windows), the per-block cross-validation oracle; as in the JAX
receiver the batched and integrated modes refuse it. The receiver takes the
JAX package's numpy objects (Handoff, Grid, EphArray), so a JAX receiver's
`save_handoff()` starts a port receiver that continues the same run.

DPEConfig(mesh=parallel.mesh.make_mesh(...)) runs every mode above on a
('chan', 'grid') mesh of ranks (one process each, all running this same
host loop on the same samples): the device calls take the mesh, each rank
correlates its share of blocks and channels and scores its rows of the
grid, and every rank gets the whole results, so the float64 host state
stays the same on every rank. Collectives are issued from the receiver's
own thread only (never from `_RawPrefetcher`'s).
"""

from __future__ import annotations

import functools
import queue
import threading
import warnings
from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..constants import C, F_CA, F_L1, L_CA, T_CA
from ..device import resolve_device
from ..io.handoff import Handoff
from ..io.rawfile import SampleFile, read_windows_raw
from ..io.synth import white_noise_iq16
from ..libgnss import frames, naveng, satpos
from ..libgnss.cacode import ca_table
from ..libgnss.ephemeris import EphArray
from ..libgnss.satcache import SatStateCache
from ..ops import dpe as dpe_ops
from ..ops import dpe_real as dpe_real_ops
from ..ops.score import grid_factors
from ..parallel.mesh import Mesh
from .ekf import NavEKF
from .grid import Grid, _mesh4, check_grid_size, spread_grid


@dataclass
class DPEFix:
    mc: int
    rx_time: float
    rx_time_a: float
    x_ecef: np.ndarray
    pos_score: float
    vel_score: float


@dataclass
class SurveyResult:
    """Multi-epoch joint DPE estimate (static 'survey' mode)."""
    x_ecef: np.ndarray       # 8-state at t_ref: pos [m], clk [m], vel, drift
    t_ref: float             # receive-time epoch the state refers to
    n_blocks: int
    n_batches: int
    pos_score: float
    vel_score: float
    sigma_pos: np.ndarray    # [4] 1-sigma ENU+clock, joint curvature [m]
    sigma_vel: np.ndarray    # [4] 1-sigma ENU+drift [m/s]
    cov_pos: np.ndarray      # [4,4] full ENU+clock covariance — the U/clock
                             # ridge lives in the off-diagonals; sigma_pos
                             # alone understates along-ridge uncertainty
    cov_vel: np.ndarray      # [4,4]
    d_enu_t: np.ndarray      # [4] joint displacement from the final
                             # prediction (diagnostic)


@dataclass
class DPEConfig:
    """Same fields and defaults as the JAX DPEConfig; see
    `_check_config` for what is refused."""
    T: float = 0.02
    l_power: int = 1
    ekf_mode: str = "passthrough"   # "alpha" = fixed-gain smoother,
                                     # "full" = 8-state EKF
    ekf_alpha: float = 0.3
    use_argmax: bool = True          # False = score-weighted mean
    interp: str = "quadratic"        # "linear" = exact reference parity,
                                     # "sinc" = whole-window reconstruction
    engine: str = "real"             # "fft" = full-FFT per-block oracle
    doppler_sign: float = 1.0
    use_sat_cache: bool = True       # Hermite-interpolated satellite states
    refine: str | None = None        # "newton": continuous sub-grid ML
                                     # polish of the argmax from the score
                                     # windows
    dump_scores_to: str | None = None  # per-block score dump (npz)
    mesh: Mesh | None = None           # parallel.mesh.Mesh ('chan', 'grid')
    ekf_q_accel: float = 1.0
    ekf_q_pos: float = 25.0
    ion_alpha: tuple | None = None     # Klobuchar iono model in the
    ion_beta: tuple | None = None      # channel back-calculation
    tropo: bool = False
    code_win: int | None = None        # score-window widths; None = sized
    carr_win: int | None = None        # to the grid (ops.dpe.auto_windows)


def _check_config(cfg: DPEConfig) -> None:
    """The JAX constructor's refusals and its warning, then what the port
    does not run — never a fallback."""
    if cfg.engine == "fft" and cfg.refine:
        raise ValueError(
            "refine needs the score windows of engine='real'; the FFT "
            "engine never returns them, so the polish would silently "
            "not run")
    if cfg.refine and not cfg.use_argmax:
        raise ValueError(
            "refine polishes the grid argmax; the score-weighted-mean "
            "estimator (use_argmax=False) has no lattice point to "
            "polish — pick one")
    if cfg.engine == "fft" and cfg.ekf_mode == "full":
        warnings.warn(
            "engine='fft' provides no score windows: the full EKF runs "
            "with its static default R instead of the adaptive "
            "score-curvature R (use engine='real' for adaptive R)",
            stacklevel=3)
    if cfg.mesh is not None and not isinstance(cfg.mesh, Mesh):
        raise TypeError(f"mesh must be a navlab_dpe_sdr_tpu_torch.parallel."
                        f"mesh.Mesh (make_mesh), not {type(cfg.mesh)!r}")
    if cfg.engine not in ("real", "fft"):
        raise ValueError(f"engine={cfg.engine!r}: 'real' or 'fft'")
    if cfg.interp not in dpe_real_ops.INTERP_MODES:
        raise ValueError(f"interp={cfg.interp!r}: one of "
                         f"{dpe_real_ops.INTERP_MODES}")


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


class _RawPrefetcher:
    """Read-ahead sample staging for file-based batched and integrated
    runs (the JAX receiver's `_RawPrefetcher`).

    A daemon thread owns the rawfile cursor: it reads each planned batch
    and keeps up to `depth` staged batches ahead of the consumer. On a
    CUDA device a batch is copied into one of a ring of pinned host
    buffers and uploaded with a non-blocking copy on a copy stream of its
    own, with an event recorded after it; `get()` makes the current
    stream wait on that event, so disk read and host->device copy hide
    behind the device's work on earlier batches. A pinned buffer is
    written again only after the event of its last upload has completed.
    On the CPU the thread still reads ahead and hands over CPU tensors.
    """

    def __init__(self, rawfile, sizes, device, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = False
        self._device = torch.device(device)
        cuda = self._device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self._device) if cuda else None
        sizes = list(sizes)
        # queued + the one being consumed + the one being filled
        ring = [None] * (depth + 2)      # (pinned buffer, upload event)

        def stage(k, blocks):
            if not cuda:
                return dpe_real_ops.to_device(blocks, self._device), None
            slot = ring[k % len(ring)]
            if slot is None:
                dtype = torch.from_numpy(blocks[:0].copy()).dtype
                slot = (torch.empty((max(sizes),) + blocks.shape[1:],
                                    dtype=dtype, pin_memory=True), None)
            pinned, last = slot
            if last is not None:
                last.synchronize()       # its upload has left the buffer
            host = pinned[:blocks.shape[0]]
            host.numpy()[...] = blocks
            with torch.cuda.stream(self._copy_stream):
                dev_t = host.to(self._device, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
            ring[k % len(ring)] = (pinned, ready)
            return dev_t, ready

        def work():
            try:
                for k, n in enumerate(sizes):
                    if self._closed:
                        return
                    staged = stage(k, read_windows_raw(rawfile, n))
                    while not self._closed:     # bounded put: exit on close
                        try:
                            self._q.put(staged, timeout=0.2)
                            break
                        except queue.Full:
                            pass
            except Exception as e:        # surfaced on the consumer side
                self._err = e
                self._q.put(None)

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="raw-prefetch")
        self._thread.start()

    def get(self) -> torch.Tensor:
        """The next staged batch [n, S, 2] on the device; on CUDA the
        current stream waits for its upload."""
        item = self._q.get()
        if item is None:
            raise self._err
        dev_t, ready = item
        if ready is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ready)
            dev_t.record_stream(cur)
        return dev_t

    def close(self):
        """Stop reading ahead and release staged buffers. After an abnormal
        exit the rawfile cursor is wherever the reader got to — resume via
        the receiver's checkpointed state, not the raw cursor."""
        self._closed = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


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
        if self.cfg.mesh is not None and self.cfg.mesh.device != self.device:
            raise ValueError(f"the mesh's ranks run on {self.cfg.mesh.device},"
                             f" the receiver on {self.device}")
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
        with tracing.span("dpe.build.windows"):
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
        chips = ca_table(self.prn_list)
        with tracing.span("dpe.build.upload"):
            self._dev = device_state(self.grid, chips, self.S, rawfile.fs,
                                     self.device)
            # each manifold's product-grid factors (or None), found once on
            # the uploaded offsets: the scorer's batched calls take them
            self._pos_factors = grid_factors(self._dev.d_enu, self._dev.dt_m)
            self._vel_factors = grid_factors(self._dev.dv_enu,
                                             self._dev.dtdot)
        if self.cfg.engine == "fft":
            # FFT of each channel's nominal code replica: per-block replicas
            # are frequency-domain fractional shifts of it
            self._code_fft0 = torch.from_numpy(dpe_ops.nominal_code_fft(
                chips, rawfile.fs, self.S)).to(self.device)

        self.mc = 0
        self.fixes: list[DPEFix] = []
        # one bool row [C] per fix in every mode: the flip decision
        self.flip_log: list[np.ndarray] = []
        self._sat_cache: SatStateCache | None = None

    # Whole-grid constants of the full EKF and the Newton polish, taken at
    # first use: a default receiver (the cold start's first fix) never pays
    # for the passes over the grid.

    @functools.cached_property
    def _lat_var(self):
        """Per-axis grid lattice variance (ENU+clock) of both manifolds,
        for the adaptive-R quantization floor: uniform-quantizer variance
        spacing^2/12."""
        def lat_var(vals):
            d = np.diff(np.unique(np.round(np.asarray(vals), 6)))
            d = d[d > 0]
            s = float(d.min()) if d.size else 1.0
            return s * s / 12.0

        g = self.grid
        return (np.array([lat_var(g.d_enu[:, j]) for j in range(3)]
                         + [lat_var(g.dt_m)]),
                np.array([lat_var(g.dv_enu[:, j]) for j in range(3)]
                         + [lat_var(g.dtdot)]))

    @functools.cached_property
    def _refine_span(self):
        """How far the Newton polish may leave each grid: 1.5 x its reach
        (position, velocity)."""
        return (np.abs(self.grid.d_enu).max() * 1.5,
                np.abs(self.grid.dv_enu).max() * 1.5)

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
        with tracing.span("dpe.step.prep"):
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
            vel_start = np.clip(
                np.round(vel_idx_c).astype(np.int64) - self.carr_win // 2,
                0, self.carr_fftpts - self.carr_win).astype(np.int32)
            fft = self.cfg.engine == "fft"
            if fft:     # the replica shift, split into int + f32 parts
                m_int, shift0 = dpe_ops.replica_shift_parts(
                    rc_snap, dfc_snap, self.rawfile.fs, self.cfg.T, self.S)
            else:       # the mid-block code phase
                shift0 = np.mod(rc_snap + dfc_snap * (self.cfg.T / 2.0), L_CA)

            # 5. one packed upload, the fused device step (K2 for the scores)
            fpk = np.stack([
                shift0, fi_corr, ri_corr,
                los_enu[:, 0], los_enu[:, 1], los_enu[:, 2], r0,
                pos_idx_c - pos_start, pos_coef,
                vel_idx_c - vel_start, vel_coef]).astype(np.float32)
            ipk = np.stack([idx_next, pos_start, vel_start]).astype(np.int32)
            fp, ip = dpe_real_ops.unpack_params(dpe_real_ops.to_device(
                dpe_real_ops.pack_params(fpk[None], ipk[None], 0),
                self.device))
            fp, ip = fp[0], ip[0]
            params = dpe_ops.ManifoldParams(
                los_enu=fp[3:6].T, r0=fp[6], pos_center=fp[7], pos_coef=fp[8],
                vel_center=fp[9], vel_coef=fp[10])
            d = self._dev
            code_mag = carr_mag = None
        with tracing.span("dpe.step.device"):
            if fft:
                rawf = raw.float()
                (pos_scores, pos_arg, vel_scores, vel_arg,
                 flip_used) = dpe_ops.dpe_device_step(
                    torch.complex(rawf[:, 0], rawf[:, 1]), self._code_fft0,
                    dpe_real_ops.to_device(m_int, self.device), fp[0], ip[0],
                    fp[1], fp[2], d.time_idc, ip[1], ip[2], params, d.d_enu,
                    d.dt_m, d.dv_enu, d.dtdot, carr_fftpts=self.carr_fftpts,
                    l_power=self.cfg.l_power, interp=self.cfg.interp,
                    code_win=self.code_win, carr_win=self.carr_win,
                    mesh=self.cfg.mesh)
            else:
                (pos_scores, pos_arg, vel_scores, vel_arg, flip_used, code_mag,
                 carr_mag) = dpe_real_ops.dpe_device_step_real(
                    raw[:, 0], raw[:, 1], d.chips, fp[0], ip[0], fp[1], fp[2],
                    d.time_idc, ip[1], ip[2], params, d.d_enu, d.dt_m,
                    d.dv_enu, d.dtdot, carr_fftpts=self.carr_fftpts,
                    period=self.period,
                    n_periods=self.S // self.period, l_power=self.cfg.l_power,
                    interp=self.cfg.interp, code_win=self.code_win,
                    carr_win=self.carr_win, mesh=self.cfg.mesh)

            # the first blocking read: the device step is done after it
            with tracing.span("dpe.step.wait"):
                if self.cfg.use_argmax:
                    pa, va = int(pos_arg), int(vel_arg)
                else:
                    ps = pos_scores.cpu().numpy().astype(np.float64)
                    vs = vel_scores.cpu().numpy().astype(np.float64)
        with tracing.span("dpe.step.update"):
            if self.cfg.use_argmax:
                d_enu = self.grid.d_enu[pa]
                dt = self.grid.dt_m[pa]
                dv_enu = self.grid.dv_enu[va]
                dtdot = self.grid.dtdot[va]
                pos_peak = float(pos_scores[pa])
                vel_peak = float(vel_scores[va])
                if self.cfg.refine == "newton":
                    dp = self._refine_ml(
                        code_mag.cpu().numpy(), pos_idx_c - pos_start,
                        pos_coef, los_enu, np.concatenate([d_enu, [dt]]),
                        span=self._refine_span[0])
                    d_enu, dt = dp[0:3], dp[3]
                    dv = self._refine_ml(
                        carr_mag.cpu().numpy(), vel_idx_c - vel_start,
                        vel_coef, los_enu, np.concatenate([dv_enu, [dtdot]]),
                        span=self._refine_span[1])
                    dv_enu, dtdot = dv[0:3], dv[3]
            else:   # score-weighted mean (JAX models/dpe.py:574)
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

            # EKF measurement update (full mode: adaptive R from the score
            # surface curvature; the FFT engine returns no windows, so its full
            # EKF keeps the static R)
            r_meas = None
            if self.cfg.ekf_mode == "full" and code_mag is not None:
                r_meas = self._adaptive_r(
                    code_mag.cpu().numpy(), carr_mag.cpu().numpy(),
                    pos_idx_c - pos_start, pos_coef,
                    vel_idx_c - vel_start, vel_coef, los_enu,
                    np.concatenate([d_enu, [dt]]),
                    np.concatenate([dv_enu, [dtdot]]), r_e2n)
            self.ekf.measurement_update(z, R=r_meas)
            self.rx_time_a = self.rx_time - self.ekf.x[3] / C

            # 6. back-calculate channel frequencies from the updated state
            self._update_channels_from_state()

            if self.cfg.dump_scores_to:
                np.savez(f"{self.cfg.dump_scores_to}/scores_{self.mc:06d}.npz",
                         pos=pos_scores.cpu().numpy(),
                         vel=vel_scores.cpu().numpy())
            self.flip_log.append(flip_used.cpu().numpy().astype(bool))
            fix = DPEFix(mc=self.mc, rx_time=self.rx_time,
                         rx_time_a=self.rx_time_a, x_ecef=self.ekf.x.copy(),
                         pos_score=pos_peak, vel_score=vel_peak)
            self.fixes.append(fix)
            return fix

    def run(self, n_blocks: int):
        for _ in range(n_blocks):
            self.step()
        return self.fixes

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

        full = self.ekf.mode == "full"

        # EKF chain: n time updates (F = I except "full"; routed through
        # time_update for single-source filter math — note the resulting
        # n-predictions-then-updates history is NOT RTS-pairable;
        # rts_smooth validates and refuses it)
        xs = np.empty((n, 8))
        if full:
            for k in range(n):
                xs[k] = self.ekf.time_update()
        else:
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

        if full:
            r_e2ns = [frames.ecef_to_enu_matrix(xs[k, 0:3])
                      for k in range(n)]
        else:
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

    @staticmethod
    def _refine_ml(win_mag, center, coef, los_enu, d0, iters: int = 4,
                   span=None):
        """Continuous ML polish: maximize sum_c q_c(center_c + coef_c *
        (-los_c . d + dt)) over (d_enu, dt) by Newton iterations on the
        per-channel 3-point parabolas. d0: (4,) start (the grid argmax)."""
        c, w = win_mag.shape
        g = np.concatenate([-los_enu, np.ones((c, 1))], axis=1)   # [C, 4]
        d = np.asarray(d0, dtype=np.float64).copy()
        for _ in range(iters):
            idx = center + coef * (g @ d)
            k0 = np.clip(np.round(idx), 1, w - 2).astype(int)
            frac = idx - k0
            y0 = win_mag[np.arange(c), k0 - 1]
            y1 = win_mag[np.arange(c), k0]
            y2 = win_mag[np.arange(c), k0 + 1]
            q1 = 0.5 * (y2 - y0) + (y2 - 2 * y1 + y0) * frac   # dq/didx
            q2 = (y2 - 2 * y1 + y0)                            # d2q/didx2
            grad = (q1 * coef) @ g                             # (4,)
            hess = (g.T * (q2 * coef * coef)) @ g              # [4, 4]
            # Newton toward the max: hess should be negative definite near
            # the peak; regularize and bail out if not
            hd = hess - 1e-9 * np.eye(4)
            try:
                step = np.linalg.solve(hd, -grad)
            except np.linalg.LinAlgError:
                break
            if not np.all(np.isfinite(step)):
                break
            step = np.clip(step, -20.0, 20.0)
            d = d + step
            if span is not None:
                d = np.clip(d, -span, span)
        return d

    @staticmethod
    def _surface_hess_gvar(win_mag, center, coef, los_enu, d):
        """Score-surface Hessian + gradient-noise covariance at offset d
        (ENU+clock coordinates) — the building blocks of both the per-fix
        adaptive R and the joint survey covariance (which sums them over
        epochs)."""
        c, w = win_mag.shape
        g = np.concatenate([-los_enu, np.ones((c, 1))], axis=1)  # [C, 4]
        idx = center + coef * (g @ d)
        k0 = np.clip(np.round(idx), 1, w - 2).astype(int)
        ar = np.arange(c)
        y0 = win_mag[ar, k0 - 1]
        y1 = win_mag[ar, k0]
        y2 = win_mag[ar, k0 + 1]
        q2 = y2 - 2.0 * y1 + y0                  # d2(score)/d(idx)^2
        hess = (g.T * (q2 * coef * coef)) @ g    # [4,4] (negative definite)
        # per-channel score noise: 2nd differences away from the peak have
        # var = 6 sigma^2 for iid window noise
        d2 = win_mag[:, 2:] - 2.0 * win_mag[:, 1:-1] + win_mag[:, :-2]
        cols = np.arange(1, w - 1)[None, :]
        tail = np.abs(cols - k0[:, None]) > 2
        sig2 = np.where(
            tail.any(axis=1),
            np.sum(d2 * d2 * tail, axis=1) / np.maximum(tail.sum(axis=1), 1)
            / 6.0,
            np.mean(d2 * d2, axis=1) / 6.0)
        gvar = 0.5 * sig2 * coef * coef          # central-diff gradient var
        gmat = (g.T * gvar) @ g
        return hess, gmat

    @staticmethod
    def _measurement_cov(win_mag, center, coef, los_enu, d, lat_var4):
        """Per-axis DPE measurement covariance from the score-surface
        curvature at the measured offset (ENU+clock coordinates).

        The argmax displacement under score noise is delta ~= -H^{-1} grad,
        so Cov(delta) = H^{-1} G H^{-1} with H the summed-score Hessian
        (3-point second differences per channel, projected through the
        manifold geometry) and G the gradient-noise covariance (per-channel
        window noise estimated from off-peak second differences). A grid
        quantization floor spacing^2/12 is added per axis.
        """
        hess, gmat = DPEReceiver._surface_hess_gvar(win_mag, center, coef,
                                                    los_enu, d)
        floor = np.diag(lat_var4)
        try:
            hinv = np.linalg.inv(hess - 1e-9 * np.eye(4))
        except np.linalg.LinAlgError:
            return floor * 4.0
        cov = hinv @ gmat @ hinv
        cov = 0.5 * (cov + cov.T) + floor
        evals, evecs = np.linalg.eigh(cov)
        evals = np.clip(evals, lat_var4.min() * 0.25, 1e6)
        return (evecs * evals) @ evecs.T

    def _adaptive_r(self, code_mag, carr_mag, pos_center, pos_coef,
                    vel_center, vel_coef, los_enu, dp4, dv4, r_e2n):
        """8x8 ECEF measurement covariance for the full EKF."""
        rp = self._measurement_cov(code_mag, pos_center, pos_coef,
                                   los_enu, dp4, self._lat_var[0])
        rv = self._measurement_cov(carr_mag, vel_center, vel_coef,
                                   los_enu, dv4, self._lat_var[1])
        t4 = np.eye(4)
        t4[0:3, 0:3] = r_e2n.T
        r = np.zeros((8, 8))
        r[0:4, 0:4] = t4 @ rp @ t4.T
        r[4:8, 4:8] = t4 @ rv @ t4.T
        return r

    def _apply_measurement(self, pa: int, va: int, r_e2n, rx_time, mc,
                           pos_peak, vel_peak, flip_row, x_pred,
                           fpk=None, code_mag=None, carr_mag=None,
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
        r_meas = None
        if (self.cfg.ekf_mode == "full" and code_mag is not None
                and fpk is not None):
            r_meas = self._adaptive_r(
                code_mag, carr_mag, fpk[7], fpk[8], fpk[9], fpk[10],
                fpk[3:6].T, dp4, dv4, r_e2n)
        self.ekf.measurement_update(z, R=r_meas)
        self.flip_log.append(np.asarray(flip_row) != 0)
        fix = DPEFix(mc=mc, rx_time=rx_time,
                     rx_time_a=rx_time - self.ekf.x[3] / C,
                     x_ecef=self.ekf.x.copy(),
                     pos_score=float(pos_peak), vel_score=float(vel_peak))
        self.fixes.append(fix)
        return fix

    def _dispatch_batch(self, n, raw_blocks_dev, start_block, done,
                        raw_staged=None, group_k: int = 1):
        with tracing.span("dpe.prepare"):
            preps = self._prepare_batch(n)
        fpk = np.stack([p[0] for p in preps])                   # [N, 11, C]
        ipk = np.stack([p[1] for p in preps])                   # [N, 3, C]

        if raw_blocks_dev is not None:
            raw_dev = raw_blocks_dev
            start = start_block + done
        else:
            # file mode always stages through the prefetcher (run_batched
            # is the only caller) — one read+upload implementation
            assert raw_staged is not None
            raw_dev = raw_staged                                # [N, S, 2]
            start = 0

        d = self._dev
        rows = dpe_real_ops.dpe_batch_blocks(
            raw_dev, dpe_real_ops.pack_params(fpk, ipk, start), d.chips,
            d.time_idc, d.d_enu, d.dt_m, d.dv_enu, d.dtdot,
            carr_fftpts=self.carr_fftpts, period=self.period,
            n_periods=self.S // self.period, n_blocks=n,
            l_power=self.cfg.l_power, interp=self.cfg.interp,
            return_windows=(self.cfg.refine == "newton"
                            or self.cfg.ekf_mode == "full"),
            code_win=self.code_win, carr_win=self.carr_win, group_k=group_k,
            use_argmax=self.cfg.use_argmax, mesh=self.cfg.mesh,
            factors=(self._pos_factors, self._vel_factors))
        # queue the device->host copy now: it runs as soon as the batch
        # finishes on the device, overlapping the NEXT batch's host prep
        return _fetch_async(rows), preps

    def _drain_batch(self, fetch: _Fetch, preps, group_k: int = 1):
        with tracing.span("dpe.drain.wait"):
            rows = _fetched(fetch)
        with tracing.span("dpe.drain.update"):
            c = len(self.prn_list)
            cw = self.code_win
            vw = self.carr_win
            pas, vas = dpe_real_ops.unpack_row_indices(rows)
            pps = rows[:, 1]
            vps = rows[:, 3]
            flips = rows[:, 4:4 + c]
            base = 4 + c
            wmeans = None
            if not self.cfg.use_argmax:     # weighted-mean cols follow flips
                wmeans = rows[:, base:base + dpe_real_ops.WMEAN_COLS]
                base += dpe_real_ops.WMEAN_COLS
            if rows.shape[1] > base:    # windows present (refine / full EKF)
                code_mags = rows[:, base:base + c * cw].reshape(-1, c, cw)
                carr_mags = rows[:, base + c * cw:].reshape(-1, c, vw)
            else:
                code_mags = carr_mags = None
            for i in range(rows.shape[0]):
                # group_k > 1: one row per K-block coherent group, referenced
                # to the group's LAST block's prediction (same convention as
                # dpe_scan_integrate)
                fpk, _, r_e2n, rx_time, mc, x_pred = preps[
                    (i + 1) * group_k - 1]
                if self.cfg.refine == "newton":
                    self._apply_refined(fpk, r_e2n, rx_time, mc,
                                        int(pas[i]), int(vas[i]),
                                        pps[i], vps[i], flips[i],
                                        code_mags[i], carr_mags[i], x_pred)
                else:
                    self._apply_measurement(int(pas[i]), int(vas[i]), r_e2n,
                                            rx_time, mc, pps[i], vps[i],
                                            flips[i], x_pred, fpk=fpk,
                                            code_mag=(None if code_mags is None
                                                      else code_mags[i]),
                                            carr_mag=(None if carr_mags is None
                                                      else carr_mags[i]),
                                            wmean=(None if wmeans is None
                                                   else wmeans[i]))
            # steer channel frequencies from the newest state at the current
            # epoch
            self.rx_time_a = self.rx_time - self.ekf.x[3] / C
            self._update_channels_from_state()

    def _apply_refined(self, fpk, r_e2n, rx_time, mc, pa, va, pos_peak,
                       vel_peak, flip_row, code_mag, carr_mag, x_pred):
        los_enu = fpk[3:6].T
        d0 = np.concatenate([self.grid.d_enu[pa], [self.grid.dt_m[pa]]])
        dp = self._refine_ml(code_mag, fpk[7], fpk[8], los_enu, d0,
                             span=self._refine_span[0])
        v0 = np.concatenate([self.grid.dv_enu[va], [self.grid.dtdot[va]]])
        dv = self._refine_ml(carr_mag, fpk[9], fpk[10], los_enu, v0,
                             span=self._refine_span[1])
        z = np.asarray(x_pred, dtype=np.float64).copy()
        z[0:3] += r_e2n.T @ dp[0:3]
        z[3] += dp[3]
        z[4:7] += r_e2n.T @ dv[0:3]
        z[7] += dv[3]
        r_meas = None
        if self.cfg.ekf_mode == "full":
            r_meas = self._adaptive_r(code_mag, carr_mag, fpk[7], fpk[8],
                                      fpk[9], fpk[10], los_enu, dp, dv,
                                      r_e2n)
        self.ekf.measurement_update(z, R=r_meas)
        self.flip_log.append(np.asarray(flip_row) != 0)
        fix = DPEFix(mc=mc, rx_time=rx_time,
                     rx_time_a=rx_time - self.ekf.x[3] / C,
                     x_ecef=self.ekf.x.copy(),
                     pos_score=float(pos_peak), vel_score=float(vel_peak))
        self.fixes.append(fix)
        return fix

    def run_integrated(self, n_batches: int, blocks_per_fix: int = 8,
                       raw_blocks_dev: torch.Tensor | None = None,
                       start_block: int = 0, coherent: bool = False,
                       _collect: list | None = None, feedback: bool = True):
        """Integrated DPE: one fix per `blocks_per_fix` blocks with the
        score surfaces accumulated on device (noncoherent integration).
        Trades fix rate for ~sqrt(N) lower score noise.

        coherent=True sums the complex correlation windows instead (with
        data-aided nav-bit alignment): equal accuracy at practical C/N0,
        but ONE manifold scoring pass per fix instead of per block — the
        N x cheaper path for dense-grid integration.

        feedback=False (coast / open-loop mode): the per-batch argmax is
        recorded as a diagnostic fix but NOT applied to the EKF state, so
        channel steering runs on pure geometric prediction from the
        initial state. At low C/N0 the per-batch argmax is too noisy to
        steer with — feeding it back corrupts the window centers and the
        run never recovers; coasting keeps the windows centered for the
        full-pass survey solve (weak-signal mode)."""
        if self.cfg.engine != "real":
            raise ValueError(
                "integrated mode runs on engine='real' only; engine='fft' "
                "is the per-block cross-validation oracle (see "
                "DPEConfig.engine)")
        self._check_batch_mode(raw_blocks_dev, start_block,
                               n_batches * blocks_per_fix)
        prefetch = (_RawPrefetcher(self.rawfile,
                                   [blocks_per_fix] * n_batches, self.device)
                    if raw_blocks_dev is None else None)
        try:
            return self._run_integrated(n_batches, blocks_per_fix,
                                        raw_blocks_dev, start_block,
                                        coherent, prefetch, _collect,
                                        feedback)
        finally:
            if prefetch is not None:
                prefetch.close()

    def _run_integrated(self, n_batches, blocks_per_fix, raw_blocks_dev,
                        start_block, coherent, prefetch, collect=None,
                        feedback=True):
        done = 0
        c = len(self.prn_list)
        d = self._dev
        for _ in range(n_batches):
            n = blocks_per_fix
            preps = self._prepare_batch(n)
            fpk = np.stack([p[0] for p in preps])
            ipk = np.stack([p[1] for p in preps])
            if raw_blocks_dev is None:
                raw_dev = prefetch.get()
                start = 0
            else:
                raw_dev = raw_blocks_dev
                start = start_block + done
            # sub-grid Newton polish needs the integrated windows; the
            # coherent path is the one that forms a single summed window.
            # With the noise integrated away the polish is limited by the
            # 3-tap interpolant's vertex bias, which cancels in the argmax
            # (all candidates go through the same interpolant): newton for
            # off-lattice smoothness, argmax for absolute accuracy on
            # dense grids.
            refine = self.cfg.refine == "newton" and coherent
            want_windows = refine or collect is not None
            res = dpe_real_ops.dpe_scan_integrate(
                raw_dev, dpe_real_ops.pack_params(fpk, ipk, start), d.chips,
                d.time_idc, d.d_enu, d.dt_m, d.dv_enu, d.dtdot,
                carr_fftpts=self.carr_fftpts, period=self.period,
                n_periods=self.S // self.period, n_blocks=n,
                l_power=self.cfg.l_power, interp=self.cfg.interp,
                code_win=self.code_win, carr_win=self.carr_win,
                coherent=coherent, return_windows=want_windows,
                use_argmax=self.cfg.use_argmax, mesh=self.cfg.mesh,
                factors=(self._pos_factors, self._vel_factors))
            # one device->host fetch: head, the last block's flips, windows
            flat = _fetched(_fetch_async(torch.cat(
                [res[0], res[1][-1].float()]
                + [w.reshape(-1) for w in res[2:]])))
            n_head = res[0].shape[0]
            row = flat[:n_head]
            flip_last = flat[n_head:n_head + c]
            pa_i, va_i = dpe_real_ops.unpack_row_indices(row[None, :])
            pa_i, va_i = int(pa_i[0]), int(va_i[0])
            wmean = row[4:12] if not self.cfg.use_argmax else None
            # the measurement is referenced to the LAST block's prediction
            # (identical to every other block's: X frozen during the batch)
            fpk_last, _, r_e2n, rx_time, mc, x_pred = preps[-1]
            code_mag = carr_mag = None
            if want_windows:
                base = n_head + c
                code_mag = flat[base:base + c * self.code_win].reshape(
                    c, self.code_win)
                carr_mag = flat[base + c * self.code_win:].reshape(
                    c, self.carr_win)
            if not feedback:
                # coast: record the argmax as a diagnostic fix, leave the
                # EKF state (and so the channel steering) on prediction
                z = np.asarray(x_pred, dtype=np.float64).copy()
                z[0:3] += r_e2n.T @ self.grid.d_enu[pa_i]
                z[3] += self.grid.dt_m[pa_i]
                z[4:7] += r_e2n.T @ self.grid.dv_enu[va_i]
                z[7] += self.grid.dtdot[va_i]
                self.flip_log.append(flip_last != 0)
                self.fixes.append(DPEFix(
                    mc=mc, rx_time=rx_time,
                    rx_time_a=rx_time - self.ekf.x[3] / C, x_ecef=z,
                    pos_score=float(row[1]), vel_score=float(row[3])))
            elif refine:
                self._apply_refined(fpk_last, r_e2n, rx_time, mc,
                                    pa_i, va_i, row[1], row[3], flip_last,
                                    code_mag, carr_mag, x_pred)
            else:
                self._apply_measurement(pa_i, va_i, r_e2n,
                                        rx_time, mc, row[1], row[3],
                                        flip_last, x_pred, wmean=wmean)
            if collect is not None:
                collect.append((code_mag, carr_mag, fpk_last, r_e2n,
                                rx_time, x_pred))
            self.rx_time_a = self.rx_time - self.ekf.x[3] / C
            self._update_channels_from_state()
            done += n
        return self.fixes

    def noise_envelope(self, blocks_per_fix: int = 16, n_batches: int = 8,
                       seed: int = 0):
        """Deterministic per-lag noise gain of the integrated noncoherent
        windows: (env_code [Wc], env_carr [Wv]), each normalized to mean 1.

        The windowed correlation algebra does not have a flat noise
        floor: the two-stage folded carrier DFT attenuates noise away
        from the fold center with the same Dirichlet envelope as the
        signal, and the code window's flip/no-flip max-selection inflates
        E|noise| at the decision lag. Summed noncoherently over hundreds
        of blocks these deterministic bumps dominate the integrated
        surface long before thermal noise does — an un-normalized
        weak-signal joint solve "finds" the window center (= the coasted
        prediction) at arbitrarily low C/N0. This calibrates the envelope
        empirically by streaming white noise through the IDENTICAL engine
        config on a throwaway receiver built from the current state."""
        noise = white_noise_iq16(self.S * blocks_per_fix * n_batches, seed)
        h = self.save_handoff()
        h.bytes_read = 0
        cal = DPEReceiver(
            SampleFile(samples=noise, fs=self.rawfile.fs,
                       ds=self.rawfile.ds),
            h, grid=self.grid, config=self.cfg, device=self.device)
        collect: list = []
        cal.run_integrated(n_batches, blocks_per_fix, coherent=False,
                           feedback=False, _collect=collect)
        env_code = np.stack([c[0] for c in collect]).mean(axis=(0, 1))
        env_carr = np.stack([c[1] for c in collect]).mean(axis=(0, 1))
        return (env_code / env_code.mean(), env_carr / env_carr.mean())

    def run_survey(self, n_batches: int, blocks_per_fix: int = 50,
                   raw_blocks_dev: torch.Tensor | None = None,
                   start_block: int = 0,
                   fine_spacing: float = 0.25, fine_n: int = 33,
                   vel_fine_spacing: float = 0.02,
                   zoom_interp: str | None = None,
                   coherent: bool = True,
                   feedback: bool = True,
                   envelope="auto") -> SurveyResult:
        """Multi-epoch joint DPE: ONE position-clock state estimated
        against the WHOLE pass (static-receiver survey mode).

        Phase 1 streams the pass through the coherent integrated engine
        (run_integrated — per-batch fixes keep the channel steering
        centered and land in self.fixes as usual), collecting each batch's
        integrated correlation windows + manifold geometry. Phase 2
        re-references every batch to one common state under a linear
        clock-drift model (drift estimated first from the joint
        velocity-drift manifold) and scores the joint 4-D manifold across
        ALL batches at once (ops.dpe_real.score_joint_argmax): score noise
        integrates down over the full pass while satellite motion adds
        genuine geometric diversity across epochs. A coarse pass on the
        receiver grid is followed by a fine lattice (fine_n^4 points at
        fine_spacing m / vel_fine_spacing m/s).

        Weak-signal mode: coherent=False collects NONCOHERENT batch
        windows (per-block magnitudes summed on the common window frame —
        no nav-bit alignment needed), and feedback=False coasts the
        channel steering on pure prediction so a noisy per-batch argmax
        can never corrupt the window centers. The joint solve then
        integrates the whole pass.

        envelope: noise-floor equalization of the collected windows (see
        noise_envelope). "auto" (default) calibrates and applies it on
        the noncoherent path — without it the deterministic window
        envelope pins the weak-signal argmax to the coasted prediction
        at arbitrarily low C/N0 (a false "hold"). Pass a precomputed
        (env_code, env_carr) to amortize the calibration across runs, or
        None to disable (coherent default: the strong-signal peak
        dominates the envelope; estimates unchanged).

        zoom_interp="sinc" reconstructs the bandlimited correlation
        exactly in the zoom passes, removing the 3-tap interpolant's
        common vertex bias from the clock estimate; the default keeps the
        estimator identical to the per-block scorer.
        """
        if envelope == "auto":
            # calibrate BEFORE the pass advances the receiver state
            envelope = (self.noise_envelope(blocks_per_fix=blocks_per_fix,
                                            n_batches=max(
                                                2, 96 // blocks_per_fix))
                        if not coherent else None)
        collect: list = []
        self.run_integrated(n_batches, blocks_per_fix, raw_blocks_dev,
                            start_block, coherent=coherent,
                            _collect=collect, feedback=feedback)
        if envelope is not None:
            env_c, env_v = envelope
            collect = [(c[0] / env_c[None, :], c[1] / env_v[None, :],
                        *c[2:]) for c in collect]
        return self._survey_solve(collect, n_batches * blocks_per_fix,
                                  fine_spacing, fine_n, vel_fine_spacing,
                                  zoom_interp)

    def _joint_argmax(self, win, los, centers, coefs, r0, off3, off1,
                      interp: str | None = None, factors=None):
        """(argmax offsets, peak) of the joint multi-epoch surface; factors:
        the grid's `grid_factors` (the receiver's own grid), or None."""
        def f32(a):
            return dpe_real_ops.to_device(
                np.ascontiguousarray(a, np.float32), self.device)

        best, arg = dpe_real_ops.score_joint_argmax(
            f32(win), f32(los), f32(centers), f32(coefs),
            f32(r0 if r0 is not None else np.zeros_like(centers)),
            f32(off3), f32(np.broadcast_to(off1, off3.shape[:1])),
            interp=interp or self.cfg.interp, l_power=self.cfg.l_power,
            has_r0=r0 is not None, mesh=self.cfg.mesh, factors=factors)
        a = int(arg)
        return (np.asarray(off3[a], np.float64).copy(),
                float(np.asarray(off1).reshape(-1)[a]
                      if np.ndim(off1) else off1), float(best))

    def _survey_solve(self, collect, n_blocks, fine_spacing, fine_n,
                      vel_fine_spacing,
                      zoom_interp: str | None = None) -> SurveyResult:
        b_n = len(collect)
        code_mag = np.stack([c[0] for c in collect])        # [B, C, Wc]
        carr_mag = np.stack([c[1] for c in collect])        # [B, C, Wv]
        fpk = np.stack([c[2] for c in collect]).astype(np.float64)
        r_e2n = collect[-1][3]
        rx_times = np.array([c[4] for c in collect])
        xs = np.stack([c[5] for c in collect]).astype(np.float64)  # [B, 8]
        t_ref = float(rx_times[-1])
        x_ref = xs[-1].copy()
        los = np.transpose(fpk[:, 3:6], (0, 2, 1))          # [B, C, 3]

        # -- stage 1: joint velocity/drift (drift feeds the clock model) --
        # re-reference each batch's centers to the common state: candidate
        # v = x_ref + grid, so the displacement from batch b's prediction
        # is R(x_ref - x_b) + grid; the batch part folds into the centers.
        dvb = (x_ref[None, 4:7] - xs[:, 4:7]) @ r_e2n.T     # [B, 3] ENU
        ddb = x_ref[7] - xs[:, 7]                           # [B]
        vcen = fpk[:, 9] + fpk[:, 10] * (-np.einsum("bci,bi->bc", los, dvb)
                                         + ddb[:, None])
        dv3, dd1, vel_peak = self._joint_argmax(
            carr_mag, los, vcen, fpk[:, 10], None,
            self.grid.dv_enu, self.grid.dtdot, factors=self._vel_factors)
        # zoom: mid lattice covers the coarse grid's quantization cell,
        # fine lattice resolves the final estimate
        for sp in (4.0 * vel_fine_spacing, vel_fine_spacing):
            ax_v = (np.arange(fine_n) - (fine_n - 1) / 2.0) * sp
            off3v, off1v = _mesh4(ax_v, ax_v)
            dv3, dd1, vel_peak = self._joint_argmax(
                carr_mag, los, vcen, fpk[:, 10], None,
                dv3[None, :] + off3v, dd1 + off1v, interp=zoom_interp)
        d_hat = x_ref[7] + dd1                          # drift at reference

        # -- stage 2: joint position/clock under the linear clock model --
        # candidate clock at batch b: b_ref + d_hat*(t_b - t_ref) + grid
        dpb = (x_ref[None, 0:3] - xs[:, 0:3]) @ r_e2n.T     # [B, 3] ENU
        dbb = (x_ref[3] + d_hat * (rx_times - t_ref)) - xs[:, 3]
        pcen = fpk[:, 7] + fpk[:, 8] * (-np.einsum("bci,bi->bc", los, dpb)
                                        + dbb[:, None])
        dp3, db1, pos_peak = self._joint_argmax(
            code_mag, los, pcen, fpk[:, 8], fpk[:, 6],
            self.grid.d_enu, self.grid.dt_m, factors=self._pos_factors)
        for sp in (4.0 * fine_spacing, fine_spacing):
            ax_p = (np.arange(fine_n) - (fine_n - 1) / 2.0) * sp
            off3p, off1p = _mesh4(ax_p, ax_p)
            dp3, db1, pos_peak = self._joint_argmax(
                code_mag, los, pcen, fpk[:, 8], fpk[:, 6],
                dp3[None, :] + off3p, db1 + off1p, interp=zoom_interp)

        # -- joint covariance: per-epoch Hessians/gradient noise summed --
        hp = gp = hv = gv = 0.0
        for b in range(b_n):
            d_p = np.concatenate([dpb[b] + dp3, [dbb[b] + db1]])
            h, g2 = self._surface_hess_gvar(code_mag[b], fpk[b, 7],
                                            fpk[b, 8], los[b], d_p)
            hp, gp = hp + h, gp + g2
            d_v = np.concatenate([dvb[b] + dv3, [ddb[b] + dd1]])
            h, g2 = self._surface_hess_gvar(carr_mag[b], fpk[b, 9],
                                            fpk[b, 10], los[b], d_v)
            hv, gv = hv + h, gv + g2

        def _cov(h, g2, spacing):
            try:
                hinv = np.linalg.inv(h - 1e-9 * np.eye(4))
                cov = hinv @ g2 @ hinv
            except np.linalg.LinAlgError:
                cov = np.full((4, 4), np.inf)
            cov = 0.5 * (cov + cov.T) + (spacing ** 2 / 12.0) * np.eye(4)
            return cov, np.sqrt(np.clip(np.diag(cov), 0.0, None))

        cov_p, sig_p = _cov(hp, gp, fine_spacing)
        cov_v, sig_v = _cov(hv, gv, vel_fine_spacing)
        x = x_ref.copy()
        x[0:3] += r_e2n.T @ dp3
        x[3] += db1
        x[4:7] += r_e2n.T @ dv3
        x[7] += dd1
        return SurveyResult(
            x_ecef=x, t_ref=t_ref, n_blocks=n_blocks, n_batches=b_n,
            pos_score=pos_peak, vel_score=vel_peak,
            sigma_pos=sig_p, sigma_vel=sig_v, cov_pos=cov_p, cov_vel=cov_v,
            d_enu_t=np.concatenate([dp3, [db1]]))

    def _check_batch_mode(self, raw_blocks_dev, start_block, n_blocks):
        """Reject configurations the batched/integrated device paths do not
        honor, instead of silently diverging from run(): score dumps, and a
        device-resident capture they cannot use (torch slicing of the
        capture would silently truncate where it runs out)."""
        if self.cfg.dump_scores_to:
            raise ValueError(
                "dump_scores_to needs the per-block run() path (batched/"
                "integrated modes never materialize the score surfaces)")
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
        the SampleFile by a read-ahead thread and uploaded per batch
        (`_RawPrefetcher`).

        group_k > 1: coherent-grouped fixes — each group of group_k
        consecutive blocks is coherently summed on the device before
        manifold scoring, one fix per group. Requires lookahead and
        n_blocks to be multiples of group_k.
        """
        if self.cfg.engine != "real":
            raise ValueError(
                "batched mode runs on engine='real' only; engine='fft' is "
                "the per-block cross-validation oracle (see "
                "DPEConfig.engine)")
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
        # file-based streaming: a reader thread stages batch k+1's samples
        # on the device while batch k computes
        prefetch = (_RawPrefetcher(self.rawfile, sizes, self.device)
                    if raw_blocks_dev is None else None)
        try:
            done = 0
            depth = max(1, int(pipeline_depth)) if pipeline else 0
            pending = deque()
            for n in sizes:
                staged = prefetch.get() if prefetch is not None else None
                pending.append(self._dispatch_batch(n, raw_blocks_dev,
                                                    start_block, done,
                                                    raw_staged=staged,
                                                    group_k=group_k))
                done += n
                if len(pending) > depth:
                    self._drain_batch(*pending.popleft(), group_k=group_k)
            while pending:
                self._drain_batch(*pending.popleft(), group_k=group_k)
            return self.fixes
        finally:
            if prefetch is not None:
                prefetch.close()
