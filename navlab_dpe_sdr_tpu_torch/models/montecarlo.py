"""Monte-Carlo automation harness: init-perturbation and grid-spacing sweeps.

Product surface for the reference's commented-out automation harnesses
(cudarecv/src/main.cu:105-224 random-initial-state runs writing indexed
XECEF logs + a shift file; main.cu:257-280 GridDimSpacing sweep) and for
pygnss's perturbed deep-init (receiver.py:181-192). Runs are sequential
receiver passes over the same capture, each on a fresh DPEReceiver.

Port of navlab_dpe_sdr_tpu/models/montecarlo.py: the host logic, rows,
CSV, shift-file and summary formats are the JAX module's; every receiver
runs on `device` (default "cuda"; a missing card raises). There is no
compiled executable to reuse across runs: the kernels are built once per
process (ops/_build.py), and a run's fixed cost is its receiver's
construction (the grid and chip table uploaded) and its first block.
"""

from __future__ import annotations

import copy
import csv
import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..io.rawfile import DTYPE_IQ16, SampleFile
from ..io.scenario import make_scenario
from ..libgnss import frames
from .dpe import DPEReceiver
from .grid import make_grid, spread_grid


@dataclass
class MCRun:
    """One Monte-Carlo run: the applied perturbation and fix-error stats."""
    idx: int
    shift_enu: tuple = (0.0, 0.0, 0.0)   # applied init offset [m] (E, N, U)
    dt_m: float = 0.0                    # applied clock-bias offset [m]
    spacing: float | None = None         # grid spacing [m] (spacing sweeps)
    radius_m: float = 0.0                # |(shift, dt)| 4D perturbation size
    final_err_m: float = float("nan")    # last-fix position error vs truth
    median_err_m: float = float("nan")   # median error over the second half
    converged: bool = False
    errs: list = field(default_factory=list)

    def row(self):
        return [self.idx, *(round(s, 3) for s in self.shift_enu),
                round(self.dt_m, 3),
                "" if self.spacing is None else self.spacing,
                round(self.final_err_m, 3), round(self.median_err_m, 3),
                int(self.converged)]


ROW_HEADER = ["idx", "dE_m", "dN_m", "dU_m", "dt_m", "spacing_m",
              "final_err_m", "median_err_m", "converged"]


def _signed_band(rng, bottom: float, span: float) -> float:
    """Uniform magnitude in [bottom, bottom+span], random sign — the
    reference's shiftBottom/shiftRange draw (main.cu:148-186)."""
    mag = rng.uniform(bottom, bottom + span)
    return mag if rng.uniform() < 0.5 else -mag


def draw_perturbation(rng, bottom: float = 50.0, span: float = 30.0,
                      time_band: tuple[float, float] | None = None):
    """One ENU + clock draw: horizontal magnitude in the signed band at a
    random bearing, vertical in the signed band, optional clock-bias band."""
    mag = _signed_band(rng, bottom, span)
    theta = rng.uniform(0.0, 2.0 * np.pi)
    d_enu = np.array([mag * np.cos(theta), mag * np.sin(theta),
                      _signed_band(rng, bottom, span)])
    dt = _signed_band(rng, *time_band) if time_band else 0.0
    return d_enu, dt


def _one_run(capture, hand, d_enu, dt_m, grid, config, blocks, fs,
             truth_ecef, device):
    h2 = copy.deepcopy(hand)
    h2.x_ecef = hand.x_ecef.copy()
    h2.x_ecef[0:3] = frames.enu_to_ecef(hand.x_ecef[0:3], np.asarray(d_enu))
    h2.x_ecef[3] += dt_m

    rf = SampleFile(capture, fs=fs)
    rx = DPEReceiver(rf, h2, grid=grid, config=config, device=device)
    fixes = rx.run(blocks)
    errs = [float(np.linalg.norm(f.x_ecef[0:3] - truth_ecef[0:3]))
            for f in fixes]
    return rx, errs


def _finish(run: MCRun, errs, converge_m: float):
    run.errs = errs
    run.final_err_m = errs[-1] if errs else float("nan")
    half = errs[len(errs) // 2:]
    run.median_err_m = float(np.median(half)) if half else float("nan")
    run.converged = bool(half) and run.median_err_m < converge_m
    return run


def _write_xecef(out_dir, idx, rx, weekno=None):
    path = os.path.join(out_dir, f"run{idx:03d}_XFile.csv")
    with open(path, "w", newline="") as fo:
        w = csv.writer(fo)
        for f in rx.fixes:
            w.writerow([f"{v:.6f}" for v in
                        [f.rx_time, *f.x_ecef]])
    return path


def perturbation_sweep(capture, hand, runs: int = 100, blocks: int = 50,
                       bottom: float = 50.0, span: float = 30.0,
                       time_band=None, grid=None, config=None,
                       converge_m: float = 20.0, seed: int = 0,
                       out_dir: str | None = None, fs: float = 2.5e6,
                       truth_ecef=None, verbose: bool = True,
                       device: str | torch.device = "cuda") -> list[MCRun]:
    """N receiver passes from randomly perturbed initial states
    (reference main.cu:140-219: 100 runs, |shift| in 50-80 m per axis)."""
    device = resolve_device(device)
    grid = grid or spread_grid()
    truth = np.asarray(truth_ecef if truth_ecef is not None else hand.x_ecef)
    rng = np.random.default_rng(seed)
    results = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for idx in range(runs):
        d_enu, dt = draw_perturbation(rng, bottom, span, time_band)
        run = MCRun(idx=idx, shift_enu=tuple(d_enu), dt_m=dt,
                    radius_m=float(np.linalg.norm([*d_enu, dt])))
        rx, errs = _one_run(capture, hand, d_enu, dt, grid, config, blocks,
                            fs, truth, device)
        _finish(run, errs, converge_m)
        if out_dir:
            _write_xecef(out_dir, idx, rx)
        results.append(run)
        if verbose:
            print(f"run {idx:3d}: |d|={run.radius_m:6.1f} m  "
                  f"final={run.final_err_m:8.1f} m  "
                  f"median={run.median_err_m:8.1f} m  "
                  f"{'CONVERGED' if run.converged else 'diverged'}")
    if out_dir:
        write_shift_file(os.path.join(out_dir, "shifts.csv"), results)
    return results


def spacing_sweep(capture, hand, spacings, blocks: int = 50, grid_n: int = 25,
                  style: str = "uniform", config=None,
                  converge_m: float = 20.0,
                  out_dir: str | None = None, fs: float = 2.5e6,
                  truth_ecef=None, verbose: bool = True,
                  device: str | torch.device = "cuda") -> list[MCRun]:
    """Grid-spacing sweep (reference main.cu:257-277: GridDimSpacing
    7.0..10.0 m in 0.5 m steps over repeated runs). style picks the axis
    family: uniform / exponential / arthur (make_grid styles)."""
    device = resolve_device(device)
    truth = np.asarray(truth_ecef if truth_ecef is not None else hand.x_ecef)
    results = []
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for idx, s in enumerate(spacings):
        grid = make_grid(style, n=grid_n, pos_spacing=float(s))
        run = MCRun(idx=idx, spacing=float(s))
        rx, errs = _one_run(capture, hand, np.zeros(3), 0.0, grid, config,
                            blocks, fs, truth, device)
        _finish(run, errs, converge_m)
        if out_dir:
            _write_xecef(out_dir, idx, rx)
        results.append(run)
        if verbose:
            print(f"spacing {s:5.2f} m: final={run.final_err_m:8.1f} m  "
                  f"median={run.median_err_m:8.1f} m  "
                  f"{'CONVERGED' if run.converged else 'diverged'}")
    return results


@dataclass
class SensPoint:
    """One C/N0 level of a sensitivity ladder."""
    cn0_dbhz: float
    per_block_med_m: float = float("nan")
    integrated_med_m: float = float("nan")
    coherent_med_m: float | None = None
    held: bool = False                  # integrated median < hold_m


SENS_HEADER = ["cn0_dbhz", "per_block_med_m", "integrated_med_m",
               "coherent_med_m", "held"]


def cn0_sweep(levels, blocks: int = 32, blocks_per_fix: int = 8,
              seed: int = 7, grid=None, config=None, hold_m: float = 30.0,
              coherent: bool = False, out_path: str | None = None,
              fs: float = 2.5e6, verbose: bool = True,
              device: str | torch.device = "cuda") -> list[SensPoint]:
    """Signal-sensitivity ladder — a capability sweep beyond the reference
    harnesses (which only perturb geometry, main.cu:140-277): synthesize
    the standard 8-satellite scenario at each C/N0, run the receiver from
    exact init, and record the per-block argmax error next to the K-block
    on-device integrated error. Shows where the per-block estimator breaks
    and how far score integration extends the hold (the integrated surface
    gains sqrt(K) in score SNR with no extra host traffic)."""
    device = resolve_device(device)
    grid = grid or spread_grid()
    results = []
    for cn0 in levels:
        sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=float(cn0),
                                       seed=seed)
        n = 50000 * blocks
        iq = sim.generate(n)
        samples = np.empty(n, DTYPE_IQ16)
        samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
        samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
        truth = hand.x_ecef

        def _med(fixes, skip):
            errs = [float(np.linalg.norm(f.x_ecef[0:3] - truth[0:3]))
                    for f in fixes[skip:]]
            return float(np.median(errs)) if errs else float("nan")

        pt = SensPoint(cn0_dbhz=float(cn0))
        rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=fs),
                         copy.deepcopy(hand), grid=grid, config=config,
                         eph=copy.deepcopy(arr), device=device)
        pt.per_block_med_m = _med(rx.run(blocks), blocks // 2)

        rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=fs),
                         copy.deepcopy(hand), grid=grid, config=config,
                         eph=copy.deepcopy(arr), device=device)
        rx.run_integrated(blocks // blocks_per_fix, blocks_per_fix)
        pt.integrated_med_m = _med(rx.fixes, 1)

        if coherent:
            rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=fs),
                             copy.deepcopy(hand), grid=grid, config=config,
                             eph=copy.deepcopy(arr), device=device)
            rx.run_integrated(blocks // blocks_per_fix, blocks_per_fix,
                              coherent=True)
            pt.coherent_med_m = _med(rx.fixes, 1)

        pt.held = pt.integrated_med_m < hold_m
        results.append(pt)
        if verbose:
            coh = ("" if pt.coherent_med_m is None
                   else f"  coherent={pt.coherent_med_m:7.1f} m")
            print(f"C/N0 {cn0:5.1f} dB-Hz: per-block="
                  f"{pt.per_block_med_m:7.1f} m  integrated(K="
                  f"{blocks_per_fix})={pt.integrated_med_m:7.1f} m{coh}  "
                  f"{'HELD' if pt.held else 'lost'}")
    if out_path:
        with open(out_path, "w", newline="") as fo:
            w = csv.writer(fo)
            w.writerow(SENS_HEADER)
            for pt in results:
                w.writerow([pt.cn0_dbhz, round(pt.per_block_med_m, 2),
                            round(pt.integrated_med_m, 2),
                            ("" if pt.coherent_med_m is None
                             else round(pt.coherent_med_m, 2)),
                            int(pt.held)])
    return results


@dataclass
class WeakPoint:
    """One C/N0 level of the weak-signal (coast + survey) ladder."""
    cn0_dbhz: float
    integrated_med_m: float = float("nan")  # closed-loop K-block integrated
    survey_err_m: float = float("nan")      # full-pass joint, coast steering
    survey_sigma_m: float = float("nan")    # predicted 3-D 1-sigma (joint cov)
    held: bool = False                      # survey_err_m < hold_m


WEAK_HEADER = ["cn0_dbhz", "integrated_med_m", "survey_err_m",
               "survey_sigma_m", "held"]


def weak_sweep(levels, blocks: int = 512, blocks_per_fix: int = 16,
               seed: int = 7, grid=None, config=None, hold_m: float = 30.0,
               out_path: str | None = None, fs: float = 2.5e6,
               fine_spacing: float = 1.0, fine_n: int = 17,
               vel_fine_spacing: float = 0.05,
               verbose: bool = True,
               device: str | torch.device = "cuda") -> list[WeakPoint]:
    """Weak-signal ladder: closed-loop K-block integration (the SENS_DEEP
    estimator) vs the full-pass open-loop survey estimator at each C/N0.

    The survey column is the weak-signal mode: channel steering coasts on
    pure prediction (feedback=False — below ~22 dB-Hz the per-batch argmax
    is too noisy to steer with), batch windows integrate noncoherently (no
    nav-bit decisions), and ONE joint 4-D state is estimated against the
    whole pass. Full-pass noncoherent gain extends the fix floor far below
    the per-batch hold — the deep-integration regime the reference's
    per-block fetch architecture cannot reach (batchcorrmanifold.cu scores
    and discards one surface per 20 ms Update)."""
    device = resolve_device(device)
    grid = grid or spread_grid()
    results = []
    envelope = None   # noise envelope depends only on grid/config —
    for cn0 in levels:  # calibrate once, reuse across the ladder
        sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=float(cn0),
                                       seed=seed)
        n = 50000 * blocks
        iq = sim.generate(n)
        samples = np.empty(n, DTYPE_IQ16)
        samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
        samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
        truth = hand.x_ecef
        pt = WeakPoint(cn0_dbhz=float(cn0))

        rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=fs),
                         copy.deepcopy(hand), grid=grid, config=config,
                         eph=copy.deepcopy(arr), device=device)
        rx.run_integrated(blocks // blocks_per_fix, blocks_per_fix)
        errs = [float(np.linalg.norm(f.x_ecef[0:3] - truth[0:3]))
                for f in rx.fixes[1:]]
        pt.integrated_med_m = float(np.median(errs)) if errs else float("nan")

        rx = DPEReceiver(SampleFile(samples=samples.copy(), fs=fs),
                         copy.deepcopy(hand), grid=grid, config=config,
                         eph=copy.deepcopy(arr), device=device)
        if envelope is None:
            envelope = rx.noise_envelope(
                blocks_per_fix=blocks_per_fix,
                n_batches=max(2, 96 // blocks_per_fix))
        sr = rx.run_survey(blocks // blocks_per_fix, blocks_per_fix,
                           coherent=False, feedback=False,
                           fine_spacing=fine_spacing, fine_n=fine_n,
                           vel_fine_spacing=vel_fine_spacing,
                           envelope=envelope)
        pt.survey_err_m = float(np.linalg.norm(sr.x_ecef[0:3] - truth[0:3]))
        pt.survey_sigma_m = float(np.sqrt(np.sum(sr.sigma_pos[0:3] ** 2)))
        pt.held = pt.survey_err_m < hold_m
        results.append(pt)
        if verbose:
            print(f"C/N0 {cn0:5.1f} dB-Hz: integrated(K={blocks_per_fix})="
                  f"{pt.integrated_med_m:7.1f} m  survey({blocks} blk)="
                  f"{pt.survey_err_m:7.1f} m (sigma {pt.survey_sigma_m:.1f})"
                  f"  {'HELD' if pt.held else 'lost'}")
    if out_path:
        with open(out_path, "w", newline="") as fo:
            w = csv.writer(fo)
            w.writerow(WEAK_HEADER)
            for pt in results:
                w.writerow([pt.cn0_dbhz, round(pt.integrated_med_m, 2),
                            round(pt.survey_err_m, 2),
                            round(pt.survey_sigma_m, 2), int(pt.held)])
    return results


def write_shift_file(path: str, results: list[MCRun]):
    """Shift/summary CSV (reference shiftFile, main.cu:135-206)."""
    with open(path, "w", newline="") as fo:
        w = csv.writer(fo)
        w.writerow(ROW_HEADER)
        for r in results:
            w.writerow(r.row())


def convergence_summary(results: list[MCRun], n_bins: int = 4) -> dict:
    """Convergence-rate vs perturbation-radius table."""
    if not results:
        return {"runs": 0, "bins": []}
    radii = np.array([r.radius_m for r in results])
    conv = np.array([r.converged for r in results])
    edges = np.linspace(radii.min(), radii.max() + 1e-9, n_bins + 1)
    bins = []
    for i in range(n_bins):
        m = (radii >= edges[i]) & (radii < edges[i + 1])
        if not m.any():
            continue
        bins.append({
            "radius_lo_m": round(float(edges[i]), 1),
            "radius_hi_m": round(float(edges[i + 1]), 1),
            "runs": int(m.sum()),
            "converged": int(conv[m].sum()),
            "rate": round(float(conv[m].mean()), 3),
            "median_final_m": round(
                float(np.median([results[j].final_err_m
                                 for j in np.flatnonzero(m)])), 2),
        })
    return {"runs": len(results),
            "converged": int(conv.sum()),
            "rate": round(float(conv.mean()), 3),
            "bins": bins}


def format_summary(summary: dict) -> str:
    lines = [f"{summary['runs']} runs, {summary.get('converged', 0)} "
             f"converged ({100.0 * summary.get('rate', 0):.0f}%)"]
    for b in summary["bins"]:
        lines.append(
            f"  |d| {b['radius_lo_m']:6.1f}-{b['radius_hi_m']:6.1f} m: "
            f"{b['converged']:3d}/{b['runs']:3d} ({100 * b['rate']:3.0f}%)  "
            f"median final {b['median_final_m']:.1f} m")
    return "\n".join(lines)


def save_summary(path: str, summary: dict, results: list[MCRun]):
    with open(path, "w") as fo:
        json.dump({"summary": summary,
                   "runs": [dict(zip(ROW_HEADER, r.row()))
                            for r in results]}, fo, indent=1)
