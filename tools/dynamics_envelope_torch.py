"""Dynamics envelope of the pipelined/grouped DPE defaults, on the port.

The port of tools/dynamics_envelope.py. The bench's default config
(pipeline depth 4 x lookahead 50 x group_k 5) coasts 4 s between
measurement feedbacks, a choice made for the static benchmark. This tool
measures where that trade breaks: three receiver-dynamics profiles
(walking ~1.5 m/s, vehicle ~14 m/s, oscillator drift 5e-8 s/s) go through
run_batched on the spread grid at every cell of depth in {1, 2, 4} x
group_k in {1, 5}, and each cell reports the median/p95 trajectory error
after settling, the last-5-seconds error, and a hold/lost verdict.

The captures come from the port's io/synth.CaptureSimulator (seed 23),
cached as dyn_torch_<profile>_<samples>.dat in the bench's cache directory,
and lie on the device as an int16 [blocks, 50000, 2] tensor.

    python3 tools/dynamics_envelope_torch.py [--seconds 30] [--out FILE]
        [--profiles walk,vehicle,clock] [--device cuda|cpu]

Prints one JSON line: dynamics_envelope.py's keys, plus card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from navlab_dpe_sdr_tpu_torch import bench  # noqa: E402
from navlab_dpe_sdr_tpu_torch.device import resolve_device  # noqa: E402
from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid  # noqa: E402

FS = 2.5e6
S = 50000
T = 0.02
C_LIGHT = 299792458.0
HOLD_MEDIAN_M = 30.0     # last-5-s median above this = feedback loop lost
LOOKAHEAD = 50
SETTLE_S = 2.0           # fixes left out of the median and p95
LAST_S = 5.0             # the hold verdict's window at the end

PROFILES = {
    # ~1.5 m/s pedestrian (ECEF components chosen non-axis-aligned)
    "walk": {"vel": [1.0, -0.9, 0.6], "clock_drift": 0.0},
    # ~14 m/s vehicle: the tests/test_dynamics.py moving-receiver profile
    "vehicle": {"vel": [10.0, -8.0, 5.0], "clock_drift": 0.0},
    # static position, 5e-8 s/s oscillator (15 m/s of clock ramp)
    "clock": {"vel": [0.0, 0.0, 0.0], "clock_drift": 5e-8},
}

CELLS = [(d, k) for d in (1, 2, 4) for k in (1, 5)]


def _capture(profile: str, seconds: float):
    """(samples int16 I/Q, handoff at the truth, ephemerides, velocity) of
    a deterministic moving-receiver capture, cached on disk."""
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu_torch.io.synth import (CaptureSimulator,
                                                   release_workspace)

    _, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    p = PROFILES[profile]
    rx_state = hand.x_ecef.copy()
    rx_state[4:7] = p["vel"]
    hand2 = copy.deepcopy(hand)
    hand2.x_ecef = rx_state.copy()
    if p["clock_drift"]:
        # a real handoff carries the scalar loops' drift estimate; the
        # DPE dtdot axis tracks residuals (test_dpe_tracks_clock_drift)
        hand2.x_ecef[7] = -p["clock_drift"] * C_LIGHT

    n = int(round(seconds * FS))
    cache = os.path.join(bench.CACHE_DIR, f"dyn_torch_{profile}_{n}.dat")
    if os.path.exists(cache) and os.path.getsize(cache) == 4 * n:
        samples = np.fromfile(cache, DTYPE_IQ16)
    else:
        bench.log(f"synthesizing {profile}: {seconds:.1f} s ...")
        sim2 = CaptureSimulator(arr, rx_state, tow0=hand.rx_time, fs=FS,
                                cn0_dbhz=47.0, nav_data=True, seed=23,
                                clock_drift=p["clock_drift"])
        iq = sim2.generate(n)
        samples = np.empty(n, DTYPE_IQ16)
        samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
        samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
        del iq
        release_workspace()
        try:
            os.makedirs(bench.CACHE_DIR, exist_ok=True)
            samples.tofile(f"{cache}.{os.getpid()}.tmp")
            os.replace(f"{cache}.{os.getpid()}.tmp", cache)
        except OSError as e:       # a read-only temporary directory
            bench.log(f"capture not cached: {e}")
    return samples, hand2, arr, np.asarray(p["vel"], np.float64)


def run_cell(samples, hand, arr, vel, depth: int, group_k: int,
             lookahead: int | None = None, raw_dev=None, device="cuda"):
    """One envelope cell on `device`; returns its metrics dict. raw_dev:
    the capture as an int16 [blocks, S, 2] tensor on the device (None:
    the receiver stages it from the samples)."""
    from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver

    lookahead = LOOKAHEAD if lookahead is None else lookahead
    n_blocks = samples.shape[0] // S
    n_blocks -= n_blocks % (group_k * lookahead) if group_k > 1 else 0
    rx = DPEReceiver(SampleFile(samples=samples, fs=FS),
                     copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr),
                     config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                     device=device)
    t0 = time.perf_counter()
    rx.run_batched(n_blocks, lookahead=lookahead, raw_blocks_dev=raw_dev,
                   start_block=0, pipeline=True, group_k=group_k,
                   pipeline_depth=depth)
    wall = time.perf_counter() - t0

    # fix i references block (i+1)*group_k - 1; truth moves at vel
    errs = []
    for i, f in enumerate(rx.fixes):
        t_el = (i + 1) * group_k * T
        truth = hand.x_ecef[0:3] + vel * t_el
        errs.append(float(np.linalg.norm(np.asarray(f.x_ecef[0:3]) - truth)))
    errs = np.asarray(errs)
    settle = max(1, int(round(SETTLE_S / (group_k * T))))
    last5 = max(1, int(round(LAST_S / (group_k * T))))
    med = float(np.median(errs[settle:]))
    p95 = float(np.percentile(errs[settle:], 95))
    med_last5 = float(np.median(errs[-last5:]))
    return {"depth": depth, "group_k": group_k,
            "median_m": round(med, 2), "p95_m": round(p95, 2),
            "median_last5s_m": round(med_last5, 2),
            "held": bool(med_last5 < HOLD_MEDIAN_M),
            "rtf": round(n_blocks * T / wall, 1),
            "n_fixes": int(errs.size)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--profiles", default="walk,vehicle,clock")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = bench.card_name(dev)
    bench.log(f"device {dev} [{card}]")

    out = {"seconds": args.seconds, "lookahead": LOOKAHEAD,
           "hold_threshold_median_last5s_m": HOLD_MEDIAN_M,
           "profiles": {}}
    for prof in args.profiles.split(","):
        samples, hand, arr, vel = _capture(prof, args.seconds)
        raw_dev = torch.from_numpy(samples.view(np.int16).reshape(-1, S, 2)
                                   ).to(dev)
        cells = []
        for depth, gk in CELLS:
            r = run_cell(samples, hand, arr, vel, depth, gk,
                         lookahead=LOOKAHEAD, raw_dev=raw_dev, device=dev)
            cells.append(r)
            bench.log(f"{prof:8s} depth={depth} K={gk}: median "
                      f"{r['median_m']:7.2f} m  p95 {r['p95_m']:8.2f}  "
                      f"last5s {r['median_last5s_m']:8.2f}  "
                      f"held={r['held']} ({r['rtf']}x) [{card}]")
        out["profiles"][prof] = {
            "speed_mps": round(float(np.linalg.norm(vel)), 2),
            "clock_drift": PROFILES[prof]["clock_drift"],
            "cells": cells}
        del raw_dev
    out["card"] = card

    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
