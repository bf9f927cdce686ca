"""The weak cold start's code-phase pull-in on the card: how far off the
truth the deep search may put a channel's code phase for the 8 ms loops to
still pull it in and decode its ephemeris.

    python3 tools/weak_pull_in_torch.py --offsets 0.6,0.8,1.0,-1.0 \
        --out pullin.json [--logs DIR] [--device cuda]

Synthesizes 43.2 s of the seeded 8-PRN scenario at 27 dB-Hz (int16 I/Q in
1 s pieces, as chip_smoke.py does) and runs the weak cold start of the
l1ca8_weak27 configuration through ScalarReceiver: acquire(deep_ms=400,
n_coh_ms=10), track 30 s in 8 ms updates (ops/tracking.cadence_loops(8)),
then 2 s at a time until 8/8 ephemerides decode, never past 43 s. First as
acquired: per channel the acquisition's code phase against the truth at
sample 0 and at the search's middle (the search folds 400 ms of a code
whose rate is off the nominal by fcaid x Doppler, so it finds the phase
the signal had about 200 ms in). Then once for each offset d: every
channel's code phase set d chips off the truth at sample 0 after the
search (its Doppler as acquired). Writes per run the ephemerides decoded,
the ms tracked, the channels in lock at the end, and each channel's code
phase 1 s and 5 s in less the unplanted run's (the loops have pulled in
where it is a small fraction of a chip). With --logs, each run's log
(prompt segments, cp, rc, fc, ri, fi, signs, window ends) goes to
DIR/run_<name>.npz, so the decode can be replayed on the host.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from navlab_dpe_sdr_tpu_torch.constants import F_CA, F_L1, L_CA
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
from navlab_dpe_sdr_tpu_torch.ops import tracking

FS = 2.5e6
CN0 = 27.0
SECONDS = 43.2
DEEP_MS, N_COH_MS, COH_MS = 400, 10, 8
FIRST_MS, STEP_MS, MOST_MS, CHUNK_MS = 30000, 2000, 43000, 2000


def capture():
    sim, hand, _ = make_scenario(nav_data=True, cn0_dbhz=CN0)
    n = int(round(SECONDS * FS))
    samples = np.empty(n, DTYPE_IQ16)
    for s0 in range(0, n, int(FS)):
        iq = sim.generate(min(int(FS), n - s0), start_sample=s0)
        samples["i"][s0:s0 + len(iq)] = np.clip(np.round(iq.real), -32768,
                                               32767)
        samples["q"][s0:s0 + len(iq)] = np.clip(np.round(iq.imag), -32768,
                                               32767)
    return samples, hand


def wrap(d):
    return (np.asarray(d, np.float64) + L_CA / 2) % L_CA - L_CA / 2


def cold_start(samples, hand, device, offset=None):
    """One weak cold start; offset (chips) plants every channel's code
    phase that far off the truth after the search. (receiver, acquisition
    results, ms tracked, PRNs decoded, seconds)."""
    t0 = time.perf_counter()
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), hand.prn_list,
                        loops=tracking.cadence_loops(COH_MS), device=device)
    res = rx.acquire(deep_ms=DEEP_MS, n_coh_ms=N_COH_MS, verbose=False)
    if offset is not None:
        rc = np.mod(np.asarray(hand.rc, np.float64) + offset, L_CA)
        rx.state = rx.state._replace(rc=torch.tensor(
            rc, dtype=torch.float32, device=rx.state.rc.device))
    done, good = 0, []
    step = FIRST_MS
    while done + step <= MOST_MS:
        rx.track(step, chunk_ms=CHUNK_MS, coh_ms=COH_MS)
        done += step
        good = rx.decode_ephemerides(verbose=False)
        if len(good) == len(hand.prn_list):
            break
        step = STEP_MS
    return rx, res, done, good, time.perf_counter() - t0


def save_log(rx, path):
    cols = {}
    for p in rx.prn_list:
        ch = rx.channels[p]
        for k in ("pseg", "cp", "rc", "fc", "ri", "fi", "lock"):
            cols[f"{k}_{p}"] = ch.col(k)
        cols[f"cp_sign_{p}"] = ch.cp_sign
    np.savez(path, prn_list=np.array(rx.prn_list), fs=FS, coh_ms=COH_MS,
             m_samp=np.array(rx._m_samp, np.int64), **cols)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--offsets", default="0.6,0.8,1.0,-1.0")
    ap.add_argument("--out", required=True)
    ap.add_argument("--logs", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    offsets = [float(x) for x in args.offsets.split(",") if x]
    t0 = time.perf_counter()
    samples, hand = capture()
    out = dict(capture_s=time.perf_counter() - t0, runs=[])
    if torch.cuda.is_available() and args.device.startswith("cuda"):
        out["card"] = torch.cuda.get_device_name()
    logs = pathlib.Path(args.logs) if args.logs else None
    if logs:
        logs.mkdir(parents=True, exist_ok=True)
    fcaid = F_CA / F_L1
    base = None
    for offset in [None] + offsets:
        rx, res, done, good, wall = cold_start(samples, hand, args.device,
                                               offset)
        run = dict(offset_chips=offset, ms_tracked=done, decoded=len(good),
                   of=len(hand.prn_list), wall_s=wall,
                   in_lock_at_end=int(sum(rx.channels[p].col("lock")[-1]
                                          for p in rx.prn_list)))
        rc_at = {}
        for ms in (1000, 5000):
            u = min(ms // COH_MS, rx.mcount - 1)
            rc_at[ms] = np.array([rx.channels[p].col("rc")[u]
                                  for p in rx.prn_list], np.float64)
        if offset is None:
            base = rc_at
            acq = np.array([r.rc for r in res])
            fi = np.array([r.fi for r in res])
            mid = np.asarray(hand.rc) + fcaid * np.asarray(hand.fi) \
                * DEEP_MS * 1e-3 / 2
            run.update(
                acq_code_gap_chips=wrap(acq - np.asarray(hand.rc)).tolist(),
                acq_code_gap_mid_chips=wrap(acq - mid).tolist(),
                code_drift_over_half_search_chips=(
                    fcaid * np.asarray(hand.fi) * DEEP_MS * 1e-3 / 2).tolist(),
                acq_doppler_gap_hz=(fi - np.asarray(hand.fi)).tolist())
        else:
            for ms in (1000, 5000):
                run[f"rc_vs_unplanted_{ms}ms_chips"] = wrap(
                    rc_at[ms] - base[ms]).tolist()
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
        if logs:
            name = "acquired" if offset is None else f"{offset:+.1f}"
            save_log(rx, logs / f"run_{name}.npz")
        del rx
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
