"""Full-pass survey on the port: multi-epoch joint DPE over the bench
capture.

The port of tools/survey_bench.py. DPEReceiver.run_survey over the bench
scenario (navlab_dpe_sdr_tpu_torch/bench.bench_capture, a static receiver
whose truth is known exactly) on the spread grid, reporting the joint
estimate's ENU error, the per-batch fix statistics it beats, and the joint
covariance. A one-batch survey on a throwaway receiver runs first, so the
kernels' builds fall outside `wall_s`.

    python3 tools/survey_bench_torch.py [--blocks 2250] [--batch 50]
        [--fine-n 33] [--fine-spacing 0.25] [--zoom-interp quadratic|linear|sinc]
        [--out FILE] [--device cuda|cpu]

Prints one JSON line: survey_bench.py's keys, plus cov_pos_enu_clk_m2 (the
joint position-clock covariance, whose off-diagonals hold the U/clock
ridge) and card. On the CPU `backend` and `card` say "cpu".
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from navlab_dpe_sdr_tpu_torch import bench  # noqa: E402
from navlab_dpe_sdr_tpu_torch.device import resolve_device  # noqa: E402
from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--blocks", type=int, default=2250)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--fine-n", type=int, default=33)
    p.add_argument("--fine-spacing", type=float, default=0.25)
    p.add_argument("--zoom-interp", default=None,
                   choices=[None, "quadratic", "linear", "sinc"])
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu_torch.libgnss import frames
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver

    card = bench.card_name(dev)
    n_batches = args.blocks // args.batch
    n_blocks = n_batches * args.batch
    samples, hand, arr = bench.bench_capture(n_blocks)
    grid = spread_grid()

    def receiver():
        return DPEReceiver(SampleFile(samples=samples, fs=bench.FS),
                           copy.deepcopy(hand), grid=grid,
                           eph=copy.deepcopy(arr),
                           config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                           device=dev)

    survey = dict(blocks_per_fix=args.batch, fine_spacing=args.fine_spacing,
                  fine_n=args.fine_n, zoom_interp=args.zoom_interp)
    receiver().run_survey(1, **survey)                   # builds, warm-up
    rx = receiver()
    t0 = time.perf_counter()
    res = rx.run_survey(n_batches, **survey)
    wall = time.perf_counter() - t0

    truth = hand.x_ecef
    r = frames.ecef_to_enu_matrix(truth[0:3])
    enu = r @ (res.x_ecef[0:3] - truth[0:3])
    errs = [float(np.linalg.norm(f.x_ecef[0:3] - truth[0:3]))
            for f in rx.fixes]
    payload = {
        "backend": dev.type,
        "n_blocks": res.n_blocks, "n_batches": res.n_batches,
        "signal_seconds": res.n_blocks * bench.T, "wall_s": wall,
        "survey_err_m": float(np.linalg.norm(enu)),
        "survey_err_enu_m": [float(e) for e in enu],
        "survey_clk_err_m": float(res.x_ecef[3] - truth[3]),
        "survey_vel_err_ms": float(np.linalg.norm(res.x_ecef[4:7]
                                                  - truth[4:7])),
        "per_batch_median_err_m": float(np.median(errs)),
        "per_batch_p95_err_m": float(np.percentile(errs, 95)),
        "sigma_pos_enu_clk_m": [float(s) for s in res.sigma_pos],
        "sigma_vel": [float(s) for s in res.sigma_vel],
        "zoom_interp": args.zoom_interp or "config-default(quadratic)",
        "fine_spacing_m": args.fine_spacing, "fine_n": args.fine_n,
        "cov_pos_enu_clk_m2": np.asarray(res.cov_pos, float).tolist(),
        "card": card,
    }
    js = json.dumps(payload)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")
    print(js, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
