"""Stage decomposition of the per-block (50 Hz) batched mode, on the port.

The port of tools/perblock_decompose.py, over the bench capture
(navlab_dpe_sdr_tpu_torch/bench.bench_capture) on the spread grid; every
value is ms per block:

  e2e_depth{1,2,4} - run_batched over `--blocks` blocks, per-block fixes,
                     pipeline at that depth: wall (median of --repeats
                     fresh receivers, with min and max), each first
                     advanced, untimed, over the 2 x 50 warm-up blocks as
                     the bench's passes are (the JAX tool times a fresh
                     receiver's first dispatches, its set-up included)
  dispatch         - device time of the same 50-block dpe_batch_blocks
                     dispatch, back to back with no host in the way
                     (stage_timing_torch "full")
  corr             - the same with a 256-point grid scored with the spread
                     grid's windows: correlation + fixed dispatch overhead
                     (stage_timing_torch "corr")
  scoring          = dispatch - corr
  host_prep        - DPEReceiver._prepare_batch(50) alone (models/dpe.py)
  drain_host       - DPEReceiver._drain_batch on a fetched result (the
                     fetch waited for first): fix parsing, the smoother,
                     the channel steering
  residual_depth4  = e2e_depth4 - dispatch - host_prep - drain_host: the
                     host's enqueue of the dispatch and what the pipeline
                     does not hide

    python3 tools/perblock_decompose_torch.py [--blocks 200] [--repeats 3]
        [--out FILE] [--device cuda|cpu]

Prints one JSON line: perblock_decompose.py's keys, plus card and backend.
On the CPU every number is the host's and labelled "cpu".
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from navlab_dpe_sdr_tpu_torch import bench  # noqa: E402
from navlab_dpe_sdr_tpu_torch.device import resolve_device  # noqa: E402
from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid  # noqa: E402

import stage_timing_torch  # noqa: E402

FS = 2.5e6
LOOKAHEAD = 50
STAGE_K = 20            # dispatches a stage_timing_torch run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver

    card = bench.card_name(dev)
    bench.log(f"device {dev} [{card}]")
    warm = 2 * LOOKAHEAD
    samples, hand, arr = bench.bench_capture(args.blocks + warm)
    grid = spread_grid()
    raw_dev = torch.from_numpy(samples.view(np.int16).reshape(-1, bench.S, 2)
                               ).to(dev)

    def fresh_rx():
        return DPEReceiver(SampleFile(samples=samples, fs=FS),
                           copy.deepcopy(hand), grid=grid,
                           eph=copy.deepcopy(arr),
                           config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                           device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"n_blocks": args.blocks, "repeats": args.repeats,
           "stat": "median_ms_per_block", "card": card, "backend": dev.type}

    # -- end to end per block at each pipeline depth ------------------------
    rx = fresh_rx()
    rx.run_batched(LOOKAHEAD, lookahead=LOOKAHEAD, raw_blocks_dev=raw_dev,
                   start_block=0)                       # warm the signature
    for depth in (1, 2, 4):
        ts = []
        for _ in range(args.repeats):
            r = fresh_rx()
            pipe = dict(lookahead=LOOKAHEAD, raw_blocks_dev=raw_dev,
                        pipeline=True, pipeline_depth=depth)
            r.run_batched(warm, start_block=0, **pipe)
            sync()
            t0 = time.perf_counter()
            r.run_batched(args.blocks, start_block=warm, **pipe)
            ts.append((time.perf_counter() - t0) / args.blocks * 1e3)
        out[f"e2e_depth{depth}"] = float(np.median(ts))
        out[f"e2e_depth{depth}_minmax"] = [min(ts), max(ts)]
        bench.log(f"e2e depth {depth}: {out[f'e2e_depth{depth}']:.4f} "
                  f"ms/block {out[f'e2e_depth{depth}_minmax']}")

    # -- host terms ----------------------------------------------------------
    r = fresh_rx()
    r.run_batched(LOOKAHEAD, lookahead=LOOKAHEAD, raw_blocks_dev=raw_dev,
                  start_block=0)
    ts = []
    for _ in range(max(3, args.repeats)):
        t0 = time.perf_counter()
        r._prepare_batch(LOOKAHEAD)
        ts.append((time.perf_counter() - t0) / LOOKAHEAD * 1e3)
    out["host_prep"] = float(np.median(ts))

    ts = []
    for _ in range(max(3, args.repeats)):
        rr = fresh_rx()
        rr.run_batched(LOOKAHEAD, lookahead=LOOKAHEAD,
                       raw_blocks_dev=raw_dev, start_block=0)
        fetch, preps = rr._dispatch_batch(LOOKAHEAD, raw_dev, warm, 0)
        sync()                              # the fetch is in: time the host
        t0 = time.perf_counter()
        rr._drain_batch(fetch, preps)
        ts.append((time.perf_counter() - t0) / LOOKAHEAD * 1e3)
    out["drain_host"] = float(np.median(ts))
    bench.log(f"host prep {out['host_prep']:.4f} + drain "
              f"{out['drain_host']:.4f} ms/block")

    # -- the dispatch's device time (no host in the way) ---------------------
    stages = {s["variant"]: s for s in stage_timing_torch.stage_times(
        ["full", "corr"], k=STAGE_K, n=LOOKAHEAD, device=dev)}
    dispatch = stages["full"]["ms_per_block"]
    corr = stages["corr"]["ms_per_block"]
    out["dispatch"] = dispatch
    out["corr"] = corr
    out["scoring"] = dispatch - corr
    out["residual_depth4"] = (out["e2e_depth4"] - dispatch - out["host_prep"]
                              - out["drain_host"])
    out["rtf_e2e_depth4"] = 20.0 / out["e2e_depth4"]
    out["rtf_dispatch_floor"] = 20.0 / dispatch
    bench.log(f"dispatch {dispatch:.4f} (corr {corr:.4f} + scoring "
              f"{out['scoring']:.4f}) | e2e d4 {out['e2e_depth4']:.4f} -> "
              f"residual {out['residual_depth4']:.4f} ms/block; rtf e2e "
              f"{out['rtf_e2e_depth4']:.2f}x vs floor "
              f"{out['rtf_dispatch_floor']:.2f}x [{card}]")

    js = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")
    print(js, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
