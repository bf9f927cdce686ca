"""Host-side split of the grouped batched DPE segment, per dispatch, on the
port.

The port of tools/host_residue.py. Over the bench's grouped segment (the
bench capture on the card, the spread grid, lookahead 50, group_k 5,
pipeline depth 4 by default; the JAX tool's default depth 2 predates the
bench's 4) it wraps the receiver's DPEReceiver._dispatch_batch,
_prepare_batch and _drain_batch (models/dpe.py) with wall timers and prints
the split per dispatch. The terms nest:

  wall_ms_per_dispatch = dispatch_host_ms + drain_ms + other_ms
  dispatch_host_ms     = prep_ms + enqueue_ms (the port's _dispatch_batch
                         runs _prepare_batch, then queues dpe_batch_blocks
                         and the result's asynchronous fetch)
  drain_ms             - _drain_batch: waiting for the oldest dispatch's
                         fetch, which holds its device time when the
                         pipeline has not hidden it, then the fix parsing,
                         the smoother and the channel steering
  other_ms             - run_batched's own loop

The device's side of the same dispatch (busy ms, launches) is
tools/stage_timing_torch.py full_g5's; together they split a dispatch into
prep, enqueue, drain and device busy.

    python3 tools/host_residue_torch.py [n_blocks [depth]] [--device cuda|cpu]

Prints one JSON line: host_residue.py's keys, plus prep_ms, enqueue_ms,
depth, nesting, card and backend. n_blocks (default 500) must be a multiple
of group_k.
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

LOOKAHEAD, GROUP_K = 50, 5
NESTING = ("wall = dispatch_host + drain + other; dispatch_host = prep + "
           "enqueue (_dispatch_batch runs _prepare_batch); drain includes "
           "waiting for the oldest dispatch's fetch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_blocks", nargs="?", type=int, default=500)
    ap.add_argument("depth", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver

    card = bench.card_name(dev)
    warmup = 2 * LOOKAHEAD
    samples, hand, arr = bench.bench_capture(args.n_blocks + warmup)
    rx = DPEReceiver(SampleFile(samples=samples, fs=bench.FS),
                     copy.deepcopy(hand), grid=spread_grid(),
                     eph=copy.deepcopy(arr),
                     config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                     device=dev)
    raw_dev = torch.from_numpy(samples.view(np.int16).reshape(-1, rx.S, 2)
                               ).to(dev)

    acc = {"dispatch": [0.0, 0], "prep": [0.0, 0], "drain": [0.0, 0]}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            acc[name][0] += time.perf_counter() - t0
            acc[name][1] += 1
            return res
        return wrapped

    # warm the grouped signature outside the timed run
    rx.run_batched(LOOKAHEAD, lookahead=LOOKAHEAD, raw_blocks_dev=raw_dev,
                   start_block=0, group_k=GROUP_K)
    rx._dispatch_batch = timed("dispatch", rx._dispatch_batch)
    rx._prepare_batch = timed("prep", rx._prepare_batch)
    rx._drain_batch = timed("drain", rx._drain_batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    rx.run_batched(args.n_blocks, lookahead=LOOKAHEAD, raw_blocks_dev=raw_dev,
                   start_block=warmup, pipeline=True, group_k=GROUP_K,
                   pipeline_depth=args.depth)
    wall = time.perf_counter() - t0

    nd = acc["dispatch"][1]
    per = {k: 1e3 * v[0] / max(1, v[1]) for k, v in acc.items()}
    out = {
        "n_blocks": args.n_blocks, "dispatches": nd,
        "wall_ms_per_dispatch": 1e3 * wall / nd,
        "dispatch_host_ms": per["dispatch"],
        "drain_ms": per["drain"],
        "other_ms": 1e3 * (wall - acc["dispatch"][0] - acc["drain"][0]) / nd,
        "rtf_segment": args.n_blocks * bench.T / wall,
        "prep_ms": per["prep"],
        "enqueue_ms": per["dispatch"] - per["prep"],
        "depth": args.depth, "nesting": NESTING,
        "card": card, "backend": dev.type,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
