"""Dense-grid DPE bench on the port: the reference's cap of 2 x 75^4
grid points.

The port of tools/dense_bench.py. One `ops/dpe_real.dpe_batch_blocks`
dispatch of --blocks blocks per iteration (K5, then K1 over both 75^4
manifolds), or with --integrate K one coherent K-block
`dpe_scan_integrate` dispatch (one scoring pass per K blocks, the
dense grid's real-time mode). Inputs are seeded: random int16 blocks
(rolled each iteration, uploaded before the clock) and the parameters of
parallel/launch.example_inputs with grid-adapted windows. An iteration's
time is the host clock around the dispatch and a synchronize, divided by
its blocks; the median of --iters.

    python3 tools/dense_bench_torch.py [--n 75] [--blocks 2] [--iters 3]
        [--integrate K] [--out FILE] [--device cuda|cpu]

Prints one JSON line: dense_bench.py's keys, plus card. On the CPU the
times are the host's, `backend` and `device` say "cpu" and `memory` is
null.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from navlab_dpe_sdr_tpu_torch.bench import card_name  # noqa: E402
from navlab_dpe_sdr_tpu_torch.device import resolve_device  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=75, help="points per grid axis")
    p.add_argument("--blocks", type=int, default=2)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--integrate", type=int, default=0, metavar="K",
                   help="coherent K-block integration: one scoring pass "
                        "per K blocks (the dense-grid real-time mode)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    from navlab_dpe_sdr_tpu_torch.models.grid import (check_grid_size,
                                                      dense_grid)
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real as dr
    from navlab_dpe_sdr_tpu_torch.ops.dpe import auto_windows
    from navlab_dpe_sdr_tpu_torch.parallel.launch import example_inputs

    card = card_name(dev)
    print(f"# device {dev} [{card}]", flush=True)

    c, s = 8, 50000
    n_blocks = args.integrate if args.integrate else args.blocks
    ex = example_inputs(c=c, s=s)
    rng = np.random.default_rng(7)
    raw_all = rng.integers(-2048, 2048, (n_blocks, s, 2)).astype(np.int16)
    fpk = np.zeros((n_blocks, dr.FPK_ROWS, c), np.float32)
    ipk = np.zeros((n_blocks, dr.IPK_ROWS, c), np.int32)
    fpk[:, 0], fpk[:, 1], fpk[:, 2] = ex["rc_mid"], ex["fi"], ex["ri"]
    fpk[:, 3:6] = ex["los_enu"].T
    fpk[:, 6] = ex["r0"]
    fpk[:, 8], fpk[:, 10] = ex["pos_coef"], ex["vel_coef"]
    ipk[:, 0] = ex["idx_next"]

    g = check_grid_size(dense_grid(n=args.n))
    n_pts = g.n_pos + g.n_vel
    print(f"# grid: {args.n}^4 pos + {args.n}^4 vel = {n_pts:,} points",
          flush=True)
    cw, vw = auto_windows(g.d_enu, g.dt_m, g.dv_enu, g.dtdot, 2.5e6,
                          ex["carr_fftpts"])
    print(f"# score windows: code {cw}, carr {vw}", flush=True)
    fpk[:, 7] = cw / 2.0
    fpk[:, 9] = vw / 2.0
    ipk[:, 1] = s // 2 - cw // 2
    ipk[:, 2] = ex["carr_fftpts"] // 2 - vw // 2
    pk = dr.pack_params(fpk, ipk, 0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    t0 = time.perf_counter()
    grid = [t(a.astype(np.float32)) for a in (g.d_enu, g.dt_m, g.dv_enu,
                                              g.dtdot)]
    chips, time_idc = t(ex["chips"]), t(ex["time_idc"])
    sync()
    print(f"# grid upload: {time.perf_counter() - t0:.1f} s "
          f"({sum(x.numel() * 4 for x in grid) / 1e6:.0f} MB)", flush=True)
    kw = dict(carr_fftpts=ex["carr_fftpts"], period=ex["period"],
              n_periods=ex["n_periods"], n_blocks=n_blocks, code_win=cw,
              carr_win=vw)

    def call(raw):
        if args.integrate:
            return dr.dpe_scan_integrate(raw, pk, chips, time_idc, *grid,
                                         coherent=True, **kw)
        return dr.dpe_batch_blocks(raw, pk, chips, time_idc, *grid,
                                   return_windows=False, **kw)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    call(t(raw_all))
    sync()
    print(f"# warmup (first dispatch): {time.perf_counter() - t0:.1f} s",
          flush=True)

    times = []
    for i in range(args.iters):
        raw = t(np.roll(raw_all, i + 1, axis=1))         # vary the inputs
        sync()
        t0 = time.perf_counter()
        call(raw)
        sync()
        times.append((time.perf_counter() - t0) / n_blocks)
        print(f"# iter {i}: {times[-1] * 1e3:.3f} ms/block", flush=True)

    sec = float(np.median(times))
    mem = None
    if dev.type == "cuda":
        mem = {"bytes_in_use": torch.cuda.memory_allocated(dev),
               "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
               "bytes_limit": torch.cuda.get_device_properties(
                   dev).total_memory}
    result = {
        "grid_points": n_pts,
        "grid_axis_n": args.n,
        "sec_per_block": sec,
        "grid_points_per_s": n_pts / sec,
        "grid_point_channel_evals_per_s": n_pts * c / sec,
        "realtime_factor": 0.02 / sec,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "blocks_per_dispatch": n_blocks,
        "coherent_integration_k": args.integrate or None,
        "memory": mem,
        "note": "reference cap 2*75^4 (batchcorrmanifold.h:17); "
                "streaming-argmax scorer (K1), peak memory independent of "
                "grid size",
        "card": card,
    }
    js = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js + "\n")
    print(js, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
