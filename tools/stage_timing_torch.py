"""Per-stage device time of the product 50-block dispatch, on the port.

The port of tools/stage_timing.py. Where does the device time of a 50-block
`ops/dpe_real.dpe_batch_blocks` dispatch go?
  full     - the spread 25^4 grid: correlation (K5) + both manifolds'
             scoring (K1 twice)
  corr     - a 256-point grid scored with the spread grid's windows, so
             the correlation work is full's and the scoring nearly free
  full_g5  - the spread grid in coherent groups of 5: correlation, the
             group sums and 1/5 of the scoring (the bench's grouped mode)
full - corr is the scoring's cost at the product's shape.

Inputs vary from dispatch to dispatch (seeded random int16 blocks, the
parameters of parallel/launch.example_inputs with 1e-4 of noise) and the
samples are on the device before any clock starts. The JAX tool chains K
dispatches in one lax.scan so that no host time enters; here the K
dispatches are enqueued while the device sleeps (torch.cuda._sleep), and
CUDA events recorded after the sleep time them back to back on the
device. The start event is checked to be still pending when the last
dispatch is queued, so the host's enqueue is off the clock:
`ms_per_dispatch` is device time, launch gaps included. The device's launch
queue holds only so many kernels (a grouped dispatch is ~120 launches):
when the host blocks on it, the dispatches are timed in smaller windows
(`windows`), whose times add up. `enqueue_ms` is the host's time to queue one
dispatch, and `device_busy_ms` / `launches` the kernels and copies of one
dispatch from torch.profiler after two lead-in dispatches
(profile_dispatch.dispatch_record; the profiler can lose a window's first
records). On the CPU the dispatches run in turn on the host's clock, the
numbers are labelled "cpu", and the profiler terms are not measured.

    python3 tools/stage_timing_torch.py [full corr full_g5] [--k 20]
        [--n 50] [--device cuda|cpu]

One JSON line a variant: stage_timing.py's keys, plus card, backend,
enqueue_ms, windows, device_busy_ms, device_share (device busy over
ms_per_dispatch), launches and kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from navlab_dpe_sdr_tpu_torch import bench  # noqa: E402
from navlab_dpe_sdr_tpu_torch.device import resolve_device  # noqa: E402
from navlab_dpe_sdr_tpu_torch.models.grid import (spread_grid,  # noqa: E402
                                                  uniform_grid)
from navlab_dpe_sdr_tpu_torch.ops import dpe_real as dr  # noqa: E402
from navlab_dpe_sdr_tpu_torch.ops.dpe import auto_windows  # noqa: E402
from navlab_dpe_sdr_tpu_torch.parallel.launch import (  # noqa: E402
    example_inputs)

C, S = 8, 50000
VARIANTS = ("full", "corr", "full_g5")
TIMED_RUNS = 3


def back_to_back_ms(fn_list, dev: torch.device) -> tuple[float, float, int]:
    """(device ms of running every fn of fn_list back to back, host ms to
    queue them, windows): the calls are queued while the device sleeps
    (torch.cuda._sleep) and CUDA events recorded after the sleep time them.
    The start event must still be pending when the last call of a window is
    queued; where it is not, the host blocked, most likely on the device's
    launch queue, which holds only so many kernels: the window is split in
    halves, each timed alike, and the halves' times are summed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    dev_ms = queue_ms = 0.0
    windows = 0
    todo = [list(fn_list)]
    per_call_ms = 1.0                    # host ms a call, as last measured
    while todo:
        fns = todo.pop(0)
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(int(cycles_per_ms
                              * max(50.0, 4.0 * per_call_ms * len(fns))))
        start.record()
        t0 = time.perf_counter()
        for fn in fns:
            fn()
        q_ms = (time.perf_counter() - t0) * 1e3
        pending = not start.query()
        end.record()
        end.synchronize()
        per_call_ms = q_ms / len(fns)
        if pending:
            dev_ms += start.elapsed_time(end)
            queue_ms += q_ms
            windows += 1
        elif len(fns) > 1:
            half = len(fns) // 2
            todo[:0] = [fns[:half], fns[half:]]
        else:
            raise RuntimeError(f"the host blocked queueing one call "
                               f"({q_ms:.1f} ms) behind a device sleep")
    return dev_ms, queue_ms, windows


def stage_times(variants, k: int = 20, n: int = 50, device="cuda",
                log=bench.log) -> list[dict]:
    """One record a variant (module docstring) of k dispatches of n
    blocks; `log` takes a line of progress."""
    dev = resolve_device(device)
    card = bench.card_name(dev)
    rng = np.random.default_rng(11)
    ex = example_inputs(c=C, s=S)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    raw_all = t(rng.integers(-2048, 2048, (n + k, S, 2)).astype(np.int16))
    chips, time_idc = t(ex["chips"]), t(ex["time_idc"])
    fpk = np.zeros((n, dr.FPK_ROWS, C), np.float32)
    ipk = np.zeros((n, dr.IPK_ROWS, C), np.int32)
    fpk[:, 0], fpk[:, 1], fpk[:, 2] = ex["rc_mid"], ex["fi"], ex["ri"]
    fpk[:, 3:6] = ex["los_enu"].T
    fpk[:, 6] = ex["r0"]
    fpk[:, 8], fpk[:, 10] = ex["pos_coef"], ex["vel_coef"]
    ipk[:, 0] = ex["idx_next"]
    spread = spread_grid()
    cw, vw = auto_windows(spread.d_enu, spread.dt_m, spread.dv_enu,
                          spread.dtdot, 2.5e6, ex["carr_fftpts"])
    fpk[:, 7] = cw / 2.0
    fpk[:, 9] = vw / 2.0
    ipk[:, 1] = S // 2 - cw // 2
    ipk[:, 2] = ex["carr_fftpts"] // 2 - vw // 2
    log(f"device {dev} [{card}]; windows {cw} / {vw} (the spread grid's)")

    out = []
    for name in variants:
        if name not in VARIANTS:
            raise ValueError(f"variant {name!r}: one of {VARIANTS}")
        group_k = 5 if name.endswith("_g5") else 1
        g = (spread if name.startswith("full")
             else uniform_grid(n=4, pos_spacing=5.0, vel_spacing=0.5))
        grid = [t(a.astype(np.float32))
                for a in (g.d_enu, g.dt_m, g.dv_enu, g.dtdot)]

        def call(pk, _grid=grid, _gk=group_k):
            return dr.dpe_batch_blocks(
                raw_all, pk, chips, time_idc, *_grid,
                carr_fftpts=ex["carr_fftpts"], period=ex["period"],
                n_periods=ex["n_periods"], n_blocks=n,
                return_windows=False, code_win=cw, carr_win=vw,
                group_k=_gk)

        def data():
            """k packed parameter sets, the kth reading blocks k..k+n-1."""
            return [dr.pack_params(
                fpk + rng.standard_normal(fpk.shape).astype(np.float32)
                * 1e-4, ipk, i) for i in range(k)]

        rows = []

        def runs(pks):
            return [lambda pk=pk: rows.append(call(pk)) for pk in pks]

        t0 = time.perf_counter()
        for fn in runs(data()):
            fn()
        check = float(sum(r.sum() for r in rows))
        warm_s = time.perf_counter() - t0
        times, queue, windows = [], [], 1
        for _ in range(TIMED_RUNS):
            rows.clear()
            fns = runs(data())
            if dev.type == "cuda":
                ms, q_ms, windows = back_to_back_ms(fns, dev)
            else:
                t0 = time.perf_counter()
                for fn in fns:
                    fn()
                ms = q_ms = (time.perf_counter() - t0) * 1e3
            # a window that blocked ran its calls again, halved
            check = float(sum(r.sum() for r in rows[-k:]))
            times.append(ms / 1e3)
            queue.append(q_ms)
        med = float(np.median(times))
        rec = {
            "variant": name, "warmup_s": warm_s, "times_s": times,
            "ms_per_dispatch": med * 1e3 / k,
            "ms_per_block": med * 1e3 / k / n,
            "grid_points": int(g.d_enu.shape[0]),
            "code_win": int(cw), "carr_win": int(vw),
            "n_blocks": n, "k": k, "check": check,
            "card": card, "backend": dev.type,
            "enqueue_ms": float(np.median(queue)) / k, "windows": windows,
            "device_busy_ms": None, "device_share": None, "launches": None,
            "kernels": None}
        if dev.type == "cuda":
            from profile_dispatch import K1_K5, dispatch_record
            pk0 = data()[0]
            d = dispatch_record(lambda: call(pk0), K1_K5)
            if d["launches"]:
                rec.update(device_busy_ms=d["busy_ms"],
                           device_share=d["busy_ms"] / rec["ms_per_dispatch"],
                           launches=d["launches"], kernels=d["kernels"])
        out.append(rec)
        log(f"{name}: {rec['ms_per_dispatch']:.4f} ms a dispatch on the "
            f"device, {rec['enqueue_ms']:.4f} ms to queue it [{card}]")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("variants", nargs="*", default=list(VARIANTS))
    p.add_argument("--k", type=int, default=20,
                   help="dispatches a timed run (the JAX tool's ST_K)")
    p.add_argument("--n", type=int, default=50,
                   help="blocks a dispatch (the JAX tool's ST_N)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    for rec in stage_times(args.variants, args.k, args.n, args.device):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
