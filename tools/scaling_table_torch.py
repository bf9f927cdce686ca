"""Scaling-efficiency table of the port's batched DPE dispatch (the port of
tools/scaling_table.py).

One measurement on the CPU is N gloo ranks, a process each, each pinned to
one core by `taskset`: the JAX tool's methodology (a virtual CPU device a
core), with a process per rank in place of a virtual device. The ranks
meet through a file:// init method in a temporary directory; each joins
with parallel/launch.init_distributed(device="cpu"), makes
global_mesh(n_chan=CHAN, device="cpu") and runs scaling_bench on it; rank 0
prints the row as JSON on its last line, and this script prints it. One
rank is the single-device path (mesh=None), as in the JAX tool.

    python tools/scaling_table_torch.py --device cpu --devices 2 [--chan 1]
        [--c 8] [--grid-scale 1] [--iters 10]
    python tools/scaling_table_torch.py --device cpu --all [--out FILE]
    python tools/scaling_table_torch.py [--device cuda]

--all builds the JAX tool's table (1, 2, 4, 8 and 16 ranks up to the
cores this process may use, every 'chan' split that divides them, the
spread grid laid out 1, 4 and 8 times) with the efficiency of each row
against one rank, and writes it to --out (SCALING_torch.json).

--device cuda (the default; it raises without a card) measures one card:
scaling_bench with mesh=None, then a world of one rank over NCCL. The row
is labelled "one card" and has no efficiency: nothing here measures across
cards. A rank that fails ends the tool with a non-zero exit and its
standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANK_TIMEOUT_S = 1800
GRID_SCALES = (1, 4, 8)
RANK_COUNTS = (1, 2, 4, 8, 16)


def rank_main(spec: dict) -> None:
    """One rank of a CPU measurement (this script with --rank-spec)."""
    import torch
    import torch.distributed as dist

    from navlab_dpe_sdr_tpu_torch.parallel.launch import (global_mesh,
                                                           init_distributed,
                                                           scaling_bench)

    torch.set_num_threads(1)
    n, rank = spec["devices"], spec["rank"]
    bench = dict(n_iters=spec["iters"], grid_scale=spec["grid_scale"],
                 n_blocks=spec["n_blocks"], n_chan_sig=spec["c"],
                 device="cpu")
    if n == 1:
        stats = scaling_bench(None, **bench)
    else:
        init_distributed(spec["rendezvous"], n, rank, device="cpu")
        try:
            stats = scaling_bench(global_mesh(n_chan=spec["chan"],
                                              device="cpu"), **bench)
        finally:
            dist.destroy_process_group()
    if rank == 0:
        stats.update(mesh={"chan": spec["chan"], "grid": n // spec["chan"]},
                     n_chan_sig=spec["c"], cores=n)
        print(json.dumps(stats), flush=True)


def measure(n_devices: int, grid_scale: int, iters: int, n_chan: int = 1,
            n_chan_sig: int = 8, n_blocks: int = 8) -> dict:
    """One row: n_devices gloo ranks on the CPU, rank r pinned to the r-th
    core this process may use."""
    cores = sorted(os.sched_getaffinity(0))
    if n_devices > len(cores):
        raise ValueError(f"{n_devices} ranks need as many cores; this "
                         f"process may use {len(cores)}")
    if n_devices % n_chan:
        raise ValueError(f"--chan {n_chan} must divide --devices "
                         f"{n_devices}")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(n_devices):
            spec = dict(devices=n_devices, rank=r, chan=n_chan, c=n_chan_sig,
                        grid_scale=grid_scale, iters=iters,
                        n_blocks=n_blocks, rendezvous=f"file://{tmp}/rdv")
            procs.append(subprocess.Popen(
                ["taskset", "-c", str(cores[r]), sys.executable,
                 os.path.abspath(__file__), "--rank-spec", json.dumps(spec)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=REPO))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [(r, p.returncode, err) for r, (p, (_, err))
              in enumerate(zip(procs, outs)) if p.returncode != 0]
    if failed:
        for r, rc, err in failed:
            print(f"rank {r} exited {rc}:\n{err}", file=sys.stderr)
        raise SystemExit(f"measurement at {n_devices} ranks failed")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def measure_card(grid_scale: int, iters: int, n_chan_sig: int = 8,
                 n_blocks: int = 8) -> dict:
    """The one-card row: scaling_bench with mesh=None, then a world of one
    rank over NCCL (its reading under "nccl_world_1")."""
    import torch.distributed as dist

    from navlab_dpe_sdr_tpu_torch.bench import card_name
    from navlab_dpe_sdr_tpu_torch.device import resolve_device
    from navlab_dpe_sdr_tpu_torch.parallel.launch import (global_mesh,
                                                           init_distributed,
                                                           scaling_bench)

    dev = resolve_device("cuda")
    bench = dict(n_iters=iters, grid_scale=grid_scale, n_blocks=n_blocks,
                 n_chan_sig=n_chan_sig, device=dev)
    row = scaling_bench(None, **bench)
    with tempfile.TemporaryDirectory() as tmp:
        dev = init_distributed(f"file://{tmp}/rdv", 1, 0, device=dev)
        try:
            mesh = global_mesh(device=dev)
            world1 = scaling_bench(mesh, **bench)
            world1.update(mesh={"chan": 1, "grid": 1}, backend="nccl",
                          collectives=mesh.collectives)
        finally:
            dist.destroy_process_group()
    row.update(mesh=None, n_chan_sig=n_chan_sig,
               cores=len(os.sched_getaffinity(0)), label="one card",
               card=card_name(dev), grid_scale=grid_scale,
               nccl_world_1=world1)
    return row


def run_all(grid_scales, iters: int, out: str) -> None:
    ncores = len(os.sched_getaffinity(0))
    counts = [n for n in RANK_COUNTS if n <= ncores]
    regimes = []
    for gs in grid_scales:
        rows = []
        for n in counts:
            for nc in (c for c in (1, 2, 4, 8) if c <= n and n % c == 0):
                row = measure(n, gs, iters, n_chan=nc)
                rows.append(row)
                print(f"grid x{gs} devices={n:2d} mesh={row['mesh']} "
                      f"{row['grid_points_per_s']:.3e} pts/s "
                      f"({row['sec_per_block'] * 1e3:.1f} ms/block)",
                      flush=True)
        base = rows[0]["grid_points_per_s"]
        for row in rows:
            row["efficiency_vs_1dev"] = (row["grid_points_per_s"]
                                         / (base * row["devices"]))
        best = {}
        for row in rows:
            d = row["devices"]
            if d not in best or row["grid_points_per_s"] > \
                    best[d]["grid_points_per_s"]:
                best[d] = row
        regimes.append({"grid_points_per_block": 2 * 390625 * gs,
                        "grid_scale": gs, "rows": rows,
                        "best_efficiency_per_devices": {
                            str(d): round(r["efficiency_vs_1dev"], 3)
                            for d, r in sorted(best.items())}})
        effs = {f"{r['devices']}dev mesh{r['mesh']}":
                round(r["efficiency_vs_1dev"], 3) for r in rows}
        print(f"grid x{gs} efficiency vs 1 device: {effs}", flush=True)
    table = {
        "metric": "grid_points_per_s of the batched DPE dispatch "
                  "(ops/dpe_real.dpe_batch_blocks: K5's plain version on "
                  "each rank's blocks, each rank's grid rows through K1's "
                  "plain version, the combine over gloo), S=50000, C=8, "
                  "N=8 blocks a dispatch, the spread grid laid out "
                  "grid_scale times",
        "methodology": "gloo ranks on the CPU, a process each, each pinned "
                       "to one core by taskset (strong scaling: a fixed "
                       "grid per regime); one rank is the single-device "
                       "path. Host numbers, not a card's.",
        "cpu": _cpu_model(),
        "host_cores": ncores,
        "regimes": regimes,
    }
    with open(out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {out}")


def _cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=1,
                   help="gloo ranks on the CPU (one core each)")
    p.add_argument("--chan", type=int, default=1,
                   help="ranks on the mesh's 'chan' axis")
    p.add_argument("--c", type=int, default=8, help="signal channels")
    p.add_argument("--grid-scale", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="SCALING_torch.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: one card; raises without one) or "
                        "cpu (gloo ranks)")
    p.add_argument("--rank-spec", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_spec:
        rank_main(json.loads(args.rank_spec))
        return 0
    if args.device == "cpu":
        if args.all:
            run_all(GRID_SCALES, args.iters, args.out)
        else:
            print(json.dumps(measure(args.devices, args.grid_scale,
                                     args.iters, n_chan=args.chan,
                                     n_chan_sig=args.c)))
        return 0
    if args.all or args.devices != 1 or args.chan != 1:
        p.error("--device cuda measures one card (mesh=None, then one NCCL "
                "rank): --all, --devices and --chan are the CPU ranks'")
    print(json.dumps(measure_card(args.grid_scale, args.iters,
                                  n_chan_sig=args.c)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
