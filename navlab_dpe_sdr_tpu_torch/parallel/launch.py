"""Multi-process launch of the port: process groups on torch.distributed,
the global ('chan', 'grid') mesh, the scaling measurement and a launcher
(port of navlab_dpe_sdr_tpu/parallel/launch.py).

Every process runs the identical host loop on the same capture; the
device calls take the global mesh (DPEConfig.mesh), so grid scoring
shards across every rank and the fixes come back whole on each. The
per-block boundary state (a few hundred bytes of phases and counters) is
replicated, not communicated.

Launch (one command per process; with nccl, one card per process):

    python -m navlab_dpe_sdr_tpu_torch.parallel.launch \\
        --coordinator host0:29500 --num-processes 4 --process-id $RANK \\
        --capture /data/cap.dat --handoff hand.csv --blocks 1000 --batched

`--coordinator` is HOST:PORT (the tcp:// rendezvous of process 0) or a
whole init-method URL (tcp://..., file://...). Or through the CLI under
torchrun: `torchrun --nproc-per-node 4 -m navlab_dpe_sdr_tpu_torch dpe
cap.dat --handoff hand.csv --mesh grid=4`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import default_backend, make_mesh


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: str | torch.device = "cuda",
                     backend: str | None = None) -> torch.device:
    """Join the process group of `num_processes` ranks as `process_id`
    through `coordinator` (HOST:PORT for tcp://, or an init-method URL).

    A CUDA rank binds cuda:{local rank} (LOCAL_RANK from a launcher, else
    process_id) unless `device` names an index; backend: nccl for a CUDA
    device, gloo for the CPU, or gloo by request on a CUDA device (the
    test bed for ranks sharing one card). Returns the rank's device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda",
                           int(os.environ.get("LOCAL_RANK", process_id)))
    dev = resolve_device(dev)
    backend = backend or default_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)
    return dev


def global_mesh(n_chan: int = 1, device: str | torch.device = "cuda"):
    """Mesh over every rank of the process group: n_chan on 'chan', the
    rest on 'grid'."""
    return make_mesh(n_chan=n_chan, device=device)


def example_inputs(c: int = 8, s: int = 50000, grid=None,
                   fs: float = 2.5e6) -> dict:
    """Seeded inputs of one DPE block step (numpy), drawn in the order of
    the JAX package's `__graft_entry__._example_args`, so both packages see
    the same values: raw_re/raw_im [S], chips [C, 1023], rc_mid, idx_next,
    fi, ri, pos_start, vel_start [C], time_idc [S], the ManifoldParams
    fields, the grid arrays and carr_fftpts/period/n_periods."""
    from ..libgnss.cacode import ca_table
    from ..models.grid import spread_grid
    from ..ops.dpe import CARR_WIN, CODE_WIN

    fpts = 8 * (1 << int(s).bit_length())
    period = int(round(1e-3 * fs))
    rng = np.random.default_rng(0)
    g = grid if grid is not None else spread_grid()
    f32 = np.float32
    out = dict(los_enu=rng.standard_normal((c, 3)).astype(f32),
               r0=np.full(c, 2.2e7, f32),
               pos_center=np.full(c, CODE_WIN / 2, f32),
               pos_coef=np.full(c, 0.00834, f32),
               vel_center=np.full(c, CARR_WIN / 2, f32),
               vel_coef=np.full(c, -1.1, f32))
    out.update(raw_re=rng.standard_normal(s).astype(f32),
               raw_im=rng.standard_normal(s).astype(f32),
               chips=ca_table(range(1, c + 1)).astype(f32))
    out.update(rc_mid=(rng.random(c) * 1023).astype(f32),
               idx_next=rng.integers(1000, s, c).astype(np.int32),
               fi=(rng.standard_normal(c) * 1000).astype(f32),
               ri=rng.random(c).astype(f32),
               time_idc=(np.arange(s) / fs).astype(f32),
               pos_start=np.full(c, s // 2 - CODE_WIN // 2, np.int32),
               vel_start=np.full(c, fpts // 2 - CARR_WIN // 2, np.int32),
               d_enu=g.d_enu.astype(f32), dt_m=g.dt_m.astype(f32),
               dv_enu=g.dv_enu.astype(f32), dtdot=g.dtdot.astype(f32),
               carr_fftpts=fpts, period=period, n_periods=s // period)
    return out


def scaling_bench(mesh, n_iters: int = 3, grid_scale: int = 1,
                  n_blocks: int = 8, n_chan_sig: int = 8,
                  device: str | torch.device = "cuda") -> dict:
    """Grid points per second of the batched DPE dispatch
    (`ops/dpe_real.dpe_batch_blocks`: block-sharded correlation, each
    rank's rows through K1, the combine) on this mesh, with the spread
    grid laid out `grid_scale` times along the grid axis; mesh=None
    measures the single-device path on `device`. Wall clock around
    `n_iters` dispatches after a warm one, synchronized. n_blocks=8
    divides over 1, 2, 4 and 8 ranks, so the correlation stays balanced."""
    from ..models.grid import spread_grid
    from ..ops import dpe_real as dr
    from ..ops.dpe import auto_windows

    dev = mesh.device if mesh is not None else resolve_device(device)
    c, s = n_chan_sig, 50000
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

    g = spread_grid()
    grid = [np.tile(a, (grid_scale,) + (1,) * (a.ndim - 1)).astype(np.float32)
            for a in (g.d_enu, g.dt_m, g.dv_enu, g.dtdot)]
    # windows sized to the scaled grid (its index span grows with it)
    cw, vw = auto_windows(*grid, 2.5e6, ex["carr_fftpts"])
    fpk[:, 7] = cw / 2.0
    fpk[:, 9] = vw / 2.0
    ipk[:, 1] = s // 2 - cw // 2
    ipk[:, 2] = ex["carr_fftpts"] // 2 - vw // 2
    pk = dr.pack_params(fpk, ipk, 0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    raw_dev, chips, time_idc = t(raw_all), t(ex["chips"]), t(ex["time_idc"])
    d_enu, dt_m, dv_enu, dtdot = (t(a) for a in grid)

    def call():
        return dr.dpe_batch_blocks(
            raw_dev, pk, chips, time_idc, d_enu, dt_m, dv_enu, dtdot,
            carr_fftpts=ex["carr_fftpts"], period=ex["period"],
            n_periods=ex["n_periods"], n_blocks=n_blocks,
            return_windows=False, code_win=cw, carr_win=vw, mesh=mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    call()
    sync()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        call()
    sync()
    dt_s = (time.perf_counter() - t0) / n_iters / n_blocks
    n_pts = d_enu.shape[0] + dv_enu.shape[0]
    return {"sec_per_block": dt_s, "grid_points_per_s": n_pts / dt_s,
            "devices": 1 if mesh is None else mesh.size,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="navlab_dpe_sdr_tpu_torch.parallel.launch",
        description="one rank of a multi-process DPE run (or the scaling "
                    "measurement) on a global ('chan', 'grid') mesh")
    p.add_argument("--coordinator", required=True,
                   help="HOST:PORT of the tcp:// rendezvous, or an "
                        "init-method URL (tcp://..., file://...)")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--capture", help="the capture file every rank reads")
    p.add_argument("--handoff")
    p.add_argument("--blocks", type=int, default=100)
    p.add_argument("--batched", action="store_true",
                   help="use the batched path (run_batched)")
    p.add_argument("--bench-only", action="store_true")
    p.add_argument("--grid", default="spread",
                   choices=["spread", "uniform", "dense"])
    p.add_argument("--grid-n", type=int, help="uniform/dense axis points")
    p.add_argument("--grid-spacing", type=float)
    p.add_argument("--device", default="cuda",
                   help="cuda (cuda:{local rank}, nccl), cuda:N, or cpu "
                        "(gloo)")
    args = p.parse_args(argv)
    gkw = {}
    if args.grid_n:
        gkw["n"] = args.grid_n
    if args.grid_spacing:
        gkw["pos_spacing"] = args.grid_spacing
    if args.grid == "spread" and gkw:
        p.error("--grid-n/--grid-spacing need --grid uniform or dense")

    dev = init_distributed(args.coordinator, args.num_processes,
                           args.process_id, device=args.device)
    try:
        mesh = global_mesh(device=dev)
        if args.bench_only or not args.capture:
            stats = scaling_bench(mesh)
            print(f"[proc {args.process_id}] {json.dumps(stats)}",
                  flush=True)
            return
        from ..io.handoff import read_handoff
        from ..io.rawfile import SampleFile
        from ..models.dpe import DPEConfig, DPEReceiver
        from ..models.grid import make_grid

        grid = make_grid(args.grid, **gkw) if args.grid != "spread" else None
        rx = DPEReceiver(SampleFile(args.capture, fs=2.5e6),
                         read_handoff(args.handoff), grid=grid,
                         config=DPEConfig(mesh=mesh), device=dev)
        if args.batched:
            rx.run_batched(args.blocks)
        else:
            rx.run(args.blocks)
        print(f"[proc {args.process_id}] final fix "
              f"{json.dumps([float(v) for v in rx.fixes[-1].x_ecef[:3]])}",
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
