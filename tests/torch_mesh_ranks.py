"""One rank of the port's mesh tests (tests/test_torch_mesh.py): torch and
the port only, never jax.

    python tests/torch_mesh_ranks.py RENDEZVOUS WORLD RANK N_CHAN INPUTS OUT CASES [DEVICE]

joins a gloo group of WORLD ranks through the file RENDEZVOUS, on DEVICE
(default cpu; cuda:0 for ranks sharing one card,
tests/test_torch_mesh_cuda.py),
makes the mesh chan=N_CHAN x grid=WORLD/N_CHAN, runs each case of the
comma-separated CASES on the captures and handoffs in INPUTS
(<scenario>.npy, <scenario>.csv, written by the test) and saves every
case's results to OUT (an .npz), with this rank's collective count.
"""

import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from navlab_dpe_sdr_tpu_torch.io.handoff import read_handoff
from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
from navlab_dpe_sdr_tpu_torch.models.dpe import (
    DPEConfig, DPEReceiver)
from navlab_dpe_sdr_tpu_torch.models.grid import (
    spread_grid, uniform_grid)
from navlab_dpe_sdr_tpu_torch.ops import dpe as dpe_ops
from navlab_dpe_sdr_tpu_torch.ops import dpe_real
from navlab_dpe_sdr_tpu_torch.parallel import launch
from navlab_dpe_sdr_tpu_torch.parallel import mesh as pmesh

FS = 2.5e6
REPO = pathlib.Path(__file__).resolve().parent.parent


def start_processes(argv_of_rank, world: int, tmp: pathlib.Path,
                    timeout: float):
    """Start `world` processes (argv_of_rank(r), logs under tmp), join them
    by a deadline, then kill any still running and fail; require exit 0.
    Returns each process's log text."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(argv_of_rank(r), stdout=log,
                                      stderr=subprocess.STDOUT, env=env,
                                      cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [p for p in procs if p.poll() is None]
        for p in hung:
            p.kill()
            p.wait()
    text = []
    for log in logs:
        log.seek(0)
        text.append(log.read())
        log.close()
    assert not hung, (f"{len(hung)} of {world} processes still running "
                      f"after {timeout} s; killed. Log 0:\n{text[0][-3000:]}")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"process {r} exit {p.returncode}:\n" \
                                  f"{text[r][-3000:]}"
    return text


def run_ranks(tmp, world, n_chan, inputs, cases, timeout, device="cpu"):
    """Each rank's {case.key: array} of one launch of this script."""
    start_processes(lambda r: [
        sys.executable, __file__, str(tmp / "rdv"), str(world), str(r),
        str(n_chan), str(inputs), str(tmp / f"out{r}.npz"), ",".join(cases),
        device], world, tmp, timeout)
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(world)]


def receiver(inputs, scenario, mesh, device="cpu", **cfg):
    samples = np.load(f"{inputs}/{scenario}.npy")
    return DPEReceiver(SampleFile(samples=samples, fs=FS),
                       read_handoff(f"{inputs}/{scenario}.csv"),
                       grid=spread_grid(), config=DPEConfig(mesh=mesh, **cfg),
                       device=mesh.device if mesh is not None else device)


def fixes(rx):
    return np.stack([f.x_ecef for f in rx.fixes])


def step_inputs(c=8, s=5000):
    """The sharded real step's inputs: launch.example_inputs on the JAX
    test's 8^4 uniform grid (tests/test_sharding.py)."""
    ex = launch.example_inputs(c=c, s=s, grid=uniform_grid(
        n=8, pos_spacing=5.0, vel_spacing=0.5))
    t = {k: torch.from_numpy(v) for k, v in ex.items()
         if isinstance(v, np.ndarray)}
    params = dpe_ops.ManifoldParams(*(t[k] for k in dpe_ops.ManifoldParams
                                      ._fields))
    args = (t["raw_re"], t["raw_im"], t["chips"], t["rc_mid"], t["idx_next"],
            t["fi"], t["ri"], t["time_idc"], t["pos_start"], t["vel_start"],
            params, t["d_enu"], t["dt_m"], t["dv_enu"], t["dtdot"])
    meta = {k: ex[k] for k in ("carr_fftpts", "period", "n_periods")}
    return args, meta


def run_case(name, inputs, mesh, device="cpu"):
    """{key: array} of one case; the receiver cases run on the mesh's
    device, or on `device` without a mesh."""
    if name == "shapes":
        return dict(shape=np.array([mesh.shape["chan"], mesh.shape["grid"]]),
                    coords=np.array([mesh.coords["chan"],
                                     mesh.coords["grid"]]),
                    grid_rows=np.array(mesh.grid_rows(390625)),
                    block_rows=np.array(mesh.block_rows(10)),
                    chan_rows=np.array([mesh.chan_rows(8).start,
                                        mesh.chan_rows(8).stop]))
    if name == "step_real":
        args, meta = step_inputs()
        out = pmesh.sharded_dpe_step_real(mesh, **meta)(*args)
        return {f"out{i}": np.asarray(x) for i, x in enumerate(out)}
    if name == "batched":
        rx = receiver(inputs, "s8", mesh, device)
        rx.run_batched(10, lookahead=5)
        return dict(fixes=fixes(rx), flips=np.stack(rx.flip_log))
    if name == "per_block":
        rx = receiver(inputs, "s8", mesh)
        rx.run(4)
        return dict(fixes=fixes(rx))
    if name == "integrated":
        rx = receiver(inputs, "s8", mesh)
        rx.run_integrated(2, blocks_per_fix=4)
        return dict(fixes=fixes(rx))
    if name == "weighted":
        rx = receiver(inputs, "s8", mesh, use_argmax=False)
        rx.run_batched(6, lookahead=3)
        return dict(fixes=fixes(rx))
    if name == "grouped":
        rx = receiver(inputs, "s8", mesh)
        rx.run_batched(16, lookahead=8, group_k=4)
        return dict(fixes=fixes(rx))
    if name == "survey":
        rx = receiver(inputs, "s8", mesh)
        res = rx.run_survey(2, blocks_per_fix=4, fine_n=9)
        return dict(x_ecef=res.x_ecef,
                    peaks=np.array([res.pos_score, res.vel_score]))
    if name == "fft":
        rx = receiver(inputs, "s8", mesh, engine="fft")
        rx.run(3)
        return dict(fixes=fixes(rx))
    if name == "chan12":
        rx = receiver(inputs, "s12", mesh)
        rx.run_batched(8, lookahead=4)
        return dict(fixes=fixes(rx))
    if name == "tie":
        # a lattice laid out twice: every score has an exact twin in the
        # other copy, which lies on other ranks
        rng = np.random.default_rng(3)
        b, c, w = 3, 8, 12
        win = torch.from_numpy(rng.random((b, c, w)).astype(np.float32))
        los = torch.from_numpy(rng.standard_normal((b, c, 3))
                               .astype(np.float32))
        cen = torch.full((b, c), w / 2.0)
        coe = torch.full((b, c), 0.00834)
        r0 = torch.full((b, c), 2.2e7)
        g = spread_grid()
        off3 = torch.from_numpy(np.tile(g.d_enu[:4000], (2, 1))
                                .astype(np.float32))
        off1 = torch.from_numpy(np.tile(g.dt_m[:4000], 2).astype(np.float32))
        best, arg = dpe_real.score_joint_argmax(win, los, cen, coe, r0, off3,
                                                off1, mesh=mesh)
        return dict(best=np.asarray(best), arg=np.asarray(arg))
    raise ValueError(name)


def main():
    rdv, world, rank, n_chan, inputs, out, cases = sys.argv[1:8]
    device = sys.argv[8] if len(sys.argv) > 8 else "cpu"
    torch.set_num_threads(1)
    # a dead peer fails the collectives within the minute, not in 30
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=int(world), rank=int(rank),
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = pmesh.make_mesh(n_chan=int(n_chan), device=device)
        res = {}
        for name in cases.split(","):
            for k, v in run_case(name, inputs, mesh).items():
                res[f"{name}.{k}"] = v
        res["collectives"] = np.array(mesh.collectives)
        np.savez(out, **res)
        print(json.dumps({"rank": int(rank), "ok": True}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
