"""The ('chan', 'grid') scoring mesh on torch.distributed: port of
navlab_dpe_sdr_tpu/parallel/mesh.py.

Two axes, as in the JAX package:

- 'chan': satellite channels, the correlator's batch axis. Each 'chan'
  rank correlates its channel shard when the channel count divides (JAX
  `chan_split`); otherwise channels are not split.
- 'grid': grid points, the primary scaling axis. Rank r of the 'grid'
  group scores rows [r * ceil(G / nd), min((r + 1) * ceil(G / nd), G)) of
  each manifold (`ceil_rows`: the offsets JAX pads and masks to), and the
  batched paths' correlation splits its N blocks over the same ranks
  (`even_rows`: contiguous parts that differ in size by at most one).

One process and one device per rank, SPMD: every rank runs the same host
loop on the same samples (the JAX multi-host model, made the only model,
since PyTorch drives no more than one device from a process). So every
collective result must be the same bits on every rank, or the float64 host
state of the ranks would drift apart. Two collectives serve: an
`all_gather` over an axis (`Mesh.all_gather`), whose combines run on every
rank alike on the gathered tensor in rank order (the (max, first index)
combine takes the highest best and, among equal bests, the lowest rank,
which holds the earlier grid rows: the single-device first-occurrence
rule; the weighted sums that ride with it are added in rank order); and a
SUM `all_reduce` (`Mesh.sum`, the channel split's score surfaces), whose
order is the backend's but whose result is the same bits on every rank
(NCCL and gloo reduce each element once and send that result to all).
Collectives are issued only from the receiver's own thread, in the same
order on every rank.

Transport. The one collective goes to the backend with the tensors where
they lie. With NCCL (a CUDA device, one card per rank) the gather runs on
the card and is ordered on the current stream: `dist.all_gather` with
async_op=False makes the current stream wait on NCCL's, so the host never
blocks and a pipelined dispatch stays asynchronous. gloo (the CPU; on the
card, the test bed for two ranks sharing one device, which NCCL refuses
with "Duplicate GPU detected") takes CUDA tensors too in torch 2.11: its
all_gather, all_gather_into_tensor, all_reduce and broadcast all ran on
cuda:0 tensors from two ranks on the H100, so no copy through the host is
needed here; gloo stages them through the host itself and the call returns
when the gather is done.
"""

from __future__ import annotations

import functools
import time

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.score import ceil_rows, even_rows, pick_first

AXES = ("chan", "grid")


class Mesh:
    """A ('chan', 'grid') mesh of ranks over a torch DeviceMesh: the two
    process groups, this rank's coordinates and its device. Counts the
    collectives it issues and the host seconds spent in them
    (`collectives`, `collective_s`; `reset_stats()` zeroes both)."""

    def __init__(self, device_mesh, device: torch.device,
                 owns_group: bool = False):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = {a: int(device_mesh.size(i)) for i, a in enumerate(AXES)}
        self.groups = {a: device_mesh.get_group(a) for a in AXES}
        self.coords = {a: int(device_mesh.get_local_rank(a)) for a in AXES}
        self.backend = dist.get_backend()
        self.owns_group = owns_group
        self.reset_stats()

    @property
    def size(self) -> int:
        return self.shape["chan"] * self.shape["grid"]

    def reset_stats(self) -> None:
        self.collectives = 0
        self.collective_s = 0.0

    # -- this rank's share -------------------------------------------------

    def grid_rows(self, g: int) -> tuple[int, int]:
        """[lo, hi) of this rank's rows of a G-point manifold."""
        return ceil_rows(g, self.shape["grid"])[self.coords["grid"]]

    def block_rows(self, n: int) -> tuple[int, int]:
        """[lo, hi) of the blocks this rank correlates out of n."""
        return even_rows(n, self.shape["grid"])[self.coords["grid"]]

    def chan_split(self, c: int) -> bool:
        """Whether C channels split over 'chan' (JAX: C % n_chan == 0)."""
        return self.shape["chan"] > 1 and c % self.shape["chan"] == 0

    def chan_rows(self, c: int) -> slice:
        """This rank's channels: its shard when they split, else all."""
        if not self.chan_split(c):
            return slice(0, c)
        lo, hi = ceil_rows(c, self.shape["chan"])[self.coords["chan"]]
        return slice(lo, hi)

    # -- collectives -------------------------------------------------------

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """[n_axis, *t.shape]: every rank's t, in rank order along `axis`
        (the one collective of the mesh). bool goes as uint8."""
        t0 = time.perf_counter()
        is_bool = t.dtype == torch.bool
        src = t.contiguous()
        if is_bool:
            src = src.view(torch.uint8)
        out = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(out, src, group=self.groups[axis])
        res = torch.stack(out)
        if is_bool:
            res = res.view(torch.bool)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return res

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of every rank's t over `axis` (a SUM all-reduce; t itself is
        overwritten with it)."""
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.groups[axis])
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return t

    def gather_rows(self, part: torch.Tensor, rows, axis: str = "grid"):
        """Concatenate each rank's rows along dim 0: rank r holds `part`
        with rows[r] = (lo, hi) of the whole; parts are padded to the
        longest for the gather and trimmed after it."""
        most = max(hi - lo for lo, hi in rows)
        pad = most - part.shape[0]
        if pad:
            part = torch.cat([part, part.new_zeros((pad,) + part.shape[1:])])
        parts = self.all_gather(part, axis)
        return torch.cat([parts[r, :hi - lo] for r, (lo, hi)
                          in enumerate(rows)])

    def gather_chan(self, t: torch.Tensor, c: int) -> torch.Tensor:
        """[M, C, ...] from this rank's channel shard [M, C / n_chan, ...];
        t itself when C channels do not split."""
        if not self.chan_split(c):
            return t
        return torch.cat(list(self.all_gather(t, "chan")), dim=1)

    def best_over_grid(self, results):
        """Combine per-rank scorer results over 'grid' in one collective.

        results: one tuple per manifold of (best, arg[, wsum4, wtot]) for
        this rank's rows, arg already a global index (int32; best/arg [N]
        or scalars, wsum4 [..., 4], wtot [...]). Returns the same tuples
        for the whole grid: (max, first index) across ranks, the weighted
        sums added in rank order (JAX `_score_axis_sharded`'s all-gather
        and psum)."""
        cols, layout = [], []
        for res in results:
            shape = res[0].shape
            parts = [res[0].reshape(-1, 1),
                     res[1].to(torch.int32).reshape(-1, 1).view(torch.float32)]
            if len(res) > 2:
                parts += [res[2].reshape(-1, 4), res[3].reshape(-1, 1)]
            cols.append(torch.cat(parts, dim=1))
            layout.append((shape, len(res) > 2))
        k = [c.shape[1] for c in cols]
        gathered = self.all_gather(torch.cat(cols, dim=1), "grid")  # [nd,M,K]
        out, col = [], 0
        for (shape, weighted), width in zip(layout, k):
            g = gathered[..., col:col + width]
            col += width
            best, arg = pick_first(g[..., 0], g[..., 1].contiguous()
                                   .view(torch.int32))
            res = (best.reshape(shape), arg.reshape(shape))
            if weighted:
                acc = g[0, :, 2:]
                for r in range(1, g.shape[0]):
                    acc = acc + g[r, :, 2:]
                res += (acc[:, :4].reshape(shape + (4,)),
                        acc[:, 4].reshape(shape))
            out.append(res)
        return out

    def close(self) -> None:
        """Destroy the process group if this mesh started it (make_mesh at
        world size 1 with no group)."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def default_backend(device: torch.device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(n_grid: int | None = None, n_chan: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """Mesh over ('chan', 'grid') of this process group's ranks, each on
    `device` (default "cuda": a missing card raises). Defaults: all ranks
    on the grid axis. n_chan * n_grid must equal the world size.

    With no process group initialized, a one-rank mesh starts a group of
    its own (an in-process store; nccl on a CUDA device, gloo on the CPU)
    and `Mesh.close()` ends it; a larger mesh raises, naming how to start
    its ranks (torchrun, or parallel/launch.py)."""
    dev = resolve_device(device)
    owns = False
    if not dist.is_initialized():
        want = (n_grid or 1) * n_chan
        if want != 1:
            raise RuntimeError(
                f"a mesh of {want} ranks needs {want} processes in one "
                f"process group, and none is initialized: start them with "
                f"`torchrun --nproc-per-node {want} -m "
                f"navlab_dpe_sdr_tpu_torch ... --mesh ...` or `python -m "
                f"navlab_dpe_sdr_tpu_torch.parallel.launch --coordinator "
                f"HOST:PORT --num-processes {want} --process-id RANK`")
        backend = default_backend(dev)
        kw = dict(device_id=dev) if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
        owns = True
    world = dist.get_world_size()
    if n_grid is None:
        n_grid = world // n_chan
    if n_chan * n_grid != world:
        raise ValueError(f"mesh chan={n_chan} x grid={n_grid} != world size "
                         f"{world}")
    if dev.type == "cuda":
        # bind the device before the DeviceMesh is made: it would otherwise
        # pick one from LOCAL_RANK, also for ranks that share a card
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (n_chan, n_grid), mesh_dim_names=AXES)
    return Mesh(dm, dev, owns_group=owns)


def shard_grid(mesh: Mesh, grid_arrays):
    """This rank's rows (views) of (d_enu, dt_m, dv_enu, dtdot).

    The receivers keep the whole grid on every rank (12.5 MB for the
    spread grid, 1 GB for the dense one) and each scoring call takes its
    rows as views, as JAX's `shard_grid` keeps these arrays replicated
    when the grid axis does not divide; this is the slice that a rank
    scores."""
    d_enu, dt_m, dv_enu, dtdot = grid_arrays
    plo, phi = mesh.grid_rows(d_enu.shape[0])
    vlo, vhi = mesh.grid_rows(dv_enu.shape[0])
    return d_enu[plo:phi], dt_m[plo:phi], dv_enu[vlo:vhi], dtdot[vlo:vhi]


def sharded_dpe_step_real(mesh: Mesh, carr_fftpts: int, period: int,
                          n_periods: int, l_power: int = 1,
                          interp: str = "quadratic",
                          code_win: int | None = None,
                          carr_win: int | None = None):
    """The per-block step of the real windowed engine on the mesh
    (`ops/dpe_real.dpe_device_step_real` with mesh=): correlation at N = 1
    over the channel shard, windows gathered over 'chan', K2 on this
    rank's grid rows, the surfaces gathered over 'grid'. Outputs are the
    whole-grid results on every rank."""
    from ..ops import dpe as dpe_ops
    from ..ops import dpe_real

    return functools.partial(
        dpe_real.dpe_device_step_real, carr_fftpts=carr_fftpts,
        period=period, n_periods=n_periods, l_power=l_power, interp=interp,
        code_win=code_win or dpe_ops.CODE_WIN,
        carr_win=carr_win or dpe_ops.CARR_WIN, mesh=mesh)


def sharded_dpe_step(mesh: Mesh, carr_fftpts: int, l_power: int = 1,
                     interp: str = "quadratic",
                     code_win: int | None = None,
                     carr_win: int | None = None):
    """The FFT engine's per-block step on the mesh (`ops/dpe.
    dpe_device_step` with mesh=): cuFFT over the channel shard, the
    windows gathered over 'chan', K2 on this rank's grid rows."""
    from ..ops import dpe as dpe_ops

    return functools.partial(
        dpe_ops.dpe_device_step, carr_fftpts=carr_fftpts, l_power=l_power,
        interp=interp, code_win=code_win or dpe_ops.CODE_WIN,
        carr_win=carr_win or dpe_ops.CARR_WIN, mesh=mesh)


def scoring_only_step(mesh: Mesh, l_power: int = 1):
    """Manifold scoring alone on the mesh (windows replicated, grid
    rows per rank): step(code_win, carr_win, params, d_enu, dt_m, dv_enu,
    dtdot) -> (pos_scores, pos_arg, vel_scores, vel_arg) of the whole
    grid, the complex windows scored by magnitude (`ops/dpe.
    score_manifolds`)."""
    from ..ops import dpe as dpe_ops

    def step(code_win, carr_win, params, d_enu, dt_m, dv_enu, dtdot):
        return dpe_ops.score_manifolds(code_win, carr_win, params, d_enu,
                                       dt_m, dv_enu, dtdot, l_power=l_power,
                                       mesh=mesh)

    return step
