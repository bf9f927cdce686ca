"""Command-line interface of the PyTorch port.

The same 13 subcommands, arguments and defaults as the JAX package's CLI
(navlab_dpe_sdr_tpu/cli.py), over the port's receivers:

  synth     generate a synthetic IF capture + matching handoff (test fixture)
  acquire   coarse+fine acquisition report for a capture
  track     scalar pipeline: acquire -> track -> decode -> PVT -> handoff
  dpe       DPE block loop from a handoff (per-block, batched or integrated)
  survey    multi-epoch joint DPE: one static state against the whole pass
  vt        vector tracking from a scalar pull-in
  fleet     several receivers at once (offline files or live radios)
  mc        Monte-Carlo perturbation / grid-spacing sweeps
  sens      C/N0 sensitivity ladder
  console   the interactive flow console
  live      live-paced real-time run under the watchdog
  record    record a sample source to rotating capture files
  bench     the port's benchmark (not written yet: ROADMAP Queue 1 item 6)

`--device cuda|cpu` (default cuda) is passed to every receiver, fleet and
sweep a command builds; without a card `cuda` raises, and nothing moves to
the CPU unless asked. `--mesh grid=G[,chan=C]` (dpe, survey) runs the
receiver on a mesh of G x C ranks, one process each: start them with
`torchrun --nproc-per-node N -m navlab_dpe_sdr_tpu_torch dpe ... --mesh
grid=N` (a CUDA rank binds cuda:{LOCAL_RANK}); a lone process runs a
one-rank mesh and exits on a larger one, saying how to start the ranks.
Only rank 0 writes the output files and prints the fixes. Differences from
the JAX CLI: no `auto` device and no `--cpu-devices` (the JAX CLI's virtual
CPU devices are its test bed for `--mesh`; the port's test bed is gloo
ranks); `acquire --engine real` (the all-real TPU engine) raises, and
`auto` is `fft`; `dpe --profile-dir` writes a torch.profiler Chrome trace;
`bench` exits naming ROADMAP Queue 1 item 6.

`--set key=value` provides setparam-style overrides of the DPE config.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

from .device import resolve_device


def _parse_set(pairs):
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def _dpe_config(args):
    """DPEConfig from --config (JSON) then --set overrides; unknown keys are
    ignored, as in the JAX CLI."""
    from .models.dpe import DPEConfig

    overrides = {}
    if getattr(args, "config", None):
        with open(args.config) as fo:
            overrides.update(json.load(fo))
    overrides.update(_parse_set(args.set))
    return DPEConfig(**{k: v for k, v in overrides.items()
                        if k in DPEConfig.__dataclass_fields__})


@contextlib.contextmanager
def _cli_mesh(args):
    """The --mesh grid=G[,chan=C] mesh (None without --mesh), torn down
    after the command. Under torchrun (WORLD_SIZE in the environment) the
    process joins the launcher's group first and a CUDA rank binds
    cuda:{LOCAL_RANK}; the mesh must then equal the world size. A lone
    process runs a one-rank mesh, and exits on a larger one."""
    if not getattr(args, "mesh", None):
        yield None
        return
    import torch.distributed as dist

    from .parallel.launch import init_distributed
    from .parallel.mesh import make_mesh

    spec = dict(kv.split("=") for kv in args.mesh.split(","))
    n_grid = int(spec.get("grid", 0)) or None
    n_chan = int(spec.get("chan", 1))
    joined = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        args.device = init_distributed(
            "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
            device=args.device.type)
        joined = True
    if not dist.is_initialized() and (n_grid or 1) * n_chan != 1:
        want = (n_grid or 1) * n_chan
        raise SystemExit(
            f"--mesh {args.mesh}: {want} ranks need {want} processes; start "
            f"them with `torchrun --nproc-per-node {want} -m "
            f"navlab_dpe_sdr_tpu_torch {args.cmd} ... --mesh {args.mesh}` "
            f"(or python -m navlab_dpe_sdr_tpu_torch.parallel.launch)")
    mesh = make_mesh(n_grid=n_grid, n_chan=n_chan, device=args.device)
    if dist.get_rank() == 0:
        print(f"mesh: {mesh.shape} over {mesh.size} rank(s) "
              f"({mesh.backend} on {mesh.device})")
    try:
        yield mesh
    finally:
        mesh.close()
        if joined:
            dist.destroy_process_group()


def _rank0(mesh) -> bool:
    """Whether this process writes outputs and prints fixes: always
    without a mesh, rank 0 with one."""
    import torch.distributed as dist

    return mesh is None or dist.get_rank() == 0


def cmd_synth(args):
    from .io.handoff import write_handoff
    from .io.scenario import make_scenario

    sim, hand, arr = make_scenario(n_sats=args.sats, cn0_dbhz=args.cn0,
                                   fs=args.fs, seed=args.seed)
    print(f"synthesizing {args.seconds}s at {args.fs / 1e6} MHz, "
          f"PRNs {hand.prn_list} ...")
    sim.write_capture(args.out, args.seconds)
    if args.handoff:
        write_handoff(args.handoff, hand)
        print(f"wrote handoff to {args.handoff}")
    print(f"wrote {args.out}")


def cmd_acquire(args):
    from .io.rawfile import SampleFile
    from .ops import acquisition

    if args.engine == "real":
        raise NotImplementedError(acquisition.REAL_ENGINE_REFUSAL)
    rf = SampleFile(args.file, fs=args.fs, ds=args.ds)
    rf.seek(int(args.skip * args.fs))
    read_ms = args.deep_ms if args.deep_ms else 10
    rf.set_block(read_ms * 1e-3, read_ms * 1e-3, verbose=False)
    block = rf.read_block()
    prns = ([int(p) for p in args.prns.split(",")] if args.prns
            else list(range(1, 33)))
    if args.deep_ms:
        results = acquisition.acquire_deep(block, prns, rf.fs, rf.fcaid,
                                           n_coh_ms=args.coh_ms,
                                           device=args.device)
    else:
        results = acquisition.acquire(block, prns, rf.fs, rf.fcaid,
                                      coherent=not args.noncoherent,
                                      device=args.device)
    print(f"{'PRN':>4} {'found':>6} {'rc[chips]':>10} {'fi[Hz]':>9} "
          f"{'cppm':>6} {'cppr':>6}")
    for r in sorted(results, key=lambda r: -r.cppm):
        print(f"{r.prn:4d} {str(r.found):>6} {r.rc:10.2f} {r.fi:9.1f} "
              f"{r.cppm:6.2f} {r.cppr:6.2f}")


def cmd_track(args):
    from .io.rawfile import SampleFile
    from .libgnss import frames
    from .models.scalar import ScalarReceiver
    from .ops.tracking import LoopConfig, cadence_loops

    rf = SampleFile(args.file, fs=args.fs, ds=args.ds)
    rf.seek(int(args.skip * args.fs))
    prns = [int(p) for p in args.prns.split(",")]
    # cadence-aware carrier-loop defaults (ops/tracking.cadence_loops):
    # unless set explicitly, coherent mode narrows the PLL and adds FLL
    # assist for pull-in
    dflt = cadence_loops(args.coh_ms)
    bn_carr = dflt.bn_carr if args.bn_carr is None else args.bn_carr
    bn_f = dflt.bn_carr_freq if args.bn_carr_freq is None else \
        args.bn_carr_freq
    rx = ScalarReceiver(rf, prns,
                        loops=LoopConfig(order=args.loop_order,
                                         bn_code=args.bn_code,
                                         bn_carr=bn_carr,
                                         bn_carr_freq=bn_f),
                        device=args.device)
    rx.acquire()
    n_ms = int(args.seconds * 1000)
    step_ms = args.coh_ms if args.coh_ms > 1 else args.batch_k
    n_ms -= n_ms % step_ms
    print(f"tracking {args.seconds}s ..." + (
        f" (coherent {args.coh_ms} ms updates)" if args.coh_ms > 1 else "")
        + (f" (batch_k={args.batch_k} fused windows)"
           if args.batch_k > 1 else ""))
    rx.track(n_ms, coh_ms=args.coh_ms, batch_k=args.batch_k)
    good = rx.decode_ephemerides()
    if args.rinex:
        from .libgnss import rinex as rinex_mod
        missing = [p for p in prns if p not in good]
        if missing:
            print(f"filling ephemerides for {missing} from {args.rinex}")
            rx.set_ephemerides(rinex_mod.load_ephemerides(
                args.rinex, missing))
    rx_time_a, rx_time, x_ecef, x_eci, sats = rx.nav_solution()
    lla = frames.ecef_to_lla(x_ecef[:3])
    print(f"fix: ECEF {x_ecef[:3]}  LLA {lla[0]:.6f},{lla[1]:.6f},{lla[2]:.1f}")
    if args.handoff:
        rx.save_handoff(args.handoff)
        print(f"wrote handoff to {args.handoff}")
    if args.checkpoint:
        rx.save_state(args.checkpoint)
        print(f"wrote checkpoint to {args.checkpoint}")


def _eph_manager(args, hand):
    """Every RINEX record per PRN; the receiver re-selects the closest-toe
    valid set each block (cuchanmgr.cu:240-306). None without --rinex."""
    if not args.rinex:
        return None
    from .libgnss import rinex as rinex_mod
    from .libgnss.ephemeris import EphManager
    return EphManager(rinex_mod.parse_rinex_nav(args.rinex), hand.prn_list)


@contextlib.contextmanager
def _profiled(profile_dir, device):
    """torch.profiler over the block; the Chrome trace is written into
    profile_dir when it ends, also when a step raises. No-op without a
    directory."""
    if not profile_dir:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profiler trace written: {path}")


def cmd_dpe(args):
    with _cli_mesh(args) as mesh:
        _dpe(args, mesh)


def _dpe(args, mesh):
    from .io.handoff import read_handoff
    from .io.printer import FixWriter
    from .io.rawfile import SampleFile
    from .models.dpe import DPEReceiver
    from .models.grid import load_grid_csv, make_grid
    from .runtime.flow import FlowRunner

    rank0 = _rank0(mesh)
    hand = read_handoff(args.handoff)
    rf = SampleFile(args.file, fs=args.fs, ds=args.ds)
    cfg = _dpe_config(args)
    cfg.mesh = mesh
    if args.grid_csv:
        grid = load_grid_csv(args.grid_csv)
    else:
        gkw = {}
        if args.grid_n:
            gkw["n"] = args.grid_n
        if args.grid_spacing:
            gkw["pos_spacing"] = args.grid_spacing
        if args.grid_vel_spacing:
            gkw["vel_spacing"] = args.grid_vel_spacing
        if args.grid == "spread" and gkw:
            raise SystemExit("--grid-n/--grid-spacing apply to "
                             "uniform/arthur/dense/exponential grids only")
        grid = make_grid(args.grid, **gkw)
        print(f"grid: {args.grid} {grid.n_pos} pos + {grid.n_vel} vel points")

    rx = DPEReceiver(rf, hand, grid=grid, config=cfg,
                     eph_manager=_eph_manager(args, hand), device=args.device)
    n_blocks = args.blocks

    with _profiled(args.profile_dir if rank0 else None, rx.device):
        writer = (FixWriter(args.out, weekno=args.weekno)
                  if args.out and rank0 else None)

        # --log port=path[:bin] — attach async loggers to arbitrary receiver
        # ports (reference DataLogger any-port attachment, datalogger.cu:34)
        port_loggers = []
        for spec in (args.log or []) if rank0 else []:
            port, _, dest = spec.partition("=")
            binary = dest.endswith(":bin")
            dest = dest[:-4] if binary else dest
            if not dest:
                raise SystemExit(
                    f"--log expects port=path[:bin], got {spec!r}")
            from .runtime.nativelib import PortLogger

            def mk_getter(name):
                if name == "x":
                    return lambda: rx.ekf.x
                if name == "fix":
                    return lambda: np.concatenate([[rx.fixes[-1].rx_time_a],
                                                   rx.fixes[-1].x_ecef])
                if not hasattr(rx, name):
                    raise SystemExit(f"--log: receiver has no port {name!r}")
                return lambda: getattr(rx, name)

            port_loggers.append(PortLogger(dest, mk_getter(port),
                                           binary=binary))

        def on_fix(fix):
            if writer:
                writer.write(fix)
            for pl in port_loggers:
                pl.step()
            if args.verbose and rank0:
                from .libgnss import frames
                lla = frames.ecef_to_lla(fix.x_ecef[:3])
                print(f"{fix.mc:5d} {lla[0]:.6f} {lla[1]:.6f} {lla[2]:8.2f} "
                      f"score {fix.pos_score:.3e}")

        def run_flow(step):
            runner = FlowRunner(step, watchdog_s=args.watchdog,
                                max_iterations=n_blocks,
                                realtime_budget_s=rx.cfg.T)
            stats = runner.run(n_blocks, on_result=on_fix)
            print(stats.summary())
            if stats.first_s is not None:
                print(f"first iteration: {stats.first_s * 1e3:.3f} ms "
                      f"(watchdog {args.watchdog} s)")
            return runner

        if args.integrate:
            rx.run_integrated(n_blocks // args.integrate,
                              blocks_per_fix=args.integrate,
                              coherent=args.coherent)
            if writer:
                for f in rx.fixes:
                    writer.write(f)
        elif args.batched:
            gk = max(1, args.group_k)
            if gk > 1 and args.lookahead % gk:
                raise SystemExit(
                    f"--group-k {gk} must divide --lookahead "
                    f"{args.lookahead} "
                    f"(each dispatch is grouped into lookahead/group_k "
                    f"coherent sums)")
            if gk > 1 and n_blocks % gk:
                print(f"note: trimming {n_blocks % gk} blocks so --blocks is "
                      f"a multiple of --group-k {gk}")
                n_blocks -= n_blocks % gk
            depth = max(0, args.pipeline_depth)
            rx.run_batched(n_blocks, lookahead=args.lookahead, group_k=gk,
                           pipeline=depth > 0, pipeline_depth=max(1, depth))
            if writer:
                for f in rx.fixes:
                    writer.write(f)
        elif args.native_io:
            # native runtime path: threaded ring-buffer sample streamer
            # feeds the step with int16 I/Q blocks; the 8-state fixes drain
            # through the async CSV logger
            from .runtime.nativelib import AsyncLogger, SampleStream

            stream = SampleStream(args.file, block_samples=rx.S,
                                  start_byte=hand.bytes_read)
            xlog = (AsyncLogger(args.xecef_log, n_cols=9)
                    if args.xecef_log and rank0 else None)

            def step_native():
                blk = stream.next_block()
                if blk is None:
                    raise EOFError
                fix = rx.step(raw_block=blk)
                if xlog:
                    xlog.write(np.concatenate([[fix.rx_time_a], fix.x_ecef]))
                return fix

            try:
                run_flow(step_native)
            finally:
                stream.close()
                if xlog:
                    xlog.close()
        else:
            runner = run_flow(rx.step)
            print(f"real-time misses (> {rx.cfg.T * 1e3:.0f} ms): "
                  f"{runner.realtime_misses}")
    for pl in port_loggers:
        pl.close()
    if writer:
        writer.close()
    if not rank0:
        return
    if rx.fixes:
        last = rx.fixes[-1]
        print(f"final fix: {last.x_ecef[:3]}")
    if args.rts_out:
        if rx.cfg.ekf_mode != "full":
            print("--rts-out needs --set ekf_mode=full", file=sys.stderr)
        elif args.batched or args.integrate:
            print("--rts-out needs the per-block loop (drop --batched/"
                  "--integrate): batched runs record predictions in "
                  "batches, which breaks the RTS pairing", file=sys.stderr)
        else:
            xs = rx.ekf.rts_smooth()
            with FixWriter(args.rts_out, weekno=args.weekno) as w:
                for fix, x in zip(rx.fixes, xs):
                    w.write(type(fix)(mc=fix.mc, rx_time=fix.rx_time,
                                      rx_time_a=fix.rx_time_a, x_ecef=x,
                                      pos_score=fix.pos_score,
                                      vel_score=fix.vel_score))
            print(f"RTS-smoothed fixes written: {args.rts_out}")
    if args.save_handoff:
        rx.save_handoff(args.save_handoff)
        print(f"checkpoint written: {args.save_handoff}")


def cmd_survey(args):
    """Multi-epoch joint DPE: one static state against the whole pass."""
    with _cli_mesh(args) as mesh:
        _survey(args, mesh)


def _survey(args, mesh):
    from .io.handoff import read_handoff
    from .io.printer import FixWriter
    from .io.rawfile import SampleFile
    from .libgnss import frames
    from .models.dpe import DPEReceiver
    from .models.grid import make_grid

    hand = read_handoff(args.handoff)
    rf = SampleFile(args.file, fs=args.fs, ds=args.ds)
    cfg = _dpe_config(args)
    cfg.mesh = mesh
    grid = make_grid(args.grid)
    rx = DPEReceiver(rf, hand, grid=grid, config=cfg,
                     eph_manager=_eph_manager(args, hand), device=args.device)
    n_batches = args.blocks // args.batch
    t0 = time.time()
    res = rx.run_survey(n_batches, blocks_per_fix=args.batch,
                        fine_spacing=args.fine_spacing, fine_n=args.fine_n,
                        vel_fine_spacing=args.vel_fine_spacing,
                        zoom_interp=args.zoom_interp)
    wall = time.time() - t0
    if not _rank0(mesh):
        return
    lla = frames.ecef_to_lla(res.x_ecef[:3])
    print(f"survey over {res.n_blocks} blocks "
          f"({res.n_blocks * cfg.T:.1f} s) in {wall:.1f} s")
    print(f"  position ECEF: {res.x_ecef[0]:.3f} {res.x_ecef[1]:.3f} "
          f"{res.x_ecef[2]:.3f}  LLA: {lla[0]:.7f} {lla[1]:.7f} "
          f"{lla[2]:.2f}")
    print(f"  clock bias {res.x_ecef[3]:.3f} m, drift "
          f"{res.x_ecef[7]:.4f} m/s at rxTime {res.t_ref:.3f}")
    print(f"  sigma ENU+clk [m]: "
          + " ".join(f"{s:.3f}" for s in res.sigma_pos))
    print(f"  velocity [m/s]: "
          + " ".join(f"{v:.4f}" for v in res.x_ecef[4:7])
          + "  sigma ENU+drift: "
          + " ".join(f"{s:.4f}" for s in res.sigma_vel))
    if args.out:
        with FixWriter(args.out, weekno=args.weekno) as w:
            for f in rx.fixes:
                w.write(f)
        print(f"per-batch fixes written: {args.out}")
    if args.json:
        payload = {
            "x_ecef": list(map(float, res.x_ecef)),
            "lla": list(map(float, lla)),
            "t_ref": res.t_ref, "n_blocks": res.n_blocks,
            "n_batches": res.n_batches,
            "sigma_pos": list(map(float, res.sigma_pos)),
            "sigma_vel": list(map(float, res.sigma_vel)),
            "cov_pos": [list(map(float, r)) for r in res.cov_pos],
            "cov_vel": [list(map(float, r)) for r in res.cov_vel],
            "pos_score": res.pos_score, "vel_score": res.vel_score,
            "wall_s": wall,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"survey JSON written: {args.json}")


def cmd_vt(args):
    from .io.rawfile import SampleFile
    from .libgnss import frames
    from .models.scalar import ScalarReceiver
    from .models.vector import VectorReceiver

    rf = SampleFile(args.file, fs=args.fs, ds=args.ds)
    rf.seek(int(args.skip * args.fs))
    prns = [int(p) for p in args.prns.split(",")]
    rx = ScalarReceiver(rf, prns, device=args.device)
    rx.acquire(verbose=False)
    print(f"scalar pull-in {args.pullin}s ...")
    rx.track(int(args.pullin * 1000))
    if args.rinex:
        from .libgnss import rinex as rinex_mod
        rx.set_ephemerides(rinex_mod.load_ephemerides(args.rinex, prns))
    else:
        rx.decode_ephemerides(verbose=False)
    vt = VectorReceiver.from_scalar(rx)
    print(f"vector tracking {args.epochs} epochs ...")
    vt.run(args.epochs)
    lla = frames.ecef_to_lla(vt.x[:3])
    print(f"final fix: {vt.x[:3]}  LLA {lla[0]:.6f},{lla[1]:.6f},{lla[2]:.1f}")


def _warm_fleet(args, prns):
    """Load every kernel and cuFFT plan the live flow will use BEFORE the
    shared clock starts (a real receiver warms up before the antenna goes
    hot): acquisition, a [2000, S, 2] and a [1, S, 2] tracking chunk, and
    with --dpe-blocks one [k, S, 2] batched DPE dispatch through a throwaway
    receiver on a synthetic handoff. A failure here raises."""
    import copy

    import torch

    from .io.rawfile import DTYPE_IQ16, SampleFile
    from .io.scenario import make_scenario
    from .models.dpe import DPEConfig, DPEReceiver
    from .models.grid import spread_grid
    from .models.scalar import ScalarReceiver

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    wsamp = np.empty(int(2.2 * args.fs), DTYPE_IQ16)
    wsamp["i"] = rng.integers(-64, 64, wsamp.shape[0]).astype(np.int16)
    wsamp["q"] = rng.integers(-64, 64, wsamp.shape[0]).astype(np.int16)
    warm_rx = ScalarReceiver(SampleFile(samples=wsamp, fs=args.fs), prns,
                             device=args.device)
    warm_rx.acquire(verbose=False)
    warm_rx.track(2000)
    warm_rx.track(1, chunk_ms=1)
    del warm_rx
    if args.dpe_blocks:
        k = max(1, args.live_lookahead)
        _, hand0, arr0 = make_scenario(nav_data=True)
        wrx = DPEReceiver(SampleFile(samples=wsamp, fs=args.fs),
                          copy.deepcopy(hand0), grid=spread_grid(),
                          eph=copy.deepcopy(arr0), config=DPEConfig(),
                          device=args.device)
        zb = torch.zeros((k, wrx.S, 2), dtype=torch.int16,
                         device=wrx.device)
        wrx.run_batched(k, lookahead=k, raw_blocks_dev=zb)
        del wrx
    print(f"pipeline warmup: {time.perf_counter() - t0:.1f} s")


def cmd_fleet(args):
    from .io.rawfile import SampleFile
    from .models.fleet import ReceiverFleet

    files = args.files
    prns = [int(p) for p in args.prns.split(",")]
    if args.live:
        # N synchronized simulated radios (one per file, or one file with
        # per-radio clock offsets) on a shared MultiSource clock — the
        # reference's multi-USRP sync capture (guhd.cpp:27-60) driven
        # end-to-end live
        from .io.frontend import MultiSource, RadioSyncConfig, SimulatedRadio
        if args.offsets_ms is not None:
            if len(files) != 1:
                raise SystemExit("--offsets-ms wants exactly one file")
            offs = [float(o) for o in args.offsets_ms.split(",")]
            srcs = [SimulatedRadio(files[0], fs=args.fs, block_samples=2500,
                                   start_byte=int(round(o * 1e-3 * args.fs))
                                   * 4)
                    for o in offs]
        else:
            srcs = [SimulatedRadio(f, fs=args.fs, block_samples=2500)
                    for f in files]
        shortest_s = min(s._iq.shape[0] for s in srcs) / args.fs
        _warm_fleet(args, prns)
        multi = MultiSource(srcs, RadioSyncConfig())
        fleet = ReceiverFleet.from_live(
            multi, prns, fs=args.fs, max_seconds=shortest_s + 1.0,
            labels=[f"rx{i}" for i in range(len(srcs))], device=args.device)
        print(f"live fleet: {len(srcs)} simulated radios on one clock "
              f"({shortest_s:.1f}s of signal each)")
    else:
        fleet = ReceiverFleet([SampleFile(f, fs=args.fs) for f in files],
                              prns,
                              labels=[f"rx{i}" for i in range(len(files))],
                              device=args.device)
    fleet.acquire(verbose=True)
    print(f"tracking {args.seconds}s on {len(files)} receivers ...")
    fleet.track(int(args.seconds * 1000))
    if args.live:
        fleet.mark_phase("track")
    decoded = fleet.decode_ephemerides(verbose=True)
    if args.rinex:
        from .libgnss import rinex as rinex_mod
        for rx, good in zip(fleet.receivers, decoded):
            missing = [p for p in prns if p not in good]
            if missing:
                rx.set_ephemerides(rinex_mod.load_ephemerides(args.rinex,
                                                              missing))
    elif any(set(g) != set(prns) for g in decoded):
        print("not all ephemerides decoded (need ~36 s of data or --rinex); "
              "skipping alignment/DPE")
        if args.live:
            # the lag/delivery accounting matters MOST when diagnosing a
            # failed live run — emit it and shut the radios down
            fleet.mark_phase("decode_failed")
            stats = {"sources": fleet.live_stats(),
                     "behind_max_s": round(fleet.multi.behind_max_s, 4),
                     "decode_failed": True}
            print(f"live stats: {stats}")
            if args.stats_out:
                with open(args.stats_out, "w") as f:
                    json.dump(stats, f, indent=1)
            fleet.multi.close()
        return
    offsets = fleet.align()
    if args.live:
        fleet.mark_phase("decode_align")
    print(f"alignment offsets [ms]: {list(offsets)}")
    for label, (rx_time_a, _, x_ecef, _, _) in zip(fleet.labels,
                                                   fleet.nav_solutions()):
        print(f"{label}: t={rx_time_a:.6f} fix={x_ecef[:3]}")
    dpes = None
    if args.dpe_blocks:
        import os
        os.makedirs(args.out_dir, exist_ok=True)
        print(f"running DPE x{args.dpe_blocks} blocks per receiver ...")
        dpes = fleet.run_dpe(args.dpe_blocks, checkpoint_dir=args.out_dir,
                             lookahead=(args.live_lookahead if args.live
                                        else 1))
        for label, drx in zip(fleet.labels, dpes):
            print(f"{label}: final {drx.fixes[-1].x_ecef[:3]}")
    if args.live:
        fleet.mark_phase("dpe")
        stats = {"sources": fleet.live_stats(),
                 "behind_max_s": round(fleet.multi.behind_max_s, 4),
                 "offsets_ms": [int(o) for o in offsets]}
        if dpes is not None and len(dpes) >= 2:
            # per-receiver median fixes must agree within grid noise —
            # the multi-radio alignment contract (0_Data_reduction.py)
            med = [np.median(np.stack([f.x_ecef[:3] for f in d.fixes]), 0)
                   for d in dpes]
            stats["fix_spread_m"] = round(float(max(
                np.linalg.norm(m - med[0]) for m in med[1:])), 2)
        print(f"live stats: {stats}")
        if args.stats_out:
            with open(args.stats_out, "w") as f:
                json.dump(stats, f, indent=1)
        fleet.multi.close()


def cmd_mc(args):
    """Monte-Carlo campaign: init-perturbation runs or grid-spacing sweep
    (reference main.cu:105-280 automation harnesses)."""
    from .io.handoff import read_handoff
    from .models import montecarlo as mc
    from .models.grid import make_grid

    hand = read_handoff(args.handoff)
    cfg = _dpe_config(args)
    truth = None
    if args.truth:
        truth = read_handoff(args.truth).x_ecef

    if args.spacings:
        spacings = [float(s) for s in args.spacings.split(",")]
        results = mc.spacing_sweep(
            args.file, hand, spacings, blocks=args.blocks,
            grid_n=args.grid_n, style=args.grid_style, config=cfg,
            converge_m=args.converge_m, out_dir=args.out_dir, fs=args.fs,
            truth_ecef=truth, device=args.device)
        for r in results:
            print(f"spacing {r.spacing:5.2f} m -> median "
                  f"{r.median_err_m:8.2f} m "
                  f"{'ok' if r.converged else 'DIVERGED'}")
    else:
        time_band = None
        if args.time_band:
            lo, hi = (float(v) for v in args.time_band.split(","))
            time_band = (lo, hi - lo)
        grid = make_grid(args.grid) if args.grid else None
        results = mc.perturbation_sweep(
            args.file, hand, runs=args.runs, blocks=args.blocks,
            bottom=args.bottom, span=args.span, time_band=time_band,
            grid=grid, config=cfg, converge_m=args.converge_m,
            seed=args.seed, out_dir=args.out_dir, fs=args.fs,
            truth_ecef=truth, device=args.device)
        summary = mc.convergence_summary(results)
        print(mc.format_summary(summary))
        if args.out_dir:
            mc.save_summary(f"{args.out_dir}/summary.json", summary, results)
            print(f"wrote {args.out_dir}/summary.json")


def cmd_sens(args):
    """C/N0 sensitivity ladder on the synthetic truth scenario: per-block
    vs on-device K-block-integrated DPE hold (capability sweep beyond the
    reference's geometry-only harnesses)."""
    from .models import montecarlo as mc
    from .models.grid import make_grid

    cfg = _dpe_config(args)
    levels = [float(v) for v in args.levels.split(",")]
    grid = make_grid(args.grid) if args.grid else None
    if args.survey:
        results = mc.weak_sweep(levels, blocks=args.blocks,
                                blocks_per_fix=args.k, seed=args.seed,
                                grid=grid, config=cfg, hold_m=args.hold_m,
                                fine_spacing=args.fine_spacing,
                                out_path=args.out, device=args.device)
        held = [pt.cn0_dbhz for pt in results if pt.held]
        print(f"survey hold (<{args.hold_m:.0f} m) down to "
              f"{min(held):.1f} dB-Hz" if held else "no level held")
    else:
        results = mc.cn0_sweep(levels, blocks=args.blocks,
                               blocks_per_fix=args.k, seed=args.seed,
                               grid=grid, config=cfg, hold_m=args.hold_m,
                               coherent=args.coherent, out_path=args.out,
                               device=args.device)
        held = [pt.cn0_dbhz for pt in results if pt.held]
        print(f"integrated hold (<{args.hold_m:.0f} m) down to "
              f"{min(held):.1f} dB-Hz" if held else "no level held")
    if args.out:
        print(f"wrote {args.out}")


def cmd_live(args):
    """Live-paced real-time demonstration (RunLive, sampleblock.cu:421-426):
    a server paces the capture over TCP at true fs wall-clock; the receiver
    must keep up under the 1.5 s watchdog with per-iteration drop
    accounting. Compute is timed after the source returns (flow.cu:132-135);
    the sample wait is delivery, not work."""
    import copy

    import torch

    from .io.handoff import read_handoff
    from .io.netsource import PacedReplayServer, open_tcp_source
    from .io.rawfile import DTYPE_IQ16, SampleFile
    from .models.dpe import DPEReceiver
    from .models.grid import make_grid
    from .runtime.flow import FlowRunner

    hand = read_handoff(args.handoff)
    cfg = _dpe_config(args)
    gkw = {}
    if args.grid_n:
        gkw["n"] = args.grid_n
    grid = make_grid(args.grid, **gkw)

    use_sim = args.source == "sim"
    srv = None
    if not use_sim:
        srv = PacedReplayServer(args.file, fs=args.fs,
                                start_byte=hand.bytes_read)
        print(f"paced server: 127.0.0.1:{srv.port} at "
              f"{args.fs / 1e6:.2f} Msps (skip {hand.bytes_read} B)")

    # a zero-sample SampleFile donor provides fs/S/block geometry; samples
    # arrive from the source
    donor = SampleFile(samples=np.zeros(0, DTYPE_IQ16), fs=args.fs,
                       ds=args.ds)
    rx = DPEReceiver(donor, hand, grid=grid, config=cfg, device=args.device)
    k = max(1, args.lookahead)

    # warm the compute pipeline before going live (a real receiver warms
    # up before the antenna goes hot): one batch of zeros through a
    # THROWAWAY receiver, so kernel loads and cuFFT plans never land inside
    # the watchdog window; the real receiver's state is untouched
    warm_rx = DPEReceiver(donor, copy.deepcopy(hand), grid=grid,
                          config=cfg, device=args.device)
    t0 = time.perf_counter()
    if k == 1:
        warm_rx.step(raw_block=np.zeros((warm_rx.S, 2), np.int16))
    else:
        warm_rx.run_batched(k, lookahead=k, raw_blocks_dev=torch.zeros(
            (k, warm_rx.S, 2), dtype=torch.int16, device=warm_rx.device))
    del warm_rx
    print(f"pipeline warmup: {time.perf_counter() - t0:.1f} s")

    if use_sim:
        # in-process simulated radio (io.frontend): the same wall-clock
        # delivery contract as the TCP pacer, through the SampleSource
        # interface every front-end (incl. SoapyRadio hardware) implements
        from .io.frontend import SimulatedRadio
        stream = SimulatedRadio(args.file, fs=args.fs, block_samples=rx.S,
                                start_byte=hand.bytes_read)
        print(f"simulated radio: wall-clock paced at "
              f"{args.fs / 1e6:.2f} Msps (skip {hand.bytes_read} B)")
    else:
        stream = open_tcp_source("127.0.0.1", srv.port, block_samples=rx.S,
                                 timeout_s=args.watchdog)
    n_blocks = int(round(args.seconds / cfg.T)) if args.seconds else 10 ** 9
    if k > 1 and n_blocks < 10 ** 9 and n_blocks % k:
        # only the [k, S, 2] batch shape is warmed
        print(f"trimming to {n_blocks - n_blocks % k} blocks "
              f"(whole {k}-block dispatches)")
        n_blocks -= n_blocks % k

    got = {"blocks": 0}

    def fetch_batch():
        want = min(k, n_blocks - got["blocks"])
        blks = []
        for _ in range(want):
            b = stream.next_block()
            if b is None:
                break
            blks.append(np.asarray(b))
        if not blks:
            return None
        if k > 1 and len(blks) < k:
            # stream ended mid-batch: drop the <1 s tail rather than
            # dispatch an unwarmed partial batch under the watchdog
            print(f"dropping {len(blks)}-block tail at stream end")
            return None
        got["blocks"] += len(blks)
        return np.stack(blks)                      # [K, S, 2] int16

    def process(batch):
        n = batch.shape[0]
        if k == 1:
            rx.step(raw_block=batch[0])
        else:
            rx.run_batched(n, lookahead=n, raw_blocks_dev=torch.from_numpy(
                batch).to(rx.device))
        return rx.fixes[-1]

    budget = k * cfg.T
    runner = FlowRunner(process, watchdog_s=args.watchdog,
                        realtime_budget_s=budget, source_fn=fetch_batch)
    t0 = time.perf_counter()
    try:
        stats = runner.run()
    finally:
        stream.close()
    wall = time.perf_counter() - t0

    margin = budget / stats.avg_s if stats.n else float("inf")
    rec = {
        "signal_seconds": got["blocks"] * cfg.T,
        "wall_seconds": round(wall, 3),
        "blocks": got["blocks"],
        "iterations": stats.n,
        "lookahead": k,
        "budget_ms": budget * 1e3,
        "avg_compute_ms": round(stats.avg_s * 1e3, 3),
        "max_compute_ms": round(max(stats.top_max) * 1e3, 3)
                          if stats.top_max else None,
        "rt_misses": runner.realtime_misses,
        "watchdog_s": args.watchdog,
        "margin_x": round(margin, 2),
        "server_behind_max_ms": round(
            (srv if srv is not None else stream).behind_max_s * 1e3, 3),
        "source": args.source,
        "fs": args.fs,
        "device": str(rx.device),
    }
    print(stats.summary())
    print(f"real-time: {rec['rt_misses']} misses over {stats.n} iterations "
          f"({rec['signal_seconds']:.1f} s of signal), margin "
          f"{rec['margin_x']}x, server fell behind at most "
          f"{rec['server_behind_max_ms']} ms")
    if args.json:
        with open(args.json, "w") as fo:
            json.dump(rec, fo, indent=1)
        print(f"wrote {args.json}")


def cmd_record(args):
    """Capture recorder: pump a sample source into timestamped rotating
    files (the guhd capture tool: guhd.cpp main loop + buffer.cpp:47-78
    filename/rotation contract). Host only: no device work."""
    from .io.frontend import RotatingRecorder, open_source, record

    src = open_source(args.source, fs=args.fs,
                      block_samples=args.block_samples, loop=args.loop)
    rec = RotatingRecorder(args.out_dir, fs=args.fs,
                           usrp_index=args.usrp_index,
                           rotate_s=args.rotate_s)
    t0 = time.perf_counter()
    with src, rec:
        n = record(src, rec, seconds=args.seconds)
    wall = time.perf_counter() - t0
    sig_s = n * args.block_samples / args.fs
    print(f"recorded {n} blocks ({sig_s:.1f} s of signal, "
          f"{n * args.block_samples * 4 / 1e6:.1f} MB) into "
          f"{len(rec.files)} file(s) in {wall:.1f} s")
    for p in rec.files:
        print(f"  {p}")
    behind = getattr(src, "behind_max_s", None)
    if behind is not None:
        print(f"recorder fell behind the radio at most {behind * 1e3:.2f} ms")


def cmd_console(args):
    from .console import Console
    Console(device=args.device).cmdloop()


def cmd_bench(args):
    raise SystemExit("bench: the port's benchmark is not written yet: "
                     "ROADMAP Queue 1 item 6 (the port bench, bench_torch.py); "
                     "bench.py times the JAX package")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="navlab_dpe_sdr_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device: cuda (default; raises without a card) "
                        "or cpu. There is no --cpu-devices: the JAX CLI's "
                        "virtual CPU devices are its --mesh test bed; the "
                        "port's mesh runs one process per rank (torchrun)")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("synth", help="generate synthetic capture + handoff")
    ps.add_argument("--out", required=True)
    ps.add_argument("--handoff")
    ps.add_argument("--seconds", type=float, default=10.0)
    ps.add_argument("--fs", type=float, default=2.5e6)
    ps.add_argument("--sats", type=int, default=8)
    ps.add_argument("--cn0", type=float, default=47.0)
    ps.add_argument("--seed", type=int, default=7)
    ps.set_defaults(fn=cmd_synth)

    pa = sub.add_parser("acquire", help="acquisition report")
    pa.add_argument("file")
    pa.add_argument("--fs", type=float, default=2.5e6)
    pa.add_argument("--ds", type=float, default=1.0)
    pa.add_argument("--skip", type=float, default=0.0, help="seconds to skip")
    pa.add_argument("--prns", help="comma list; default 1-32")
    pa.add_argument("--noncoherent", action="store_true")
    pa.add_argument("--deep-ms", type=int, default=0, metavar="MS",
                    help="deep (weak-signal) acquisition over MS of "
                         "capture: coherent folds of --coh-ms summed "
                         "noncoherently (ops/acquisition.acquire_deep)")
    pa.add_argument("--coh-ms", type=int, default=10,
                    help="coherent fold length for --deep-ms [ms]")
    pa.add_argument("--engine", choices=["auto", "fft", "real"],
                    default="auto",
                    help="auto = fft (torch.fft); real, the JAX package's "
                         "all-real TPU search, is not ported and raises")
    pa.set_defaults(fn=cmd_acquire)

    pt = sub.add_parser("track", help="scalar pipeline -> handoff")
    pt.add_argument("file")
    pt.add_argument("--fs", type=float, default=2.5e6)
    pt.add_argument("--ds", type=float, default=1.0)
    pt.add_argument("--skip", type=float, default=0.0)
    pt.add_argument("--prns", required=True)
    pt.add_argument("--seconds", type=float, default=36.0)
    pt.add_argument("--rinex", help="RINEX nav fallback for undecoded PRNs")
    pt.add_argument("--handoff", help="write handoff CSV here")
    pt.add_argument("--checkpoint", help="write receiver checkpoint dir")
    pt.add_argument("--loop-order", type=int, choices=[2, 3], default=2,
                    help="loop-filter order (critically damped)")
    pt.add_argument("--bn-code", type=float, default=3.0,
                    help="code-loop noise bandwidth [Hz]")
    pt.add_argument("--bn-carr", type=float, default=None,
                    help="carrier-loop noise bandwidth [Hz] (default 40, "
                         "or 48/coh_ms in coherent mode)")
    pt.add_argument("--bn-carr-freq", type=float, default=None,
                    help="FLL-assist bandwidth [Hz] (default 0, or "
                         "12/coh_ms in coherent mode)")
    pt.add_argument("--batch-k", type=int, default=1,
                    help="fuse k consecutive 1 ms windows into one device "
                         "correlation pass (predictor-corrector; NCO lags "
                         "the loops by <= k ms; 1 ms cadence only)")
    pt.add_argument("--coh-ms", type=int, default=1,
                    help="coherent predetection integration per loop "
                         "update [ms] (1..10): >1 trades loop update "
                         "rate for ~3 dB discriminator SNR per doubling "
                         "(weak-signal tracking)")
    pt.set_defaults(fn=cmd_track)

    grids = ["spread", "uniform", "arthur", "dense", "exponential"]
    pd = sub.add_parser("dpe", help="DPE block loop from a handoff")
    pd.add_argument("file")
    pd.add_argument("--handoff", required=True)
    pd.add_argument("--rinex", help="take ephemerides from RINEX")
    pd.add_argument("--fs", type=float, default=2.5e6)
    pd.add_argument("--ds", type=float, default=1.0)
    pd.add_argument("--blocks", type=int, default=1500)
    pd.add_argument("--grid", default="spread", choices=grids,
                    help="dense = reference-cap 75^4+75^4 uniform grid "
                         "(63.3M points, BCM_MAX_GRID_SIZE); tune with "
                         "--grid-n/--grid-spacing")
    pd.add_argument("--grid-n", type=int, metavar="N",
                    help="points per axis for uniform/arthur/dense (N^4 "
                         "per manifold, capped at 2*75^4 total)")
    pd.add_argument("--grid-spacing", type=float, metavar="M",
                    help="position grid spacing [m]")
    pd.add_argument("--grid-vel-spacing", type=float, metavar="MPS",
                    help="velocity grid spacing [m/s]")
    pd.add_argument("--grid-csv", help="custom ENU grid CSV (rngrid3-style)")
    pd.add_argument("--out", help="nav CSV output")
    pd.add_argument("--weekno", type=int, default=2008)
    pd.add_argument("--batched", action="store_true",
                    help="high-throughput batched mode")
    pd.add_argument("--mesh", metavar="SPEC",
                    help="mesh of ranks, e.g. 'grid=8' or 'chan=2,grid=4' "
                         "(axes multiply to the world size; one process "
                         "per rank, started by torchrun); shards manifold "
                         "scoring over grid points and correlation over "
                         "channels")
    pd.add_argument("--integrate", type=int, metavar="K",
                    help="integrated mode: one fix per K blocks with "
                         "on-device score accumulation (lower noise)")
    pd.add_argument("--coherent", action="store_true",
                    help="with --integrate: sum complex correlations "
                         "(data-aided nav-bit alignment) — equal accuracy, "
                         "one manifold scoring per fix instead of per "
                         "block (K x cheaper; enables dense-grid "
                         "integration in real time)")
    pd.add_argument("--lookahead", type=int, default=25)
    pd.add_argument("--group-k", type=int, default=1, metavar="K",
                    help="with --batched: coherent-group K consecutive "
                         "blocks on device before manifold scoring (one "
                         "fix per K blocks at ~1/K scoring cost; K must "
                         "divide --lookahead)")
    pd.add_argument("--pipeline-depth", type=int, default=0, metavar="N",
                    help="with --batched: keep N dispatched batches in "
                         "flight (0 = drain each batch before the next — "
                         "the accuracy reference; 2 hides the per-batch "
                         "upload+fetch round-trip behind device compute "
                         "at N batches of prediction staleness)")
    pd.add_argument("--watchdog", type=float, default=1.5)
    pd.add_argument("--verbose", action="store_true")
    pd.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="DPEConfig overrides (setparam-style)")
    pd.add_argument("--config", help="JSON file of DPEConfig fields")
    pd.add_argument("--save-handoff", metavar="OUT.csv",
                    help="write a resume checkpoint (handoff contract) "
                         "after the run")
    pd.add_argument("--rts-out", metavar="OUT.csv",
                    help="post-processing: RTS-smoothed fixes over the "
                         "whole pass (needs ekf_mode=full)")
    pd.add_argument("--profile-dir",
                    help="write a torch.profiler Chrome trace (CPU and CUDA "
                         "activities) of the run into this directory")
    pd.add_argument("--native-io", action="store_true",
                    help="use the native C++ sample streamer + async logger")
    pd.add_argument("--xecef-log",
                    help="async X_ECEF CSV (XECEFLogger equivalent), with "
                         "--native-io")
    pd.add_argument("--log", action="append", metavar="PORT=PATH[:bin]",
                    help="attach an async logger to any receiver port "
                         "(rc/fi/fc/cp/x/fix/...); ':bin' writes raw f64 "
                         "instead of CSV (per-block modes)")
    pd.set_defaults(fn=cmd_dpe)

    pu = sub.add_parser("survey",
                        help="multi-epoch joint DPE: one static state "
                             "estimated against the whole pass")
    pu.add_argument("file")
    pu.add_argument("--handoff", required=True)
    pu.add_argument("--rinex", help="take ephemerides from RINEX")
    pu.add_argument("--fs", type=float, default=2.5e6)
    pu.add_argument("--ds", type=float, default=1.0)
    pu.add_argument("--blocks", type=int, default=1500,
                    help="total 20 ms blocks to survey over")
    pu.add_argument("--batch", type=int, default=50,
                    help="blocks coherently integrated per epoch")
    pu.add_argument("--grid", default="spread", choices=grids,
                    help="coarse-pass grid (zoom lattices refine it)")
    pu.add_argument("--fine-spacing", type=float, default=0.25,
                    help="final zoom lattice spacing [m]")
    pu.add_argument("--fine-n", type=int, default=33,
                    help="zoom lattice points per axis (N^4)")
    pu.add_argument("--vel-fine-spacing", type=float, default=0.02,
                    help="velocity zoom lattice spacing [m/s]")
    pu.add_argument("--zoom-interp", choices=["quadratic", "linear", "sinc"],
                    help="zoom-pass interpolant; sinc = exact bandlimited "
                         "reconstruction (removes the 3-tap vertex bias "
                         "from the clock estimate)")
    pu.add_argument("--mesh", metavar="SPEC",
                    help="mesh of ranks, e.g. 'grid=8' (one process per "
                         "rank, started by torchrun)")
    pu.add_argument("--out", help="per-batch fix CSV")
    pu.add_argument("--json", help="survey result JSON")
    pu.add_argument("--weekno", type=int, default=2008)
    pu.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="DPEConfig overrides (setparam-style)")
    pu.add_argument("--config", help="JSON file of DPEConfig fields")
    pu.set_defaults(fn=cmd_survey)

    pv = sub.add_parser("vt", help="vector tracking from scalar pull-in")
    pv.add_argument("file")
    pv.add_argument("--fs", type=float, default=2.5e6)
    pv.add_argument("--ds", type=float, default=1.0)
    pv.add_argument("--skip", type=float, default=0.0)
    pv.add_argument("--prns", required=True)
    pv.add_argument("--pullin", type=float, default=1.0,
                    help="seconds of scalar tracking before VT")
    pv.add_argument("--rinex", help="ephemerides from RINEX instead of decode")
    pv.add_argument("--epochs", type=int, default=100)
    pv.set_defaults(fn=cmd_vt)

    pf = sub.add_parser("fleet", help="multi-receiver parallel processing")
    pf.add_argument("files", nargs="+")
    pf.add_argument("--fs", type=float, default=2.5e6)
    pf.add_argument("--prns", required=True)
    pf.add_argument("--seconds", type=float, default=36.0)
    pf.add_argument("--rinex", help="ephemeris fallback for undecoded PRNs")
    pf.add_argument("--dpe-blocks", type=int, default=0)
    pf.add_argument("--out-dir", default="fleet_out")
    pf.add_argument("--live", action="store_true",
                    help="drive the files as wall-clock-paced simulated "
                         "radios on one shared clock (MultiSource) "
                         "instead of offline captures")
    pf.add_argument("--offsets-ms", default=None,
                    help="per-radio receiver-clock offsets [ms] for "
                         "--live with ONE file (same scene, N radios), "
                         "e.g. 0,7")
    pf.add_argument("--stats-out", default=None,
                    help="write live delivery/agreement stats JSON here")
    pf.add_argument("--live-lookahead", type=int, default=25,
                    help="blocks per DPE dispatch in --live mode (per-"
                         "block dispatches cost a launch round-trip each)")
    pf.set_defaults(fn=cmd_fleet)

    pm = sub.add_parser("mc", help="Monte-Carlo perturbation / grid sweeps")
    pm.add_argument("file")
    pm.add_argument("--handoff", required=True)
    pm.add_argument("--truth", help="handoff CSV holding the true state "
                                    "(default: --handoff's state)")
    pm.add_argument("--fs", type=float, default=2.5e6)
    pm.add_argument("--runs", type=int, default=100)
    pm.add_argument("--blocks", type=int, default=50)
    pm.add_argument("--bottom", type=float, default=50.0,
                    help="min |shift| per axis [m] (reference shiftBottom)")
    pm.add_argument("--span", type=float, default=30.0,
                    help="band width above --bottom [m] (shiftRange)")
    pm.add_argument("--time-band", metavar="LO,HI",
                    help="also perturb clock bias, |dt| in [LO,HI] m")
    pm.add_argument("--grid", help="grid preset for perturbation runs "
                                   "(default spread)")
    pm.add_argument("--spacings", metavar="S1,S2,...",
                    help="grid-spacing sweep mode [m] (GridDimSpacing)")
    pm.add_argument("--grid-n", type=int, default=25,
                    help="uniform-grid axis points for --spacings")
    pm.add_argument("--grid-style", default="uniform",
                    choices=["uniform", "exponential", "arthur"],
                    help="axis style for the --spacings sweep")
    pm.add_argument("--converge-m", type=float, default=20.0)
    pm.add_argument("--seed", type=int, default=0)
    pm.add_argument("--out-dir", help="write indexed XECEF logs + "
                                      "shifts.csv + summary.json here")
    pm.add_argument("--config", help="DPEConfig JSON overrides")
    pm.add_argument("--set", action="append", default=[],
                    metavar="K=V", help="DPEConfig field override")
    pm.set_defaults(fn=cmd_mc)

    px = sub.add_parser("sens", help="C/N0 sensitivity ladder (per-block "
                                     "vs integrated DPE hold)")
    px.add_argument("--levels", default="45,40,35,30,25",
                    help="comma-separated C/N0 levels [dB-Hz]")
    px.add_argument("--blocks", type=int, default=32,
                    help="blocks per level (20 ms each)")
    px.add_argument("--k", type=int, default=8,
                    help="blocks integrated per fix")
    px.add_argument("--hold-m", type=float, default=30.0,
                    help="hold threshold on the integrated median [m]")
    px.add_argument("--coherent", action="store_true",
                    help="also run coherent (bit-aligned) integration")
    px.add_argument("--survey", action="store_true",
                    help="weak-signal ladder: open-loop (coast) steering + "
                         "full-pass noncoherent joint survey estimate vs "
                         "closed-loop K-block integration")
    px.add_argument("--fine-spacing", type=float, default=1.0,
                    help="survey fine-lattice spacing [m] (--survey)")
    px.add_argument("--grid", help="grid preset (default spread)")
    px.add_argument("--seed", type=int, default=7)
    px.add_argument("--out", help="CSV output path")
    px.add_argument("--config")
    px.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    px.set_defaults(fn=cmd_sens)

    pc = sub.add_parser("console", help="interactive flow console")
    pc.set_defaults(fn=cmd_console)

    pl = sub.add_parser("live", help="live-paced real-time demo: serve the "
                        "capture over TCP at true fs wall-clock and hold "
                        "real time under the watchdog (RunLive)")
    pl.add_argument("file", help="capture file to pace")
    pl.add_argument("--handoff", required=True)
    pl.add_argument("--fs", type=float, default=2.5e6)
    pl.add_argument("--ds", type=float, default=1.0)
    pl.add_argument("--seconds", type=float, default=None,
                    help="stop after this much signal (default: full file)")
    pl.add_argument("--lookahead", type=int, default=25,
                    help="blocks per iteration (1 = per-block mode; "
                    "latency K*20 ms, budget K*20 ms)")
    pl.add_argument("--grid", default="spread", choices=grids)
    pl.add_argument("--grid-n", type=int, default=0)
    pl.add_argument("--watchdog", type=float, default=1.5)
    pl.add_argument("--set", action="append", default=[], metavar="K=V")
    pl.add_argument("--json", help="write the run record here")
    pl.add_argument("--source", default="tcp", choices=["tcp", "sim"],
                    help="tcp = paced TCP replay server; sim = in-process "
                    "simulated radio (io.frontend.SimulatedRadio)")
    pl.set_defaults(fn=cmd_live)

    pr = sub.add_parser("record", help="record a sample source to "
                        "timestamped rotating capture files (guhd capture "
                        "tool: YYYYMMDD_HHMMSS_usrpN_rateKHz.dat)")
    pr.add_argument("source", help="capture path | sim://path | "
                    "tcp://host:port | soapy://driver=...")
    pr.add_argument("--out-dir", required=True)
    pr.add_argument("--fs", type=float, default=2.5e6)
    pr.add_argument("--seconds", type=float, default=None,
                    help="stop after this much signal (default: full source)")
    pr.add_argument("--rotate-s", type=float, default=600.0,
                    help="seconds of signal per file (reference: 600)")
    pr.add_argument("--block-samples", type=int, default=50000)
    pr.add_argument("--usrp-index", type=int, default=0)
    pr.add_argument("--loop", action="store_true",
                    help="sim:// source loops its capture")
    pr.set_defaults(fn=cmd_record)

    pb = sub.add_parser("bench", help="the port's benchmark: not written "
                                      "yet (ROADMAP Queue 1 item 6); exits")
    pb.add_argument("--blocks", type=int, default=100)
    pb.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    # the one device of the run, resolved before any work: a missing card
    # raises here, whatever the subcommand
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    main()
