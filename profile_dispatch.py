#!/usr/bin/env python3
"""The port's batched main path (chip_smoke.py phase 5) and the device side
of one 50-block dispatch of each kind, read by one routine for any tree that
holds the port:

    python3 profile_dispatch.py [--tree DIR] [--label NAME]
    python3 profile_dispatch.py --walls SECONDS [--tree DIR] [--label NAME]
    python3 profile_dispatch.py --pairs N --parent DIR [--walls SECONDS]

--tree is the directory whose navlab_dpe_sdr_tpu_torch is imported (this
script's own by default), so two trees are set side by side by running this
one script on each, alternating (parent, change, change, parent), each in
a process of its own. On a 12 s capture of the seeded 8-PRN scenario it runs
DPEReceiver.run_batched as phase 5 does: 100 warm-up blocks, 200 blocks per
block and 200 in coherent groups of 5 (lookahead 50, pipeline depth 4, the
capture on the card), with the wall, real-time factor and fix errors of
each; then one more dispatch of each kind under torch.profiler
(`dispatch_record`): kernel launches, device-busy ms, its share of the
profiled wall, the device ms of K1 ("score_kernel") and K5 ("windowed_"),
and how many times the window was taken. The last line is a JSON object of
those numbers. Needs a CUDA card; imports nothing of JAX.

--walls SECONDS times, instead, each host-bound path over a window of at
least SECONDS of host time (`walls`): rounds of a fresh receiver, set up and
warmed outside the window, on the same capture. --pairs N runs this script
with --walls 2N times, each in a process of its own, on the --parent tree
and on this one in the order parent, change, change, parent, ... (N pairs),
and prints each path's rate on both sides with its median and range, and
whether the two ranges are apart ("resolved") or overlap ("unresolved", with
the spread that hides any difference smaller than it).

This is also the measurement module the other scripts share:
chip_smoke.py, windowed_times.py and track_window_terms.py read device
records (`device_profile`, `dispatch_record`, which retakes an empty window
through `profile_seeing`, and `kernel_device_ms`), time a call
(`cuda_ms`), read the kernels' clock64() splits (`clock_parts` for K4,
`k5_clock_split` for K5), build K5's inputs at the main path's shapes
(`k5_inputs`) and build a kernel source's variants (`patched`,
`build_variant`) from here.
"""

from __future__ import annotations

import argparse
import collections
import copy
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

FS = 2.5e6
S = 50000
T = 0.02                  # seconds per block
N_BLOCKS = 50             # blocks per dispatch (the lookahead)
K1_K5 = ("score_kernel", "windowed_")     # K1/K2's and K5's kernel names
# profiler windows taken ("windows"), and how many of them showed none of
# the kernels sought ("empty") or, for a kernel's own time, another count
# of its launches than the calls made ("miscounted"); either window is
# then taken again
TAKES = collections.Counter()


def device_profile(fn, lead_in: int = 0):
    """Run fn() under torch.profiler and synchronize; with lead_in > 0,
    lead_in calls first, each its own synchronized range, and only the last
    call counted: the profiler can lose the first device records of a window
    (a 50-block dispatch's first seven kernels, or all eight, on an H100
    with torch 2.11), and a lead-in call absorbs them. Returns (kernel
    launches, device-busy ms: kernels and copies summed, wall ms of the
    counted call, {kernel name: (ms, launches)}); launches 0 when the
    profiler showed no device activity in it."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(lead_in + 1):
            with record_function(f"profiled call {i}"):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
    # device records only: not the calls' own ranges, which the profiler
    # also draws on the device's timeline
    events = [e for e in prof.events()
              if not e.name.startswith("profiled call ")]
    cuda = torch.autograd.DeviceType.CUDA
    counted = [e for e in events if e.device_type == cuda]
    if lead_in:
        mark = [e.time_range for e in prof.events()
                if e.name == f"profiled call {lead_in}"
                and e.device_type != cuda][0]
        counted = [e for e in counted
                   if mark.start <= e.time_range.start <= mark.end]
    launches, busy, by_name = 0, 0.0, {}
    for e in counted:
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        seen = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (seen[0] + ms, seen[1] + 1)
        if "memcpy" not in e.name.lower() and "memset" not in e.name.lower():
            launches += 1
    return launches, busy, wall, by_name


def profile_seeing(fn, names):
    """device_profile(fn) after two lead-in calls, taken again (three times
    at most) while the counted call shows no kernel whose name holds one of
    `names`. Returns device_profile's four values and the number of times
    the window was taken (TAKES counts them all)."""
    for takes in range(1, 4):
        res = device_profile(fn, lead_in=2)
        TAKES["windows"] += 1
        if all(any(n in k for k in res[3]) for n in names):
            break
        TAKES["empty"] += 1
    return res + (takes,)


def dispatch_record(fn, kernels=K1_K5) -> dict:
    """The device side of one fn() (profile_seeing): kernel launches,
    device-busy ms, the profiled wall and the busy share of it, each
    kernel name's ms and launches, and the times the window was taken;
    launches 0 when the profiler showed no device activity."""
    launches, busy, wall, by_name, takes = profile_seeing(fn, kernels)
    own = {k: [sum(v[0] for n, v in by_name.items() if k in n),
               sum(v[1] for n, v in by_name.items() if k in n)]
           for k in kernels}
    return dict(launches=launches, busy_ms=busy, wall_ms=wall,
                share=busy / wall, kernels=own, takes=takes)


def record_line(what: str, rec: dict, card: str) -> str:
    """One log line of a dispatch_record."""
    if rec["launches"] == 0:
        return (f"device side of {what}: not measured (the profiler showed "
                f"no device activity)")
    return (f"device side of {what} (one run under torch.profiler after two "
            f"lead-in runs, outside the timed segments; window taken "
            f"{rec['takes']} time(s)): {rec['launches']} kernel launches, "
            f"device busy {rec['busy_ms']:.3f} ms of {rec['wall_ms']:.3f} ms "
            f"of profiled wall (share {rec['share']:.3f}), of which "
            + ", ".join(f"{k} {ms:.4f} ms in {n} launch(es) "
                        f"({ms / rec['busy_ms']:.3f} of device busy)"
                        for k, (ms, n) in rec["kernels"].items())
            + f" [{card}]")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls after
    one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_device_ms(fn, reps: int, name: str):
    """The device's own ms per launch of the kernels whose name holds
    `name`, from torch.profiler over `reps` calls of fn, each launching it
    once. The `reps` calls are the last of three such runs in one profiler
    window (device_profile's lead-in: the profiler can lose a window's
    first device records). A reading is taken only from a window that
    recorded `reps` launches of it in the counted run, or reps - 1; a
    window that recorded another count (none, or too few: a misread at a
    fraction of the time) is taken again, three times at most, and counted
    in TAKES ("empty", "miscounted"). None when no window counted right."""
    fn()

    def loop():
        for _ in range(reps):
            fn()

    for _ in range(3):
        found = [v for k, v in device_profile(loop, lead_in=2)[3].items()
                 if name in k]
        count = sum(n for _, n in found)
        TAKES["windows"] += 1
        if count and count in (reps, reps - 1):
            return sum(ms for ms, _ in found) / count
        TAKES["empty" if count == 0 else "miscounted"] += 1
    return None


def clock_parts(kernel, n_upd: int, n_chan: int, dev, logf):
    """More launches of K4's kernel(clocks) with the kernel's clock buffer
    (whose logs must equal logf, the path's, unless logf is None): (clocked
    ms a launch, the clock in MHz, us per update of each of
    track.CLOCK_NAMES, mean over channels)."""
    from navlab_dpe_sdr_tpu_torch.ops import track

    clocks = torch.zeros((n_chan, track.N_CLOCKS), dtype=torch.int64,
                         device=dev)
    _, lfc, _ = kernel(clocks)           # warms this instantiation
    assert logf is None or torch.equal(lfc, logf), \
        "the clocked kernel logs differently"
    clocked_ms = cuda_ms(lambda: kernel(clocks), 3)
    clk = clocks.cpu().numpy().astype(np.float64).mean(axis=0)
    us = clk / clk[-1] * clocked_ms * 1e3 / n_upd
    return clocked_ms, clk[-1] / clocked_ms / 1e3, us


def k5_clock_split(correlate, a, kw) -> dict:
    """K5's {phase: thousands of SM clocks, mean over blocks and ranks}
    (correlate.CLOCK_NAMES) of one launch with its clock buffer, whose
    windows must equal an unclocked launch's, and the slowest block's whole
    ("whole max")."""
    want = correlate.windowed_correlate_cuda(*a, **kw)
    c = a[2].shape[0]
    clocks = torch.zeros((a[0].shape[0], c, correlate.windowed_cluster(),
                          len(correlate.CLOCK_NAMES)), dtype=torch.int64,
                         device=a[0].device)
    got = correlate.windowed_correlate_cuda(*a, **kw, clocks=clocks)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    k = clocks.reshape(-1, clocks.shape[-1]).double().cpu().numpy() / 1e3
    out = dict(zip(correlate.CLOCK_NAMES, k.mean(axis=0).round(3).tolist()))
    out["whole max"] = round(float(k[:, -1].max()), 3)
    return out


def k5_inputs(first, hand, arr, grid, dev):
    """K5 at the main path's shapes: the first N_BLOCKS blocks of `first`
    (int16 I/Q) with the parameters the batched receiver prepares for them
    (windows of auto_windows). Returns (args, kw, n_chan): args(lo, hi,
    cs=slice(None), dtype="int16") gives the correlator's arguments for
    blocks lo..hi-1 and channels cs as batch_correlate passes them (views
    all), from the int16 capture or from float32 samples (the capture times
    0.3); kw its keywords."""
    from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import (DPEConfig, DPEReceiver,
                                                     device_state)
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real

    rx = DPEReceiver(SampleFile(samples=first, fs=FS), copy.deepcopy(hand),
                     grid=grid, eph=copy.deepcopy(arr),
                     config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                     device="cpu")
    preps = rx._prepare_batch(N_BLOCKS)
    pk = dpe_real.pack_params(np.stack([p[0] for p in preps]),
                              np.stack([p[1] for p in preps]), 0)
    d = device_state(grid, rx._dev.chips.numpy(), S, FS, dev)
    cap = torch.from_numpy(first[:S * N_BLOCKS].view(np.int16)
                           .reshape(N_BLOCKS, S, 2)).to(dev)
    fpk, ipk = dpe_real.unpack_params(dpe_real.to_device(pk, dev))
    kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
              n_periods=S // rx.period, code_win=rx.code_win,
              carr_win=rx.carr_win)
    samples = {"int16": cap, "float32": cap.float() * 0.3}

    def args(lo, hi, cs=slice(None), dtype="int16"):
        raw = samples[dtype][lo:hi]
        f, i = fpk[lo:hi, :, cs], ipk[lo:hi, :, cs]
        return (raw[..., 0], raw[..., 1], d.chips[cs], f[:, 0], i[:, 0],
                f[:, 1], f[:, 2], d.time_idc, i[:, 1], i[:, 2])

    return args, kw, len(rx.prn_list)


def patched(source: str, patches) -> str:
    """source with each (old, new) of patches applied in order; each old
    text must occur once."""
    for old, new in patches:
        if source.count(old) != 1:
            raise ValueError(f"patch text found {source.count(old)} times: "
                             f"{old!r}")
        source = source.replace(old, new)
    return source


def build_variant(text: str, source: str, name: str) -> pathlib.Path:
    """A variant `text` of the package's csrc/<source>.cu, built by nvcc
    with the package's flags -> <build dir>/variants/lib<source>_<hash>.so
    (`name` only labels an error)."""
    from navlab_dpe_sdr_tpu_torch.ops import _build

    out_dir = _build.build_dir() / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    src = out_dir / f"{source}_{digest}.cu"
    lib = out_dir / f"lib{source}_{digest}.so"
    if not lib.exists():
        src.write_text(text)
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                              str(lib), str(src)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n"
                               f"{res.stderr}")
    return lib


def main_path(first, hand, arr, grid, dev, card, log=print) -> dict:
    """Phase 5 on `first` (>= 600 blocks of int16 I/Q): the warm-up, the
    two timed segments and the device record of one more dispatch of each
    kind. Returns {"segments": {name: {...}}, "dispatch": {name: {...}},
    "fixes": [300, 8] of the warm-up and the segments, "counts": the launch
    counts of the timed segments}."""
    from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
    from navlab_dpe_sdr_tpu_torch.ops import _build

    rx = DPEReceiver(SampleFile(samples=first, fs=FS), copy.deepcopy(hand),
                     grid=grid, eph=copy.deepcopy(arr),
                     config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                     device=dev)
    raw_dev = torch.from_numpy(first.view(np.int16).reshape(-1, S, 2)
                               ).to(dev)
    run = dict(lookahead=N_BLOCKS, raw_blocks_dev=raw_dev, pipeline=True,
               pipeline_depth=4)
    t0 = time.perf_counter()
    rx.run_batched(50, start_block=0, **run)
    rx.run_batched(50, start_block=50, group_k=5, **run)
    torch.cuda.synchronize()
    log(f"warm-up: 100 blocks in {time.perf_counter() - t0:.2f} s")

    out = dict(segments={}, dispatch={})
    _build.reset_launch_counts()
    for name, start, group_k in (("per-block", 100, 1),
                                 ("grouped K=5", 300, 5)):
        before = _build.launch_counts()
        n_fix0 = len(rx.fixes)
        t0 = time.perf_counter()
        rx.run_batched(200, start_block=start, group_k=group_k, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = _build.launch_counts()
        k1 = after["score_argmax"] - before["score_argmax"]
        k5 = (after.get("windowed_correlate", 0)
              - before.get("windowed_correlate", 0))
        err = np.array([np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3])
                        for f in rx.fixes[n_fix0:]])
        seg = dict(fixes=len(err), k1=k1, k5=k5, wall_s=wall,
                   rtf=200 * T / wall, median_m=float(np.median(err)),
                   p95_m=float(np.percentile(err, 95)),
                   finite=bool(np.isfinite(err).all()))
        out["segments"][name] = seg
        log(f"main path {name}: 200 blocks, K1 {k1} and K5 {k5} launches "
            f"({200 // N_BLOCKS} dispatches), {seg['fixes']} fixes, error "
            f"median {seg['median_m']:.2f} m p95 {seg['p95_m']:.2f} m, wall "
            f"{wall:.3f} s, {seg['rtf']:.2f}x real time [{card}]")
    out["counts"] = _build.launch_counts()
    total = sum(s["wall_s"] for s in out["segments"].values())
    log(f"main path: 400 blocks in {total:.3f} s, {400 * T / total:.2f}x "
        f"real time [{card}]")
    out["fixes"] = np.stack([f.x_ecef for f in rx.fixes])
    names = tuple(k for k in K1_K5
                  if k != "windowed_" or out["counts"].get(
                      "windowed_correlate", 0))
    for name, start, group_k in (("per-block", 500, 1),
                                 ("grouped K=5", 550, 5)):
        rec = dispatch_record(
            lambda: rx.run_batched(50, start_block=start, group_k=group_k,
                                   **run), names)
        out["dispatch"][name] = rec
        log(record_line(f"one 50-block dispatch, {name}", rec, card))
    return out


def walls(samples, hand, arr, grid, dev, card, seconds: float,
          log=print) -> dict:
    """Each host-bound path's wall over a window of at least `seconds` of
    host time, in rounds: a fresh receiver is made and warmed outside the
    window, then the timed run (synchronized at both ends) goes into it.
    per-block and grouped K=5: run_batched over blocks 50 .. end after 50
    warm ones (lookahead 50, pipeline depth 4, the capture on the card);
    integrated: run_integrated noncoherent, 8 blocks a fix, after one warm
    fix; vector: VectorReceiver, 500 epochs after 50 warm ones. Returns
    {path: dict(rate, unit, window_s, rounds, round_min, round_max)}: the
    real-time factor (s of signal a s of wall) or epochs a second over the
    whole window, and the slowest and fastest round's."""
    from navlab_dpe_sdr_tpu_torch.io.rawfile import SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
    from navlab_dpe_sdr_tpu_torch.models.vector import VectorReceiver

    raw_dev = torch.from_numpy(samples.view(np.int16).reshape(-1, S, 2)
                               ).to(dev)
    n_all = raw_dev.shape[0]
    run = dict(lookahead=N_BLOCKS, raw_blocks_dev=raw_dev, pipeline=True,
               pipeline_depth=4)

    def dpe():
        return DPEReceiver(SampleFile(samples=samples, fs=FS),
                           copy.deepcopy(hand), grid=grid,
                           eph=copy.deepcopy(arr),
                           config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                           device=dev)

    def batched(group_k):
        def make():
            rx = dpe()
            rx.run_batched(N_BLOCKS, start_block=0, group_k=group_k, **run)
            return rx

        def go(rx):
            n = (n_all - N_BLOCKS) // N_BLOCKS * N_BLOCKS
            rx.run_batched(n, start_block=N_BLOCKS, group_k=group_k, **run)
            return n * T
        return make, go

    def integrated():
        def make():
            rx = dpe()
            rx.run_integrated(1, 8, raw_blocks_dev=raw_dev)
            return rx

        def go(rx):
            n_fix = (n_all - 8) // 8
            rx.run_integrated(n_fix, 8, raw_blocks_dev=raw_dev, start_block=8)
            return n_fix * 8 * T
        return make, go

    def vector():
        def make():
            vt = VectorReceiver(SampleFile(samples=samples, fs=FS),
                                hand.prn_list, copy.deepcopy(arr),
                                hand.x_ecef, hand.rx_time, cp=hand.cp,
                                rc=hand.rc, fc=hand.fc, fi=hand.fi,
                                ri=hand.ri, device=dev)
            vt.run(50)
            return vt

        def go(vt):
            vt.run(500)
            return 500
        return make, go

    out = {}
    for path, unit, (make, go) in (
            ("per-block", "x real time", batched(1)),
            ("grouped K=5", "x real time", batched(5)),
            ("integrated", "x real time", integrated()),
            ("vector", "epochs/s", vector())):
        window = amount = 0.0
        rates = []
        while window < seconds:
            obj = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = go(obj)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            window += dt
            amount += got
            rates.append(got / dt)
            del obj
        out[path] = dict(rate=amount / window, unit=unit, window_s=window,
                         rounds=len(rates), round_min=min(rates),
                         round_max=max(rates))
        log(f"wall, {path}: {out[path]['rate']:.2f} {unit} over "
            f"{window:.3f} s of host time in {len(rates)} rounds (a round "
            f"{min(rates):.2f} to {max(rates):.2f}) [{card}]")
    return out


def pairs(n_pairs: int, parent: str, seconds: float) -> dict:
    """--pairs: this script with --walls on the parent tree and on this one,
    alternating (parent, change, change, parent, ...), a process each.
    Returns {path: dict(parent=[rates], change=[rates], unit, verdict)}."""
    here = pathlib.Path(__file__).resolve()
    order = [("parent", "change"), ("change", "parent")]
    trees = dict(parent=str(pathlib.Path(parent).resolve()),
                 change=str(here.parent))
    runs = dict(parent=[], change=[])
    for i in range(n_pairs):
        for side in order[i % 2]:
            res = subprocess.run(
                [sys.executable, str(here), "--tree", trees[side], "--label",
                 side, "--walls", str(seconds)], capture_output=True,
                text=True)
            print(res.stdout.rstrip(), flush=True)
            if res.returncode != 0:
                raise RuntimeError(f"--walls on {side} failed:\n{res.stderr}")
            runs[side].append(json.loads(res.stdout.strip().splitlines()[-1])
                              ["walls"])
    out = {}
    card = card_line()
    for path in runs["change"][0]:
        a = [r[path]["rate"] for r in runs["parent"]]
        b = [r[path]["rate"] for r in runs["change"]]
        med_a, med_b = float(np.median(a)), float(np.median(b))
        apart = min(b) > max(a) or max(b) < min(a)
        spread = 100.0 * (max(a + b) - min(a + b)) / med_a
        verdict = (f"resolved: the change {100.0 * (med_b / med_a - 1):+.1f} %"
                   if apart else f"unresolved: the ranges overlap, spread "
                   f"{spread:.1f} % of the parent's median")
        out[path] = dict(parent=a, change=b, unit=runs["change"][0][path]
                         ["unit"], verdict=verdict)
        print(f"pairs, {path} ({out[path]['unit']}): parent median "
              f"{med_a:.2f} ({min(a):.2f} to {max(a):.2f}), change median "
              f"{med_b:.2f} ({min(b):.2f} to {max(b):.2f}), {n_pairs} "
              f"pairs; {verdict} [{card}]", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(pathlib.Path(__file__).parent),
                    help="directory holding the navlab_dpe_sdr_tpu_torch "
                         "to measure")
    ap.add_argument("--label", default="", help="name printed in the JSON")
    ap.add_argument("--walls", type=float, default=0.0,
                    help="time each host-bound path over this many seconds")
    ap.add_argument("--pairs", type=int, default=0,
                    help="alternate --walls on --parent and this tree")
    ap.add_argument("--parent", help="the tree set against this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_dispatch: no CUDA device", file=sys.stderr)
        return 2
    if args.pairs:
        if not args.parent:
            ap.error("--pairs needs --parent")
        res = pairs(args.pairs, args.parent, args.walls or 3.0)
        print(json.dumps(dict(pairs=res)), flush=True)
        return 0
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16
    from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
    from navlab_dpe_sdr_tpu_torch.models.grid import spread_grid
    import navlab_dpe_sdr_tpu_torch as pkg
    assert pathlib.Path(pkg.__file__).resolve().is_relative_to(tree), \
        pkg.__file__

    card = card_line()
    print(f"{card}; the port of {tree}", flush=True)
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n = 600 * S                                   # 12 s
    samples = np.empty(n, DTYPE_IQ16)
    for s0 in range(0, n, int(FS)):
        iq = sim.generate(min(int(FS), n - s0), start_sample=s0)
        samples["i"][s0:s0 + len(iq)] = np.clip(np.round(iq.real), -32768,
                                               32767)
        samples["q"][s0:s0 + len(iq)] = np.clip(np.round(iq.imag), -32768,
                                               32767)
    if args.walls:
        res = walls(samples, hand, arr, spread_grid(), torch.device("cuda"),
                    card, args.walls, log=lambda m: print(m, flush=True))
        print(json.dumps(dict(label=args.label, tree=str(tree), card=card,
                              walls=res)), flush=True)
        return 0
    res = main_path(samples, hand, arr, spread_grid(),
                    torch.device("cuda"), card,
                    log=lambda m: print(m, flush=True))
    print(json.dumps(dict(label=args.label, tree=str(tree), card=card,
                          segments=res["segments"],
                          dispatch=res["dispatch"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
