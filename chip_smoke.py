#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (navlab_dpe_sdr_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

Phases, one line or more each (any failure raises and exits non-zero):
1. the card: nvidia-smi name and power limit;
2. build the port's CUDA kernels from ops/csrc, both sources at once, and
   time each build;
3. K1 (score_argmax) against its plain PyTorch version on the card at the
   batched path's shapes (N=50 blocks, C=8 channels, the spread grid's
   390 625 points per manifold, code/carrier windows of the receiver),
   every case of manifold x l_power x interp x weighted, with both times
   (CUDA events around the wrapper, and the kernel's own time from
   torch.profiler), and the grouped path's N=10;
4. one fused dispatch on the card against the same dispatch on the CPU;
5. the batched main path: DPEReceiver.run_batched on the first 10 s of a
   40 s synthetic capture held on the card as int16 [B, S, 2]: 100 warm-up
   blocks, 200 blocks per block (lookahead 50, pipeline depth 4), 200 blocks
   in coherent groups of 5; K1 launch counts, fix errors against truth,
   wall time and real-time factor; then, outside the timed segments, one
   more dispatch of each kind under torch.profiler: kernel launches,
   device-busy ms and its share of the wall, K1's device ms;
6. K3 (correlate_window) against its plain version: seeded state and raw,
   C=8, S=2500 (one bulk copy per window), and S=2501 (a window that is no
   multiple of 16 bytes: the kernel's 4-byte copies);
7. K4 (track_chunk) against its plain version on one 2000 ms chunk of the
   capture from the acquisition result: cp/ncp/lock equal, signs equal
   after step 5, rc within 1e-3 chips, fi within 0.1 Hz, prompt sums within
   1e-3 of each channel's peak; ms per chunk and real-time factor; and one
   extra launch with the kernel's clock buffer: where a step's time goes;
8. K2 (score_surface_argmax) against its plain version: N=1, G=390 625,
   both manifolds x quadratic/linear x l_power 1/2, the surface within
   rtol 1e-6, the kernel's (max, first index) equal to the plain surface's;
9. the cold-start path on the card, twice (the second timed: cold receiver
   state, warm kernels): ScalarReceiver acquire -> track 30 s, then 2 s at
   a time to 8/8 ephemerides (checked against the scenario's) -> scalar
   PVT -> save_handoff -> DPEReceiver.run(1), then 50 more per-block steps;
   K2/K3/K4 launch counts, errors, TTFF wall, tracking real-time factor;
   then one more per-block step under torch.profiler (launches, device-busy
   ms, K2's device ms);
10. (run right after phase 3, before the capture is made) K1's
   block-summed mode (score_argmax(block_sum=True): the scores of all
   blocks summed per grid point inside the kernel) against its plain
   version: bit-equal best, equal first index, weighted sums bitwise equal
   across two runs, on the spread grid at N=8 and N=50, on the dense grid
   (2 x 75^4 points, the reference's cap) at N=16 with l_power 1 and 2 and
   at N=1 (the coherent run's launch: its blocks are summed before the
   scorer), and on a grid laid out twice (an exact tie across tiles); sinc
   interpolation at the survey's zoom shape (33^4 points, 25 epochs) within
   rtol 1e-5, argmax equal or a tie within 1e-6;
11. integrated DPE: run_integrated noncoherent on the spread grid (8 blocks
   a fix, 25 fixes), coherent on the dense grid (16 blocks a fix, 12
   fixes), and the first again read from the SampleFile through the
   read-ahead thread (fixes identical); launches, errors, wall, real-time
   factor, and the device side of one profiled fix;
12. the survey: run_survey over 25 s (25 batches of 50 blocks), coherent,
   default fine lattice, a warm-up run, then one timed run and one with
   sinc zoom passes (their launches are the ones counted); errors against
   truth; the wall split (pass, coarse, zoom) from one more run of each,
   synchronized after every stage;
13. run_batched with refine="newton" and ekf_mode="full": 200 blocks, the
   rows carrying the score windows;
14. K4's coherent mode against its plain version from the acquisition
   state (K4's limits of phase 7), 8 channels: m = 2, 8, 10 code periods a
   window over 200 updates, m = 4 on the coherent cold start's 2000 ms chunk
   (500 updates);
15. K4's batch_k = 4 schedule against its plain version on one 2000 ms
   chunk, then ScalarReceiver.track(2000, batch_k=4) from the acquisition
   state;
16. K3's windows mode (the open-loop correlation of vector tracking)
   against its plain version: 20 windows x 8 channels, bit-equal;
17. the coherent cold start: acquire -> track(36 000, coh_ms=4) with the
   CLI's coherent loop defaults -> 8/8 ephemerides -> scalar PVT within
   15 m; TTFF wall and tracking real-time factor per chunk;
18. the weak start: 2 s of the scenario at 27 dB-Hz, deep acquisition
   (deep_ms=400, n_coh_ms=10) and track(2000, coh_ms=8), held to the JAX
   package's run of the same sequence on the CPU
   (tools/weak_start_reference.json, written by
   tools/weak_start_reference.py);
19. VectorReceiver for 50 epochs from the truth handoff and from
   from_scalar after phase 9's cold start: median error under 20 m,
   epochs per second, one K3 windows-mode launch an epoch.
Each path is driven with the launch counts set to 0 just before it and
read just after.
The line before the last is the kernels' JSON record (launches on the
timed paths, error against the plain version, ms, plain ms, the roofline
bound of the same work and what sets it, library_ms: null where no single
PyTorch call computes the function, device_ms: the kernel's own time from
torch.profiler, null if the profiler showed none); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import copy
import hashlib
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from navlab_dpe_sdr_tpu_torch.constants import F_CA, F_L1
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.io.synth import release_workspace
from navlab_dpe_sdr_tpu_torch.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu_torch.libgnss import frames
from navlab_dpe_sdr_tpu_torch.models.grid import (_mesh4, dense_grid,
                                                  spread_grid)
from navlab_dpe_sdr_tpu_torch.models.dpe import (DPEConfig, DPEReceiver,
                                                 device_state)
from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
from navlab_dpe_sdr_tpu_torch.models.vector import VectorReceiver
from navlab_dpe_sdr_tpu_torch.ops import _build, score, track, tracking
from navlab_dpe_sdr_tpu_torch.ops import dpe as dpe_ops
from navlab_dpe_sdr_tpu_torch.ops import dpe_real
from navlab_dpe_sdr_tpu_torch.ops.acquisition import deep_dopplers

SEED = 20261016
FS = 2.5e6
S = 50000
CARR_FFTPTS = 8 * (1 << S.bit_length())
N_BLOCKS = 50          # blocks per dispatch on the main path (lookahead)
T = 0.02               # seconds per block
CAPTURE_S = 40.0       # the LNAV wait needs >= 36 s of signal
TRACK_MS = 2000        # one K4 chunk
SCORE_SRC = "navlab_dpe_sdr_tpu_torch/ops/csrc/score_argmax.cu"
TRACK_SRC = "navlab_dpe_sdr_tpu_torch/ops/csrc/track_chunk.cu"
# Published peaks of one H100 SXM (dense, at the 700 W limit): f32 outside
# the tensor cores, and HBM3.
PEAK_F32 = 67e12        # operations / s
PEAK_BYTES = 3.35e12    # bytes / s
# f32 operations counted from the plain versions: one grid point of one
# channel in score_points (line-of-sight projection 5, range 1 or, with the
# curvature term, 5, index 3, round/clip/offset 4, the per-tap coefficient
# form a + d (b + d c) 4, the channel sum 1; a multiply-add counts as two),
# and one sample of one channel in correlate_window_plain (phase, cos and
# sin, wipeoff, three chip indices, segment, 12 multiply-adds).
OPS_PER_POINT_CHANNEL = {"pos": 22, "vel": 18}
# sinc: the index (13 with the curvature term, 9 without), then per tap a
# subtraction, sinpi, two multiplications, a division and an addition (the
# sine counted as one operation), and the channel sum.
OPS_SINC = {"pos": (14, 6), "vel": (10, 6)}       # (fixed, per tap)
OPS_PER_SAMPLE_CHANNEL = 60
KERNELS = {
    "K1": dict(name="score_argmax", route="cuda", source=SCORE_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_score.py:166"),
    "K2": dict(name="score_surface", route="cuda", source=SCORE_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_score.py:43"),
    "K3": dict(name="correlate_window", route="cuda", source=TRACK_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_track.py:50"),
    "K4": dict(name="track_chunk", route="cuda", source=TRACK_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_track.py:181"),
    "K4 coherent": dict(name="track_chunk_coherent", route="cuda",
                        source=TRACK_SRC,
                        replaces="navlab_dpe_sdr_tpu/ops/pallas_track.py:181"),
    "K4 batch_k": dict(name="track_chunk_batched", route="cuda",
                       source=TRACK_SRC,
                       replaces="navlab_dpe_sdr_tpu/ops/pallas_track.py:181"),
    "K3 windows": dict(name="correlate_windows", route="cuda",
                       source=TRACK_SRC,
                       replaces="navlab_dpe_sdr_tpu/ops/pallas_track.py:50"),
}
WEAK_REF = pathlib.Path(__file__).resolve().parent / "tools" / \
    "weak_start_reference.json"
FCAID = F_CA / F_L1


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over
    the f32 peak and bytes (each input read once, each output written once)
    over the memory rate."""
    t_ops, t_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


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


def device_profile(fn):
    """Run fn() once under torch.profiler and synchronize. Returns (kernel
    launches, device-busy ms: kernels and copies summed, wall ms under the
    profiler, {kernel name: (ms, launches)}); launches 0 when the profiler
    showed no device activity."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches, busy, by_name = 0, 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        busy += ms
        seen = by_name.get(e.key, (0.0, 0))
        by_name[e.key] = (seen[0] + ms, seen[1] + e.count)
        if "memcpy" not in e.key.lower() and "memset" not in e.key.lower():
            launches += e.count
    return launches, busy, wall, by_name


def kernel_device_ms(fn, reps: int, name: str):
    """The device's own ms per launch of the kernels whose name holds
    `name`, from torch.profiler over `reps` calls of fn (per launch the
    profiler recorded: it can drop one, and now and then a whole window,
    which is taken again, three times at most); None when it showed none."""
    fn()

    def loop():
        for _ in range(reps):
            fn()

    for _ in range(3):
        found = [v for k, v in device_profile(loop)[3].items() if name in k]
        count = sum(n for _, n in found)
        if count:
            return sum(ms for ms, _ in found) / count
    return None


def device_record(what: str, fn, kernel: str, card: str) -> None:
    """Log the device side of one fn() outside the timed segments: kernel
    launches, device-busy ms and its share of the wall, and the device ms
    of the kernels named `kernel`."""
    launches, busy, wall, by_name = device_profile(fn)
    if launches == 0:
        log(f"device side of {what}: not measured (the profiler showed no "
            f"device activity)")
        return
    own = sum(ms for k, (ms, _) in by_name.items() if kernel in k)
    n_own = sum(n for k, (_, n) in by_name.items() if kernel in k)
    log(f"device side of {what} (one run under torch.profiler, outside the "
        f"timed segments): {launches} kernel launches, device busy "
        f"{busy:.3f} ms of {wall:.3f} ms of profiled wall (share "
        f"{busy / wall:.3f}), of which {kernel} {own:.4f} ms in {n_own} "
        f"launch(es) [{card}]")


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def add_ms(a, b):
    """a + b, or None when either was not measured."""
    return None if a is None or b is None else a + b


def scorer_inputs(rng, manifold: str, width: int, grid, dev,
                  n: int = N_BLOCKS):
    """Main-path-shaped scorer operands made with numpy from the seed."""
    c = 8
    win = np.abs(rng.standard_normal((n, c, width))).astype(np.float32) + 0.1
    win[:, :, width // 2 - 1:width // 2 + 2] += [4.0, 10.0, 4.0]
    los = rng.standard_normal((n, c, 3))
    los /= np.linalg.norm(los, axis=2, keepdims=True)
    centers = width / 2.0 + rng.standard_normal((n, c)) * 0.4
    if manifold == "pos":
        coefs = np.full((n, c), FS / 2.99792458e8)
        r0 = np.full((n, c), 2.2e7) + rng.standard_normal((n, c)) * 1e6
        off3, off1 = grid.d_enu, grid.dt_m
    else:
        coefs = np.full((n, c), -(CARR_FFTPTS / FS) * 1575.42e6 / 2.99792458e8)
        r0 = None
        off3, off1 = grid.dv_enu, grid.dtdot

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    return [t(a) for a in (win, los, centers, coefs, r0, off3, off1)]


def check_scorer(grid, widths, dev):
    """Phase 3: kernel vs plain on the card, every case. Returns a dict:
    err (max |best diff|), and per dispatch (both manifolds, quadratic,
    l_power 1, argmax: the main path's calls) ms and plain_ms from CUDA
    events around the wrappers, device_ms from the profiler, the bound, and
    ms10/device_ms10 at the grouped path's N=10."""
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    times = {}
    ops = nbytes = 0
    dev_ms, ms10, dev_ms10 = 0.0, 0.0, 0.0
    for manifold in ("pos", "vel"):
        args = scorer_inputs(rng, manifold, widths[manifold], grid, dev)
        for interp in ("quadratic", "linear"):
            for l_power in (1, 2):
                for weighted in (False, True):
                    kw = dict(interp=interp, l_power=l_power,
                              weighted=weighted)
                    got = score.score_argmax(*args, **kw)
                    torch.cuda.synchronize()
                    want = score.score_argmax_plain(*args, **kw)
                    err = compare_scores(args, got, want, kw)
                    max_err = max(max_err, err)
                    line = (f"scorer {manifold} W={widths[manifold]} "
                            f"{interp} l_power={l_power} "
                            f"weighted={weighted}: max|best diff| {err:.3e}")
                    if interp == "quadratic" and l_power == 1:
                        k_ms = cuda_ms(lambda: score.score_argmax(
                            *args, **kw), 20)
                        p_ms = cuda_ms(lambda: score.score_argmax_plain(
                            *args, **kw), 3)
                        times[(manifold, weighted)] = (k_ms, p_ms)
                        line += (f"; kernel {k_ms:.4f} ms, plain "
                                 f"{p_ms:.4f} ms")
                        if not weighted:
                            n, c = args[0].shape[:2]
                            ops += (n * c * args[5].shape[0]
                                    * OPS_PER_POINT_CHANNEL[manifold])
                            nbytes += tensor_bytes(*args, *got[:2])
                    log(line)
        # the main path's call again for the kernel's own time, and the
        # grouped path's N = 10 (50 blocks in coherent groups of 5)
        d50 = kernel_device_ms(lambda: score.score_argmax(*args), 10,
                               "score_kernel")
        args10 = [None if a is None else a[:10].contiguous()
                  for a in args[:5]] + args[5:]
        got = score.score_argmax(*args10)
        want = score.score_argmax_plain(*args10)
        max_err = max(max_err, compare_scores(
            args10, got, want, dict(interp="quadratic", l_power=1,
                                    weighted=False)))
        m10 = cuda_ms(lambda: score.score_argmax(*args10), 20)
        d10 = kernel_device_ms(lambda: score.score_argmax(*args10), 10,
                               "score_kernel")
        log(f"scorer {manifold} W={widths[manifold]} quadratic l_power=1 "
            f"argmax: kernel's own time N=50 {fmt_ms(d50)}; N=10: kernel == "
            f"plain, wrapper {m10:.4f} ms, kernel's own {fmt_ms(d10)}")
        ms10 += m10
        dev_ms, dev_ms10 = add_ms(dev_ms, d50), add_ms(dev_ms10, d10)
    return dict(err=max_err,
                ms=times[("pos", False)][0] + times[("vel", False)][0],
                plain_ms=times[("pos", False)][1] + times[("vel", False)][1],
                device_ms=dev_ms, ms10=ms10, device_ms10=dev_ms10,
                bound=bound(ops, nbytes))


def compare_scores(args, got, want, kw) -> float:
    """argmax equal (or a tie within 1e-6 relative), best within rtol 1e-5,
    weighted means within rtol 1e-4. Returns max |best diff|."""
    best_k, arg_k = got[0].cpu().numpy(), got[1].cpu().numpy()
    best_p, arg_p = want[0].cpu().numpy(), want[1].cpu().numpy()
    np.testing.assert_allclose(best_k, best_p, rtol=1e-5)
    for n in np.nonzero(arg_k != arg_p)[0]:
        a = int(arg_k[n])
        win, los, cen, coe, r0, off3, off1 = args
        s_at = score.score_points(
            win[n:n + 1], los[n:n + 1], cen[n:n + 1], coe[n:n + 1],
            None if r0 is None else r0[n:n + 1], off3[a:a + 1],
            off1[a:a + 1], kw["interp"], kw["l_power"]).item()
        assert abs(s_at - best_p[n]) <= 1e-6 * abs(best_p[n]), (
            f"block {n}: kernel argmax {a} scores {s_at}, plain argmax "
            f"{arg_p[n]} scores {best_p[n]}")
    if kw["weighted"]:
        mk = (got[2] / got[3][:, None]).cpu().numpy()
        mp = (want[2] / want[3][:, None]).cpu().numpy()
        np.testing.assert_allclose(mk, mp, rtol=1e-4, atol=1e-6)
    return float(np.abs(best_k - best_p).max())


def make_capture(seconds: float, cn0_dbhz: float = 47.0):
    """int16 I/Q capture of the seeded 8-PRN scenario, synthesized in 1 s
    pieces (each piece's noise is seeded by its first sample)."""
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=cn0_dbhz)
    n = int(round(seconds * FS))
    samples = np.empty(n, DTYPE_IQ16)
    step = int(FS)
    for s0 in range(0, n, step):
        iq = sim.generate(min(step, n - s0), start_sample=s0)
        samples["i"][s0:s0 + len(iq)] = np.clip(np.round(iq.real), -32768,
                                               32767)
        samples["q"][s0:s0 + len(iq)] = np.clip(np.round(iq.imag), -32768,
                                               32767)
    release_workspace()
    return samples, hand, arr


def receiver(samples, hand, arr, grid, device):
    return DPEReceiver(SampleFile(samples=samples, fs=FS),
                       copy.deepcopy(hand), grid=grid,
                       eph=copy.deepcopy(arr),
                       config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                       device=device)


def check_dispatch(samples, hand, arr, grid):
    """Phase 4: one 5-block dispatch, card vs CPU, same packed inputs."""
    rx = receiver(samples, hand, arr, grid, "cpu")
    preps = rx._prepare_batch(5)
    pk = dpe_real.pack_params(np.stack([p[0] for p in preps]),
                              np.stack([p[1] for p in preps]), 0)
    rows = {}
    for dev in ("cpu", "cuda"):
        d = device_state(grid, rx._dev.chips.numpy(), S, FS, dev)
        cap = torch.from_numpy(samples[:S * 5].view(np.int16)
                               .reshape(5, S, 2)).to(dev)
        rows[dev] = dpe_real.dpe_batch_blocks(
            cap, pk, d.chips, d.time_idc, d.d_enu, d.dt_m, d.dv_enu,
            d.dtdot, carr_fftpts=rx.carr_fftpts, period=rx.period,
            n_periods=S // rx.period, n_blocks=5, return_windows=True,
            code_win=rx.code_win, carr_win=rx.carr_win).cpu().numpy()
    idx_c = dpe_real.unpack_row_indices(rows["cpu"])
    idx_g = dpe_real.unpack_row_indices(rows["cuda"])
    for a, b in zip(idx_c, idx_g):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(rows["cuda"][:, [1, 3]],
                               rows["cpu"][:, [1, 3]], rtol=1e-4)
    c = len(rx.prn_list)
    np.testing.assert_array_equal(rows["cuda"][:, 4:4 + c],
                                  rows["cpu"][:, 4:4 + c])
    wc, wg = rows["cpu"][:, 4 + c:], rows["cuda"][:, 4 + c:]
    rel = float(np.abs(wg - wc).max() / np.abs(wc).max())
    assert rel < 1e-4, rel
    return rel


def build_all():
    """Phase 2: nvcc for every source at once; {name: (library, seconds)}."""
    out, errors = {}, []

    def one(name):
        t0 = time.perf_counter()
        try:
            out[name] = (_build.build(name), time.perf_counter() - t0)
        except Exception as e:      # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(name,))
               for name in ("score_argmax", "track_chunk")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def check_correlator(dev, card):
    """Phase 6: K3 against its plain version at the path's window (S=2500,
    staged by one bulk copy) and at S=2501 (10 004 bytes: the 4-byte
    copies); dict(err, ms, plain_ms, device_ms, bound) of the first."""
    rng = np.random.default_rng(SEED)
    c = 8
    tab = torch.from_numpy(ca_table(range(1, c + 1)).astype(np.float32)
                           ).to(dev)
    st = tracking.init_state(
        rc=rng.random(c) * 1023.0, ri=rng.random(c),
        fc=F_CA + rng.standard_normal(c), fi=rng.standard_normal(c) * 1000.0,
        device=dev)
    args = (st.rc, st.dfc, st.ri, st.fi, tab)
    result = None
    for s in (2500, 2501):
        fs = s * 1000.0
        raw = torch.from_numpy(np.clip(np.round(rng.standard_normal((s, 2))
                                                * 64.0), -32768, 32767)
                               .astype(np.int16)).to(dev)
        rawf = raw.float()
        times = track.window_times(s, fs, dev)

        def kernel():
            return track.correlate_window(raw, *args, fs)

        def plain():
            return track.correlate_window_plain(rawf[:, 0], rawf[:, 1],
                                                *args, times, fs)[0]

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        assert rel < 1e-5, (s, rel)
        k_ms, p_ms = cuda_ms(kernel, 200), cuda_ms(plain, 20)
        log(f"K3 correlate_window: C={c}, S={s} "
            f"({'bulk copy' if s % 4 == 0 else '4-byte copies'}): "
            f"{'bit-equal' if torch.equal(got, want) else 'within limit'}, "
            f"max|diff| {err:.3e} (rel {rel:.3e}, limit 1e-5); kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per window [{card}]")
        if result is None:
            result = dict(
                err=err, ms=k_ms, plain_ms=p_ms,
                device_ms=kernel_device_ms(kernel, 50,
                                           "correlate_window_kernel"),
                bound=bound(c * s * OPS_PER_SAMPLE_CHANNEL,
                            tensor_bytes(raw, times, tab, *args[:4], got)))
    return result


def tracker_inputs(samples, hand, dev):
    """Phase 7's inputs: the state after acquisition, one 2000 ms chunk of
    the capture on the card, and the channels' code table."""
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), hand.prn_list,
                        device=dev)
    res = rx.acquire(verbose=False)
    assert all(r.found for r in res), [r.cppm for r in res]
    raw = torch.from_numpy(samples[:TRACK_MS * 2500].view(np.int16)
                           .reshape(TRACK_MS, 2500, 2).copy()).to(dev)
    return rx.state, raw, rx.code_table


def compare_logs(lf_k, li_k, lf_p, li_p, rows):
    """K4's limits (phase 7) between a kernel's and a plain log: ints
    equal, signs equal after update 5, rc within 1e-3 chips, fi within
    0.1 Hz, prompt within 1e-3 of each channel's peak. Returns (verdict,
    max |float diff|)."""
    np.testing.assert_array_equal(li_k, li_p)
    n = len(tracking.LOG_F_BASE)
    np.testing.assert_array_equal(lf_k[5:, n:], lf_p[5:, n:])
    drc = np.abs(lf_k[:, rows["rc"]] - lf_p[:, rows["rc"]])
    drc = float(np.minimum(drc, 1023.0 - drc).max())
    dfi = float(np.abs(lf_k[:, rows["fi"]] - lf_p[:, rows["fi"]]).max())
    dpr = 0.0
    for name in ("iP", "qP"):
        r = rows[name]
        peak = np.abs(lf_p[:, r]).max(axis=0)
        dpr = max(dpr, float((np.abs(lf_k[:, r] - lf_p[:, r]) / peak).max()))
    assert drc < 1e-3 and dfi < 0.1 and dpr < 1e-3, (drc, dfi, dpr)
    err = float(np.abs(lf_k - lf_p).max())
    if np.array_equal(lf_k, lf_p):
        return "bit-equal", err
    return (f"within limits: rc {drc:.2e} chips, fi {dfi:.2e} Hz, prompt "
            f"{dpr:.2e} of peak", err)


def track_bound(steps, s, raw, code_table, lf, li):
    n_chan = code_table.shape[0]
    return bound(steps * s * n_chan * OPS_PER_SAMPLE_CHANNEL,
                 tensor_bytes(raw, code_table, lf, li)
                 + 2 * n_chan * (16 + 5 + 40) * 4)


def check_tracker(st0, raw, code_table, card):
    """Phase 7: K4 against its plain version on one 2000 ms chunk from the
    acquisition result; dict(err: max |float log diff|, ms, plain_ms,
    device_ms, bound)."""
    n_chan = code_table.shape[0]

    def kernel(clocks=None):
        return tracking.track_chunk_packed(st0, raw, code_table, FS, FCAID,
                                           clocks=clocks)

    _, lfk, lik = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lfp, lip = tracking.track_chunk_plain(st0, raw, code_table, FS, FCAID)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    lf_p, li_p = lfp.cpu().numpy(), lip.cpu().numpy()
    k_ms = cuda_ms(kernel, 5)
    rows = {k: i for i, k in enumerate(tracking.LOG_F_ROWS)}
    margins, err = compare_logs(lfk.cpu().numpy(), lik.cpu().numpy(), lf_p,
                                li_p, rows)
    log(f"K4 track_chunk: {TRACK_MS} ms x {n_chan} channels from "
        f"acquisition: logs {margins} (max|float diff| {err:.3e}); kernel "
        f"{k_ms:.3f} ms per chunk ({TRACK_MS / k_ms:.1f}x real time), plain "
        f"{p_ms:.1f} ms ({TRACK_MS / p_ms:.2f}x) [{card}]")

    # where a step goes: one more launch, with the kernel's clock buffer
    clocks = torch.zeros((n_chan, track.N_CLOCKS), dtype=torch.int64,
                         device=raw.device)
    _, lfc, _ = kernel(clocks)            # warms this instantiation
    assert torch.equal(lfc, lfk), "the clocked kernel logs differently"
    clocked_ms = cuda_ms(lambda: kernel(clocks), 3)
    clk = clocks.cpu().numpy().astype(np.float64).mean(axis=0)
    us = clk / clk[-1] * clocked_ms * 1e3 / TRACK_MS      # per step
    log(f"K4 step split (us per step, mean over channels; clocked kernel "
        f"{clocked_ms:.3f} ms per chunk, {clk[-1] / clocked_ms / 1e3:.0f} "
        f"MHz): " + ", ".join(f"{n} {u:.3f}" for n, u in
                              zip(track.CLOCK_NAMES, us)) + f" [{card}]")
    steps, s = raw.shape[:2]
    return dict(
        err=err, ms=k_ms, plain_ms=p_ms,
        device_ms=kernel_device_ms(kernel, 3, "track_chunk_kernel"),
        bound=track_bound(steps, s, raw, code_table, lfk, lik))


def check_surface(grid, widths, dev, card):
    """Phase 8: K2 against its plain version, N=1, G=390 625. Returns a
    dict: err (max |diff|), and per block (both manifolds, quadratic,
    l_power 1: the per-block step's calls) ms, plain_ms, device_ms, bound."""
    rng = np.random.default_rng(SEED + 2)
    max_err, k_ms, p_ms, d_ms = 0.0, 0.0, 0.0, 0.0
    ops = nbytes = 0
    for manifold in ("pos", "vel"):
        # one block of the batch (windows, geometry) against the whole grid
        args = scorer_inputs(rng, manifold, widths[manifold], grid, dev)
        args = [None if a is None else a[:1].contiguous()
                for a in args[:5]] + args[5:]
        for interp in ("quadratic", "linear"):
            for l_power in (1, 2):
                kw = dict(interp=interp, l_power=l_power)
                got, best, arg = score.score_surface_argmax(*args, **kw)
                assert got.shape == (1, grid.n_pos), got.shape
                want = score.score_surface_plain(*args, **kw)
                torch.cuda.synchronize()
                # the kernel's (max, first index) are the plain surface's
                assert int(arg[0]) == int(want.argmax())
                assert float(best[0]) == float(want.max())
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                if interp == "quadratic" and l_power == 1:
                    km = cuda_ms(lambda: score.score_surface_argmax(
                        *args, **kw), 50)
                    pm = cuda_ms(lambda: score.score_surface_plain(
                        *args, **kw), 5)
                    dm = kernel_device_ms(lambda: score.score_surface_argmax(
                        *args, **kw), 20, "score_kernel")
                    k_ms, p_ms = k_ms + km, p_ms + pm
                    d_ms = add_ms(d_ms, dm)
                    ops += (args[0].shape[1] * args[5].shape[0]
                            * OPS_PER_POINT_CHANNEL[manifold])
                    nbytes += tensor_bytes(*args, got, best, arg)
                    log(f"K2 score_surface {manifold} W={widths[manifold]}"
                        f": wrapper {km:.4f} ms, kernel's own {fmt_ms(dm)}, "
                        f"plain {pm:.4f} ms [{card}]")
    log(f"K2 score_surface: N=1, G={grid.n_pos}, both manifolds x "
        f"quadratic/linear x l_power 1/2: surface max|diff| {max_err:.3e} "
        f"(rtol 1e-6), max and first index equal; per block wrapper "
        f"{k_ms:.4f} ms, kernel's own {fmt_ms(d_ms)}, plain {p_ms:.4f} ms "
        f"[{card}]")
    return dict(err=max_err, ms=k_ms, plain_ms=p_ms, device_ms=d_ms,
                bound=bound(ops, nbytes))


def cold_start(samples, hand, arr, grid, dev):
    """Phase 9, one pass: acquire -> track to 8/8 ephemerides -> handoff ->
    first per-block DPE fix. Returns the receivers, handoff, wall time and
    its split by stage (host clock; each stage ends in a host fetch)."""
    prns = list(hand.prn_list)
    stages = {"track": 0.0, "decode": 0.0}
    t0 = time.perf_counter()
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), prns, device=dev)
    res = rx.acquire(verbose=False)
    stages["acquire"] = time.perf_counter() - t0
    signal_ms, good = 0, []
    # 30 s, then 2 s at a time until every channel decodes, keeping 2 s of
    # capture for the DPE steps that follow the handoff
    for n_ms in [30_000] + [2_000] * int((CAPTURE_S - 32.0) // 2):
        if signal_ms >= 30_000 and len(good) == len(prns):
            break
        t1 = time.perf_counter()
        rx.track(n_ms)
        signal_ms += n_ms
        t2 = time.perf_counter()
        good = rx.decode_ephemerides(verbose=False)
        stages["track"] += t2 - t1
        stages["decode"] += time.perf_counter() - t2
    t1 = time.perf_counter()
    h = rx.save_handoff("")
    stages["handoff"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    drx = DPEReceiver(SampleFile(samples=samples, fs=FS), h, grid=grid,
                      eph=rx.eph_array(), config=DPEConfig(), device=dev)
    fix = drx.run(1)[0]
    stages["first fix"] = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    return dict(rx=rx, res=res, good=good, h=h, drx=drx, fix=fix, wall=wall,
                stages=stages, signal_s=h.bytes_read / 4 / FS + 0.02)


def check_cold_start(samples, hand, arr, grid, dev, card):
    """Phase 9: warm pass, then the timed pass with every launch count set
    to 0 just before it and read just after."""
    cold_start(samples, hand, arr, grid, dev)            # warm the kernels
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    run = cold_start(samples, hand, arr, grid, dev)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    rx, drx, h = run["rx"], run["drx"], run["h"]
    prns = list(hand.prn_list)
    assert all(r.found for r in run["res"]), "acquisition"
    assert sorted(run["good"]) == sorted(prns), run["good"]
    for e in arr.ephs:
        dec = rx.channels[e.prn].ephemeris
        assert abs(dec.sqrt_A - e.sqrt_A) < 1e-3, e.prn
        assert abs(dec.t_oe - e.t_oe) < 1e-9, e.prn
        assert abs(dec.M_0 - e.M_0) < 1e-8, e.prn
    _, _, x_ecef, _, _ = rx.nav_solution()
    pvt_m = float(np.linalg.norm(x_ecef[:3] - hand.x_ecef[:3]))
    fix_m = float(np.linalg.norm(run["fix"].x_ecef[:3] - hand.x_ecef[:3]))
    assert pvt_m < 15.0, pvt_m
    assert fix_m < 15.0, fix_m
    # K3 runs here only as K4's device function, once per tracked step
    assert counts["track_chunk"] > 0 and rx.mcount > 0, counts
    assert counts["score_surface"] == 2, counts      # one fix, 2 manifolds
    rtfs = sorted(n * 1e-3 / w for n, w in rx.chunk_walls)
    log(f"cold start: 8/8 acquired, 8/8 ephemerides (sqrt_A, t_oe, M_0 "
        f"equal to the scenario's), scalar PVT {pvt_m:.2f} m, first "
        f"per-block DPE fix {fix_m:.2f} m; TTFF wall {run['wall']:.3f} s for "
        f"{run['signal_s']:.2f} s of signal (cold receiver state, warm "
        f"kernels); tracking {rx.mcount} ms in {len(rtfs)} chunks, real-time "
        f"factor per chunk median {float(np.median(rtfs)):.1f}x [min "
        f"{rtfs[0]:.1f}, max {rtfs[-1]:.1f}]; launches {counts}, K3 body "
        f"run inside K4 for {rx.mcount} steps [{card}]")
    log("cold start split (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in run["stages"].items()))

    t0 = time.perf_counter()
    drx.run(50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = np.array([np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3])
                    for f in drx.fixes[1:]])
    assert len(err) == 50 and np.isfinite(err).all()
    med = float(np.median(err))
    assert med < 15.0, med
    log(f"per-block DPE after the handoff: 50 steps, error median "
        f"{med:.2f} m p95 {float(np.percentile(err, 95)):.2f} m, wall "
        f"{wall:.3f} s ({50 * T / wall:.2f}x real time) [{card}]")
    device_record("one per-block step", drx.step, "score_kernel", card)
    return counts, rx.mcount, rx


def sum_bound(args, got, manifold, interp="quadratic"):
    """Roofline bound of one block-summed call: every point-channel's
    operations and one add per block and point; inputs once, outputs once."""
    n, c, w = args[0].shape
    g = args[5].shape[0]
    if interp == "sinc":
        fixed, per_tap = OPS_SINC[manifold]
        per = fixed + per_tap * w
    else:
        per = OPS_PER_POINT_CHANNEL[manifold]
    return bound(n * c * g * per + n * g, tensor_bytes(*args, *got[:2]))


def check_sum_case(name, args, manifold, card, interp="quadratic",
                   l_power=1, reps=10, timed=True):
    """One shape of the block-summed mode: kernel against plain (bit-equal,
    or for sinc rtol 1e-5 and a tie within 1e-6), weighted sums bitwise
    equal across two runs; when timed also their means within rtol 1e-4 of
    the plain version's, wrapper ms, the kernel's own ms, plain ms and the
    bound."""
    kw = dict(interp=interp, l_power=l_power, block_sum=True)
    got = score.score_argmax(*args, **kw)
    want = score.score_argmax_plain(*args, **kw)
    torch.cuda.synchronize()
    if interp == "sinc":
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
        if int(got[1]) != int(want[1]):
            idx = [int(got[1]), int(want[1])]
            at = score.score_points(*args[:5], args[5][idx], args[6][idx],
                                    interp, l_power).sum(dim=0)
            assert abs(float(at[0] - at[1])) <= 1e-6 * abs(float(at[1])), (
                name, idx, at)
        verdict = (f"best rel diff "
                   f"{abs(float(got[0] - want[0])) / abs(float(want[0])):.2e}"
                   f" (rtol 1e-5), argmax "
                   f"{'equal' if int(got[1]) == int(want[1]) else 'a tie'}")
    else:
        assert torch.equal(got[0], want[0]), (name, got[0], want[0])
        assert torch.equal(got[1], want[1]), (name, got[1], want[1])
        verdict = "best bit-equal, arg equal"
    wa = score.score_argmax(*args, weighted=True, **kw)
    wb = score.score_argmax(*args, weighted=True, **kw)
    torch.cuda.synchronize()
    for x, y in zip(wa, wb):
        assert torch.equal(x, y), (name, "weighted sums differ run to run")
    assert int(wa[1]) == int(got[1])
    if not timed:
        log(f"K1 block sum {name} {manifold} N={args[0].shape[0]} "
            f"G={args[5].shape[0]} {interp} l_power={l_power}: {verdict}, "
            f"weighted sums repeat bitwise")
        return None
    wp = score.score_argmax_plain(*args, weighted=True, **kw)
    torch.testing.assert_close(wa[2] / wa[3], wp[2] / wp[3], rtol=1e-4,
                               atol=1e-5)
    k_ms = cuda_ms(lambda: score.score_argmax(*args, **kw), reps)
    d_ms = kernel_device_ms(lambda: score.score_argmax(*args, **kw), reps,
                            "score_kernel")
    p_ms = cuda_ms(lambda: score.score_argmax_plain(*args, **kw), 1)
    bnd = sum_bound(args, got, manifold, interp)
    n, _, w = args[0].shape
    log(f"K1 block sum {name} {manifold} N={n} W={w} G={args[5].shape[0]}"
        f" {interp} l_power={l_power}: {verdict}, weighted sums repeat "
        f"bitwise; wrapper {k_ms:.4f} ms, kernel's own {fmt_ms(d_ms)}, "
        f"plain {p_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}) [{card}]")
    return dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, **bnd)


def check_block_sum(grid, widths, dev, card):
    """Phase 10: the block-summed mode and sinc. Returns the K1 sub-entries
    of the kernels line (per call of both manifolds)."""
    rng = np.random.default_rng(SEED + 10)
    out = {}

    def both(key, cases):
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for r in cases:
            for k in tot:
                tot[k] = add_ms(tot[k], r[k])
        out.update({f"ms_{key}": tot["ms"], f"device_ms_{key}":
                    tot["device_ms"], f"plain_ms_{key}": tot["plain_ms"],
                    f"bound_ms_{key}": tot["bound_ms"]})

    # the spread grid at the integrated path's N = 8 and the survey's N = 50
    for n in (8, 50):
        cases = []
        for manifold in ("pos", "vel"):
            args = scorer_inputs(rng, manifold, widths[manifold], grid, dev,
                                 n=n)
            cases.append(check_sum_case("spread", args, manifold, card))
            if n == 8:
                for kw in (dict(l_power=2), dict(interp="linear")):
                    check_sum_case("spread", args, manifold, card, reps=3,
                                   timed=False, **kw)
        both(f"sum_n{n}", cases)

    # an exact tie across tiles: the grid laid out twice
    args = scorer_inputs(rng, "pos", widths["pos"], grid, dev, n=8)
    args[5] = torch.cat([args[5], args[5]])
    args[6] = torch.cat([args[6], args[6]])
    best, arg = score.score_argmax(*args, block_sum=True)
    want = score.score_argmax_plain(*args, block_sum=True)
    assert torch.equal(best, want[0]) and torch.equal(arg, want[1])
    assert int(arg) < grid.n_pos
    log(f"K1 block sum, the spread grid twice over (G={args[5].shape[0]}): "
        f"the tie goes to the first copy (arg {int(arg)}), as in the plain "
        f"version")
    del args

    # the dense grid (the reference's cap) with its own window widths
    dense = dense_grid()
    dcw, dvw = dpe_ops.auto_windows(dense.d_enu, dense.dt_m, dense.dv_enu,
                                    dense.dtdot, FS, CARR_FFTPTS)
    cases, cases_n1 = [], []
    for manifold, w in (("pos", dcw), ("vel", dvw)):
        args = scorer_inputs(rng, manifold, w, dense, dev, n=16)
        assert args[5].shape[0] == 75 ** 4 > 2 ** 24
        cases.append(check_sum_case("dense", args, manifold, card, reps=3))
        check_sum_case("dense", args, manifold, card, l_power=2, reps=3,
                       timed=False)
        # one block: what the coherent integrated run launches on this grid
        one = [None if a is None else a[:1].contiguous() for a in args[:5]]
        cases_n1.append(check_sum_case("dense", one + args[5:], manifold,
                                       card, reps=3))
        del args, one
    both("sum_n16_dense", cases)
    both("sum_n1_dense", cases_n1)
    del dense

    # sinc at the survey's zoom shape: 33^4 points about the coarse argmax,
    # 25 epochs
    ax = (np.arange(33) - 16.0)
    cases = []
    for manifold, sp in (("pos", 0.25), ("vel", 0.02)):
        args = scorer_inputs(rng, manifold, widths[manifold], grid, dev,
                             n=25)
        off3, off1 = _mesh4(ax * sp, ax * sp)
        args[5] = torch.from_numpy(off3.astype(np.float32)).to(dev)
        args[6] = torch.from_numpy(off1.astype(np.float32)).to(dev)
        cases.append(check_sum_case("zoom", args, manifold, card,
                                    interp="sinc", reps=3))
        check_sum_case("zoom", args, manifold, card, reps=3, timed=False)
    both("sum_sinc_zoom", cases)
    return out


def fix_errors(fixes, truth):
    return np.array([np.linalg.norm(f.x_ecef[:3] - truth[:3])
                     for f in fixes])


def check_integrated(samples, hand, arr, grid, dev, card):
    """Phase 11: integrated DPE at full width. Returns K1's launches."""
    first = samples[:S * 216]      # a warm fix, the timed ones, a profiled one
    raw_dev = torch.from_numpy(first.view(np.int16).reshape(-1, S, 2)).to(dev)
    cfg = DPEConfig(ekf_mode="alpha", ekf_alpha=0.3)

    def make(g, samp=first):
        return DPEReceiver(SampleFile(samples=samp, fs=FS),
                           copy.deepcopy(hand), grid=g,
                           eph=copy.deepcopy(arr), config=copy.deepcopy(cfg),
                           device=dev)

    launches = 0
    runs = {}
    dense = dense_grid()
    for name, g, k, n_fix, kw in (
            ("noncoherent, spread grid", grid, 8, 25, dict()),
            ("coherent, dense grid 2 x 75^4", dense, 16, 12,
             dict(coherent=True)),
            ("noncoherent, spread grid, from the file", grid, 8, 25, None)):
        rx = make(g)
        if kw is None:      # file mode: the read-ahead thread stages batches
            warm = timed = dict()
        else:
            warm = dict(raw_blocks_dev=raw_dev, **kw)
            timed = dict(start_block=k, **warm)
        rx.run_integrated(1, k, **warm)       # the first fix warms the shape
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rx.run_integrated(n_fix, k, **timed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = _build.launch_counts()["score_argmax"]
        assert n_launch == 2 * n_fix, (name, n_launch)
        assert len(rx.fixes) == n_fix + 1 and rx.mc == (n_fix + 1) * k
        err = fix_errors(rx.fixes[1:], hand.x_ecef)
        assert np.isfinite(err).all()
        med = float(np.median(err))
        assert med < 15.0, (name, med)
        launches += n_launch
        runs[name] = rx
        log(f"integrated DPE, {name}: {n_fix} fixes of {k} blocks "
            f"(G={g.n_pos} per manifold, windows {rx.code_win}/"
            f"{rx.carr_win}), {n_launch} kernel launches, error median "
            f"{med:.2f} m max {float(err.max()):.2f} m [first "
            f"{err[0]:.2f}, last {err[-1]:.2f}], wall {wall:.3f} s, "
            f"{n_fix * k * T / wall:.2f}x real time [{card}]")
        if kw == dict():
            device_record(
                "one integrated fix of 8 blocks, spread grid",
                lambda: rx.run_integrated(1, 8, raw_blocks_dev=raw_dev,
                                          start_block=208),
                "score_kernel", card)
    a = runs["noncoherent, spread grid"]
    b = runs["noncoherent, spread grid, from the file"]
    assert len(b.fixes) == 26
    for fa, fb in zip(a.fixes, b.fixes):
        assert np.array_equal(fa.x_ecef, fb.x_ecef), (fa.mc, "file mode")
        assert (fa.pos_score, fa.vel_score) == (fb.pos_score, fb.vel_score)
    assert not [t for t in threading.enumerate() if t.name == "raw-prefetch"]
    log("integrated DPE: the file-mode run's 26 fixes equal the "
        "device-resident run's exactly")
    return launches


def check_survey(samples, hand, arr, grid, dev, card):
    """Phase 12: the survey solve over 25 s. A warm-up run, then the timed
    runs (quadratic and sinc zoom passes) on the receiver as it is, whose
    launches are the ones returned; then one more run of each with a
    synchronize after every pass and joint argmax, for the wall split
    alone."""
    n_batches, k = 25, 50
    raw_dev = torch.from_numpy(samples[:S * n_batches * k].view(np.int16)
                               .reshape(-1, S, 2)).to(dev)
    truth = hand.x_ecef
    r_e2n = frames.ecef_to_enu_matrix(truth[0:3])

    def survey(zoom, calls=None):
        rx = DPEReceiver(SampleFile(samples=samples, fs=FS),
                         copy.deepcopy(hand), grid=grid,
                         eph=copy.deepcopy(arr), device=dev)
        if calls is not None:
            inner_pass, inner_joint = rx.run_integrated, rx._joint_argmax

            def timed_pass(*a, **kw):
                t0 = time.perf_counter()
                out = inner_pass(*a, **kw)
                torch.cuda.synchronize()
                calls.append(("pass", time.perf_counter() - t0))
                return out

            def timed_joint(win, los, cen, coe, r0, off3, off1, interp=None):
                t0 = time.perf_counter()
                out = inner_joint(win, los, cen, coe, r0, off3, off1,
                                  interp=interp)
                torch.cuda.synchronize()
                calls.append(("coarse" if off3.shape[0] == grid.n_pos
                              else "zoom", time.perf_counter() - t0))
                return out

            rx.run_integrated, rx._joint_argmax = timed_pass, timed_joint
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = rx.run_survey(n_batches=n_batches, blocks_per_fix=k,
                            raw_blocks_dev=raw_dev, zoom_interp=zoom)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_launch = _build.launch_counts()["score_argmax"]
        # two per integrated fix, then six joint passes (coarse and two zoom
        # passes per manifold)
        assert n_launch == 2 * n_batches + 6, n_launch
        assert res.n_blocks == n_batches * k and res.n_batches == n_batches
        assert len(rx.fixes) == n_batches
        assert np.isfinite(res.pos_score) and np.isfinite(res.vel_score)
        assert np.isfinite(res.x_ecef).all()
        assert np.all(res.sigma_pos > 0) and np.all(res.sigma_vel > 0)
        enu = r_e2n @ (res.x_ecef[0:3] - truth[0:3])
        assert abs(enu[0]) < 1.5 and abs(enu[1]) < 1.5, enu
        assert np.linalg.norm(enu) < 6.0, enu
        return res, enu, wall, n_launch

    survey(None)                           # warms the shapes
    launches = 0
    for zoom in (None, "sinc"):
        res, enu, wall, n_launch = survey(zoom)
        launches += n_launch
        log(f"survey, zoom {zoom or 'quadratic'}: {n_batches} batches of {k} "
            f"blocks ({n_batches * k * T:.0f} s), {n_launch} kernel "
            f"launches, ENU error {enu[0]:.2f} / {enu[1]:.2f} / "
            f"{enu[2]:.2f} m (3-D {float(np.linalg.norm(enu)):.2f} m), clock "
            f"{res.x_ecef[3] - truth[3]:.2f} m, sigma_pos "
            f"{np.array2string(res.sigma_pos, precision=3)}, wall "
            f"{wall:.3f} s ({n_batches * k * T / wall:.1f}x real time) "
            f"[{card}]")
    for zoom in (None, "sinc"):
        calls = []
        _, _, wall, _ = survey(zoom, calls)
        split = {key: sum(t for kk, t in calls if kk == key)
                 for key in ("pass", "coarse", "zoom")}
        log(f"survey, zoom {zoom or 'quadratic'}, one more run synchronized "
            f"after every stage: wall {wall:.3f} s: pass "
            f"{split['pass']:.3f} s, coarse {split['coarse']:.4f} s, zoom "
            f"{split['zoom']:.4f} s [{card}]")
    return launches


def check_refined(samples, hand, arr, grid, dev, card):
    """Phase 13: the batched path with the Newton polish and the full EKF.
    Returns K1's launches."""
    first = samples[:S * 250]
    raw_dev = torch.from_numpy(first.view(np.int16).reshape(-1, S, 2)).to(dev)
    rx = DPEReceiver(SampleFile(samples=first, fs=FS), copy.deepcopy(hand),
                     grid=grid, eph=copy.deepcopy(arr),
                     config=DPEConfig(refine="newton", ekf_mode="full"),
                     device=dev)
    widths = []
    inner = dpe_real.pack_rows

    def pack_rows(*a, **kw):
        rows = inner(*a, **kw)
        widths.append(rows.shape[1])
        return rows

    dpe_real.pack_rows = pack_rows
    try:
        run = dict(lookahead=N_BLOCKS, raw_blocks_dev=raw_dev, pipeline=True,
                   pipeline_depth=4)
        rx.run_batched(50, start_block=0, **run)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rx.run_batched(200, start_block=50, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        dpe_real.pack_rows = inner
    launches = _build.launch_counts()["score_argmax"]
    assert launches == 2 * (200 // N_BLOCKS), launches
    c = len(rx.prn_list)
    assert set(widths) == {4 + c + c * (rx.code_win + rx.carr_win)}, widths
    fixes = rx.fixes[50:]
    assert len(fixes) == 200
    err = fix_errors(fixes, hand.x_ecef)
    assert np.isfinite(err).all()
    med, p95 = float(np.median(err)), float(np.percentile(err, 95))
    assert med < 15.0, med
    # off the lattice: the spread grid's offsets are whole metres
    r = frames.ecef_to_enu_matrix(hand.x_ecef[0:3])
    enu = np.stack([r @ (f.x_ecef[0:3] - hand.x_ecef[0:3])
                    for f in fixes[-6:]])
    frac = np.abs(enu - np.round(enu))
    assert frac.max() > 1e-3, enu
    tr, tr4 = float(np.trace(rx.ekf.P)), float(np.trace(rx.ekf.P[:4, :4]))
    assert tr < 300.0 and tr4 > 1.0, (tr, tr4)
    log(f"refined + full EKF batched run: 200 blocks, {launches} kernel "
        f"launches, rows of {widths[0]} floats (windows inside), error "
        f"median {med:.2f} m p95 {p95:.2f} m, trace(P) {tr:.1f} "
        f"(position-clock block {tr4:.2f}), wall {wall:.3f} s, "
        f"{200 * T / wall:.2f}x real time [{card}]")
    return launches


def check_coherent(st0, samples, code_table, card):
    """Phase 14: K4's coherent mode against its plain version from the
    acquisition state at m = 2, 8, 10 (200 updates each) and at m = 4 on
    the coherent cold start's own chunk (2000 ms, 500 updates). Returns the
    K4 coherent entry (m = 4, the path's shape)."""
    dev = code_table.device
    out, errs = {}, []
    for m in (2, 4, 8, 10):
        n_upd = TRACK_MS // m if m == 4 else 200
        raw = torch.from_numpy(samples[:n_upd * m * 2500].view(np.int16)
                               .reshape(n_upd, m * 2500, 2).copy()).to(dev)
        loops = tracking.cadence_loops(m)

        def kernel():
            return tracking.track_chunk_packed(st0, raw, code_table, FS,
                                               FCAID, loops, coh_ms=m)

        _, lfk, lik = kernel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lfp, lip = tracking.track_chunk_plain(st0, raw, code_table, FS,
                                                 FCAID, loops, m)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        rows = {k: i for i, k in enumerate(tracking.log_f_rows(m))}
        verdict, err = compare_logs(lfk.cpu().numpy(), lik.cpu().numpy(),
                                    lfp.cpu().numpy(), lip.cpu().numpy(),
                                    rows)
        errs.append(err)
        k_ms = cuda_ms(kernel, 5)
        log(f"K4 coherent m={m}: {n_upd} updates ({n_upd * m} ms) x "
            f"{code_table.shape[0]} channels from acquisition: logs "
            f"{verdict} (max|float diff| {err:.3e}); kernel {k_ms:.3f} ms "
            f"({n_upd * m / k_ms:.1f}x real time, "
            f"{k_ms / n_upd * 1e3:.2f} us an update), plain {p_ms:.1f} ms "
            f"[{card}]")
        if m == 4:
            out = dict(ms=k_ms, plain_ms=p_ms, device_ms=kernel_device_ms(
                kernel, 3, "track_window_kernel"),
                bound=track_bound(n_upd, m * 2500, raw, code_table, lfk,
                                  lik))
    out["err"] = max(errs)
    return out


def check_batched(st0, samples, hand, code_table, card):
    """Phase 15: K4's batch_k = 4 schedule against its plain version on the
    path's 2000 ms chunk, then the receiver's batch_k path. Returns the K4
    batch_k entry."""
    dev = code_table.device
    n = TRACK_MS
    raw = torch.from_numpy(samples[:n * 2500].view(np.int16)
                           .reshape(n, 2500, 2).copy()).to(dev)

    def kernel():
        return tracking.track_chunk_packed(st0, raw, code_table, FS, FCAID,
                                           batch_k=4)

    _, lfk, lik = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lfp, lip = tracking.track_chunk_batched_plain(st0, raw, code_table,
                                                     FS, FCAID, batch_k=4)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    rows = {k: i for i, k in enumerate(tracking.LOG_F_ROWS)}
    verdict, err = compare_logs(lfk.cpu().numpy(), lik.cpu().numpy(),
                                lfp.cpu().numpy(), lip.cpu().numpy(), rows)
    k_ms = cuda_ms(kernel, 5)
    d_ms = kernel_device_ms(kernel, 3, "track_window_kernel")
    log(f"K4 batch_k=4: {n} steps x {code_table.shape[0]} channels from "
        f"acquisition: logs {verdict} (max|float diff| {err:.3e}); kernel "
        f"{k_ms:.3f} ms ({n / k_ms:.1f}x real time), plain {p_ms:.1f} ms "
        f"[{card}]")

    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), hand.prn_list,
                        device=dev)
    rx.state = st0
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rx.track(TRACK_MS, batch_k=4)
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()["track_chunk_batched"]
    assert launches == 1 and rx.mcount == TRACK_MS, (launches, rx.mcount)
    lock = np.array([rx.channels[p].col("lock")[-1] for p in hand.prn_list])
    assert (lock == 1).all(), lock
    log(f"batch_k path: ScalarReceiver.track({TRACK_MS}, batch_k=4) from "
        f"acquisition: {launches} launch, 8/8 channels in lock at the end, "
        f"wall {wall:.3f} s ({TRACK_MS * 1e-3 / wall:.1f}x real time) "
        f"[{card}]")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, device_ms=d_ms,
                launches=launches,
                bound=track_bound(n, 2500, raw, code_table, lfk, lik))


def check_windows(samples, hand, dev, card):
    """Phase 16: K3's windows mode against its plain version, 20 windows x
    8 channels at the handoff phases. Returns the K3 windows entry."""
    w = 20
    tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)
                           ).to(dev)
    raw = torch.from_numpy(samples[:w * 2500].view(np.int16)
                           .reshape(w, 2500, 2).copy()).to(dev)
    args = [torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in
            (hand.rc, np.asarray(hand.fc) - F_CA, hand.ri, hand.fi)]

    def kernel():
        return track.correlate_windows_cuda(raw, *args, tab, FS)

    def plain():
        return tracking.track_open_loop_plain(*args, raw, tab, FS)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert torch.equal(got, want), err
    k_ms, p_ms = cuda_ms(kernel, 100), cuda_ms(plain, 3)
    d_ms = kernel_device_ms(kernel, 20, "correlate_window_kernel")
    c = tab.shape[0]
    bnd = bound(w * c * (2500 * OPS_PER_SAMPLE_CHANNEL + 60),
                tensor_bytes(raw, tab, *args, got)
                + 2500 * 4)                              # the time table
    log(f"K3 windows mode: {w} windows x {c} channels, bit-equal to the "
        f"plain recurrence and combine; wrapper {k_ms:.4f} ms, kernel's own "
        f"{fmt_ms(d_ms)}, plain {p_ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}) [{card}]")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, device_ms=d_ms, bound=bnd)


def check_coherent_cold_start(samples, hand, arr, dev, card):
    """Phase 17: acquire -> track(36 000, coh_ms=4) -> LNAV -> PVT. Returns
    K4 coherent launches."""
    prns = list(hand.prn_list)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), prns,
                        loops=tracking.cadence_loops(4), device=dev)
    res = rx.acquire(verbose=False)
    t1 = time.perf_counter()
    rx.track(36_000, coh_ms=4)
    t2 = time.perf_counter()
    good = rx.decode_ephemerides(verbose=False)
    _, _, x_ecef, _, _ = rx.nav_solution()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    assert all(r.found for r in res), "acquisition"
    assert sorted(good) == sorted(prns), good
    for e in arr.ephs:
        dec = rx.channels[e.prn].ephemeris
        assert abs(dec.sqrt_A - e.sqrt_A) < 1e-3, e.prn
        assert abs(dec.M_0 - e.M_0) < 1e-8, e.prn
    pvt_m = float(np.linalg.norm(x_ecef[:3] - hand.x_ecef[:3]))
    assert pvt_m < 15.0, pvt_m
    assert counts["track_chunk_coherent"] == 18, counts
    assert counts["track_chunk"] == 0 and rx.mcount == 9000, counts
    rtfs = sorted(n * 1e-3 / w for n, w in rx.chunk_walls)
    log(f"coherent cold start (coh_ms=4, Bn_carr 12 Hz + FLL 3 Hz): 8/8 "
        f"acquired, 8/8 ephemerides, scalar PVT {pvt_m:.2f} m; TTFF wall "
        f"{wall:.3f} s (acquire {t1 - t0:.3f} s, track {t2 - t1:.3f} s) for "
        f"36.0 s of signal; {rx.mcount} updates in {len(rtfs)} chunks, "
        f"real-time factor per chunk median {float(np.median(rtfs)):.1f}x "
        f"[min {rtfs[0]:.1f}, max {rtfs[-1]:.1f}]; launches {counts} "
        f"[{card}]")
    return counts["track_chunk_coherent"]


def check_weak_start(dev, card):
    """Phase 18: deep acquisition and coherent tracking at 27 dB-Hz, held
    to the JAX package's run of the same sequence on the CPU. Returns K4
    coherent launches."""
    ref = json.loads(WEAK_REF.read_text())
    samples, hand, _ = make_capture(ref["seconds"], ref["cn0_dbhz"])
    assert hashlib.sha256(samples.tobytes()).hexdigest() == ref["sha256"], \
        "the weak capture differs from the reference's"
    m = ref["coh_ms"]
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), hand.prn_list,
                        loops=tracking.cadence_loops(m), device=dev)
    rx.acquire(deep_ms=ref["deep_ms"], n_coh_ms=ref["n_coh_ms"],
               verbose=False)                          # warms the shapes
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = rx.acquire(deep_ms=ref["deep_ms"], n_coh_ms=ref["n_coh_ms"],
                     verbose=False)
    t1 = time.perf_counter()
    rx.track(ref["track_ms"], coh_ms=m)
    t2 = time.perf_counter()
    launches = _build.launch_counts()["track_chunk_coherent"]
    assert launches == 1, launches
    n_per = int(FS * 1e-3) * ref["n_coh_ms"]
    bin_hz = FS / (8 * (1 << n_per.bit_length()))
    worst = dict(fi_acq=0.0, fi=0.0, lock=0, cp=0)
    for r in res:
        want = ref["prns"][str(r.prn)]
        ch = rx.channels[r.prn]
        assert r.found == want["found"] and r.rc == want["rc"], (r, want)
        worst["fi_acq"] = max(worst["fi_acq"], abs(r.fi - want["fi_acq"]))
        worst["fi"] = max(worst["fi"], float(np.abs(
            ch.col("fi") - np.array(want["fi"])).max()))
        worst["lock"] += int((ch.col("lock") != np.array(want["lock"])).sum())
        worst["cp"] += int(ch.col("cp")[-1] != want["cp_end"])
    n_found = sum(r.found for r in res)
    n_lock = sum(int(rx.channels[r.prn].col("lock")[-1]) for r in res)
    log(f"weak start at {ref['cn0_dbhz']:.0f} dB-Hz: deep acquisition "
        f"({ref['deep_ms']} ms, {ref['n_coh_ms']} ms coherent, "
        f"{len(deep_dopplers(ref['n_coh_ms']))} Dopplers) {n_found}/8 found, "
        f"found/rc equal to the JAX package's, fi within "
        f"{worst['fi_acq']:.2f} Hz (one bin {bin_hz:.2f} Hz), {t1 - t0:.3f} "
        f"s; track({ref['track_ms']}, coh_ms={m}) {t2 - t1:.3f} s, "
        f"{n_lock}/8 in lock at the end: against the JAX run (op by op) fi "
        f"within {worst['fi']:.2e} Hz over all {rx.mcount} updates (limit "
        f"0.1), lock flags differing in {worst['lock']} updates, final cp "
        f"differing in {worst['cp']} channels; {launches} K4 launch "
        f"[{card}]")
    assert worst["fi_acq"] <= bin_hz * 1.001, worst
    assert worst["fi"] < 0.1 and worst["lock"] == 0 and worst["cp"] == 0, \
        worst
    return launches


def check_vector(samples, hand, arr, rx_cold, dev, card):
    """Phase 19: 50 vector epochs from the truth handoff and from
    from_scalar after the cold start. Returns K3 windows-mode launches."""
    launches = 0
    for name, make in (
            ("from the truth handoff", lambda: VectorReceiver(
                SampleFile(samples=samples, fs=FS), hand.prn_list,
                copy.deepcopy(arr), hand.x_ecef, hand.rx_time, cp=hand.cp,
                rc=hand.rc, fc=hand.fc, fi=hand.fi, ri=hand.ri, device=dev)),
            ("from_scalar after the cold start",
             lambda: VectorReceiver.from_scalar(rx_cold))):
        vt = make()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        fixes = vt.run(50)
        wall = time.perf_counter() - t0
        n = _build.launch_counts()["correlate_windows"]
        assert n == 50, n
        launches += n
        err = fix_errors(fixes, hand.x_ecef)
        assert np.isfinite(err).all()
        med = float(np.median(err))
        assert med < 20.0, (name, med)
        log(f"vector tracking {name}: 50 epochs of 20 ms, {n} K3 "
            f"windows-mode launches, error median {med:.2f} m (limit 20) "
            f"max {float(err.max()):.2f} m, wall {wall:.3f} s "
            f"({50 / wall:.1f} epochs/s, {50 * 0.02 / wall:.2f}x real time) "
            f"[{card}]")
    return launches



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    for name, (lib, sec) in build_all().items():
        log(f"build: {name} -> {lib.name} in {sec:.2f} s")
    log(f"tracking kernel: {track.kernel_design()}")

    grid = spread_grid()
    cw, vw = dpe_ops.auto_windows(grid.d_enu, grid.dt_m, grid.dv_enu,
                                  grid.dtdot, FS, CARR_FFTPTS)
    widths = {"pos": cw, "vel": vw}
    k1 = check_scorer(grid, widths, dev)
    log(f"scorer: kernel == plain in all 16 cases and at N=10 (max|best "
        f"diff| {k1['err']:.3e}); per dispatch (pos W={cw} + vel W={vw}, "
        f"G={grid.n_pos}): N=50 wrapper {k1['ms']:.4f} ms, kernel's own "
        f"{fmt_ms(k1['device_ms'])}, plain {k1['plain_ms']:.4f} ms; N=10 "
        f"wrapper {k1['ms10']:.4f} ms, kernel's own "
        f"{fmt_ms(k1['device_ms10'])} [{card}]")
    k1_sum = check_block_sum(grid, widths, dev, card)

    t0 = time.perf_counter()
    samples, hand, arr = make_capture(CAPTURE_S)
    log(f"capture: {CAPTURE_S:.0f} s synthesized in "
        f"{time.perf_counter() - t0:.1f} s")
    first = samples[:S * 600]        # 500 timed and warm-up blocks + 100
    rel = check_dispatch(first, hand, arr, grid)
    log(f"dispatch: card == cpu on 5 blocks (indices, flips equal; "
        f"windows rel diff {rel:.2e})")

    rx = receiver(first, hand, arr, grid, dev)
    raw_dev = torch.from_numpy(first.view(np.int16).reshape(-1, S, 2)
                               ).to(dev)
    run = dict(lookahead=N_BLOCKS, raw_blocks_dev=raw_dev, pipeline=True,
               pipeline_depth=4)
    t0 = time.perf_counter()
    rx.run_batched(50, start_block=0, **run)
    rx.run_batched(50, start_block=50, group_k=5, **run)
    torch.cuda.synchronize()
    log(f"warm-up: 100 blocks in {time.perf_counter() - t0:.2f} s")
    n_warm = len(rx.fixes)

    segments = []
    _build.reset_launch_counts()
    for name, start, group_k in (("per-block", 100, 1),
                                 ("grouped K=5", 300, 5)):
        before = _build.launch_counts()["score_argmax"]
        n_fix0 = len(rx.fixes)
        t0 = time.perf_counter()
        rx.run_batched(200, start_block=start, group_k=group_k, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()["score_argmax"] - before
        fixes = rx.fixes[n_fix0:]
        assert launches == 2 * (200 // N_BLOCKS), (name, launches)
        assert len(fixes) == 200 // group_k, (name, len(fixes))
        err = np.array([np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3])
                        for f in fixes])
        assert np.isfinite(err).all()
        med, p95 = float(np.median(err)), float(np.percentile(err, 95))
        assert med < 15.0, (name, med)
        segments.append(wall)
        log(f"main path {name}: 200 blocks, {launches} kernel launches "
            f"({200 // N_BLOCKS} dispatches), {len(fixes)} fixes, error "
            f"median {med:.2f} m p95 {p95:.2f} m, wall {wall:.3f} s, "
            f"{200 * T / wall:.2f}x real time [{card}]")
    k1_launches = _build.launch_counts()["score_argmax"]
    assert k1_launches > 0 and len(rx.fixes) == n_warm + 240
    total = sum(segments)
    log(f"main path: 400 blocks in {total:.3f} s, {400 * T / total:.2f}x "
        f"real time [{card}]")
    for name, start, group_k in (("per-block", 500, 1),
                                 ("grouped K=5", 550, 5)):
        device_record(
            f"one 50-block dispatch, {name}",
            lambda: rx.run_batched(50, start_block=start, group_k=group_k,
                                   **run), "score_kernel", card)
    del raw_dev, rx

    k3 = check_correlator(dev, card)
    st0, raw0, table0 = tracker_inputs(samples, hand, dev)
    k4 = check_tracker(st0, raw0, table0, card)
    del raw0
    k2 = check_surface(grid, widths, dev, card)
    counts, k4_steps, rx_cold = check_cold_start(samples, hand, arr, grid,
                                                 dev, card)

    k1_by_path = {"batched": k1_launches}
    k1_by_path["integrated"] = check_integrated(samples, hand, arr, grid,
                                                dev, card)
    k1_by_path["survey"] = check_survey(samples, hand, arr, grid, dev, card)
    k1_by_path["refined"] = check_refined(samples, hand, arr, grid, dev,
                                          card)
    assert all(n > 0 for n in k1_by_path.values()), k1_by_path

    k4c = check_coherent(st0, samples, table0, card)
    k4b = check_batched(st0, samples, hand, table0, card)
    k3w = check_windows(samples, hand, dev, card)
    k4c_by_path = {"coherent cold start": check_coherent_cold_start(
        samples, hand, arr, dev, card)}
    k4c_by_path["weak start"] = check_weak_start(dev, card)
    k3w_launches = check_vector(samples, hand, arr, rx_cold, dev, card)

    # no single PyTorch call computes any of these functions: library_ms is
    # null throughout
    rows = [("K1", sum(k1_by_path.values()), k1),
            ("K2", counts["score_surface"], k2),
            ("K3", counts["correlate_window"], k3),
            ("K4", counts["track_chunk"], k4),
            ("K4 coherent", sum(k4c_by_path.values()), k4c),
            ("K4 batch_k", k4b.pop("launches"), k4b),
            ("K3 windows", k3w_launches, k3w)]
    kernels = [dict(KERNELS[k], launches=n, max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], **r["bound"], library_ms=None,
                    device_ms=r["device_ms"]) for k, n, r in rows]
    kernels[4]["launches_by_path"] = k4c_by_path
    kernels[0].update(ms_n10=k1["ms10"], device_ms_n10=k1["device_ms10"],
                      launches_by_path=k1_by_path, **k1_sum)
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms against a bound of "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']}; "
            f"{100.0 * k['bound_ms'] / k['ms']:.2f} % of it) [{card}]")
    # the cold-start path launches K3 standalone no time: its body runs as
    # K4's device code, once per tracked 1 ms step of each K4 launch
    kernels[2]["steps_inside_track_chunk"] = k4_steps
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
