#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (navlab_dpe_sdr_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

Phases, one line or more each (any failure raises and exits non-zero):
1. the card: nvidia-smi name and power limit;
2. build the port's CUDA kernels from ops/csrc, the four sources at once
   (an nvcc each), and time each build;
3. K1 (score_argmax) against its plain PyTorch version on the card at the
   batched path's shapes (N=50 blocks, C=8 channels, the spread grid's
   390 625 points per manifold, code/carrier windows of the receiver),
   every case of manifold x l_power x interp x weighted, with both times
   (CUDA events around the wrapper, and the kernel's own time from
   torch.profiler), the grouped path's N=10 and the receiver's default
   lookahead N=25 (the CLI's `live`), each a launch plan of its own;
4. one fused dispatch on the card against the same dispatch on the CPU;
5. the batched main path: DPEReceiver.run_batched on the first 10 s of a
   40 s synthetic capture held on the card as int16 [B, S, 2]: 100 warm-up
   blocks, 200 blocks per block (lookahead 50, pipeline depth 4), 200 blocks
   in coherent groups of 5; K1 and K5 launch counts, fix errors against
   truth, wall time and real-time factor; then, outside the timed
   segments, one more dispatch of each kind under torch.profiler: kernel
   launches, device-busy ms and its share of the wall, K1's and K5's
   device ms;
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
   K2/K3/K4/K5 launch counts, errors, TTFF wall, tracking real-time factor
   (K5 once a step); then one more per-block step under torch.profiler
   (launches, device-busy ms, K2's and K5's device ms);
10. (run right after phase 3, before the capture is made) K1's
   block-summed modes (score_argmax(block_sum=True): the scores of all
   blocks summed per grid point inside the kernel, one thread block a
   tile) against their plain version: bit-equal best, equal first index,
   weighted sums bitwise equal across two runs, on the spread grid at N=8
   (the integrated fix), N=50 and N=25 (the survey's coarse joint pass),
   and on a grid=2 and a grid=4 mesh rank's rows of that grid (191 and 96
   tiles), each with the kernel's own time; N = 2, 7, 13 and 64, offsets
   4 bytes off a 16-byte boundary; exact ties across tiles (the grid laid
   out twice), within a thread's points (every point twice in a row) and
   across threads (the same, one point on); on the dense grid (2 x 75^4
   points, the reference's cap) at N=16 with l_power 1 and 2 and at N=1
   (the coherent run's launch: its blocks are summed before the scorer);
   the survey's zoom lattice (33^4 points, 25 epochs), quadratic and sinc
   (sinc within rtol 1e-5, argmax equal or a tie within 1e-6);
11. integrated DPE: run_integrated noncoherent on the spread grid (8 blocks
   a fix, 25 fixes), coherent on the dense grid (16 blocks a fix, 12
   fixes), and the first again read from the SampleFile through the
   read-ahead thread (fixes identical); K1 and K5 launches, errors, wall,
   real-time factor, and the device side of one profiled fix;
12. the survey: run_survey over 25 s (25 batches of 50 blocks), coherent,
   default fine lattice, a warm-up run, then one timed run and one with
   sinc zoom passes (their K1 and K5 launches are the ones counted); errors
   against
   truth; the wall split (pass, coarse, zoom) from one more run of each,
   synchronized after every stage;
13. run_batched with refine="newton" and ekf_mode="full": 200 blocks, the
   rows carrying the score windows;
14. K4's coherent mode against its plain version from the acquisition
   state (K4's limits of phase 7), 8 channels: m = 2, 8, 10 code periods a
   window over 200 updates, m = 4 on the coherent cold start's 2000 ms chunk
   (500 updates); each with the kernel's own time (torch.profiler) and the
   clock64() split of an update (one more launch with the clock buffer);
15. K4's batch_k = 4 schedule against its plain version on one 2000 ms
   chunk, with its own time and the clock split of a step; batch_k = 2, 3,
   5, 8 against plain over 240 steps (the kernel's other pass shapes);
   then ScalarReceiver.track(2000, batch_k=4) from the acquisition state;
16. K3's windows mode (the open-loop correlation of vector tracking)
   against its plain version, bit-equal, one launch a call: 20 windows x 8
   channels (the vector epoch) with the phases as four vectors and as the
   columns of one [C, 4] tensor, and 1 and 40 windows, each timed; 2, 20
   and 40 windows of 2500 and 2501 samples, int16 and float32, 1, 8 and 12
   channels;
17. the coherent cold start: acquire -> track(36 000, coh_ms=4) with the
   CLI's coherent loop defaults -> 8/8 ephemerides -> scalar PVT within
   15 m; TTFF wall and tracking real-time factor per chunk;
18. the weak start: 2 s of the scenario at 27 dB-Hz, deep acquisition
   (deep_ms=400, n_coh_ms=10) and track(2000, coh_ms=8), held to the JAX
   package's run of the same sequence on the CPU
   (tools/weak_start_reference.json, written by
   tools/weak_start_reference.py): found and the code bins to the JAX
   search's, the fine frequency and carrier phase to the port's search on
   the CPU, and the track, started where the JAX tracker started (the CPU
   search's results), op by op to the JAX tracker's over its first 100
   updates and in its final cp; the acquired and tracked Dopplers also to
   the scenario's truth; then its decode on 32.5 s at the same level:
   tracking 30 s then 2 s, a decode after each (the weak cold start's
   attempts), every channel too short to frame at 30 s with no soft work,
   8/8 by the soft pass at 32 s in one bit-loop launch, the ephemerides
   equal to the plain host decode's on the same logs; the decode's ms per
   attempt; then the bit loop kernel alone on the 8 channels' bit sums,
   its decisions equal to the plain loop's (`navbits._loop` forward then
   backward) and each pass's end within 1e-9, and its time against the
   plain loop's for the kernels line;
19. VectorReceiver for 50 epochs from the truth handoff and from
   from_scalar after phase 9's cold start: median error under 20 m,
   epochs per second, one K3 windows-mode launch an epoch;
20. the FFT engine, DPEConfig(engine="fft"): one block on the card against
   the CPU (argmaxes and flips equal, correlations and surfaces within
   1e-5 of their peak, the flip decision's closest call), run_batched and
   run_integrated refused, 50 timed per-block steps from the truth handoff
   (median under 15 m), one profiled step;
21. the receiver fleet: two receivers over the capture and the capture
   started 7 ms later, acquire -> track(34 000) in parallel -> 8/8
   ephemerides -> align (offsets ~[7, 0], one 1 ms K4 launch a millisecond
   of offset) -> run_dpe(200, lookahead=50) in parallel, the same run with
   parallel=False twice and in parallel again: offsets, logs and fixes
   bit-equal; TTFF per receiver, walls, the aggregate real-time factor;
22. the live fleet: ReceiverFleet.from_live over two paced SimulatedRadios
   (1.9 s, seeded ephemerides, run_dpe(5)), its live_stats();
23. the Monte-Carlo harness at full width: perturbation_sweep (8 runs x 50
   blocks, the 50-80 m band), spacing_sweep (3 spacings x 50 blocks),
   cn0_sweep ([45, 30] dB-Hz, 32 blocks, 8 a fix), weak_sweep (27 dB-Hz,
   128 blocks); the convergence summaries and walls;
24. the command line (navlab_dpe_sdr_tpu_torch/cli.py) through cli.main in
   this process, on the capture written to a temporary file with its truth
   handoff: acquire (8/8), track 34 s (8/8 ephemerides, scalar fix within
   15 m, handoff and checkpoint), track 36 s with --coh-ms 4 and with
   --batch-k 4 (the same limits), dpe batched from that handoff (lookahead
   50, group_k 5, depth 4, 200 blocks: median within 15 m), per block with
   the native streamer, the X_ECEF log and a profiler trace, integrated (8
   blocks a fix), the batched and integrated CSVs each equal, to the CSV's
   print precision, to the same receiver and mode driven through the
   Python API, survey from the truth handoff as phase 12 (E and N
   within 1.5 m), vt (50 epochs after a 34 s
   pull-in), live over the simulated radio (no real-time miss), a live
   fleet of two simulated radios warmed up and run to its decode-failed
   branch (1 s), the console from a dofile; one "CLI ..." line each (wall,
   signal, launches, error);
   then `python -m navlab_dpe_sdr_tpu_torch dpe` in a fresh interpreter
   (exit 0, iteration 1's time against the 1.5 s watchdog);
25. the mesh (navlab_dpe_sdr_tpu_torch/parallel), in child processes of
   this script (`--mesh-child`; this process keeps no process group), on
   phase 5's 12 s and truth handoff at full width: (a) NCCL at world size
   1: phase 5's batched sequence, its fixes equal to phase 5's to the bit,
   the collectives per dispatch; then `python -m
   navlab_dpe_sdr_tpu_torch.parallel.launch --bench-only` (one rank: a
   single-device reading, no scaling number); (b) two gloo ranks sharing
   cuda:0 on grid=2: the batched sequence, run_integrated (25 fixes of 8),
   20 per-block steps, 10 FFT-engine steps, a 4-batch survey, and on
   chan=2 x grid=1 run_batched(50); every dispatch that splits blocks or
   channels is held to the same call on one device with the same inputs
   (windows equal to the bit, flips equal, argmaxes equal or, with the
   channels split, a proven tie), and each run's fixes equal on both ranks
   and equal one device's run (phase 5's for the batched sequence) to the
   bit over every fix (with the channels split: within 1e-6 up to the
   first proven tie, and within one step of the spread grid after it);
   rank 1's K1 slice against its plain version; per run the wall, the
   collectives and their host ms, the launches by kernel, the audit and
   every rank's last fix; (c) on one card, every dispatch of the batched
   sequence, run_integrated and the survey correlated whole and as 2, 3
   and 4 grid ranks would share its blocks, held as in (b): no window
   element may differ and no argmax turn ("mesh ..." lines);
26. (run last, on the capture's first 50 blocks) K5, the
   windowed correlator, against its plain version at the main path's
   shapes (N = 50, 8, 1; magnitude and complex; int16 and float32
   samples): windows within 1e-5 of each channel's window maximum, flips
   and code argmaxes equal; the same blocks correlated as 2, 3, 4 and 50
   grid ranks share them and over 4 of the 8 channels, equal to the bit;
   wrapper, kernels' own and plain ms, and the bound ("K5 ..." lines);
27. (run after phase 24, before phase 25) the port's bench
   (navlab_dpe_sdr_tpu_torch/bench.run, bench.py's protocol) on the 40 s
   capture: both dispatch signatures warmed, then 3 passes of 100 warm-up
   blocks, 200 per-block blocks and 1700 in coherent groups of 5 (lookahead
   50, depth 4), the scalar segment (K4 over four 2000 ms chunks), TTFF
   twice (acquire -> track to 8/8 ephemerides within the capture ->
   handoff -> first fix) and the parity block (K5 against the direct
   correlator, K1 against plain over 4096 grid points): its JSON on a
   "bench: ..." line, every key of bench.py's JSON present, both segments'
   median error and the first fix under 15 m, 8/8 ephemerides, the
   correlator's max rel diffs under 1e-5 with flips and code argmaxes
   equal, and K1's under 1e-5;
28. (run after phase 27, before phase 25) the moving receiver at full
   width: the dynamics envelope (tools/dynamics_envelope_torch.run_cell:
   walk, vehicle and clock profiles of 10 s, depth {1, 4} x group_k {1,
   5}, the spread grid, lookahead 50; walk and clock held in every cell,
   the vehicle at depth 1 x K 1, its other cells beside DYN_r05's
   verdicts), the vehicle per block (50 steps), the maneuver (the full
   EKF's RMS under 5 m and 0.85 x alpha's; RTS-smoothed under 0.85 x the
   forward run's and 4.8 m), K4 PLL-only and FLL-assisted on the 250 Hz/s
   Doppler ramp; then K5, K1 and K2 held to their plain versions on the
   inputs that path gave them (recorded as it called them), K4's ramp logs
   to track_chunk_plain (PLL-only off the ramp by more than 100 Hz,
   FLL-assisted within 25 Hz), and a paced 10 s live run through
   tools/live_run_torch.py with no real-time miss ("dynamics ..." lines);
29. (run after phase 28, before phase 25) card against CPU, block by
   block: the maneuver's run_batched(60, lookahead=10) under the alpha
   filter and the full EKF, phase 5's capture for 100 blocks per block
   and 100 in coherent groups of 5, and DPEReceiver.run(50) on the
   vehicle profile, each once on the card and once on the CPU from the
   same inputs on the spread grid, every K5, K1 and K2 call recorded on
   both; every card call's inputs through the kernel on the card and the
   plain version on the CPU (K5 within 1e-5 of each channel's maximum,
   flips and code argmaxes equal; K1 and K2 argmax equal or a tie held on
   both surfaces); then the free-running runs, cells equal and fixes
   within 1e-6 m (alpha) or 1e-3 m (full EKF) up to the first parting,
   which must be a float32 near-tie ("card vs CPU ..." lines);
30. (run right after phase 10) K1's factored kernel (score_argmax with a
   product grid's `grid_factors`) against the per-point kernel on the same
   inputs: the spread 25^4 and the dense 75^4 grids, both manifolds, the
   argmax and block-summed modes, quadratic and linear, N = 1, 10 and 50,
   then l_power 2 and 3 and a mesh rank's run-aligned rows on the spread
   grid; best and argmax equal to the bit, each launch under its own
   count; the dense grid's N = 1 launches (25 clock values a thread) equal
   to the plain version's bits; the weighted modes with factors launch the
   per-point kernel; and the kernel's own time a launch, per-point against
   factored, at dense N = 50 and spread N = 10 and 50 ("factored ..."
   lines). Phase 3 holds the main path's factored calls to the plain
   version and times them for the kernels line. Phase 5 then asserts that
   its run_batched passes on the spread grid launch K1 factored only.
Each path is driven with the launch counts set to 0 just before it and
read just after.

Phase 5's run and every device record come from profile_dispatch.py, which
also runs phase 5 alone against any tree (`--tree DIR`), so two trees are
read by one routine.
The line before the last is the kernels' JSON record (launches on the
timed paths, and by path in launches_by_path, the CLI's, the mesh's and
the dynamics phase's and the card-against-CPU phase's included; error
against the plain version, ms, plain ms, the roofline
bound of the same work and what sets it, library_ms: null where no single
PyTorch call computes the function, device_ms: the kernel's own time from
torch.profiler, null if the profiler showed none); the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import io
import itertools
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch


from navlab_dpe_sdr_tpu_torch import bench, cli, tracing
from navlab_dpe_sdr_tpu_torch.constants import F_CA, F_L1
from navlab_dpe_sdr_tpu_torch.io.handoff import read_handoff, write_handoff
from navlab_dpe_sdr_tpu_torch.io.printer import FixWriter
from navlab_dpe_sdr_tpu_torch.io.frontend import (MultiSource,
                                                  RadioSyncConfig,
                                                  SimulatedRadio)
from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu_torch.io.scenario import make_scenario
from navlab_dpe_sdr_tpu_torch.io.synth import (CaptureSimulator,
                                               release_workspace)
from navlab_dpe_sdr_tpu_torch.libgnss.cacode import ca_code, ca_table
from navlab_dpe_sdr_tpu_torch.libgnss import frames
from navlab_dpe_sdr_tpu_torch.models.grid import (_mesh4, dense_grid,
                                                  spread_grid)
from navlab_dpe_sdr_tpu_torch.models import montecarlo
from navlab_dpe_sdr_tpu_torch.models.dpe import (DPEConfig, DPEReceiver,
                                                 device_state)
from navlab_dpe_sdr_tpu_torch.models.fleet import ReceiverFleet
from navlab_dpe_sdr_tpu_torch.models import navbits
from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
from navlab_dpe_sdr_tpu_torch.runtime import flow
from navlab_dpe_sdr_tpu_torch.models.vector import VectorReceiver
from navlab_dpe_sdr_tpu_torch.ops import _build, correlate, score, track
from navlab_dpe_sdr_tpu_torch.ops import tracking
from navlab_dpe_sdr_tpu_torch.ops import dpe as dpe_ops
from navlab_dpe_sdr_tpu_torch.ops import dpe_real
from navlab_dpe_sdr_tpu_torch.ops.acquisition import deep_dopplers
from profile_dispatch import (K1_K5, TAKES, card_line, clock_parts, cuda_ms,
                              dispatch_record, k5_clock_split, k5_inputs,
                              kernel_device_ms, record_line)
from profile_dispatch import main_path as dispatch_main_path

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tools"))
import dynamics_envelope_torch as dyn_env  # noqa: E402

SEED = 20261016
FS = 2.5e6
S = 50000
CARR_FFTPTS = 8 * (1 << S.bit_length())
N_BLOCKS = 50          # blocks per dispatch on the main path (lookahead)
T = 0.02               # seconds per block
CAPTURE_S = 40.0       # the LNAV wait needs >= 36 s of signal
TRACK_MS = 2000        # one K4 chunk
# the fleet: 34 s tracked (8/8 ephemerides decode by 32 s) + the 7 ms
# alignment + 200 DPE blocks fit the 40 s capture, also for the receiver
# that starts 7 ms into it
FLEET_TRACK_MS = 34_000
FLEET_DPE_BLOCKS = 200
SCORE_SRC = "navlab_dpe_sdr_tpu_torch/ops/csrc/score_argmax.cu"
TRACK_SRC = "navlab_dpe_sdr_tpu_torch/ops/csrc/track_chunk.cu"
CORR_SRC = "navlab_dpe_sdr_tpu_torch/ops/csrc/windowed_correlate.cu"
NAVBITS_SRC = "navlab_dpe_sdr_tpu_torch/ops/csrc/navbits_loop.cu"
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
# sinc, in the form the kernel computes (sin(pi (x - k)) = (-1)^k
# sin(pi x)): the index (13 with the curvature term, 9 without), one sine
# (counted as one operation) and its scale by 1/pi, and the channel sum;
# then per tap a subtraction, a reciprocal and a multiply-add. (A sine and a
# division in every tap, the direct form, would be 6 a tap.)
OPS_SINC = {"pos": (16, 4), "vel": (12, 4)}       # (fixed, per tap)
OPS_PER_SAMPLE_CHANNEL = 60
# K5, per (block, channel), from the plain version's algebra: the folds 8 a
# sample (4 multiply-adds), and 8 more a sample of the periods after the
# nav-bit boundary's; the lags 16 a (lag, tau) (the whole and the tail
# folds, re and im); the lag-0 sums 8 a tau; the wipe 4 a sample; the
# carrier DFT 8 a (bin, sample) (z = A yb: 4 multiply-adds a complex
# product). The twiddles' sines, the rotation and the arc are left out.
OPS_K5 = dict(fold=8, tail=8, lag=16, lag0=8, wipe=4, dft=8)
# K1's launch keys (ops/_build.py), per block and block-summed: on a
# product grid's factors the receiver's calls launch the factored kernel
K1_KEYS = ("score_argmax", "score_argmax_factored")
K1_SUM_KEYS = ("score_argmax_sum", "score_argmax_sum_factored")


def k1_count(counts: dict, keys=K1_KEYS) -> int:
    """K1's launches in a launch_counts() dict, under any of `keys`."""
    return sum(counts.get(k, 0) for k in keys)


KERNELS = {
    "K1": dict(name="score_argmax", route="cuda", source=SCORE_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_score.py:166"),
    "K1 block-summed": dict(name="score_argmax_sum", route="cuda",
                            source=SCORE_SRC,
                            replaces="navlab_dpe_sdr_tpu/ops/pallas_score.py"
                                     ":166"),
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
    "K5": dict(name="windowed_correlate", route="cuda", source=CORR_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/dpe_real.py:420"),
    "navbits loop": dict(name="navbits_loop", route="cuda",
                         source=NAVBITS_SRC, replaces=None),
}

WEAK_REF = pathlib.Path(__file__).resolve().parent / "tools" / \
    "weak_start_reference.json"
OP_BY_OP = 100    # weak-start updates held op by op (the tracking tests' tier)
WEAK_DECODE_S = 32.5   # the weak decode's capture: the 30 s and 32 s attempts
FCAID = F_CA / F_L1


def log(msg: str) -> None:
    print(msg, flush=True)


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


def device_record(what: str, fn, kernels, card: str) -> None:
    """Log the device side of one fn() outside the timed segments
    (profile_dispatch.dispatch_record: the third of three calls):
    kernel launches, device-busy ms and its share of the wall, and the
    device ms of the kernels whose names hold each of `kernels` (a name or
    a tuple), every one of which fn launches."""
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    log(record_line(what, dispatch_record(fn, kernels), card))


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
    """Phase 3: kernel vs plain on the card, every case, each call as the
    receiver makes it: with the grid's `grid_factors` (the factored kernel
    in the argmax mode, the per-point kernel in the weighted mode). Returns
    a dict: err (max |best diff|), and per dispatch (both manifolds,
    quadratic, l_power 1, argmax: the main path's calls, factored) ms and
    plain_ms from CUDA events around the wrappers, device_ms from the
    profiler, the bound, ms10/device_ms10 at the grouped path's N=10, and
    the same calls without factors (the per-point kernel) at N=50:
    ms_per_point/device_ms_per_point."""
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    times = {}
    ops = nbytes = 0
    dev_ms, ms10, dev_ms10 = 0.0, 0.0, 0.0
    ms_pp, dev_ms_pp = 0.0, 0.0
    for manifold in ("pos", "vel"):
        args = scorer_inputs(rng, manifold, widths[manifold], grid, dev)
        f = score.grid_factors(args[5], args[6])
        assert f is not None and f.fits, manifold
        for interp in ("quadratic", "linear"):
            for l_power in (1, 2):
                for weighted in (False, True):
                    kw = dict(interp=interp, l_power=l_power,
                              weighted=weighted)
                    got = score.score_argmax(*args, factors=f, **kw)
                    torch.cuda.synchronize()
                    want = score.score_argmax_plain(*args, **kw)
                    err = compare_scores(args, got, want, kw)
                    max_err = max(max_err, err)
                    line = (f"scorer {manifold} W={widths[manifold]} "
                            f"{interp} l_power={l_power} "
                            f"weighted={weighted}: max|best diff| {err:.3e}")
                    if interp == "quadratic" and l_power == 1:
                        k_ms = cuda_ms(lambda: score.score_argmax(
                            *args, factors=f, **kw), 20)
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
        # the main path's call again for the kernel's own time, the same
        # call without factors (the per-point kernel), and the grouped
        # path's N = 10 (50 blocks in coherent groups of 5)
        d50 = kernel_device_ms(lambda: score.score_argmax(*args, factors=f),
                               10, "score_kernel_factored")
        p50 = cuda_ms(lambda: score.score_argmax(*args), 20)
        dp50 = kernel_device_ms(lambda: score.score_argmax(*args), 10,
                                "score_kernel<")
        args10 = [None if a is None else a[:10].contiguous()
                  for a in args[:5]] + args[5:]
        # and N = 25: the receiver's default lookahead (the CLI's `live`),
        # which has a launch plan of its own
        args25 = [None if a is None else a[:25].contiguous()
                  for a in args[:5]] + args[5:]
        for a_n in (args10, args25):
            got = score.score_argmax(*a_n, factors=f)
            want = score.score_argmax_plain(*a_n)
            max_err = max(max_err, compare_scores(
                a_n, got, want, dict(interp="quadratic", l_power=1,
                                     weighted=False)))
        m10 = cuda_ms(lambda: score.score_argmax(*args10, factors=f), 20)
        d10 = kernel_device_ms(lambda: score.score_argmax(
            *args10, factors=f), 10, "score_kernel_factored")
        m25 = cuda_ms(lambda: score.score_argmax(*args25, factors=f), 20)
        log(f"scorer {manifold} W={widths[manifold]} quadratic l_power=1 "
            f"argmax, factored: kernel's own time N=50 {fmt_ms(d50)} "
            f"(per-point {fmt_ms(dp50)}, wrapper {p50:.4f} ms); N=10: "
            f"kernel == plain, wrapper {m10:.4f} ms, kernel's own "
            f"{fmt_ms(d10)}; N=25: kernel == plain, wrapper {m25:.4f} ms")
        ms10 += m10
        ms_pp += p50
        dev_ms, dev_ms10 = add_ms(dev_ms, d50), add_ms(dev_ms10, d10)
        dev_ms_pp = add_ms(dev_ms_pp, dp50)
    return dict(err=max_err,
                ms=times[("pos", False)][0] + times[("vel", False)][0],
                plain_ms=times[("pos", False)][1] + times[("vel", False)][1],
                device_ms=dev_ms, ms10=ms10, device_ms10=dev_ms10,
                ms_per_point=ms_pp, device_ms_per_point=dev_ms_pp,
                bound=bound(ops, nbytes))


def score_at(args, n: int, cells, kw):
    """score_points of block n of the scorer arguments `args` at the grid
    indices `cells`, on the arguments' device and dtype: [len(cells)]."""
    win, los, cen, coe, r0, off3, off1 = args
    idx = torch.as_tensor(cells, device=off3.device)
    return score.score_points(
        win[n:n + 1], los[n:n + 1], cen[n:n + 1], coe[n:n + 1],
        None if r0 is None else r0[n:n + 1], off3[idx], off1[idx],
        kw.get("interp", "quadratic"), kw.get("l_power", 1))[0]


def compare_scores(args, got, want, kw, ref_args=None, ties=None) -> float:
    """argmax equal (or a tie within 1e-6 relative that holds on both
    surfaces: each side's scores at the other's argmax within 1e-6 of its
    own max), best within rtol 1e-5, weighted means within rtol 1e-4.
    ref_args: the plain version's inputs where they lie on another device
    (the same values); ties: a list that gets (block, kernel argmax, plain
    argmax) of each tie. Returns max |best diff|."""
    best_k, arg_k = got[0].cpu().numpy(), got[1].cpu().numpy()
    best_p, arg_p = want[0].cpu().numpy(), want[1].cpu().numpy()
    np.testing.assert_allclose(best_k, best_p, rtol=1e-5)
    ref_args = args if ref_args is None else ref_args
    for n in np.nonzero(arg_k != arg_p)[0]:
        a, b = int(arg_k[n]), int(arg_p[n])
        for side, cell, best in ((ref_args, a, best_p[n]),
                                 (args, b, best_k[n])):
            s_at = score_at(side, n, [cell], kw).item()
            assert abs(s_at - best) <= 1e-6 * abs(best), (
                f"block {n}: kernel argmax {a} ({best_k[n]}), plain argmax "
                f"{b} ({best_p[n]}); the other side scores {cell} {s_at}")
        if ties is not None:
            ties.append((int(n), a, b))
    if kw.get("weighted"):
        mk = (got[2] / got[3][:, None]).cpu().numpy()
        mp = (want[2] / want[3][:, None]).cpu().numpy()
        np.testing.assert_allclose(mk, mp, rtol=1e-4, atol=1e-6)
    return float(np.abs(best_k - best_p).max())


def hold_k2(a, kw, ref_args=None, ties=None) -> float:
    """K2 (score_surface_argmax) against its plain version on the same
    inputs (ref_args: those inputs on another device): the surface within
    rtol 1e-6 and, per block, the max and its first index equal; with
    `ties` a list, a differing index may instead be a tie that holds on
    both surfaces (each scores the other's index within 1e-6 of its own
    max), appended to ties as (block, kernel's, plain's). Returns max
    |surface diff|."""
    got, best, arg = score.score_surface_argmax(*a, **kw)
    want = score.score_surface_plain(
        *(a if ref_args is None else ref_args), **kw).to(got.device)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    w_best, w_arg = want.max(dim=1)           # the first index at the max
    for n in range(got.shape[0]):
        a_k, a_p = int(arg[n]), int(w_arg[n])
        if a_k == a_p:
            assert float(best[n]) == float(w_best[n]), (n, best, w_best)
            continue
        assert ties is not None, f"block {n}: kernel {a_k}, plain {a_p}"
        for surf, cell, top in ((want, a_k, w_best[n]), (got, a_p, best[n])):
            assert abs(float(surf[n, cell]) - float(top)) <= 1e-6 * abs(
                float(top)), (n, a_k, a_p, float(surf[n, cell]), float(top))
        ties.append((n, a_k, a_p))
    return float((got - want).abs().max())


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


def receiver(samples, hand, arr, grid, device, mesh=None, **cfg):
    return DPEReceiver(SampleFile(samples=samples, fs=FS),
                       copy.deepcopy(hand), grid=grid,
                       eph=copy.deepcopy(arr),
                       config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3,
                                        mesh=mesh, **cfg),
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


def k5_bound(args, out, kw) -> dict:
    """bound() of one K5 call: OPS_K5 at these inputs (the tail periods as
    this call's nav-bit boundaries give them) and the bytes of the inputs
    and outputs, each once."""
    raw_re, raw_im, chips, rc, idx_next, fi, ri, time_idc = args[:8]
    n, s = raw_re.shape
    c = chips.shape[0]
    p0, n_p = kw["period"], kw["n_periods"]
    wc, wv = kw["code_win"], kw["carr_win"]
    p_b = torch.div(idx_next.long(), p0, rounding_mode="floor")
    tail = int(((n_p - 1 - p_b).clamp(0, n_p) * p0).sum())
    o = OPS_K5
    ops = (n * c * ((o["fold"] + o["wipe"] + o["dft"] * wv) * s
                    + (o["lag"] * wc + o["lag0"]) * p0) + o["tail"] * tail)
    nbytes = (tensor_bytes(raw_re, raw_im, chips, time_idc, *out)
              + 6 * n * c * 4)
    return bound(ops, nbytes)


def on_device(args, dev):
    """args with every tensor moved to dev (the rest as it is)."""
    return [x.to(dev) if torch.is_tensor(x) else x for x in args]


def hold_k5(a, kw, ref=None):
    """K5 against its plain version on the correlator's arguments a and
    keywords kw (with ref a device, the plain version on the same inputs
    moved there): windows within 1e-5 of each channel's window maximum,
    flips and code-window argmaxes equal (a channel whose nav-bit boundary
    is sample 0, a degenerate tie, left out). Returns (the worst relative
    difference, max |diff|, flips, channels kept)."""
    keep = a[4] != 0                                   # [n, C]
    got = correlate.windowed_correlate(*a, **kw)
    want = correlate.windowed_correlate_plain(
        *(a if ref is None else on_device(a, ref)), **kw)
    want = type(want)(*on_device(want, got.flip_used.device))
    torch.cuda.synchronize()
    worst = err = 0.0
    for name in got._fields[:-1]:
        g, w = getattr(got, name)[keep], getattr(want, name)[keep]
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        worst = max(worst, float(
            (diff / w.abs().amax(-1, keepdim=True)).max()))
    assert worst < 1e-5, (a[0].shape, kw, worst)
    assert torch.equal(got.flip_used[keep], want.flip_used[keep])
    mags = [torch.hypot(o.code_re, o.code_im) if kw.get("complex_out")
            else o.code_mag for o in (got, want)]
    assert torch.equal(mags[0].argmax(-1)[keep],
                       mags[1].argmax(-1)[keep]), (a[0].shape, kw)
    return worst, err, int(got.flip_used.sum()), int(keep.sum())


def check_k5(first, hand, arr, grid, dev, card):
    """Phase 26 (run last): K5 against its plain version on
    the card at the main path's shapes: the capture's first 50 blocks with
    the parameters the batched receiver prepares for them (windows of
    auto_windows), passed as batch_correlate passes them, at N = 50, the
    integrated fix's N = 8 and the per-block step's N = 1, magnitude and
    complex, from the int16 capture and from float32 samples (the capture
    times 0.3: the kernel's other instance, which the per-block step runs
    on a complex or arg_pi4 block): windows within 1e-5 of each channel's
    window maximum, flips and code-window argmaxes equal (but on a channel
    whose nav-bit boundary is sample 0, a degenerate tie); the 50 blocks
    correlated as 2, 3, 4 and 50 grid ranks share them, and over 4 of the 8
    channels, bit for bit, from either (and how many elements the plain
    version's 25/25 split changes). At each N: CUDA events around the
    wrapper, the kernel's own time from torch.profiler, the plain version,
    the bound and the kernel's share of it, and the clock64() split of one
    more launch (mean thousands of SM clocks a thread block: the code
    phase, up to the code windows out, and the carrier phase; that
    launch's windows must equal the unclocked one's). Returns the kernels
    line's K5 entry (its bound at N = 50)."""
    args, kw, n_chan = k5_inputs(first, hand, arr, grid, dev)
    samples = ("int16", "float32")

    res = dict(err=0.0, cluster=correlate.windowed_cluster())
    for n in (N_BLOCKS, 8, 1):
        worst = dict.fromkeys(samples, 0.0)
        for dtype, cplx in itertools.product(samples, (False, True)):
            rel, err, flips, kept = hold_k5(args(0, n, dtype=dtype),
                                            dict(kw, complex_out=cplx))
            worst[dtype] = max(worst[dtype], rel)
            if dtype == "int16":
                res["err"] = max(res["err"], err)
                n_flips, n_keep = flips, kept
        a = args(0, n)

        def kernel():
            return correlate.windowed_correlate(*a, **kw)

        def plain():
            return correlate.windowed_correlate_plain(*a, **kw)

        k_ms, p_ms = cuda_ms(kernel, 20), cuda_ms(plain, 5)
        d_ms = kernel_device_ms(kernel, 10, "windowed_")
        b = k5_bound(a, kernel(), kw)
        kc = k5_clock_split(correlate, a, kw)
        code_kc = sum(kc[k] for k in correlate.CLOCK_NAMES[:7])
        carr_kc = sum(kc[k] for k in correlate.CLOCK_NAMES[7:-1])
        key = "" if n == N_BLOCKS else f"_n{n}"
        res.update({f"ms{key}": k_ms, f"plain_ms{key}": p_ms,
                    f"device_ms{key}": d_ms,
                    f"kclocks_code{key}": code_kc,
                    f"kclocks_carrier{key}": carr_kc})
        if n == N_BLOCKS:
            res["bound"] = b
        else:
            res[f"bound_ms{key}"] = b["bound_ms"]
        share = ("not measured" if d_ms is None
                 else f"{100.0 * b['bound_ms'] / d_ms:.2f} %")
        log(f"K5 windowed_correlate N={n} C={n_chan} S={S} "
            f"windows {kw['code_win']}/{kw['carr_win']}, one cluster launch of "
            f"R={res['cluster']} thread blocks a (block, channel): "
            f"magnitude and complex "
            f"within rel {worst['int16']:.3e} (int16 samples), "
            f"{worst['float32']:.3e} (float32) of each channel's window "
            f"maximum (limit 1e-5), flips equal ({n_flips} of {a[4].numel()} "
            f"flipped; {a[4].numel() - n_keep} degenerate boundary-0 "
            f"channel(s) left out), code argmaxes equal; wrapper "
            f"{k_ms:.4f} ms, kernel's own {fmt_ms(d_ms)}, plain "
            f"{p_ms:.4f} ms; bound {b['bound_ms']:.5f} ms ({b['bound_by']}), "
            f"share of bound {share} [{card}]")
        log(f"K5 N={n} clock split (thousands of SM clocks a thread block, "
            f"mean over blocks and ranks): code phase {code_kc:.3f}, "
            f"carrier phase {carr_kc:.3f}; " + ", ".join(
                f"{k} {v:.3f}" for k, v in kc.items()) + f" [{card}]")

    for dtype, cplx in itertools.product(samples, (False, True)):
        whole = correlate.windowed_correlate(
            *args(0, N_BLOCKS, dtype=dtype), **kw, complex_out=cplx)
        for parts in SPLITS + (N_BLOCKS,):
            shares = [correlate.windowed_correlate(
                *args(lo, hi, dtype=dtype), **kw, complex_out=cplx)
                for lo, hi in score.even_rows(N_BLOCKS, parts)]
            for name, f in zip(whole._fields, zip(*shares)):
                assert torch.equal(torch.cat(f), getattr(whole, name)), \
                    (parts, name, dtype, cplx)
        sub = correlate.windowed_correlate(
            *args(0, N_BLOCKS, slice(2, 6), dtype), **kw, complex_out=cplx)
        for name in whole._fields:
            assert torch.equal(getattr(sub, name),
                               getattr(whole, name)[:, 2:6]), (name, dtype,
                                                               cplx)
    pw = correlate.windowed_correlate_plain(*args(0, N_BLOCKS), **kw)
    ps = [correlate.windowed_correlate_plain(*args(lo, hi), **kw)
          for lo, hi in score.even_rows(N_BLOCKS, 2)]
    n_plain = sum(int((torch.cat(f) != getattr(pw, name)).sum())
                  for name, f in zip(pw._fields[:2], zip(*ps)))
    log(f"K5 batch invariance: the 50 blocks correlated whole, as "
        f"{', '.join(str(p) for p in SPLITS)} and 50 grid ranks share them "
        f"and over channels 2-5 alone: windows and flips equal to the bit, "
        f"magnitude and complex, int16 and float32 samples (the plain version on the card, 25/25: "
        f"{n_plain} of {pw.code_mag.numel() + pw.carr_mag.numel()} window "
        f"elements differ) [{card}]")
    return res


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
               for name in ("score_argmax", "track_chunk",
                            "windowed_correlate", "navbits_loop")]
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


def clock_split(kernel, n_upd: int, n_chan: int, dev, logf) -> str:
    """clock_parts as "name us, ..." (us per update)."""
    clocked_ms, mhz, us = clock_parts(kernel, n_upd, n_chan, dev, logf)
    return (f"clocked kernel {clocked_ms:.3f} ms, "
            f"{mhz:.0f} MHz: "
            + ", ".join(f"{n} {u:.3f}" for n, u in
                        zip(track.CLOCK_NAMES, us)))


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

    log(f"K4 step split (us per step, mean over channels): "
        f"{clock_split(kernel, TRACK_MS, n_chan, raw.device, lfk)} "
        f"[{card}]")
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
    to 0 just before it and read just after, then 50 more per-block steps,
    counted the same way. Returns (the timed pass's counts, its tracked
    steps, the scalar receiver, K5's launches in the 50 steps)."""
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
    assert counts["windowed_correlate"] == 1, counts  # one correlation
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

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    drx.run(50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = _build.launch_counts()["windowed_correlate"]
    assert k5 == 50, k5
    err = np.array([np.linalg.norm(f.x_ecef[:3] - hand.x_ecef[:3])
                    for f in drx.fixes[1:]])
    assert len(err) == 50 and np.isfinite(err).all()
    med = float(np.median(err))
    assert med < 15.0, med
    log(f"per-block DPE after the handoff: 50 steps ({k5} K5 launches), "
        f"error median "
        f"{med:.2f} m p95 {float(np.percentile(err, 95)):.2f} m, wall "
        f"{wall:.3f} s ({50 * T / wall:.2f}x real time) [{card}]")
    device_record("one per-block step", drx.step, K1_K5, card)
    return counts, rx.mcount, rx, k5


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
    """One shape of the block-summed mode: kernel against plain (bit-equal, or for sinc rtol 1e-5 and a tie
    within 1e-6), weighted sums bitwise equal across two runs; when timed
    also their means within rtol 1e-4 of the plain version's, wrapper ms,
    the kernel's own ms, plain ms and the bound. Returns the kernel's
    result (best, arg) and, when timed, its times."""
    kw = dict(interp=interp, l_power=l_power)

    def kernel(**more):
        return score.score_argmax(*args, **kw, **more, block_sum=True)

    got = kernel()
    want = score.score_argmax_plain(*args, **kw, block_sum=True)
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
    wa = kernel(weighted=True)
    wb = kernel(weighted=True)
    torch.cuda.synchronize()
    for x, y in zip(wa, wb):
        assert torch.equal(x, y), (name, "weighted sums differ run to run")
    assert int(wa[1]) == int(got[1])
    n, _, w = args[0].shape
    shape = (f"K1 block sum {name} {manifold} N={n} W={w} "
             f"G={args[5].shape[0]} {interp} l_power={l_power}")
    if not timed:
        log(f"{shape}: {verdict}, weighted sums repeat bitwise")
        return got, None
    wp = score.score_argmax_plain(*args, **kw, weighted=True, block_sum=True)
    torch.testing.assert_close(wa[2] / wa[3], wp[2] / wp[3], rtol=1e-4,
                               atol=1e-5)
    k_ms = cuda_ms(kernel, reps)
    d_ms = kernel_device_ms(kernel, reps, "score_")
    p_ms = cuda_ms(lambda: score.score_argmax_plain(*args, **kw,
                                                    block_sum=True), 1)
    bnd = sum_bound(args, got, manifold, interp)
    log(f"{shape}: {verdict}, weighted sums repeat bitwise; wrapper "
        f"{k_ms:.4f} ms, kernel's own {fmt_ms(d_ms)}, plain {p_ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}"
        + ("" if d_ms is None else
           f"; {100.0 * bnd['bound_ms'] / d_ms:.1f} % of it by the kernel's "
           f"own time") + f") [{card}]")
    return got, dict(ms=k_ms, device_ms=d_ms, plain_ms=p_ms, **bnd)


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """The two tensors hold the same bits (float32 or int32)."""
    return x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def check_factored(dev, card) -> dict:
    """Phase 30: the factored kernel against the per-point kernel, bit for
    bit (and at dense N = 1 against the plain version), and both kernels'
    own time a launch. Returns {case: (per-point ms, factored ms)} of the
    timed cases."""
    rng = np.random.default_rng(SEED + 30)
    times, cases = {}, 0

    def pair(a, f, **kw):
        nonlocal cases
        before = _build.launch_counts()
        per = score.score_argmax(*a, **kw)
        fac = score.score_argmax(*a, factors=f, **kw)
        after = _build.launch_counts()
        plain_key, fac_key = K1_SUM_KEYS if kw.get("block_sum") else K1_KEYS
        assert (after[plain_key] - before[plain_key],
                after[fac_key] - before[fac_key]) == (1, 1), (kw, after)
        for name, x, y in zip(("best", "arg"), per, fac):
            assert same_bits(x, y), (kw, a[0].shape, name, x, y)
        cases += 1
        return fac

    for gname, grid in (("spread", spread_grid()), ("dense", dense_grid())):
        cw, vw = dpe_ops.auto_windows(grid.d_enu, grid.dt_m, grid.dv_enu,
                                      grid.dtdot, FS, CARR_FFTPTS)
        for manifold, width in (("pos", cw), ("vel", vw)):
            args = scorer_inputs(rng, manifold, width, grid, dev)
            f = score.grid_factors(args[5], args[6])
            run = 25 if gname == "spread" else 75
            assert f is not None and f.o1u.shape[0] == run, gname
            by_n = {n: [None if x is None else x[:n].contiguous()
                        for x in args[:5]] + args[5:] for n in (1, 10, 50)}
            for n, a in by_n.items():
                for interp in ("quadratic", "linear"):
                    for block_sum in (False, True):
                        fac = pair(a, f, interp=interp, block_sum=block_sum)
                        if gname == "dense" and n == 1 and not block_sum:
                            # 25 clock values a thread: held to plain
                            want = score.score_argmax_plain(*a,
                                                            interp=interp)
                            assert all(same_bits(x, y) for x, y in zip(
                                fac, want)), (manifold, interp, fac, want)
                            cases += 1
            # the weighted modes with factors: the per-point kernel
            before = _build.launch_counts()
            for block_sum in (False, True):
                score.score_argmax(*by_n[1], factors=f, weighted=True,
                                   block_sum=block_sum)
            after = _build.launch_counts()
            assert all(after[k] - before[k] == 1 for k in (
                "score_argmax", "score_argmax_sum")), (before, after)
            assert k1_count(after) + k1_count(after, K1_SUM_KEYS) == (
                k1_count(before) + k1_count(before, K1_SUM_KEYS) + 2)
            if gname == "spread":
                for l_power in (2, 3):
                    for block_sum in (False, True):
                        pair(by_n[10], f, l_power=l_power,
                             block_sum=block_sum)
                # a mesh rank's rows that start and end on runs: the rows'
                # own factors
                lo, hi = 100 * run, args[5].shape[0] - 4 * run
                rows = by_n[10][:5] + [args[5][lo:hi], args[6][lo:hi]]
                fr = score.factor_rows(f, lo, hi)
                assert fr is not None and score.factor_rows(
                    f, lo + 1, hi) is None
                pair(rows, fr)
            timed = [(50, by_n[50])] if gname == "dense" else [
                (10, by_n[10]), (50, by_n[50])]
            for n, a in timed:
                per_ms = kernel_device_ms(lambda: score.score_argmax(*a), 10,
                                          "score_kernel<")
                fac_ms = kernel_device_ms(lambda: score.score_argmax(
                    *a, factors=f), 10, "score_kernel_factored")
                ev = [cuda_ms(lambda: score.score_argmax(*a, **kw), 10)
                      for kw in ({}, dict(factors=f))]
                times[f"{gname} {manifold} N={n}"] = (per_ms, fac_ms)
                log(f"factored {gname} {manifold} (G={args[5].shape[0]}, "
                    f"L={run}, W={width}) N={n} quadratic argmax: kernel's "
                    f"own time per-point {fmt_ms(per_ms)}, factored "
                    f"{fmt_ms(fac_ms)}; wrapper (CUDA events) per-point "
                    f"{ev[0]:.4f} ms, factored {ev[1]:.4f} ms [{card}]")
            del args, by_n
    log(f"factored: {cases} cases, best and argmax bit-equal to the "
        f"per-point kernel's (dense N = 1 to the plain version's); the "
        f"weighted modes run the per-point kernel [{card}]")
    return times


def check_block_sum(grid, widths, dev, card):
    """Phase 10: the block-summed modes and sinc. Returns the K1
    block-summed entry of the kernels line: its times at the integrated
    fix's shape (N = 8, both manifolds) and, under keys of their own, at
    every other shape."""
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
        return tot, cases

    # the spread grid at the integrated path's N = 8, the survey's N = 50
    # and its coarse joint pass (25 epochs)
    entry = None
    for n, key in ((8, "sum_n8"), (50, "sum_n50"), (25, "sum_n25_coarse")):
        cases = []
        for manifold in ("pos", "vel"):
            args = scorer_inputs(rng, manifold, widths[manifold], grid, dev,
                                 n=n)
            cases.append(check_sum_case("spread", args, manifold, card)[1])
            if n == 8:
                for kw in (dict(l_power=2), dict(interp="linear")):
                    check_sum_case("spread", args, manifold, card, reps=3,
                                   timed=False, **kw)
        tot, _ = both(key, cases)
        if n == 8:
            entry = dict(tot, bound=dict(
                bound_ms=tot["bound_ms"], bound_by=cases[0]["bound_by"]))

    # a grid=2 and a grid=4 mesh rank's rows of the spread grid (195 313
    # and 97 657 points, 191 and 96 tiles): the block sums phase 25's ranks
    # launch
    for key, part, (lo, hi) in (
            ("half", "a mesh rank's half", score.ceil_rows(grid.n_pos, 2)[0]),
            ("quarter", "a mesh rank's quarter",
             score.ceil_rows(grid.n_pos, 4)[0])):
        for n in (8, 50):
            cases = []
            for manifold in ("pos", "vel"):
                args = scorer_inputs(rng, manifold, widths[manifold], grid,
                                     dev, n=n)
                args[5], args[6] = args[5][lo:hi], args[6][lo:hi]
                cases.append(check_sum_case(part, args, manifold, card,
                                            reps=5)[1])
            both(f"sum_n{n}_{key}", cases)

    # N = 2, 7, 13 (a staged batch boundary inside N at these widths) and
    # 64; the offsets 4 bytes off a 16-byte boundary (1 point a thread)
    for n in (2, 7, 13, 64):
        args = scorer_inputs(rng, "pos", widths["pos"], grid, dev, n=n)
        check_sum_case("spread", args, "pos", card, reps=3, timed=False)
    args = scorer_inputs(rng, "vel", widths["vel"], grid, dev, n=8)
    args[5], args[6] = args[5][1:], args[6][1:]
    check_sum_case("spread, unaligned", args, "vel", card, reps=3,
                   timed=False)

    # exact ties: the grid laid out twice (across tiles), every point twice
    # in a row (both copies among a thread's four points), and the same one
    # point on (copies 4T + 3 and 4T + 4 fall to threads T and T + 1)
    args = scorer_inputs(rng, "pos", widths["pos"], grid, dev, n=8)
    o3, o1 = args[5], args[6]
    twice3, twice1 = o3.repeat_interleave(2, dim=0), o1.repeat_interleave(2)
    for how, (a3, a1), first in (
            ("the spread grid twice over", (torch.cat([o3, o3]),
                                            torch.cat([o1, o1])), grid.n_pos),
            ("every point twice in a row", (twice3, twice1), 0),
            ("every point twice in a row, one point on", (
                torch.cat([o3[-1:], twice3]), torch.cat([o1[-1:], twice1])),
             1)):
        args[5], args[6] = a3.contiguous(), a1.contiguous()
        best, arg = score.score_argmax(*args, block_sum=True)
        want = score.score_argmax_plain(*args, block_sum=True)
        assert torch.equal(best, want[0]) and torch.equal(arg, want[1])
        if how == "the spread grid twice over":
            assert int(arg) < first
        else:
            # (index 0 of the shifted layout is the last point's first copy)
            assert int(arg) % 2 == first or int(arg) == 0, (how, int(arg))
        log(f"K1 block sum, {how} (G={args[5].shape[0]}): the tie goes to "
            f"the first copy (arg {int(arg)}), as in the plain version")
    del args, o3, o1

    # the dense grid (the reference's cap) with its own window widths
    dense = dense_grid()
    dcw, dvw = dpe_ops.auto_windows(dense.d_enu, dense.dt_m, dense.dv_enu,
                                    dense.dtdot, FS, CARR_FFTPTS)
    cases, cases_n1 = [], []
    for manifold, w in (("pos", dcw), ("vel", dvw)):
        args = scorer_inputs(rng, manifold, w, dense, dev, n=16)
        assert args[5].shape[0] == 75 ** 4 > 2 ** 24
        cases.append(check_sum_case("dense", args, manifold, card,
                                    reps=3)[1])
        check_sum_case("dense", args, manifold, card, l_power=2, reps=3,
                       timed=False)
        # one block: what the coherent integrated run launches on this grid
        one = [None if a is None else a[:1].contiguous() for a in args[:5]]
        cases_n1.append(check_sum_case("dense", one + args[5:], manifold,
                                       card, reps=3)[1])
        del args, one
    both("sum_n16_dense", cases)
    both("sum_n1_dense", cases_n1)
    del dense

    # the survey's zoom lattice: 33^4 points about the coarse argmax, 25
    # epochs, its joint passes quadratic and sinc
    ax = (np.arange(33) - 16.0)
    cases, cases_q = [], []
    for manifold, sp in (("pos", 0.25), ("vel", 0.02)):
        args = scorer_inputs(rng, manifold, widths[manifold], grid, dev,
                             n=25)
        off3, off1 = _mesh4(ax * sp, ax * sp)
        args[5] = torch.from_numpy(off3.astype(np.float32)).to(dev)
        args[6] = torch.from_numpy(off1.astype(np.float32)).to(dev)
        cases.append(check_sum_case("zoom", args, manifold, card,
                                    interp="sinc", reps=3)[1])
        cases_q.append(check_sum_case("zoom", args, manifold, card,
                                      reps=3)[1])
    both("sum_sinc_zoom", cases)
    both("sum_n25_zoom", cases_q)
    return dict(entry, err=0.0, **out)


def fix_errors(fixes, truth):
    return np.array([np.linalg.norm(f.x_ecef[:3] - truth[:3])
                     for f in fixes])


def check_integrated(samples, hand, arr, grid, dev, card):
    """Phase 11: integrated DPE at full width. Returns K1's (block-summed)
    and K5's launches."""
    first = samples[:S * 216]      # a warm fix, the timed ones, a profiled one
    raw_dev = torch.from_numpy(first.view(np.int16).reshape(-1, S, 2)).to(dev)
    cfg = DPEConfig(ekf_mode="alpha", ekf_alpha=0.3)

    def make(g, samp=first):
        return DPEReceiver(SampleFile(samples=samp, fs=FS),
                           copy.deepcopy(hand), grid=g,
                           eph=copy.deepcopy(arr), config=copy.deepcopy(cfg),
                           device=dev)

    launches = k5_all = 0
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
        got = _build.launch_counts()
        n_launch = k1_count(got, K1_SUM_KEYS)
        assert n_launch == 2 * n_fix, (name, n_launch)
        # both grids are product grids: every K1 launch is factored
        assert got["score_argmax_sum_factored"] == n_launch, (name, got)
        assert k1_count(got) == 0
        k5 = _build.launch_counts()["windowed_correlate"]
        assert k5 == n_fix, (name, k5)
        assert len(rx.fixes) == n_fix + 1 and rx.mc == (n_fix + 1) * k
        err = fix_errors(rx.fixes[1:], hand.x_ecef)
        assert np.isfinite(err).all()
        med = float(np.median(err))
        assert med < 15.0, (name, med)
        launches += n_launch
        k5_all += k5
        runs[name] = rx
        log(f"integrated DPE, {name}: {n_fix} fixes of {k} blocks "
            f"(G={g.n_pos} per manifold, windows {rx.code_win}/"
            f"{rx.carr_win}), K1 {n_launch} and K5 {k5} launches, error "
            f"median "
            f"{med:.2f} m max {float(err.max()):.2f} m [first "
            f"{err[0]:.2f}, last {err[-1]:.2f}], wall {wall:.3f} s, "
            f"{n_fix * k * T / wall:.2f}x real time [{card}]")
        if kw == dict():
            device_record(
                "one integrated fix of 8 blocks, spread grid",
                lambda: rx.run_integrated(1, 8, raw_blocks_dev=raw_dev,
                                          start_block=208),
                K1_K5, card)
    a = runs["noncoherent, spread grid"]
    b = runs["noncoherent, spread grid, from the file"]
    assert len(b.fixes) == 26
    for fa, fb in zip(a.fixes, b.fixes):
        assert np.array_equal(fa.x_ecef, fb.x_ecef), (fa.mc, "file mode")
        assert (fa.pos_score, fa.vel_score) == (fb.pos_score, fb.vel_score)
    assert not [t for t in threading.enumerate() if t.name == "raw-prefetch"]
    log("integrated DPE: the file-mode run's 26 fixes equal the "
        "device-resident run's exactly")
    return launches, k5_all


def check_survey(samples, hand, arr, grid, dev, card):
    """Phase 12: the survey solve over 25 s. A warm-up run, then the timed
    runs (quadratic and sinc zoom passes) on the receiver as it is, whose
    K1 (block-summed) and K5 launches are the ones returned; then one more run of each with a
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

            def timed_joint(win, los, cen, coe, r0, off3, off1, **kw):
                t0 = time.perf_counter()
                out = inner_joint(win, los, cen, coe, r0, off3, off1, **kw)
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
        got = _build.launch_counts()
        n_launch = k1_count(got, K1_SUM_KEYS)
        # two per integrated fix, then six joint passes (coarse and two zoom
        # passes per manifold), all block-summed; K5 once a batch. The
        # fixes and the coarse passes score the spread grid, factored; the
        # zoom lattices (33 clock values) the per-point kernel
        assert n_launch == 2 * n_batches + 6, n_launch
        assert got["score_argmax_sum_factored"] == 2 * n_batches + 2, got
        assert k1_count(got) == 0
        n_k5 = _build.launch_counts()["windowed_correlate"]
        assert n_k5 == n_batches, n_k5
        assert res.n_blocks == n_batches * k and res.n_batches == n_batches
        assert len(rx.fixes) == n_batches
        assert np.isfinite(res.pos_score) and np.isfinite(res.vel_score)
        assert np.isfinite(res.x_ecef).all()
        assert np.all(res.sigma_pos > 0) and np.all(res.sigma_vel > 0)
        enu = r_e2n @ (res.x_ecef[0:3] - truth[0:3])
        assert abs(enu[0]) < 1.5 and abs(enu[1]) < 1.5, enu
        assert np.linalg.norm(enu) < 6.0, enu
        return res, enu, wall, n_launch, n_k5

    survey(None)                           # warms the shapes
    launches = k5 = 0
    for zoom in (None, "sinc"):
        res, enu, wall, n_launch, n_k5 = survey(zoom)
        launches, k5 = launches + n_launch, k5 + n_k5
        log(f"survey, zoom {zoom or 'quadratic'}: {n_batches} batches of {k} "
            f"blocks ({n_batches * k * T:.0f} s), K1 {n_launch} and K5 "
            f"{n_k5} launches, ENU error {enu[0]:.2f} / {enu[1]:.2f} / "
            f"{enu[2]:.2f} m (3-D {float(np.linalg.norm(enu)):.2f} m), clock "
            f"{res.x_ecef[3] - truth[3]:.2f} m, sigma_pos "
            f"{np.array2string(res.sigma_pos, precision=3)}, wall "
            f"{wall:.3f} s ({n_batches * k * T / wall:.1f}x real time) "
            f"[{card}]")
    for zoom in (None, "sinc"):
        calls = []
        _, _, wall, _, _ = survey(zoom, calls)
        split = {key: sum(t for kk, t in calls if kk == key)
                 for key in ("pass", "coarse", "zoom")}
        log(f"survey, zoom {zoom or 'quadratic'}, one more run synchronized "
            f"after every stage: wall {wall:.3f} s: pass "
            f"{split['pass']:.3f} s, coarse {split['coarse']:.4f} s, zoom "
            f"{split['zoom']:.4f} s [{card}]")
    return launches, k5


def check_refined(samples, hand, arr, grid, dev, card):
    """Phase 13: the batched path with the Newton polish and the full EKF.
    Returns K1's and K5's launches."""
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
    launches = k1_count(_build.launch_counts())
    assert launches == 2 * (200 // N_BLOCKS), launches
    k5 = _build.launch_counts()["windowed_correlate"]
    assert k5 == 200 // N_BLOCKS, k5
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
    log(f"refined + full EKF batched run: 200 blocks, K1 {launches} and K5 "
        f"{k5} launches, rows of {widths[0]} floats (windows inside), error "
        f"median {med:.2f} m p95 {p95:.2f} m, trace(P) {tr:.1f} "
        f"(position-clock block {tr4:.2f}), wall {wall:.3f} s, "
        f"{200 * T / wall:.2f}x real time [{card}]")
    return launches, k5


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

        def kernel(clocks=None):
            return tracking.track_chunk_packed(st0, raw, code_table, FS,
                                               FCAID, loops, coh_ms=m,
                                               clocks=clocks)

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
        d_ms = kernel_device_ms(kernel, 3, "track_window_kernel")
        split = clock_split(kernel, n_upd, code_table.shape[0], dev, lfk)
        log(f"K4 coherent m={m}: {n_upd} updates ({n_upd * m} ms) x "
            f"{code_table.shape[0]} channels from acquisition: logs "
            f"{verdict} (max|float diff| {err:.3e}); kernel {k_ms:.3f} ms "
            f"({n_upd * m / k_ms:.1f}x real time, "
            f"{k_ms / n_upd * 1e3:.2f} us an update), kernel's own "
            f"{fmt_ms(d_ms)}, plain {p_ms:.1f} ms; update split (us) "
            f"{split} [{card}]")
        if m == 4:
            out = dict(ms=k_ms, plain_ms=p_ms, device_ms=d_ms,
                       bound=track_bound(n_upd, m * 2500, raw, code_table,
                                         lfk, lik))
    out["err"] = max(errs)
    return out


def check_batched(st0, samples, hand, code_table, card):
    """Phase 15: K4's batch_k = 4 schedule against its plain version on the
    path's 2000 ms chunk, batch_k = 2, 3, 5, 8 on its first 240 steps, then
    the receiver's batch_k path. Returns the K4 batch_k entry."""
    dev = code_table.device
    n = TRACK_MS
    raw = torch.from_numpy(samples[:n * 2500].view(np.int16)
                           .reshape(n, 2500, 2).copy()).to(dev)

    def kernel(clocks=None):
        return tracking.track_chunk_packed(st0, raw, code_table, FS, FCAID,
                                           clocks=clocks, batch_k=4)

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
    split = clock_split(kernel, n, code_table.shape[0], dev, lfk)
    log(f"K4 batch_k=4: {n} steps x {code_table.shape[0]} channels from "
        f"acquisition: logs {verdict} (max|float diff| {err:.3e}); kernel "
        f"{k_ms:.3f} ms ({n / k_ms:.1f}x real time, "
        f"{k_ms / n * 1e3:.3f} us a step), kernel's own {fmt_ms(d_ms)}, "
        f"plain {p_ms:.1f} ms; step split (us) {split} [{card}]")
    # the kernel's other pass shapes: 2, 3 and 1 windows a pass, and a
    # batch over two passes (track.window_pass)
    sweep = []
    for kb in (2, 3, 5, 8):
        rk = raw[:240]
        _, lfk2, lik2 = tracking.track_chunk_packed(
            st0, rk, code_table, FS, FCAID, batch_k=kb)
        _, lfp2, lip2 = tracking.track_chunk_batched_plain(
            st0, rk, code_table, FS, FCAID, batch_k=kb)
        v, e = compare_logs(lfk2.cpu().numpy(), lik2.cpu().numpy(),
                            lfp2.cpu().numpy(), lip2.cpu().numpy(), rows)
        err = max(err, e)
        sweep.append(f"batch_k={kb} ({track.window_pass(1, kb)} a pass) {v}")
    log(f"K4 batch_k sweep: 240 steps x {code_table.shape[0]} channels from "
        f"acquisition, logs against plain: {'; '.join(sweep)} [{card}]")

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
    """Phase 16: K3's windows mode against its plain version, bit-equal, at
    the handoff phases: the vector epoch's shape (20 windows x 8 channels,
    int16, S = 2500) timed, with the phases as four vectors and as the
    columns of one [C, 4] tensor (VectorReceiver.step's one copy); W = 1
    and 40 timed; W = 2, S = 2501 (no multiple of 16 bytes), float32
    samples and C = 1 and 12 held to plain. Returns the K3 windows entry
    (the vector epoch's shape) with the other times under keys of their
    own."""
    ph = np.stack([np.asarray(x, np.float32) for x in
                   (hand.rc, np.asarray(hand.fc) - F_CA, hand.ri, hand.fi)],
                  axis=1)

    def case(w, s=2500, c=8, dtype=torch.int16, timed=False, packed=False):
        prns = list(hand.prn_list) + [1, 3, 4, 5][:max(0, c - 8)]
        tab = torch.from_numpy(ca_table(prns[:c]).astype(np.float32)).to(dev)
        n = w * s
        raw = torch.from_numpy(samples[:n].view(np.int16).reshape(w, s, 2)
                               .copy()).to(dev).to(dtype)
        rows = np.resize(ph, (c, 4)).astype(np.float32)
        cols = torch.from_numpy(rows).to(dev)
        args = ([cols[:, i] for i in range(4)] if packed else
                [cols[:, i].contiguous() for i in range(4)])

        def kernel():
            return track.correlate_windows_cuda(raw, *args, tab, FS)

        def plain():
            return tracking.track_open_loop_plain(*args, raw, tab, FS)

        _build.reset_launch_counts()
        got = kernel()
        assert _build.launch_counts()["correlate_windows"] == 1
        want = plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert torch.equal(got, want), (w, s, c, dtype, err)
        what = (f"{w} windows x {c} channels, S = {s}, "
                f"{str(dtype).split('.')[-1]}"
                + (", phases as columns of one [C, 4] tensor" if packed
                   else ""))
        if not timed:
            log(f"K3 windows mode: {what}: bit-equal to the plain recurrence "
                f"and combine, one launch")
            return None
        k_ms, p_ms = cuda_ms(kernel, 100), cuda_ms(plain, 3)
        d_ms = kernel_device_ms(kernel, 20, "correlate_windows_kernel")
        bnd = bound(w * c * (s * OPS_PER_SAMPLE_CHANNEL + 60),
                    tensor_bytes(raw, tab, *args, got)
                    + s * 4)                              # the time table
        log(f"K3 windows mode: {what}: bit-equal to the plain recurrence and "
            f"combine, one launch; wrapper {k_ms:.4f} ms, kernel's own "
            f"{fmt_ms(d_ms)}, plain {p_ms:.3f} ms, bound "
            f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}"
            + ("" if d_ms is None else
               f"; {100.0 * bnd['bound_ms'] / d_ms:.2f} % of it by the "
               f"kernel's own time") + f") [{card}]")
        return dict(err=err, ms=k_ms, plain_ms=p_ms, device_ms=d_ms,
                    bound=bnd)

    entry = case(20, timed=True)
    packed = case(20, timed=True, packed=True)
    entry.update(ms_packed=packed["ms"], device_ms_packed=packed["device_ms"])
    for w in (1, 40):
        r = case(w, timed=True)
        entry.update({f"ms_w{w}": r["ms"], f"device_ms_w{w}": r["device_ms"],
                      f"bound_ms_w{w}": r["bound"]["bound_ms"]})
    for w, s, c, dtype in ((2, 2501, 8, torch.int16),
                           (20, 2500, 8, torch.float32),
                           (40, 2501, 12, torch.float32),
                           (1, 2500, 1, torch.int16),
                           (20, 2501, 12, torch.int16)):
        case(w, s, c, dtype)
    return entry


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
    to the JAX package's run of the same sequence on the CPU: found and the
    code bins to the JAX search's, the fine frequency within one bin and
    the carrier phase within 1e-3 cycles of the port's search on the CPU
    (the `seed` the JAX tracker started from); the track, started from that
    seed (at 27 dB-Hz the loops magnify a start's last float32 bits: the
    card's own start departs by Hz within 250 updates), op by op to the
    JAX tracker's: fi within 0.1 Hz and the lock flags equal over the
    first OP_BY_OP updates (the tracking tests' tight tier: at this C/N0 a
    sum's last bit, added in another order, grows past it later; PRN 30
    parts from 0.003 Hz at update 189, the CPU's plain tracker alike), and
    the final cp equal; the acquired and the tracked Dopplers also to the
    scenario's truth (within a quarter cycle of an 8 ms update, 31.25 Hz).
    Returns K4 coherent launches."""
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
    seed = [ref["prns"][str(p)]["seed"] for p in hand.prn_list]
    ri_gap = max(abs((r.ri - s["ri"] + 0.5) % 1.0 - 0.5)
                 for r, s in zip(res, seed))
    rx.state = tracking.init_state(
        **{k: [s[k] for s in seed] for k in ("rc", "ri", "fc", "fi")},
        device=dev)
    rx.track(ref["track_ms"], coh_ms=m)
    t2 = time.perf_counter()
    launches = _build.launch_counts()["track_chunk_coherent"]
    assert launches == 1, launches
    n_per = int(FS * 1e-3) * ref["n_coh_ms"]
    bin_hz = FS / (8 * (1 << n_per.bit_length()))
    truth = dict(zip(hand.prn_list, hand.fi))
    worst = dict(fi_acq=0.0, fi=0.0, lock=0, cp=0, fi_truth=0.0,
                 fi_end=0.0, parted={})
    for r in res:
        want = ref["prns"][str(r.prn)]
        ch = rx.channels[r.prn]
        assert r.found == want["found"] and r.rc == want["rc"], (r, want)
        worst["fi_acq"] = max(worst["fi_acq"],
                              abs(r.fi - want["seed"]["fi"]))
        dfi = np.abs(ch.col("fi") - np.array(want["fi"]))
        worst["fi"] = max(worst["fi"], float(dfi[:OP_BY_OP].max()))
        worst["lock"] += int((ch.col("lock")[:OP_BY_OP]
                              != np.array(want["lock"])[:OP_BY_OP]).sum())
        parted = np.flatnonzero(dfi > 1e-3)
        if len(parted):
            worst["parted"][r.prn] = int(parted[0])
        worst["cp"] += int(ch.col("cp")[-1] != want["cp_end"])
        worst["fi_truth"] = max(worst["fi_truth"], abs(r.fi - truth[r.prn]))
        worst["fi_end"] = max(worst["fi_end"], abs(
            float(ch.col("fi")[-1]) - truth[r.prn]))
    n_found = sum(r.found for r in res)
    n_lock = sum(int(rx.channels[r.prn].col("lock")[-1]) for r in res)
    log(f"weak start at {ref['cn0_dbhz']:.0f} dB-Hz: deep acquisition "
        f"({ref['deep_ms']} ms, {ref['n_coh_ms']} ms coherent, "
        f"{len(deep_dopplers(ref['n_coh_ms']))} Dopplers) {n_found}/8 found, "
        f"found/rc equal to the JAX package's, fi within "
        f"{worst['fi_acq']:.2f} Hz of the port's CPU search (one bin "
        f"{bin_hz:.2f} Hz), ri within {ri_gap:.2e} cycles of it (limit "
        f"1e-3), and {worst['fi_truth']:.2f} Hz of the truth "
        f"(limit 31.25), {t1 - t0:.3f} s; track({ref['track_ms']}, "
        f"coh_ms={m}) {t2 - t1:.3f} s from the CPU search's start, "
        f"{n_lock}/8 in lock at the end: against the JAX run from the "
        f"same start (op by op) fi within "
        f"{worst['fi']:.2e} Hz over the first {OP_BY_OP} updates (limit "
        f"0.1), lock flags differing in {worst['lock']} of them, parting "
        f"by 1e-3 Hz at update {worst['parted'] or 'none'} of "
        f"{rx.mcount}, final cp differing in {worst['cp']} channels; final "
        f"fi within "
        f"{worst['fi_end']:.2f} Hz of the truth at sample 0 (limit 31.25); "
        f"{launches} K4 launch [{card}]")
    assert worst["fi_acq"] <= bin_hz * 1.001 and ri_gap < 1e-3, (worst,
                                                                   ri_gap)
    assert worst["fi"] < 0.1 and worst["lock"] == 0 and worst["cp"] == 0, \
        worst
    assert worst["fi_truth"] < 31.25 and worst["fi_end"] < 31.25, worst
    return launches


def check_weak_decode(dev, card):
    """Phase 18, its decode: WEAK_DECODE_S of the scenario at the weak
    reference's C/N0, deep acquisition, coh_ms tracking 30 s then 2 s with
    a decode after each, as the weak cold start makes them. At 30 s every
    channel is too short to frame (no bit-loop launch); at 32 s every one
    decodes by the soft pass in one launch, each ephemeris equal to the
    plain host decode's (`_parse`, channel by channel, on the same logs).
    The decode's wall a attempt (the 32 s one twice: its first call makes
    cuFFT's float64 plans), its spans, the plain decode's wall, and the
    bit loop kernel's own time on the 8 channels' bit sums (CUDA events).
    Returns the bit loop's launches in the decode and `check_bit_loops`'
    dict."""
    ref = json.loads(WEAK_REF.read_text())
    t0 = time.perf_counter()
    samples, hand, _ = make_capture(WEAK_DECODE_S, ref["cn0_dbhz"])
    log(f"weak decode: {WEAK_DECODE_S} s at {ref['cn0_dbhz']:.0f} dB-Hz "
        f"synthesized in {time.perf_counter() - t0:.1f} s")
    m = ref["coh_ms"]
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), hand.prn_list,
                        loops=tracking.cadence_loops(m), device=dev)
    rx.acquire(deep_ms=ref["deep_ms"], n_coh_ms=ref["n_coh_ms"],
               verbose=False)
    rx.track(30_000, coh_ms=m)
    _build.reset_launch_counts()
    rows = []
    for extra in (0, 2000, 0):
        if extra:
            rx.track(extra, coh_ms=m)
        torch.cuda.synchronize()
        counts = dict(rx.decode_counts)
        tracing.clear()
        with tracing.recording():
            t0 = time.perf_counter()
            good = rx.decode_ephemerides(verbose=False)
            wall = time.perf_counter() - t0
        spans = {n: sum(s.t1 - s.t0 for s in tracing.spans(n)) * 1e3
                 for n in ("scalar.decode.hard", "scalar.decode.soft")}
        rows.append(dict(periods=len(rx.channels[rx.prn_list[0]].cp_sign),
                         good=len(good), ms=wall * 1e3, **spans,
                         counts={k: v - counts[k]
                                 for k, v in rx.decode_counts.items()}))
    tracing.clear()
    launches = _build.launch_counts()["navbits_loop"]
    n_ch = len(rx.prn_list)
    assert rows[0]["counts"]["too_short"] == n_ch and rows[0]["good"] == 0, \
        rows[0]
    for r in rows[1:]:
        assert r["counts"]["soft"] == n_ch and r["good"] == n_ch, r
    assert launches == 2, launches
    t0 = time.perf_counter()
    plain = {p: rx._parse(p)[0] for p in rx.prn_list}
    plain_ms = (time.perf_counter() - t0) * 1e3
    differ = [p for p in rx.prn_list
              if dataclasses.asdict(plain[p])
              != dataclasses.asdict(rx.channels[p].ephemeris)]
    for name, r in zip(("30 s", "32 s", "32 s again"), rows):
        log(f"weak decode at {name} ({r['periods']} periods): {r['good']}/"
            f"{n_ch} in {r['ms']:.2f} ms (hard framer "
            f"{r['scalar.decode.hard']:.2f} ms, soft pass "
            f"{r['scalar.decode.soft']:.2f} ms), outcomes {r['counts']} "
            f"[{card}]")
    log(f"weak decode: the plain host decode of the same logs "
        f"{plain_ms:.2f} ms, its ephemerides differing in {len(differ)} of "
        f"{n_ch} channels {differ}; {launches} bit loop launches in the "
        f"decode [{card}]")
    assert not differ, differ
    return launches, check_bit_loops(rx, dev, card)


def check_bit_loops(rx, dev, card):
    """Phase 18, the bit loop kernel alone on the 8 channels' bit sums and
    loop starts, as the plain path forms them from the receiver's logs
    (`_soft_signs`, `bit_edge`, `loop_start`), padded to the longest:
    its int8 decisions equal to `navbits._loop` forward then backward
    (`coherent_bits`' order) channel by channel, nothing written past a
    channel's bits, and each pass's end (phase, rate) within 1e-9 of the
    plain loop's. Returns the kernels line's dict: err (the largest end
    difference), ms (CUDA events around the launch), plain_ms (`_loop`
    twice a channel on the host, as a CPU receiver runs it), device_ms,
    bound (each sum read once, each decision and end written once)."""
    sums, start, want, ends = [], [], [], []
    for p in rx.prn_list:
        soft = rx._soft_signs(p)
        o = navbits.bit_edge(soft)
        nb = (len(soft) - o) // navbits.PERIODS_A_BIT
        z, phase, rate = navbits.loop_start(soft[o:o + 20 * nb].reshape(
            nb, 20).sum(axis=1))
        _, p_f, r_f = navbits._loop(z, phase, rate)
        bits, p_b, r_b = navbits._loop(z[::-1], p_f, -r_f)
        sums.append(z)
        start.append((phase, rate))
        want.append(bits[::-1])
        ends.append((p_f, r_f, p_b, r_b))
    n_ch = len(sums)
    nb = np.array([len(z) for z in sums])
    padded = np.zeros((n_ch, nb.max()), np.complex128)
    for c, z in enumerate(sums):
        padded[c, :len(z)] = z
    args = (torch.from_numpy(padded).to(dev), torch.from_numpy(nb).to(dev),
            torch.tensor(start, dtype=torch.float64, device=dev),
            torch.zeros((n_ch, nb.max()), dtype=torch.int8, device=dev))
    got_ends = navbits._bit_loops(*args)
    torch.cuda.synchronize()
    got = args[3].cpu().numpy()
    wrong = [c for c, k in enumerate(nb)
             if not np.array_equal(got[c, :k], want[c]) or got[c, k:].any()]
    err = float(np.abs(got_ends.cpu().numpy() - np.array(ends)).max())
    k_ms = cuda_ms(lambda: navbits._bit_loops(*args), 20)
    cpu_args = tuple(a.cpu() for a in args)
    navbits._bit_loops(*cpu_args)
    t0 = time.perf_counter()
    navbits._bit_loops(*cpu_args)
    p_ms = (time.perf_counter() - t0) * 1e3
    d_ms = kernel_device_ms(lambda: navbits._bit_loops(*args), 20,
                            "navbits_loop_kernel")
    # bytes only: the two chains of dependent float64 steps, not the
    # operations' count, keep the kernel far from any bound (PERF.md)
    bnd = bound(0, tensor_bytes(*args, got_ends))
    log(f"bit loop kernel: {n_ch} channels of {nb.min()}-{nb.max()} bits, "
        f"decisions equal to the plain loop's in {n_ch - len(wrong)} of "
        f"{n_ch} channels {wrong}, pass ends within {err:.3e} (limit 1e-9); "
        f"wrapper {k_ms:.4f} ms, kernel's own {fmt_ms(d_ms)}, plain (host "
        f"loop) {p_ms:.2f} ms; bound {bnd['bound_ms']:.6f} ms "
        f"({bnd['bound_by']}) [{card}]")
    assert not wrong and err < 1e-9, (wrong, err)
    return dict(err=err, ms=k_ms, plain_ms=p_ms, device_ms=d_ms, bound=bnd)


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


def flip_decisions(args):
    """The FFT engine's flip decision |corr_f[0]| > |corr[0]| taken again in
    complex128 from one step's inputs, and how far it is from a tie
    (|(|flip| - |no flip|)| / max; inf where the block holds no nav-bit
    boundary). At lag 0 the correlation is sum_t repl(t) bb(t), the flipped
    one the same with the tail past idx_next negated."""
    raw, cf, m_int, m_frac, idx_next, fi, ri, t = args[:8]
    ang = (fi.double()[:, None] * t.double()[None, :]
           + ri.double()[:, None]) * (-2.0 * np.pi)
    bb = raw.to(torch.complex128)[None, :] * torch.exp(1j * ang)
    repl = torch.fft.ifft(cf * dpe_ops._shift_phase(raw.shape[0], m_int,
                                                    m_frac)).real.double()
    tail = (torch.arange(raw.shape[0], device=raw.device)[None, :]
            >= idx_next.long()[:, None])
    head_sum = (repl * bb * ~tail).sum(-1)
    tail_sum = (repl * bb * tail).sum(-1)
    nf, fl = (head_sum + tail_sum).abs(), (head_sum - tail_sum).abs()
    margin = (fl - nf).abs() / torch.maximum(fl, nf)
    boundary = idx_next.long() < raw.shape[0]
    return fl > nf, torch.where(boundary, margin, torch.inf)


def check_fft_engine(samples, hand, arr, grid, dev, card):
    """Phase 20: DPEConfig(engine="fft"), the per-block FFT engine (cuFFT
    correlation, K2 on the score windows): the refusals of the batched and
    integrated modes; one block on the card against the same block on the
    CPU; 50 timed steps from the truth handoff, each step's flip decisions
    held to the same decision taken in complex128, with the closest call
    reported; one profiled step. Returns K2's launches."""
    rx = DPEReceiver(SampleFile(samples=samples, fs=FS), copy.deepcopy(hand),
                     grid=grid, eph=copy.deepcopy(arr), device=dev,
                     config=DPEConfig(engine="fft", ekf_mode="alpha",
                                      ekf_alpha=0.3))
    for call in (lambda: rx.run_batched(N_BLOCKS, lookahead=N_BLOCKS),
                 lambda: rx.run_integrated(1, 8)):
        try:
            call()
        except ValueError as e:
            assert "engine='real' only" in str(e), e
        else:
            raise AssertionError("the FFT engine ran a batch mode")
    assert rx.mc == 0

    # every step's device inputs and outputs are kept (references only)
    seen = []
    inner = dpe_ops.dpe_device_step

    def step(*a, **kw):
        out = inner(*a, **kw)
        seen.append((a, kw, out))
        return out

    dpe_ops.dpe_device_step = step
    try:
        rx.step()
        # block 1 again on the CPU: correlations, surfaces, argmaxes, flips
        a, kw, got = seen[0]
        cpu = [x.cpu() if isinstance(x, torch.Tensor) else
               type(x)(*(y.cpu() for y in x)) if isinstance(x, tuple) else x
               for x in a]
        sc = [dpe_ops.batch_correlate(*ar, kw["carr_fftpts"])
              for ar in (a[:8], cpu[:8])]
        want = inner(*cpu, **kw)
        torch.cuda.synchronize()
        assert torch.equal(sc[0].flip_used.cpu(), sc[1].flip_used)
        rel = {}
        for name, g, w in (("code_corr", sc[0].code_corr, sc[1].code_corr),
                           ("carr_fft", sc[0].carr_fft, sc[1].carr_fft),
                           ("pos surface", got[0], want[0]),
                           ("vel surface", got[2], want[2])):
            rel[name] = float((g.cpu() - w).abs().max() / w.abs().max())
            assert rel[name] < 1e-5, (name, rel[name])
        assert int(got[1]) == int(want[1]) and int(got[3]) == int(want[3])
        assert torch.equal(got[4].cpu(), want[4])
        log(f"FFT engine, one block card against CPU: argmaxes and flips "
            f"equal (flips {got[4].cpu().int().tolist()}), "
            + ", ".join(f"{k} rel {v:.2e}" for k, v in rel.items())
            + f" (limit 1e-5, of the CPU's peak) [{card}]")
        del sc, want, got, cpu

        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rx.run(50)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_k2 = _build.launch_counts()["score_surface"]
    finally:
        dpe_ops.dpe_device_step = inner
    assert n_k2 == 100, n_k2
    err = fix_errors(rx.fixes[1:], hand.x_ecef)
    assert len(err) == 50 and np.isfinite(err).all()
    med, p95 = float(np.median(err)), float(np.percentile(err, 95))
    assert med < 15.0, med
    closest, differ, n_bound = np.inf, 0, 0
    for a, _, out in seen:
        f64, margin = flip_decisions(a)
        bound = torch.isfinite(margin)
        n_bound += int(bound.sum())
        differ += int((f64 != out[4])[bound].sum())
        closest = min(closest, float(margin.min()))
    del seen
    log(f"FFT engine (engine='fft', ekf alpha): 50 per-block steps from the "
        f"truth handoff, {n_k2} K2 launches, error median {med:.2f} m p95 "
        f"{p95:.2f} m, wall {wall:.3f} s ({50 * T / wall:.2f}x real time); "
        f"flip decisions over the 51 blocks: {n_bound} channel-blocks with a "
        f"nav-bit boundary, {differ} differing from the decision in "
        f"complex128, the closest call {closest:.2e} of the larger lag-0 "
        f"magnitude [{card}]")
    assert differ == 0, differ
    device_record("one FFT-engine step", rx.step, "score_kernel", card)
    return n_k2


def seeded_ephemerides(arr, cp_shift):
    """{prn: ephemeris} with its cp anchor moved into a receiver's own cp
    frame (the scenario's anchors assume cp = 1000 at scenario sample 0)."""
    out = {}
    for e in arr.ephs:
        e2 = copy.deepcopy(e)
        e2.cp_timestamp += cp_shift
        out[e2.prn] = e2
    return out


def align_chunks_vs_plain(calls):
    """Phase 21's hold of K4 at align's shape: each chain of successive
    launches that align made ([1, S, 2] chunks, one window each: fewer than
    the ring's slots, the state carried from launch to launch) is run again
    through the plain tracker, chained from the same first state on the
    same raw chunks. Every chunk's logs and every carried TrackState must
    equal the kernel's bit for bit. Returns (chains, chunks, chunk shape)."""
    chains, st = 0, None
    for cont, st_in, raw, args, kw, (st_k, lf_k, li_k) in calls:
        assert raw.shape[0] == 1 and kw.get("coh_ms", 1) == 1 \
            and kw.get("batch_k", 1) == 1, (tuple(raw.shape), kw)
        if not cont:
            chains, st = chains + 1, st_in
        st, lf_p, li_p = tracking.track_chunk_plain(st, raw, *args)
        assert torch.equal(lf_k, lf_p) and torch.equal(li_k, li_p), chains
        for k in tracking.TrackState._fields:
            assert torch.equal(getattr(st_k, k), getattr(st, k)), (chains, k)
    return chains, len(calls), list(calls[0][2].shape)


def fleet_pass(samples, hand, dev, parallel, record_align=False):
    """Phase 21, one pass: two receivers (the capture, and the capture
    started 7 ms later) through acquire -> track -> LNAV -> align ->
    batched DPE, the launches of each stage counted from 0. Returns the
    fleet, its DPE receivers, offsets, launches, walls and each DPE
    receiver's first-fix time (from the start of the pass); with
    record_align, also align's K4 calls (inputs and outputs) for
    `align_chunks_vs_plain`."""
    prns = list(hand.prn_list)
    shift = int(0.007 * FS)
    first_fix = {}
    inner = DPEReceiver._drain_batch
    inner_track = tracking.track_chunk_packed
    calls, last = [], [None]

    def track_chunk_packed(state, raw, *args, **kw):
        st_in = tracking.TrackState(*(t.clone() for t in state))
        out = inner_track(state, raw, *args, **kw)
        calls.append((state is last[0], st_in, raw.clone(), args, kw, out))
        last[0] = out[0]
        return out

    def drain(self, *a, **kw):
        out = inner(self, *a, **kw)
        first_fix.setdefault(id(self), time.perf_counter())
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = ReceiverFleet([SampleFile(samples=samples, fs=FS),
                           SampleFile(samples=samples[shift:], fs=FS)],
                          prns, device=dev)
    fleet.acquire()
    _build.reset_launch_counts()
    fleet.track(FLEET_TRACK_MS, parallel=parallel)
    k4_track = _build.launch_counts()["track_chunk"]
    good = fleet.decode_ephemerides()
    assert all(sorted(g) == sorted(prns) for g in good), good
    _build.reset_launch_counts()
    if record_align:
        tracking.track_chunk_packed = track_chunk_packed
    try:
        offsets = fleet.align()
    finally:
        tracking.track_chunk_packed = inner_track
    k4_align = _build.launch_counts()["track_chunk"]
    t_align = time.perf_counter() - t0
    DPEReceiver._drain_batch = drain
    try:
        _build.reset_launch_counts()
        dpes = fleet.run_dpe(FLEET_DPE_BLOCKS, grid=spread_grid(),
                             lookahead=N_BLOCKS, parallel=parallel)
        torch.cuda.synchronize()
        k1 = k1_count(_build.launch_counts())
        k5 = _build.launch_counts()["windowed_correlate"]
    finally:
        DPEReceiver._drain_batch = inner
    wall = time.perf_counter() - t0
    return dict(fleet=fleet, dpes=dpes, offsets=offsets, wall=wall,
                t_align=t_align, k4_track=k4_track, k4_align=k4_align,
                k1=k1, k5=k5, ttff=[first_fix[id(d)] - t0 for d in dpes],
                align_calls=calls)


def check_fleet(samples, hand, dev, card):
    """Phase 21: the receiver fleet four times, parallel, sequential
    (parallel=False), sequential, parallel (so neither side runs first
    only): offsets, tracking logs and fixes bit-equal across all four;
    the first run's align chunks held to the plain tracker
    (`align_chunks_vs_plain`). Returns launches by kernel (the first
    run's)."""
    runs = [(p, fleet_pass(samples, hand, dev, p, record_align=i == 0))
            for i, p in enumerate((True, False, False, True))]
    par = runs[0][1]
    assert abs(int(par["offsets"][0]) - 7) <= 1 and par["offsets"][1] <= 1
    n_chains, n_chunks, shape = align_chunks_vs_plain(par.pop("align_calls"))
    assert n_chunks == par["k4_align"] == int(par["offsets"].sum()), \
        (n_chunks, par["k4_align"], par["offsets"])
    for _, other in runs[1:]:
        np.testing.assert_array_equal(par["offsets"], other["offsets"])
        for a, b in zip(par["fleet"].receivers, other["fleet"].receivers):
            for prn in a.prn_list:
                for k in ("rc", "fi", "iP", "qP", "cp", "lock"):
                    assert np.array_equal(a.channels[prn].col(k),
                                          b.channels[prn].col(k)), (prn, k)
        for a, b in zip(par["dpes"], other["dpes"]):
            assert len(a.fixes) == len(b.fixes) == FLEET_DPE_BLOCKS
            for fa, fb in zip(a.fixes, b.fixes):
                assert np.array_equal(fa.x_ecef, fb.x_ecef), fa.mc
                assert (fa.pos_score, fa.vel_score) == (fb.pos_score,
                                                        fb.vel_score)
    meds = []
    for label, d in zip(par["fleet"].labels, par["dpes"]):
        err = fix_errors(d.fixes, hand.x_ecef)
        assert np.isfinite(err).all()
        meds.append(float(np.median(err)))
        assert meds[-1] < 15.0, (label, meds[-1])
    signal_s = sum((FLEET_TRACK_MS + int(off)) * 1e-3
                   + FLEET_DPE_BLOCKS * T for off in par["offsets"])
    assert par["k1"] == 2 * 2 * FLEET_DPE_BLOCKS // N_BLOCKS, par["k1"]
    assert par["k5"] == 2 * FLEET_DPE_BLOCKS // N_BLOCKS, par["k5"]
    log(f"fleet: 2 receivers (the capture, and the capture 7 ms later), "
        f"8/8 ephemerides decoded on both after track({FLEET_TRACK_MS}), "
        f"align offsets {par['offsets'].tolist()} ms ({par['k4_align']} "
        f"1 ms K4 launches, data dependent; their {n_chunks} {shape} chunks"
        f" in {n_chains} chain(s) == the plain tracker chained from "
        f"the same state, logs and carried TrackState bit for bit), "
        f"run_dpe({FLEET_DPE_BLOCKS}, "
        f"lookahead={N_BLOCKS}) error medians "
        + " / ".join(f"{m:.2f}" for m in meds)
        + f" m; parallel runs == sequential runs bit for bit (offsets, "
        f"logs, fixes); launches K4 {par['k4_track']} (track) + "
        f"{par['k4_align']} (align), K1 {par['k1']}, K5 {par['k5']} "
        f"[{card}]")
    for parallel, r in runs:
        name = "parallel" if parallel else "sequential"
        log(f"fleet, {name}: wall {r['wall']:.3f} s ({r['t_align']:.3f} s "
            f"to aligned), TTFF per receiver "
            + " / ".join(f"{t:.3f}" for t in r["ttff"])
            + f" s, aggregate {signal_s:.2f} s of signal over both "
            f"receivers, {signal_s / r['wall']:.1f}x real time [{card}]")
    return dict(k4=par["k4_track"], k4_align=par["k4_align"], k1=par["k1"],
                k5=par["k5"])


def check_live_fleet(samples, hand, arr, dev, card):
    """Phase 22: ReceiverFleet.from_live over two paced SimulatedRadios (the
    first 1.9 s of the capture, the second radio 7 ms late) on one
    MultiSource clock, seeded ephemerides, acquire -> track(1400) -> align
    -> run_dpe(5). Returns launches by kernel."""
    n = int(1.9 * FS)
    srcs = [SimulatedRadio(samples[:n], fs=FS, block_samples=2500),
            SimulatedRadio(samples[:n], fs=FS, block_samples=2500,
                           start_byte=int(0.007 * FS) * 4)]
    multi = MultiSource(srcs, RadioSyncConfig(setup_time_s=0.05))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    fleet = ReceiverFleet.from_live(multi, hand.prn_list, fs=FS,
                                    max_seconds=2.0, timeout_s=60.0,
                                    device=dev)
    try:
        fleet.acquire()
        fleet.track(1400, parallel=True)
        fleet.mark_phase("track")
        for rx, cp_shift in zip(fleet.receivers, (-1000.0, -1007.0)):
            rx.set_ephemerides(seeded_ephemerides(arr, cp_shift))
        offsets = fleet.align()
        fleet.mark_phase("align")
        dpes = fleet.run_dpe(5, grid=spread_grid(), parallel=True)
        fleet.mark_phase("dpe")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        stats = fleet.live_stats()
    finally:
        multi.close()
    assert abs(int(offsets[0]) - 7) <= 1 and offsets[1] <= 1, offsets
    meds = [np.median(np.stack([f.x_ecef[:3] for f in d.fixes]), 0)
            for d in dpes]
    spread = float(np.linalg.norm(meds[1] - meds[0]))
    errs = [float(np.linalg.norm(d.fixes[-1].x_ecef[:3] - hand.x_ecef[:3]))
            for d in dpes]
    assert spread < 25.0 and max(errs) < 40.0, (spread, errs)
    assert all(s["delivered_s"] > 0.5 for s in stats), stats
    log(f"live fleet: 2 paced radios, 1.9 s, offsets {offsets.tolist()} ms, "
        f"last fixes {errs[0]:.2f} / {errs[1]:.2f} m from truth, median "
        f"spread {spread:.2f} m, wall {wall:.3f} s; launches K4 "
        f"{counts['track_chunk']}, K2 {counts['score_surface']}, K5 "
        f"{counts['windowed_correlate']}; "
        f"live_stats {json.dumps(stats)} [{card}]")
    return dict(k4=counts["track_chunk"], k2=counts["score_surface"],
                k5=counts["windowed_correlate"])


def check_montecarlo(samples, hand, dev, card):
    """Phase 23: the Monte-Carlo harness at the receiver's full width, cut
    in runs and blocks: perturbation_sweep (8 runs x 50 blocks, the
    reference's 50-80 m band), spacing_sweep (3 spacings), cn0_sweep
    ([45, 30] dB-Hz, 32 blocks, 8 a fix), weak_sweep (one level, 128
    blocks). Returns launches by kernel over all four."""
    counts = dict(score_argmax=0, score_argmax_factored=0,
                  score_argmax_sum=0, score_argmax_sum_factored=0,
                  score_surface=0, windowed_correlate=0)
    with tempfile.TemporaryDirectory() as tmp:
        cap = pathlib.Path(tmp) / "capture.dat"
        samples[:S * 60].tofile(cap)
        sweeps = (
            ("perturbation_sweep(runs=8, blocks=50)",
             lambda: montecarlo.perturbation_sweep(
                 str(cap), copy.deepcopy(hand), runs=8, blocks=50, seed=1,
                 fs=FS, verbose=False, out_dir=str(pathlib.Path(tmp) / "mc"),
                 device=dev)),
            ("spacing_sweep([7.0, 8.5, 10.0], blocks=50)",
             lambda: montecarlo.spacing_sweep(
                 str(cap), copy.deepcopy(hand), [7.0, 8.5, 10.0], blocks=50,
                 fs=FS, verbose=False, device=dev)),
            ("cn0_sweep([45, 30], blocks=32, blocks_per_fix=8)",
             lambda: montecarlo.cn0_sweep([45.0, 30.0], blocks=32,
                                          blocks_per_fix=8, verbose=False,
                                          device=dev)),
            ("weak_sweep([27], blocks=128, blocks_per_fix=16)",
             lambda: montecarlo.weak_sweep([27.0], blocks=128,
                                           blocks_per_fix=16, verbose=False,
                                           device=dev)))
        for name, sweep in sweeps:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = sweep()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = _build.launch_counts()
            for k in counts:
                counts[k] += got[k]
            if name.startswith(("perturbation", "spacing")):
                assert all(np.isfinite(r.errs).all() and len(r.errs) == 50
                           for r in res)
                summary = montecarlo.convergence_summary(res)
                text = montecarlo.format_summary(summary).replace(
                    "\n", "; ")
                rows = " ".join(",".join(map(str, r.row())) for r in res)
                log(f"Monte-Carlo {name}: {text}; rows {rows}; wall "
                    f"{wall:.3f} s ({wall / len(res):.3f} s a run); launches "
                    f"K2 {got['score_surface']}, K1 {k1_count(got)}, "
                    f"K1 block-summed {k1_count(got, K1_SUM_KEYS)}, K5 "
                    f"{got['windowed_correlate']} [{card}]")
            else:
                log(f"Monte-Carlo {name}: "
                    + "; ".join(json.dumps(dataclasses.asdict(p))
                                for p in res)
                    + f"; wall {wall:.3f} s; launches K2 "
                    f"{got['score_surface']}, K1 {k1_count(got)}, K1 "
                    f"block-summed {k1_count(got, K1_SUM_KEYS)}, K5 "
                    f"{got['windowed_correlate']} [{card}]")
    assert counts["score_surface"] > 0 and k1_count(counts, K1_SUM_KEYS) > 0
    return counts


REPO = pathlib.Path(__file__).resolve().parent
PRNS = "2,7,6,12,31,30,13,26"     # the scenario's eight
CLI_TRACK_S = 34                  # as the fleet: 8/8 decode, 200 blocks fit


def run_cli(argv, stdin_text=None):
    """cli.main(argv) in this process, the launch counts set to 0 just
    before it and read just after: (stdout, wall s, launches by key). What
    it printed is shown if it raises."""
    out = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    stdin = sys.stdin
    try:
        if stdin_text is not None:
            sys.stdin = io.StringIO(stdin_text)
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        torch.cuda.synchronize()
    except BaseException:
        print(out.getvalue()[-6000:], flush=True)
        raise
    finally:
        sys.stdin = stdin
    return out.getvalue(), time.perf_counter() - t0, _build.launch_counts()


def csv_errors(path, truth, col0, header):
    """3-D errors [m] of the ECEF columns col0..col0+2 of a CSV."""
    rows = np.loadtxt(path, delimiter=",", skiprows=int(header),
                      usecols=(col0, col0 + 1, col0 + 2), ndmin=2)
    return np.linalg.norm(rows - truth[:3], axis=1)


def same_fixes_csv(cli_csv, api_csv) -> float:
    """Two FixWriter CSVs: equal rows, counts and times equal, the numbers
    equal to the print precision (one 1 mm step of %+15.3f, allowing the
    rounding of values a hair apart). Returns the largest difference."""
    a = np.loadtxt(cli_csv, delimiter=",", skiprows=1, ndmin=2)
    b = np.loadtxt(api_csv, delimiter=",", skiprows=1, ndmin=2)
    assert a.shape == b.shape and len(a), (a.shape, b.shape)
    np.testing.assert_array_equal(a[:, :3], b[:, :3])
    diff = float(np.abs(a[:, 3:] - b[:, 3:]).max())
    assert diff <= 1.5e-3, diff
    return diff


def check_cli(samples, hand, dev, card):
    """Phase 24: the command line, each subcommand through cli.main in this
    process on the 40 s capture written to a temporary file with its truth
    handoff: acquire; track to 8/8 ephemerides and a handoff, then 36 s
    coherent (--coh-ms 4) and with --batch-k 4; dpe batched
    (lookahead 50, group_k 5, depth 4), per block with the native streamer,
    the X_ECEF log and a profiler trace, and integrated (8 a fix), the
    batched and integrated CSVs held to the same receiver driven through
    the Python API; survey; vt; live over the simulated radio; a live fleet
    of two simulated radios to its decode-failed branch, its warm-up
    included; the console from a dofile; then
    `python -m navlab_dpe_sdr_tpu_torch dpe` in a fresh interpreter. The
    per-block runs pass --watchdog 60 and print iteration 1's time
    (FlowStats.first_s). Returns launches by kernel key, summed."""
    truth = hand.x_ecef
    r_e2n = frames.ecef_to_enu_matrix(truth[0:3])
    dv = ["--device", str(torch.device(dev).type)]
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        cap, hand_csv, scal = tmp / "cap.dat", tmp / "truth.csv", \
            tmp / "scalar.csv"
        samples.tofile(cap)
        write_handoff(str(hand_csv), hand)

        def api_csv(name, run):
            """The CLI's receiver and mode driven through the Python API on
            the card and written by the same FixWriter, to hold the CLI's
            CSV to: what differs is only the CLI's wiring."""
            rx = DPEReceiver(SampleFile(str(cap)), read_handoff(str(scal)),
                             grid=spread_grid(), config=DPEConfig(),
                             device=dev)
            run(rx)
            with FixWriter(str(tmp / name), weekno=2008) as w:
                for f in rx.fixes:
                    w.write(f)
            return tmp / name

        def call(name, argv, signal_s, stdin_text=None):
            text, wall, counts = run_cli(dv + argv, stdin_text)
            for k, n in counts.items():
                totals[k] = totals.get(k, 0) + n
            shown = {k: n for k, n in counts.items() if n}
            return text, wall, shown, (f"CLI {name}: wall {wall:.3f} s for "
                                       f"{signal_s:.2f} s of signal, "
                                       f"launches {json.dumps(shown)}")

        text, wall, counts, line = call(
            "acquire", ["acquire", str(cap), "--prns", PRNS], 0.01)
        found = sum(ln.split()[1] == "True" for ln in text.splitlines()[1:])
        assert found == 8, text
        log(f"{line}, {found}/8 found [{card}]")

        text, wall, counts, line = call(
            "track", ["track", str(cap), "--prns", PRNS, "--seconds",
                      str(CLI_TRACK_S), "--handoff", str(scal),
                      "--checkpoint", str(tmp / "ck")], CLI_TRACK_S)
        n_eph = text.count("complete=True")
        err = float(np.linalg.norm(read_handoff(str(scal)).x_ecef[:3]
                                   - truth[:3]))
        assert n_eph == 8 and err < 15.0, (n_eph, err)
        assert (tmp / "ck" / "receiver.mat").is_file()
        log(f"{line}, {n_eph}/8 ephemerides, scalar fix {err:.2f} m from "
            f"the truth (limit 15) [{card}]")

        for mode, key in ((["--coh-ms", "4"], "track_chunk_coherent"),
                          (["--batch-k", "4"], "track_chunk_batched")):
            text, wall, counts, line = call(
                "track " + " ".join(mode),
                ["track", str(cap), "--prns", PRNS, "--seconds", "36", *mode],
                36.0)
            n_eph = text.count("complete=True")
            x = np.array(re.search(r"fix: ECEF \[([^\]]*)\]", text).group(1)
                         .split(), float)
            err = float(np.linalg.norm(x - truth[:3]))
            assert n_eph == 8 and err < 15.0 and counts.get(key, 0) > 0, \
                (mode, n_eph, err, counts)
            log(f"{line}, {n_eph}/8 ephemerides, scalar fix {err:.2f} m "
                f"from the truth (limit 15) [{card}]")

        text, wall, counts, line = call(
            "dpe --batched", ["dpe", str(cap), "--handoff", str(scal),
                              "--batched", "--lookahead", "50", "--group-k",
                              "5", "--pipeline-depth", "4", "--blocks", "200",
                              "--out", str(tmp / "fixes.csv")], 200 * T)
        err = csv_errors(tmp / "fixes.csv", truth, 3, header=True)
        med = float(np.median(err))
        assert k1_count(counts) > 0 and len(err) == 40
        assert np.isfinite(err).all() and med < 15.0, med
        diff = same_fixes_csv(tmp / "fixes.csv", api_csv(
            "fixes_api.csv", lambda rx: rx.run_batched(
                200, lookahead=50, group_k=5, pipeline=True,
                pipeline_depth=4)))
        log(f"{line}, {len(err)} fixes in the CSV, error median {med:.2f} m "
            f"p95 {float(np.percentile(err, 95)):.2f} m (limit 15); CSV == "
            f"the Python API's run_batched on the card (max diff {diff:.1e}, "
            f"limit 1.5e-3) [{card}]")

        text, wall, counts, line = call(
            "dpe (per block, native I/O)",
            ["dpe", str(cap), "--handoff", str(scal), "--blocks", "50",
             "--native-io", "--xecef-log", str(tmp / "x.csv"),
             "--profile-dir", str(tmp / "prof"), "--watchdog", "60"], 50 * T)
        err = csv_errors(tmp / "x.csv", truth, 1, header=False)
        trace = (tmp / "prof" / "trace.json").read_bytes()
        first = re.search(r"first iteration: (\S+) ms", text).group(1)
        assert counts.get("score_surface", 0) > 0 and len(err) == 50
        assert b"score_kernel" in trace and np.isfinite(err).all()
        log(f"{line}, x.csv {len(err)} rows, error median "
            f"{float(np.median(err)):.2f} m, profiler trace "
            f"{len(trace) / 1e6:.1f} MB naming score_kernel "
            f"{trace.count(b'score_kernel')} times, first iteration {first} "
            f"ms (watchdog 60 s; the default is 1.5 s) [{card}]")

        text, wall, counts, line = call(
            "dpe --integrate 8", ["dpe", str(cap), "--handoff", str(scal),
                                  "--integrate", "8", "--blocks", "200",
                                  "--out", str(tmp / "integ.csv")], 200 * T)
        err = csv_errors(tmp / "integ.csv", truth, 3, header=True)
        med = float(np.median(err))
        assert k1_count(counts, K1_SUM_KEYS) > 0 and len(err) == 25
        assert med < 15.0, med
        diff = same_fixes_csv(tmp / "integ.csv", api_csv(
            "integ_api.csv", lambda rx: rx.run_integrated(
                25, blocks_per_fix=8)))
        log(f"{line}, 25 fixes, error median {med:.2f} m (limit 15); CSV == "
            f"the Python API's run_integrated on the card (max diff "
            f"{diff:.1e}, limit 1.5e-3) [{card}]")

        text, wall, counts, line = call(
            "survey", ["survey", str(cap), "--handoff", str(hand_csv),
                       "--blocks", "200", "--batch", "50", "--json",
                       str(tmp / "s.json")], 200 * T)
        res = json.loads((tmp / "s.json").read_text())
        enu = r_e2n @ (np.array(res["x_ecef"][:3]) - truth[:3])
        assert res["n_batches"] == 4 and k1_count(counts, K1_SUM_KEYS) > 0
        assert abs(enu[0]) < 1.5 and abs(enu[1]) < 1.5, enu
        log(f"{line}, ENU error {enu[0]:.2f} / {enu[1]:.2f} / {enu[2]:.2f} m "
            f"(limits E, N 1.5) [{card}]")

        text, wall, counts, line = call(
            "vt", ["vt", str(cap), "--prns", PRNS, "--pullin",
                   str(CLI_TRACK_S), "--epochs", "50"], CLI_TRACK_S + 50 * T)
        x = np.array(re.search(r"final fix: \[([^\]]*)\]", text).group(1)
                     .split(), float)
        err = float(np.linalg.norm(x - truth[:3]))
        assert counts.get("correlate_windows", 0) == 50, counts
        assert np.isfinite(err) and err < 20.0, err
        log(f"{line}, last vector fix {err:.2f} m from the truth (limit 20) "
            f"[{card}]")

        text, wall, counts, line = call(
            "live --source sim", ["live", str(cap), "--handoff", str(scal),
                                  "--source", "sim", "--seconds", "2",
                                  "--lookahead", "25", "--json",
                                  str(tmp / "live.json")], 2.0)
        rec = json.loads((tmp / "live.json").read_text())
        if rec["rt_misses"]:
            log(f"CLI live: {rec['rt_misses']} real-time misses [{card}]")
        assert rec["rt_misses"] == 0 and rec["iterations"] == 4, rec
        log(f"{line}, {rec['iterations']} iterations of {rec['lookahead']} "
            f"blocks, {rec['rt_misses']} real-time misses, avg compute "
            f"{rec['avg_compute_ms']} ms of a {rec['budget_ms']:.0f} ms "
            f"budget (margin {rec['margin_x']}x), max "
            f"{rec['max_compute_ms']} ms [{card}]")

        text, wall, counts, line = call(
            "fleet --live", ["fleet", str(cap), "--live", "--offsets-ms",
                             "0,7", "--prns", PRNS, "--seconds", "1",
                             "--dpe-blocks", "50", "--stats-out",
                             str(tmp / "fleet.json")], 1.0)
        stats = json.loads((tmp / "fleet.json").read_text())
        assert stats["decode_failed"] and len(stats["sources"]) == 2, stats
        assert counts.get("track_chunk", 0) > 0, counts
        assert k1_count(counts) == 2, counts
        log(f"{line}, two simulated radios on one clock warmed up (a "
            f"25-block DPE dispatch included), 1 s decodes no ephemeris "
            f"(the decode-failed branch), track-phase lag misses "
            f"{[s['phases']['track']['lag_misses'] for s in stats['sources']]}"
            f" [{card}]")

        script = tmp / "flow.dofile"
        script.write_text(f"newflow f {cap} {scal}\nsetparam f interp "
                          f"linear\nstartflow f 5\nstatus\n")
        text, wall, counts, line = call(
            "console", ["console"], 5 * T,
            stdin_text=f"dofile {script}\nquit\n")
        assert "final fix" in text and "failed" not in text, text
        assert counts.get("score_surface", 0) > 0
        log(f"{line}, dofile newflow / setparam / startflow f 5 / status: "
            f"{text.count('fixes=5')} flow with 5 fixes [{card}]")

        env = dict(os.environ, PYTHONPATH=str(REPO))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "navlab_dpe_sdr_tpu_torch", "dpe",
             str(cap), "--handoff", str(scal), "--blocks", "20",
             "--watchdog", "60"], capture_output=True, text=True, env=env,
            cwd=REPO, timeout=300)
        wall = time.perf_counter() - t0
        if res.returncode or "final fix" not in res.stdout:
            print(res.stdout[-3000:], res.stderr[-3000:], flush=True)
        assert res.returncode == 0 and "final fix" in res.stdout
        first = re.search(r"first iteration: (\S+) ms", res.stdout).group(1)
        log(f"CLI python -m navlab_dpe_sdr_tpu_torch dpe --blocks 20 (a "
            f"fresh interpreter): exit 0, wall {wall:.3f} s with start-up, "
            f"first iteration {first} ms, "
            + re.search(r"20 iterations: [^\n]*", res.stdout).group(0)
            + f" [{card}]")
    return totals



# -- phase 27: the port's bench -----------------------------------------------

BENCH_BLOCKS = round(CAPTURE_S / T) - 2 * N_BLOCKS  # after the warm-up


def check_bench(samples, hand, arr, grid, dev, card) -> dict:
    """Phase 27: bench.run on the whole capture, held to its limits.
    Returns the launches of its timed passes, scalar segment and timed
    cold start, summed by kernel mode."""
    t0 = time.perf_counter()
    res = bench.run(samples, hand, arr, grid, BENCH_BLOCKS,
                    lookahead=N_BLOCKS, group_k=5, depth=4, device=dev)
    assert res["protocol"]["passes"] == 3, res["protocol"]
    log("bench: " + json.dumps(res))
    missing = set(bench.BENCH_PY_KEYS) - set(res)
    assert not missing, missing
    assert res["card"] == card and res["parity"]["backend"] == "cuda", res
    assert res["fix_median_m"] < 15.0, res["fix_median_m"]
    assert res["fix_median_m_grouped"] < 15.0, res["fix_median_m_grouped"]
    ttff, par = res["ttff"], res["parity"]
    assert ttff["eph_decoded"] == 8 and ttff["first_fix_m"] < 15.0, ttff
    assert par["corr_code_max_rel"] < 1e-5, par
    assert par["corr_carr_max_rel"] < 1e-5, par
    assert par["corr_flip_equal"] and par["corr_argmax_equal"], par
    assert par["pallas_score_max_rel"] <= 1e-5, par
    launches = {}
    for stage in res["launches"].values():
        for k, v in stage.items():
            launches[k] = launches.get(k, 0) + v
    log(f"bench phase: {BENCH_BLOCKS} blocks a pass, rtf median "
        f"{res['value']:.2f}x {res['value_minmax']}, per-block segment "
        f"{res['rtf_first_200']:.2f}x, fixes median {res['fix_median_m']:.2f}"
        f" m (p95 {res['fix_p95_m']:.2f}), grouped "
        f"{res['fix_median_m_grouped']:.2f} m; scalar tracking "
        f"{res['scalar_track_rtf']:.1f}x; TTFF {ttff['ttff_s']:.3f} s for "
        f"{ttff['signal_s']:.2f} s of signal, first fix "
        f"{ttff['first_fix_m']:.2f} m; launches {launches}; wall "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    return launches


# -- phase 28: the moving receiver --------------------------------------------

DYN_SECONDS = 10.0                      # each profile's capture
DYN_CELLS = [(1, 1), (1, 5), (4, 1), (4, 5)]  # (pipeline depth, group_k)
# DYN_r05.json's verdicts for the vehicle at 30 s (the JAX package): lost
# from depth 2 on
DYN_R05_VEHICLE = {(1, 1): (21.45, True), (1, 5): (26.95, True),
                   (4, 1): (51.62, False), (4, 5): (59.09, False)}
MOVE_VEL = np.array([10.0, -8.0, 5.0])  # tests/test_dynamics.py, ECEF m/s
MOVE_ACC = np.array([4.0, 3.0, -2.0])   # m/s^2
RAMP_STEPS, RAMP_FI0, RAMP_FDOT = 1200, 120.0, 250.0
LIVE_SECONDS = 10.0


@contextlib.contextmanager
def recording(module, name: str, calls: list, outs: list | None = None):
    """Within the block, module.<name> appends each call's (args, kwargs)
    to `calls` before it runs, and with `outs` its result to outs."""
    inner = getattr(module, name)

    def rec(*a, **kw):
        calls.append((a, kw))
        out = inner(*a, **kw)
        if outs is not None:
            outs.append(out)
        return out

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def moving_capture(n_blocks: int, seed: int, acc=None):
    """tests/test_dynamics.py's moving receiver (~14 m/s, with acc a
    constant acceleration) with that test's seed: (samples, handoff at the
    truth, ephemerides, truth state)."""
    _, hand, arr = make_scenario(nav_data=True)
    truth = hand.x_ecef.copy()
    truth[4:7] = MOVE_VEL
    sim = CaptureSimulator(arr, truth, tow0=hand.rx_time, fs=FS,
                           cn0_dbhz=47.0, nav_data=True, accel_ecef=acc,
                           seed=seed)
    iq = sim.generate(S * n_blocks)
    samples = np.empty(iq.shape[0], DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    h = copy.deepcopy(hand)
    h.x_ecef = truth.copy()
    return samples, h, arr, truth


def ramp_signal():
    """tests/test_dynamics.py:178's signal: PRN 5 at 45 dB-Hz, Doppler
    120 Hz + 250 Hz/s, seed 0: (float32 [steps, 2500, 2], code table,
    the true Doppler a step)."""
    n = 2500 * RAMP_STEPS
    t = np.arange(n) / FS
    fi_t = RAMP_FI0 + RAMP_FDOT * t
    ph = RAMP_FI0 * t + 0.5 * RAMP_FDOT * t * t
    rc_t = np.cumsum(np.full(n, F_CA) / FS * (1.0 + fi_t / F_L1))
    chips = ca_code(5)[np.mod(np.floor(rc_t), 1023).astype(np.int64)]
    amp = 32 * np.sqrt(10 ** (45.0 / 10) / FS)
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * (
        32 / np.sqrt(2))
    iq = amp * chips * np.exp(2j * np.pi * ph) + noise
    raw = np.stack([iq.real, iq.imag], -1).astype(np.float32)
    return (raw.reshape(RAMP_STEPS, 2500, 2),
            ca_code(5)[None, :].astype(np.float32),
            RAMP_FI0 + RAMP_FDOT * np.arange(RAMP_STEPS) * 1e-3)


def rms_error(states, times, truth, acc=None):
    """RMS distance of states' positions from the truth trajectory."""
    errs = []
    for x, t in zip(states, times):
        p = truth[0:3] + truth[4:7] * t
        if acc is not None:
            p = p + 0.5 * acc * t * t
        errs.append(np.linalg.norm(np.asarray(x)[0:3] - p))
    return float(np.sqrt(np.mean(np.square(errs))))


def check_dynamics(samples, dev, card) -> dict:
    """Phase 28: the moving receiver at full width (tests/test_dynamics.py
    and tools/dynamics_envelope_torch.py on the card). Counted path: (a)
    the envelope at 10 s a profile (walk, vehicle, clock) over depth {1,
    4} x group_k {1, 5}, spread grid, lookahead 50, through
    dynamics_envelope_torch.run_cell on device-resident captures: walk and
    clock held in every cell, the vehicle at depth 1 x K 1 (its other
    cells printed beside DYN_r05's verdicts, not asserted); the vehicle
    per block for 50 steps (tests/test_dynamics.py:25's limits); (b) the
    maneuver: run_batched(60, lookahead=10) alpha and full EKF (full under
    5 m RMS and 0.85 x alpha's), per block 40 steps under the full EKF and
    rts_smooth (under 0.85 x forward and 4.8 m); K4 (1 ms mode) PLL-only
    and FLL-assisted on the 250 Hz/s ramp. Then, not counted, (c) the
    kernels at the path's own inputs, recorded as the path called them: K5
    on the vehicle's first dispatch (N = 50) at phase 26's tolerance, K1
    on that dispatch's windows, K2 on a per-block step, K4's ramp logs
    against track_chunk_plain at K4's limits (PLL-only off the ramp by more
    than 100 Hz, FLL-assisted within 25 Hz over the last 200 updates); (d)
    tools/live_run_torch.py --seconds 10 on the capture: no real-time
    miss. Returns the launches of the counted path by kernel key."""
    t_phase = time.perf_counter()
    grid = spread_grid()
    caps = {p: dyn_env._capture(p, DYN_SECONDS) for p in dyn_env.PROFILES}
    raws = {p: torch.from_numpy(c[0].view(np.int16).reshape(-1, S, 2)
                                ).to(dev) for p, c in caps.items()}
    man60, man40 = (moving_capture(n, 7, MOVE_ACC) for n in (60, 40))
    ramp_raw, ramp_tab, ramp_truth = ramp_signal()
    ramp_raw = torch.from_numpy(ramp_raw).to(dev)
    ramp_tab = torch.from_numpy(ramp_tab).to(dev)
    log(f"dynamics inputs: three {DYN_SECONDS:.0f} s profile captures, the "
        f"maneuver (60 and 40 blocks), the ramp in "
        f"{time.perf_counter() - t_phase:.1f} s")

    _build.reset_launch_counts()
    # (a) the envelope
    cells, k5_calls, k1_calls = {}, [], []
    for prof, (smp, hand, arr, vel) in caps.items():
        for depth, gk in DYN_CELLS:
            rec = (prof, depth, gk) == ("vehicle", 1, 1)
            with contextlib.ExitStack() as stack:
                if rec:
                    stack.enter_context(recording(
                        dpe_real, "windowed_correlate", k5_calls))
                    stack.enter_context(recording(
                        dpe_real, "score_argmax", k1_calls))
                t0 = time.perf_counter()
                r = dyn_env.run_cell(smp, hand, arr, vel, depth, gk,
                                     lookahead=N_BLOCKS, raw_dev=raws[prof],
                                     device=dev)
                wall = time.perf_counter() - t0
            cells[(prof, depth, gk)] = r
            ref = ""
            if prof == "vehicle":
                m5, held = DYN_R05_VEHICLE[(depth, gk)]
                ref = (f" (DYN_r05, the JAX package at 30 s: last 5 s "
                       f"{m5} m, held={held})")
            log(f"dynamics envelope {prof} depth={depth} K={gk}: median "
                f"{r['median_m']} m, p95 {r['p95_m']} m, last 5 s "
                f"{r['median_last5s_m']} m, held={r['held']}, "
                f"{r['n_fixes']} fixes, wall {wall:.3f} s{ref} [{card}]")
    for key, r in cells.items():
        if key[0] in ("walk", "clock"):
            assert r["held"], (key, r)
    assert cells[("vehicle", 1, 1)]["held"], cells[("vehicle", 1, 1)]
    del raws

    # the vehicle per block (tests/test_dynamics.py:25), K2 recorded
    smp, hand, arr, vel = caps["vehicle"]
    k2_calls = []
    rx = DPEReceiver(SampleFile(samples=smp, fs=FS), copy.deepcopy(hand),
                     grid=grid, eph=copy.deepcopy(arr), device=dev)
    with recording(dpe_real, "score_surface_argmax", k2_calls):
        rx.run(50)
    errs = [np.linalg.norm(f.x_ecef[0:3] - (hand.x_ecef[0:3]
                                            + vel * (k + 1) * T))
            for k, f in enumerate(rx.fixes)]
    verr = [np.linalg.norm(f.x_ecef[4:7] - vel) for f in rx.fixes]
    assert np.median(errs[5:]) < 20.0 and np.median(verr[5:]) < 2.5, (
        errs, verr)
    log(f"dynamics vehicle per block: 50 steps, median error "
        f"{np.median(errs[5:]):.3f} m, velocity {np.median(verr[5:]):.3f} "
        f"m/s (limits 20 m, 2.5 m/s) [{card}]")

    # (b) the maneuver (tests/test_dynamics.py:55 and :136)
    smp, hand, arr, truth = man60
    rms = {}
    for mode in ("alpha", "full"):
        rx = DPEReceiver(SampleFile(samples=smp.copy(), fs=FS),
                         copy.deepcopy(hand), grid=grid,
                         eph=copy.deepcopy(arr),
                         config=DPEConfig(ekf_mode=mode, ekf_alpha=0.3),
                         device=dev)
        rx.run_batched(60, lookahead=10)
        rms[mode] = rms_error([f.x_ecef for f in rx.fixes],
                              [f.rx_time - hand.rx_time for f in rx.fixes],
                              truth, MOVE_ACC)
    assert rms["full"] < 5.0 and rms["full"] < 0.85 * rms["alpha"], rms
    smp, hand, arr, truth = man40
    rx = DPEReceiver(SampleFile(samples=smp, fs=FS), copy.deepcopy(hand),
                     grid=grid, eph=copy.deepcopy(arr),
                     config=DPEConfig(ekf_mode="full"), device=dev)
    rx.run(40)
    times = [f.rx_time - hand.rx_time for f in rx.fixes]
    fwd = rms_error([f.x_ecef for f in rx.fixes], times, truth, MOVE_ACC)
    smo = rms_error(rx.ekf.rts_smooth(), times, truth, MOVE_ACC)
    assert smo < 0.85 * fwd and smo < 4.8, (smo, fwd)
    log(f"dynamics maneuver (~5.4 m/s^2): batched lookahead 10, RMS full "
        f"EKF {rms['full']:.3f} m, alpha {rms['alpha']:.3f} m (limits 5 m, "
        f"0.85 x alpha); per block 40 steps under the full EKF, forward "
        f"{fwd:.3f} m, RTS-smoothed {smo:.3f} m (limits 0.85 x forward, "
        f"4.8 m) [{card}]")

    # the tracker under the 250 Hz/s ramp: K4, 1 ms mode
    st_r = tracking.init_state(rc=[0.0], ri=[0.0], fc=[F_CA], fi=[RAMP_FI0],
                               device=dev)
    ramp = {}
    for name, fll in (("PLL-only", 0.0), ("FLL-assisted", 8.0)):
        loops = tracking.LoopConfig(order=2, bn_carr=10.0, bn_carr_freq=fll)
        _, lf, li = tracking.track_chunk_packed(st_r, ramp_raw, ramp_tab, FS,
                                                FCAID, loops)
        ramp[name] = (loops, lf.cpu().numpy(), li.cpu().numpy())
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    log(f"dynamics path launches: {counts} [{card}]")

    # (c) the kernels at the path's inputs (these launches are not counted)
    a, kw = k5_calls[0]
    assert a[0].shape[0] == N_BLOCKS, a[0].shape
    rel, err, flips, kept = hold_k5(a, kw)
    log(f"dynamics K5 on the vehicle's first dispatch (N={N_BLOCKS}): "
        f"windows within rel {rel:.3e} of each channel's maximum (limit "
        f"1e-5), max|diff| {err:.3e}, flips equal ({flips} flipped, "
        f"{a[4].numel() - kept} boundary-0 channel(s) left out), code "
        f"argmaxes equal [{card}]")
    k1_err = 0.0
    for a, kw in k1_calls[:2]:                 # that dispatch's two K1
        got = score.score_argmax(*a, **kw)
        want = score.score_argmax_plain(*a, **{k: v for k, v in kw.items()
                                               if k != "factors"})
        k1_err = max(k1_err, compare_scores(list(a), got, want, kw))
    k2_err = max(hold_k2(a, kw) for a, kw in k2_calls[-2:])  # the last step's
    log(f"dynamics K1 on that dispatch's windows: argmax equal or a tie "
        f"within 1e-6, max|best diff| {k1_err:.3e}; K2 on the 50th "
        f"per-block step: surface max|diff| {k2_err:.3e} (rtol 1e-6), max "
        f"and first index equal [{card}]")
    rows = {k: i for i, k in enumerate(tracking.LOG_F_ROWS)}
    for name, (loops, lf, li) in ramp.items():
        _, lfp, lip = tracking.track_chunk_plain(st_r, ramp_raw, ramp_tab,
                                                 FS, FCAID, loops)
        verdict, _ = compare_logs(lf, li, lfp.cpu().numpy(),
                                  lip.cpu().numpy(), rows)
        fi_err = float(np.median(np.abs(lf[-200:, rows["fi"], 0]
                                        - ramp_truth[-200:])))
        log(f"dynamics K4 ramp {name} (bn_carr_freq "
            f"{loops.bn_carr_freq:g}): kernel against plain {verdict}; "
            f"median |fi error| over the last 200 updates {fi_err:.2f} Hz "
            f"[{card}]")
        if loops.bn_carr_freq > 0.0:
            assert fi_err < 25.0, fi_err
        else:
            assert fi_err > 100.0, fi_err

    # (d) a paced live run through the tool, in a fresh interpreter
    with tempfile.TemporaryDirectory() as tmp:
        cap = pathlib.Path(tmp) / "cap.dat"
        samples.tofile(cap)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(REPO / "tools" / "live_run_torch.py"),
             "--seconds", f"{LIVE_SECONDS:g}", "--capture", str(cap)],
            capture_output=True, text=True, timeout=600, cwd=str(REPO))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    live = json.loads(r.stdout.strip().splitlines()[-1])
    assert live["rt_misses"] == 0 and live["blocks"] == round(
        LIVE_SECONDS / T), live
    log(f"dynamics live run (tools/live_run_torch.py --seconds "
        f"{LIVE_SECONDS:g}): {live['blocks']} blocks, "
        f"{live['iterations']} iterations, rt_misses {live['rt_misses']}, "
        f"avg_compute_ms {live['avg_compute_ms']}, max_compute_ms "
        f"{live['max_compute_ms']}, margin_x {live['margin_x']}, "
        f"server_behind_max_ms {live['server_behind_max_ms']}; tool wall "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    log(f"dynamics phase: wall {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return counts


# -- phase 29: card against CPU, block by block ------------------------------

TIE_REL = 1e-6           # a tie: two scores within this share of the peak
K5_REL = 1e-5            # K5's windows against plain (hold_k5)
# fixes up to the first parting: lattice cells filtered in float64, or the
# full EKF's R, a float64 function of float32 windows (ROADMAP Queue 3)
FIX_TOL_M, FULL_EKF_TOL_M = 1e-6, 1e-3


@dataclasses.dataclass
class Traced:
    """One run of phase 29 on one device: every K5 call's (args, kwargs),
    every scorer call's (args, kwargs) and result (K1 in a batched run, K2
    in the per-block one), the cells of every _apply_measurement, the
    fixes."""
    k5: list
    scorer: list
    outs: list
    cells: list
    fixes: list


def card_cpu_runs(first, hand, arr, grid) -> dict:
    """Phase 29's runs: name -> (the fixes' tolerance up to the first
    parting [m], the capture with its truth for the RMS or None, make(dev)
    -> (receiver, drive)). Each run is made the same way on both
    devices, from the same int16 samples, handoff and ephemerides."""
    man = moving_capture(60, 7, MOVE_ACC)
    veh = dyn_env._capture("vehicle", DYN_SECONDS)

    def maneuver(mode):
        def make(dev):
            smp, h, ar, _ = man
            rx = DPEReceiver(SampleFile(samples=smp.copy(), fs=FS),
                             copy.deepcopy(h), grid=grid,
                             eph=copy.deepcopy(ar),
                             config=DPEConfig(ekf_mode=mode, ekf_alpha=0.3),
                             device=dev)
            return rx, lambda: rx.run_batched(60, lookahead=10)
        return make

    def main_path(dev):
        rx = receiver(first, hand, arr, grid, dev)
        raw = torch.from_numpy(first[:S * 200].view(np.int16)
                               .reshape(-1, S, 2)).to(dev)
        run = dict(lookahead=N_BLOCKS, raw_blocks_dev=raw, pipeline=True,
                   pipeline_depth=4)

        def drive():
            rx.run_batched(100, start_block=0, **run)
            rx.run_batched(100, start_block=100, group_k=5, **run)
        return rx, drive

    def per_block(dev):
        smp, h, ar, _ = veh
        rx = DPEReceiver(SampleFile(samples=smp, fs=FS), copy.deepcopy(h),
                         grid=grid, eph=copy.deepcopy(ar), device=dev)
        return rx, lambda: rx.run(50)

    return {"maneuver alpha": (FIX_TOL_M, man, maneuver("alpha")),
            "maneuver full EKF": (FULL_EKF_TOL_M, man, maneuver("full")),
            "main path": (FIX_TOL_M, None, main_path),
            "per-block step": (FIX_TOL_M, None, per_block)}


def traced(make, dev) -> Traced:
    """make(dev)'s run with every K5 and scorer call and every measurement
    recorded as the path makes them."""
    rx, drive = make(dev)
    t = Traced([], [], [], [], [])
    inner = rx._apply_measurement

    def apply(pa, va, *a, **kw):
        t.cells.append((pa, va))
        return inner(pa, va, *a, **kw)

    rx._apply_measurement = apply
    with recording(dpe_real, "windowed_correlate", t.k5), \
            recording(dpe_real, "score_argmax", t.scorer, t.outs), \
            recording(dpe_real, "score_surface_argmax", t.scorer, t.outs):
        drive()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t.fixes = list(rx.fixes)
    return t


def measurements(t: Traced) -> list:
    """One entry a fix: {"call": the index of its position scorer call
    (the velocity's follows), "row": its block in that call, "pos"/"vel":
    (cell, peak)}."""
    out = []
    for i in range(0, len(t.scorer), 2):
        (pa, _), (va, _) = t.scorer[i], t.scorer[i + 1]
        assert pa[4] is not None and va[4] is None, i     # pos, then vel
        (pb, parg), (vb, varg) = (
            (o[-2].cpu().numpy(), o[-1].cpu().numpy())
            for o in t.outs[i:i + 2])
        out += [dict(call=i, row=r, pos=(int(parg[r]), float(pb[r])),
                     vel=(int(varg[r]), float(vb[r])))
                for r in range(len(parg))]
    if t.cells:                     # batched: the cells the EKF was given
        assert t.cells == [(m["pos"][0], m["vel"][0]) for m in out]
    assert len(out) == len(t.fixes), (len(out), len(t.fixes))
    return out


def hold_same_inputs(t: Traced, ref) -> dict:
    """Step 2 of phase 29: every recorded call of the card run, kernel on
    the card against the plain version on the same inputs on `ref`: K5 by
    hold_k5, K1 by compare_scores, K2 by hold_k2 (ties allowed where they
    hold on both surfaces)."""
    k5_rel = 0.0
    for a, kw in t.k5:
        k5_rel = max(k5_rel, hold_k5(a, kw, ref=ref)[0])
    ties, n1, n2 = [], 0, 0
    for (a, kw), out in zip(t.scorer, t.outs):
        ref_a = on_device(a, ref)
        if len(out) == 2:                      # K1 (best, arg); K2 adds
            # the surface
            n1 += 1
            compare_scores(list(a), score.score_argmax(*a, **kw),
                           score.score_argmax(*ref_a, **kw), kw, ref_a,
                           ties)
        else:                                             # K2
            n2 += 1
            hold_k2(a, kw, ref_a, ties)
    return dict(k5=len(t.k5), k5_rel=k5_rel, k1=n1, k2=n2, ties=ties)


def float64(args):
    return [None if x is None else x.detach().cpu().double() for x in args]


def classify_parting(card: Traced, cpu: Traced, mc: dict, mp: dict) -> dict:
    """Step 3 of phase 29 at the first measurement whose cells part (the
    card's kernels held to plain on every call's inputs before this): per
    manifold that parted, both cells scored in float64 from the card's
    scorer windows and from the CPU's. A float32 near-tie when each window
    set puts its own device's cell first (within TIE_REL of the peak: the
    float32 scorer's rounding), each gap is within what the windows'
    difference moves the two scores (delta = card - cpu at each cell), and
    the windows agree within K5's tolerance; anything else a fault."""
    out = {}
    for k, man in enumerate(("pos", "vel")):
        (cc, pc), (cp, pp) = mc[man], mp[man]
        if cc == cp:
            continue
        (ac, kw), (ap, _) = card.scorer[mc["call"] + k], \
            cpu.scorer[mp["call"] + k]
        r = mc["row"]
        a64c, a64p = float64(ac), float64(ap)
        s_c = score_at(a64c, r, [cc, cp], kw).numpy()
        s_p = score_at(a64p, r, [cc, cp], kw).numpy()
        gap_c, gap_p = s_c[0] - s_c[1], s_p[1] - s_p[0]
        delta = s_c - s_p
        eps = TIE_REL * float(np.abs(np.concatenate([s_c, s_p])).max())
        wc, wp = a64c[0][r], a64p[0][r]
        w_rel = float(((wc - wp).abs() / wp.abs().amax(-1, keepdim=True))
                      .max())
        same_params = all(torch.equal(x[r].cpu(), y[r].cpu())
                          for x, y in zip(ac[1:5], ap[1:5]) if x is not None)
        tie = (min(gap_c, gap_p) >= -eps and w_rel < K5_REL
               and max(gap_c, gap_p) <= float(np.abs(delta).sum()) + eps)
        out[man] = dict(cells=(cc, cp), peaks=(pc, pp), gaps=(gap_c, gap_p),
                        rel_gap=max(abs(gap_c), abs(gap_p)) / abs(s_p).max(),
                        delta=tuple(delta), w_rel=w_rel,
                        same_params=same_params,
                        verdict="float32 near-tie" if tie else "FAULT")
    return out


def check_card_vs_cpu(first, hand, arr, grid, card, dev=None,
                      ref=None) -> dict:
    """Phase 29: card against CPU, block by block. Four runs, each once on
    the card and once on the CPU (the plain versions) from the same int16
    samples, handoff, ephemerides and DPEConfig on the spread grid at full
    width: tests/test_dynamics.py's maneuver (moving_capture(60, 7,
    MOVE_ACC)) through run_batched(60, lookahead=10) under the alpha
    filter and under the full EKF; phase 5's capture from the truth
    handoff, alpha, lookahead 50, pipeline depth 4, 100 blocks per block
    (two N = 50 dispatches) then 100 in coherent groups of 5
    (coherent_sum's path); DPEReceiver.run(50) on the vehicle profile (K2's
    path). Every K5, K1 and K2 call and every _apply_measurement's cells
    are recorded on both devices. (1) Every card call's inputs go through
    the kernel on the card and through the plain version on the CPU: K5
    within K5_REL of each channel's window maximum, flips and code
    argmaxes equal; K1 and K2 argmaxes equal or a tie that holds on both
    surfaces. (2) The free-running runs: cells equal and fixes within
    FIX_TOL_M (the full EKF: FULL_EKF_TOL_M) up to the first measurement
    whose cells part, which is
    classified (classify_parting) and must be a float32 near-tie. No cut:
    the CPU runs (the plain scorer over 390 625 points a block) take most
    of the phase's wall. dev/ref default to cuda/cpu. Returns the launches
    of the card runs by kernel key."""
    t_phase = time.perf_counter()
    dev = torch.device(dev or "cuda")
    ref = torch.device(ref or "cpu")
    runs = card_cpu_runs(first, hand, arr, grid)
    launches = {}
    for name, (tol, man, make) in runs.items():
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        on_card = traced(make, dev)
        card_s = time.perf_counter() - t0
        for k, v in _build.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        t0 = time.perf_counter()
        on_cpu = traced(make, ref)
        cpu_s = time.perf_counter() - t0
        held = hold_same_inputs(on_card, ref)
        log(f"card vs CPU {name}: same inputs held on every call: K5 "
            f"{held['k5']} calls (windows within rel {held['k5_rel']:.3e} of "
            f"each channel's maximum, limit {K5_REL:g}; flips and code "
            f"argmaxes equal), K1 {held['k1']} calls, K2 {held['k2']} calls "
            f"(argmax equal, ties held on both surfaces: "
            f"{held['ties'] or 'none'}) [{card}]")
        m_c, m_p = measurements(on_card), measurements(on_cpu)
        assert len(m_c) == len(m_p), (len(m_c), len(m_p))
        part, worst = None, 0.0
        for i, (a, b) in enumerate(zip(m_c, m_p)):
            if (a["pos"][0], a["vel"][0]) != (b["pos"][0], b["vel"][0]):
                part = i
                break
            gap = float(np.abs(on_card.fixes[i].x_ecef
                               - on_cpu.fixes[i].x_ecef).max())
            assert gap <= tol, (name, i, gap)
            worst = max(worst, gap)
        rms = ""
        if man is not None:
            truth, t_h = man[3], man[1].rx_time
            rms = "; RMS card {:.3f} m, CPU {:.3f} m".format(*(
                rms_error([f.x_ecef for f in t.fixes],
                          [f.rx_time - t_h for f in t.fixes], truth,
                          MOVE_ACC) for t in (on_card, on_cpu)))
        head = (f"card vs CPU {name}: {len(m_c)} measurements, cells equal "
                f"and fixes within {worst:.3e} m (limit {tol:g})")
        if part is None:
            log(f"{head} over all of them; first parting: none{rms}; card "
                f"{card_s:.1f} s, CPU {cpu_s:.1f} s [{card}]")
            continue
        cls = classify_parting(on_card, on_cpu, m_c[part], m_p[part])
        desc = "; ".join(
            f"{man_}: cells card {c['cells'][0]} / CPU {c['cells'][1]}, "
            f"peaks {c['peaks'][0]!r} / {c['peaks'][1]!r}, float64 gaps "
            f"(own cell first) on the card's windows {c['gaps'][0]:.6g}, "
            f"on the CPU's {c['gaps'][1]:.6g} (rel {c['rel_gap']:.3e}), "
            f"card - CPU at the cells {c['delta'][0]:.6g} / "
            f"{c['delta'][1]:.6g}, windows apart by {c['w_rel']:.3e} of a "
            f"channel's maximum, parameters "
            f"{'equal' if c['same_params'] else 'differ'}: {c['verdict']}"
            for man_, c in cls.items())
        log(f"{head} up to measurement {part}; first parting: block "
            f"{on_card.fixes[part].mc} (K1/K2 and K5 held to plain at its "
            f"inputs above), {desc}{rms}; card {card_s:.1f} s, CPU "
            f"{cpu_s:.1f} s [{card}]")
        assert all(c["verdict"] == "float32 near-tie"
                   for c in cls.values()), (name, part, cls)
    log(f"card vs CPU phase: launches {launches}, wall "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


# -- phase 25: the mesh -------------------------------------------------------

MESH_RUNS = ("batched", "integrated", "per-block", "fft", "survey")
# the runs whose dispatches split blocks (or channels) over ranks
AUDITED = ("batched", "integrated", "survey", "chan split")
MESH_TIMEOUT_S = 300


def mesh_case(name, first, hand, arr, grid, dev, mesh):
    """One receiver run of phase 25 on the first 12 s (phase 5's capture and
    truth handoff), with `mesh` or on one device: (fixes [n, 8], extra
    {name: array}, dispatches). "batched" is phase 5's sequence (100 warm-up
    blocks, 200 per block, 200 in groups of 5; lookahead 50, depth 4)."""
    raw_dev = torch.from_numpy(first.view(np.int16).reshape(-1, S, 2)).to(dev)
    run = dict(lookahead=N_BLOCKS, raw_blocks_dev=raw_dev, pipeline=True,
               pipeline_depth=4)
    extra, dispatches = {}, 0
    cfg = dict(engine="fft") if name == "fft" else {}
    rx = receiver(first, hand, arr, grid, dev, mesh, **cfg)
    if name == "batched":
        for start, gk, n in ((0, 1, 50), (50, 5, 50), (100, 1, 200),
                             (300, 5, 200)):
            rx.run_batched(n, start_block=start, group_k=gk, **run)
            dispatches += n // N_BLOCKS
    elif name == "integrated":
        rx.run_integrated(25, 8, raw_blocks_dev=raw_dev)
        dispatches = 25
    elif name == "per-block":
        rx.run(20)
        dispatches = 20
    elif name == "fft":
        rx.run(10)
        dispatches = 10
    elif name == "survey":
        res = rx.run_survey(4, 50, raw_blocks_dev=raw_dev)
        extra["survey"] = res.x_ecef
        dispatches = 4 + 6
    elif name == "chan split":
        rx.run_batched(50, **run)
        dispatches = 1
    torch.cuda.synchronize()
    return np.stack([f.x_ecef for f in rx.fixes]), extra, dispatches


def scorer_windows(args, kw, groups, mesh=None, parts=1):
    """The magnitude windows the scorer sees, the flips and the packed
    parameters of their rows, for the arguments of a dpe_batch_blocks or
    dpe_scan_integrate call: correlated on `mesh`, or, with parts > 1, as
    that many grid ranks correlate them (each its `even_rows` share of the
    blocks, on one card), the shares concatenated."""
    raw, pk, chips, time_idc = args[:4]
    fpk, ipk = dpe_real.unpack_params(dpe_real.to_device(pk, raw.device))
    start, n = int(pk[0, dpe_real.START_ROW, 0]), kw["n_blocks"]
    cplx = groups > 1 or kw.get("coherent", False)

    def corr(lo, hi, m):
        return dpe_real.batch_correlate(
            raw, start + lo, fpk[lo:hi], ipk[lo:hi], chips, time_idc,
            kw["carr_fftpts"], kw["period"], kw["n_periods"], hi - lo,
            kw["code_win"], kw["carr_win"], complex_out=cplx, mesh=m)

    if parts > 1:
        shares = [corr(lo, hi, None) for lo, hi in score.even_rows(n, parts)]
        out = type(shares[0])(*(torch.cat(f) for f in zip(*shares)))
    else:
        out = corr(0, n, mesh)
        if mesh is not None:
            out = dpe_real.gather_chan_out(mesh, out, chips.shape[0])
    flips = out.flip_used
    if cplx:
        g = groups if groups > 1 else n
        out = dpe_real.coherent_sum(dpe_real.RealBlockOutC(
            *(x.reshape((-1, g) + x.shape[1:]) for x in out)))
        fpk = fpk[g - 1::g]
    return out, flips, fpk


def hold_to_single(got, single, args, kw, idx_m, idx_s, peaks_m, peaks_s,
                   block_sum):
    """Windows, flips and argmaxes of a split correlation (`got`, from
    scorer_windows) against one device's whole call (`single`): flips
    equal, windows within rel 1e-5 (max |diff| over max |single|), peaks
    within rtol 1e-5, and each argmax equal or a proven tie (the single
    device's windows score both indices within 1e-6 of each other, summed
    over blocks where the call sums them). Returns (rel, window elements
    that differ, of how many, whether an argmax differed)."""
    (wm, fm, _), (ws, fs, fpk) = got, single
    assert torch.equal(fm, fs), "flips differ"
    rel, n_diff, n_all = 0.0, 0, 0
    for a, b in ((wm.code_mag, ws.code_mag), (wm.carr_mag, ws.carr_mag)):
        rel = max(rel, ((a - b).abs().max() / b.abs().max()).item())
        n_diff += int((a != b).sum())
        n_all += b.numel()
    assert rel < 1e-5, rel
    np.testing.assert_allclose(peaks_m, peaks_s, rtol=1e-5)
    d = args[4:8]
    los = fpk[:, 3:6].transpose(1, 2)
    tied = False
    for j, (win, off3, off1, cen, coe, r0) in enumerate((
            (ws.code_mag, d[0], d[1], fpk[:, 7], fpk[:, 8], fpk[:, 6]),
            (ws.carr_mag, d[2], d[3], fpk[:, 9], fpk[:, 10], None))):
        for n in np.nonzero(idx_m[j] != idx_s[j])[0]:
            rows = slice(None) if block_sum else slice(n, n + 1)
            at = [score.score_points(
                win[rows], los[rows], cen[rows], coe[rows],
                None if r0 is None else r0[rows], off3[i:i + 1],
                off1[i:i + 1], kw["interp"], kw["l_power"]).sum().item()
                for i in (int(idx_m[j][n]), int(idx_s[j][n]))]
            assert abs(at[0] - at[1]) <= 1e-6 * abs(at[1]), (j, n, at)
            tied = True
    return rel, n_diff, n_all, tied


class DispatchAudit:
    """While entered, the receivers' dpe_batch_blocks and
    dpe_scan_integrate calls go through `_batch` and `_integrate`, which
    call the originals (`_orig`)."""

    def __init__(self):
        self._orig = (dpe_real.dpe_batch_blocks, dpe_real.dpe_scan_integrate)

    def __enter__(self):
        dpe_real.dpe_batch_blocks = self._batch
        dpe_real.dpe_scan_integrate = self._integrate
        return self

    def __exit__(self, *exc):
        dpe_real.dpe_batch_blocks, dpe_real.dpe_scan_integrate = self._orig


class MeshAudit(DispatchAudit):
    """Holds every dispatch that a mesh run makes through dpe_batch_blocks
    and dpe_scan_integrate to the same call without the mesh, on the same
    inputs (`hold_to_single`, on the windows the scorer sees: per block,
    per coherent group, or summed coherently), while the run goes on with
    the mesh's results. Records, per dispatch, the rows it returned and
    whether an argmax differed."""

    def __init__(self):
        super().__init__()
        self.rel, self.rows, self.tied = 0.0, [], []

    def _check(self, args, kw, idx_m, idx_s, peaks_m, peaks_s, groups,
               block_sum):
        rel, _, _, tied = hold_to_single(
            scorer_windows(args, kw, groups, mesh=kw["mesh"]),
            scorer_windows(args, kw, groups), args, kw, idx_m, idx_s,
            peaks_m, peaks_s, block_sum)
        self.rel = max(self.rel, rel)
        self.tied.append(tied)

    def _batch(self, *args, **kw):
        got = self._orig[0](*args, **dict(kw, return_windows=True))
        if kw["mesh"] is not None:
            want = self._orig[0](*args, **dict(kw, return_windows=True,
                                              mesh=None))
            g, w = got.cpu().numpy(), want.cpu().numpy()
            self._check(args, kw, dpe_real.unpack_row_indices(g),
                        dpe_real.unpack_row_indices(w), g[:, [1, 3]],
                        w[:, [1, 3]], kw.get("group_k", 1), False)
            self.rows.append(got.shape[0])
        if not kw["return_windows"]:
            c = args[2].shape[0]
            got = got[:, :4 + c + (0 if kw["use_argmax"]
                                   else dpe_real.WMEAN_COLS)]
        return got

    def _integrate(self, *args, **kw):
        got = self._orig[1](*args, **kw)
        if kw["mesh"] is not None:
            want = self._orig[1](*args, **dict(kw, mesh=None))
            g, w = got[0].cpu().numpy()[None], want[0].cpu().numpy()[None]
            self._check(args, kw, dpe_real.unpack_row_indices(g),
                        dpe_real.unpack_row_indices(w), g[:, [1, 3]],
                        w[:, [1, 3]], 1, True)
            self.rows.append(1)
        return got

    def summary(self) -> dict:
        first = self.tied.index(True) if any(self.tied) else None
        return dict(dispatches=len(self.rows), rel=self.rel,
                    ties=int(sum(self.tied)),
                    fixes_before_first_tie=(None if first is None
                                            else sum(self.rows[:first])))


SPLITS = (2, 3, 4)      # grid ranks whose block shares SplitAudit forms


class SplitAudit(DispatchAudit):
    """On one card, holds each dispatch that a single-device run makes
    through dpe_batch_blocks and dpe_scan_integrate against the same blocks
    correlated as 2, 3 and 4 grid ranks would (`scorer_windows` with
    parts=; 50 blocks go 25/25, 17/17/16 and 13/13/12/12), each argmax
    from K1 on the split windows against K1 on the whole call's
    (`hold_to_single`). Records per split: dispatches, window elements
    that differ and of how many, the worst rel, and the argmaxes that
    differed (each a proven tie)."""

    def __init__(self):
        super().__init__()
        self.stats = {p: dict(dispatches=0, n_diff=0, n_all=0, rel=0.0,
                              ties=0) for p in SPLITS}

    @staticmethod
    def _argmaxes(win, fpk, args, kw, block_sum):
        """([pos idx], [vel idx]), [[pos peak, vel peak] per row] by K1."""
        d = args[4:8]
        los = fpk[:, 3:6].transpose(1, 2)
        res = [score.score_argmax(w, los, cen, coe, r0, o3, o1,
                                  interp=kw["interp"], l_power=kw["l_power"],
                                  block_sum=block_sum)
               for w, cen, coe, r0, o3, o1 in (
                   (win.code_mag, fpk[:, 7], fpk[:, 8], fpk[:, 6], d[0],
                    d[1]),
                   (win.carr_mag, fpk[:, 9], fpk[:, 10], None, d[2], d[3]))]
        idx = [np.atleast_1d(r[1].cpu().numpy()) for r in res]
        peaks = np.stack([np.atleast_1d(r[0].cpu().numpy()) for r in res], 1)
        return idx, peaks

    def _audit(self, args, kw, groups, block_sum):
        single = scorer_windows(args, kw, groups)
        idx_s, peaks_s = self._argmaxes(single[0], single[2], args, kw,
                                        block_sum)
        for p in SPLITS:
            got = scorer_windows(args, kw, groups, parts=p)
            idx_m, peaks_m = self._argmaxes(got[0], got[2], args, kw,
                                            block_sum)
            rel, n_diff, n_all, tied = hold_to_single(
                got, single, args, kw, idx_m, idx_s, peaks_m, peaks_s,
                block_sum)
            st = self.stats[p]
            st["dispatches"] += 1
            st["n_diff"] += n_diff
            st["n_all"] += n_all
            st["rel"] = max(st["rel"], rel)
            st["ties"] += sum(int((a != b).sum())
                              for a, b in zip(idx_m, idx_s))

    def _batch(self, *args, **kw):
        self._audit(args, kw, kw.get("group_k", 1), False)
        return self._orig[0](*args, **kw)

    def _integrate(self, *args, **kw):
        self._audit(args, kw, 1, True)
        return self._orig[1](*args, **kw)


def mesh_child(spec_path: str) -> int:
    """A rank of phase 25 (this script with --mesh-child SPEC): joins its
    group (nccl at world size 1 through make_mesh, or gloo on cuda:0
    through parallel/launch.init_distributed) and runs spec["runs"] on the
    mesh, then for gloo the chan=2 x grid=1 mesh on 50 blocks; each run
    whose dispatches split blocks or channels first under a MeshAudit,
    then once more timed, with the launch counts and the mesh's collective
    counters zeroed before it (its fixes equal to the audited run's). On
    gloo rank 1, its K1 slice against the plain version. Writes <out>.npz
    (fixes) and <out>.json (stats)."""
    import pickle

    import torch.distributed as dist
    from navlab_dpe_sdr_tpu_torch.parallel import launch
    from navlab_dpe_sdr_tpu_torch.parallel.mesh import make_mesh

    spec = json.loads(pathlib.Path(spec_path).read_text())
    dev = torch.device("cuda", 0)
    first = np.load(spec["samples"])
    with open(spec["handoff"], "rb") as f:
        hand, arr = pickle.load(f)
    grid = spread_grid()
    if spec["backend"] == "gloo":
        launch.init_distributed(f"file://{spec['rdv']}", spec["world"],
                                spec["rank"], device=dev, backend="gloo")
    mesh = make_mesh(device=dev)
    fixes, stats = {}, {"rank": dist.get_rank(), "backend": mesh.backend,
                        "shape": mesh.shape, "runs": {}}
    try:
        cases = [(name, mesh) for name in spec["runs"]]
        if spec["backend"] == "gloo":
            cases.append(("chan split", make_mesh(n_chan=2, device=dev)))
        for name, m in cases:
            audit = None
            if spec["audit"] and name in AUDITED:
                with MeshAudit() as audit:
                    audited = mesh_case(name, first, hand, arr, grid, dev, m)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            m.reset_stats()
            t0 = time.perf_counter()
            fx, extra, dispatches = mesh_case(name, first, hand, arr, grid,
                                              dev, m)
            wall = time.perf_counter() - t0
            launched = {k: v for k, v in _build.launch_counts().items() if v}
            if audit is not None:
                np.testing.assert_array_equal(fx, audited[0])
            fixes[name] = fx
            for k, v in extra.items():
                fixes[f"{name}.{k}"] = v
            stats["runs"][name] = dict(
                wall_s=wall, collectives=m.collectives,
                collective_ms=m.collective_s * 1e3, dispatches=dispatches,
                shape=m.shape, launches=launched,
                audit=None if audit is None else audit.summary())
        if spec["backend"] == "gloo" and dist.get_rank() == 1:
            stats["k1_slice"] = k1_slice_vs_plain(grid, dev, mesh)
        np.savez(spec["out"] + ".npz", **fixes)
        pathlib.Path(spec["out"] + ".json").write_text(json.dumps(stats))
    finally:
        mesh.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def k1_slice_vs_plain(grid, dev, mesh):
    """This rank's K1 call on its grid rows, as the mesh path makes it
    (ops/dpe_real._score_rows), against score_argmax_plain on the same rows
    with the rows' offset added (argmax equal or a tie, best rtol 1e-5)."""
    cw, _ = dpe_ops.auto_windows(grid.d_enu, grid.dt_m, grid.dv_enu,
                                 grid.dtdot, FS, CARR_FFTPTS)
    args = scorer_inputs(np.random.default_rng(SEED), "pos", cw, grid, dev)
    lo, hi = mesh.grid_rows(args[5].shape[0])
    best, arg = dpe_real._score_rows(mesh, *args, "quadratic", 1, False,
                                     False, False)
    sliced = args[:5] + [args[5][lo:hi], args[6][lo:hi]]
    want = score.score_argmax_plain(*sliced)
    err = compare_scores(sliced, (best, arg - lo), want, dict(
        interp="quadratic", l_power=1, weighted=False))
    return dict(rows=[lo, hi], max_abs_err=err)


def start_mesh_children(specs, tmp):
    """Start this script with --mesh-child for each spec; wait for all by a
    deadline (then kill them), require exit 0. Returns their (stats,
    fixes)."""
    procs = []
    for i, spec in enumerate(specs):
        path = tmp / f"spec{i}.json"
        path.write_text(json.dumps(spec))
        log_f = open(tmp / f"child{i}.log", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--mesh-child", str(path)], stdout=log_f,
            stderr=subprocess.STDOUT, cwd=REPO), log_f))
    deadline = time.monotonic() + MESH_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, log_f) in enumerate(procs):
        log_f.seek(0)
        text = log_f.read()
        log_f.close()
        assert p.returncode == 0, f"mesh child {i} exit {p.returncode}:\n" \
                                  f"{text[-4000:]}"
    return [(json.loads(pathlib.Path(sp["out"] + ".json").read_text()),
             dict(np.load(sp["out"] + ".npz"))) for sp in specs]


# After a proven tie the two runs may take neighbouring grid points and go
# on from different states: one step of the spread grid's finest spacing
# along each of its axes (5 m in E, N and U; 6 m of clock; 0.5 m/s in E, N
# and U; 0.25 m/s of drift), as gaps of position, clock, velocity, drift.
AFTER_TIE = np.array([5.0 * np.sqrt(3), 6.0, 0.5 * np.sqrt(3), 0.25])


def fix_gaps(got, want):
    """Per fix [n, 4]: |position diff| [m], |clock diff| [m], |velocity
    diff| [m/s], |drift diff| [m/s] of two [n, 8] state sequences."""
    d = got - want
    return np.stack([np.linalg.norm(d[:, :3], axis=1), np.abs(d[:, 3]),
                     np.linalg.norm(d[:, 4:7], axis=1), np.abs(d[:, 7])], 1)


def same_fixes(got, want, audit, exact=True):
    """The mesh run's fixes against one device's: equal (to the bit, or
    within 1e-6 with the channels split) up to the first dispatch where an
    argmax differed as a proven tie (MeshAudit), and every later fix
    within AFTER_TIE of one device's. Returns (how many fixes came before
    the first tie, the largest gaps after it [4] or None)."""
    upto = len(want)
    if audit is not None and audit["fixes_before_first_tie"] is not None:
        upto = audit["fixes_before_first_tie"]
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got[:upto], want[:upto])
    else:
        np.testing.assert_allclose(got[:upto], want[:upto], rtol=0,
                                   atol=1e-6)
    if upto == len(want):
        return upto, None
    after = fix_gaps(got[upto:], want[upto:]).max(axis=0)
    assert (after <= AFTER_TIE).all(), (after, AFTER_TIE)
    return upto, after


def check_mesh(samples, hand, arr, grid, dev, card, phase5_fixes):
    """Phase 25: DPEConfig(mesh=...) at full width on phase 5's 12 s, in
    child processes (this process keeps no process group): (a) NCCL at
    world size 1, phase 5's batched sequence, its fixes equal to phase 5's
    to the bit, then parallel/launch.py --bench-only; (b) two gloo ranks
    sharing cuda:0 on grid=2: the batched sequence, run_integrated (25
    fixes of 8), 20 per-block steps, 10 FFT-engine steps, a 4-batch survey
    and, on chan=2 x grid=1, run_batched(50), every dispatch that splits
    blocks or channels held to one device's on the same inputs
    (MeshAudit: windows to the bit), the fixes equal to one device's run
    (phase 5's for the batched sequence) to the bit over every fix (with
    the channels split: within 1e-6 up to the first proven tie and within
    AFTER_TIE after it), and equal on both ranks; rank 1's K1 slice
    against its plain version; (c) first, on one card and in this process,
    one device's batched sequence (equal to phase 5's), run_integrated and
    survey, each dispatch also correlated as 2, 3 and 4 grid ranks share
    its blocks (SplitAudit: no window element differs). Returns {kernel:
    launches} of the timed mesh runs (rank 0 of each launch)."""
    import pickle

    first = samples[:S * 600]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = pathlib.Path(tmp_s)
        np.save(tmp / "first.npy", first)
        with open(tmp / "hand.pkl", "wb") as f:
            pickle.dump((hand, arr), f)
        common = dict(samples=str(tmp / "first.npy"),
                      handoff=str(tmp / "hand.pkl"))
        t_phase = t0 = time.perf_counter()
        with SplitAudit() as split:
            again = mesh_case("batched", first, hand, arr, grid, dev, None)
            refs = {name: mesh_case(name, first, hand, arr, grid, dev, None)
                    for name in ("integrated", "survey")}
        np.testing.assert_array_equal(again[0], phase5_fixes)
        for p, st in split.stats.items():
            shares = ["/".join(str(hi - lo) for lo, hi in score.even_rows(
                n, p)) for n in (N_BLOCKS, 8)]
            log(f"mesh (c) one card, the blocks split as {p} grid ranks "
                f"take them ({shares[0]} of 50, {shares[1]} of an "
                f"integrated fix's 8): {st['dispatches']} dispatches (the "
                f"batched sequence, run_integrated, the survey) against the "
                f"whole call: {st['n_diff']} of {st['n_all']} window "
                f"elements differ (limit 0: K5's windows do not depend on "
                f"the split), max rel {st['rel']:.3e}, flips equal, "
                f"{st['ties']} argmaxes differ; "
                f"{time.perf_counter() - t0:.1f} s for all three splits "
                f"[{card}]")
            assert st["n_diff"] == 0 and st["ties"] == 0, (p, st)
        refs.update({name: mesh_case(name, first, hand, arr, grid, dev,
                                     None)
                     for name in ("per-block", "fft", "chan split")})
        refs["batched"] = (phase5_fixes, {}, 0)

        def report(label, name, st, fixes_by_rank, matched, after=None):
            r = st["runs"][name]
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
            last = [fx[name][-1][:3].tolist() for fx in fixes_by_rank]
            tail = "" if after is None else (
                " up to the first tie, the rest within "
                + ", ".join(f"{v:.3f}" for v in after)
                + " (position m, clock m, velocity m/s, drift m/s) of them")
            au = r["audit"]
            audit = "" if au is None else (
                f"; audit of {au['dispatches']} dispatches against one "
                f"device: windows rel {au['rel']:.3e}, {au['ties']} with a "
                f"differing argmax (each a proven tie)")
            log(f"mesh {label}, {name}: wall {r['wall_s']:.3f} s, "
                f"{r['collectives']} collectives in {r['dispatches']} "
                f"dispatches/steps ({r['collectives'] / r['dispatches']:.2f} "
                f"a dispatch), {r['collective_ms']:.3f} ms of host clock in "
                f"them, launches {r['launches']}; {matched} of "
                f"{len(fixes_by_rank[0][name])} fixes equal to one device's"
                f"{tail}{audit}; last fix on every rank {last} [{card}]")

        (st_a, fx_a), = start_mesh_children([dict(
            common, backend="nccl", rank=0, world=1, runs=["batched"],
            audit=False, out=str(tmp / "nccl"))], tmp)
        assert st_a["backend"] == "nccl", st_a
        np.testing.assert_array_equal(fx_a["batched"], phase5_fixes)
        assert st_a["runs"]["batched"]["collectives"] > 0
        report("(a) nccl, world size 1", "batched", st_a, [fx_a],
               len(phase5_fixes))

        res = subprocess.run(
            [sys.executable, "-m", "navlab_dpe_sdr_tpu_torch.parallel.launch",
             "--coordinator", f"file://{tmp}/rdv_bench", "--num-processes",
             "1", "--process-id", "0", "--bench-only", "--device", "cuda"],
            capture_output=True, text=True, cwd=REPO, timeout=MESH_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-3000:]
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("[proc 0] ")][-1]
        bench = json.loads(line.split(" ", 2)[2])
        log(f"mesh (a) parallel/launch.py --bench-only, one rank (nccl, "
            f"world size 1), a single-device reading and no scaling number: "
            f"grid_points_per_s {bench['grid_points_per_s']:.6e}, "
            f"sec_per_block {bench['sec_per_block']:.6e} on "
            f"{bench['device']} [{card}]")

        specs = [dict(common, backend="gloo", rank=r, world=2,
                      rdv=str(tmp / "rdv_gloo"), runs=list(MESH_RUNS),
                      audit=True, out=str(tmp / f"gloo{r}"))
                 for r in range(2)]
        got = start_mesh_children(specs, tmp)
        stats, fixes = [g[0] for g in got], [g[1] for g in got]
        for st in stats:
            assert st["backend"] == "gloo" and st["shape"] == {
                "chan": 1, "grid": 2}, st
        for name in MESH_RUNS + ("chan split",):
            want, extra, _ = refs[name]
            audit = stats[0]["runs"][name]["audit"]
            matched, after = 0, None
            # the windows are one device's to the bit (K5 is batch- and
            # channel-invariant); the grid splits' fixes too, over every
            # fix; the channel split sums the channels in another order
            assert audit is None or audit["rel"] == 0.0, (name, audit)
            for fx in fixes:
                np.testing.assert_array_equal(fx[name], fixes[0][name])
                matched, after = same_fixes(fx[name], want, audit,
                                            exact=name != "chan split")
                if name != "chan split":
                    assert matched == len(want) and after is None, (
                        name, matched, after)
                for k, v in extra.items():   # the survey's state
                    if audit["rel"] == 0.0:
                        np.testing.assert_array_equal(fx[f"{name}.{k}"], v)
                    else:                    # one fine-lattice step
                        np.testing.assert_allclose(
                            fx[f"{name}.{k}"][:4], v[:4], rtol=0,
                            atol=0.25 * np.sqrt(3) + 1e-9)
            report("(b) gloo, 2 ranks on cuda:0", name, stats[0], fixes,
                   matched, after)
        k1 = stats[1]["k1_slice"]
        log(f"mesh (b) rank 1's K1 slice rows {k1['rows']} (G=390 625, "
            f"N=50): kernel == plain with the offset added, max|best diff| "
            f"{k1['max_abs_err']:.3e} [{card}]")
        log(f"mesh phase: wall {time.perf_counter() - t_phase:.1f} s "
            f"[{card}]")
    return launches


def main_path(first, hand, arr, grid, dev, card):
    """Phase 5 on the first 12 s (profile_dispatch.main_path) held to its
    limits: K1 twice and K5 once a dispatch, every fix finite, each
    segment's median error under 15 m. Returns (K1 and K5 launches of the
    timed segments, the fixes of the whole sequence [300, 8])."""
    res = dispatch_main_path(first, hand, arr, grid, dev, card, log)
    for name, seg in res["segments"].items():
        group_k = 5 if name.startswith("grouped") else 1
        assert seg["k1"] == 2 * (200 // N_BLOCKS), (name, seg)
        assert seg["k5"] == 200 // N_BLOCKS, (name, seg)
        assert seg["fixes"] == 200 // group_k, (name, seg)
        assert seg["finite"] and seg["median_m"] < 15.0, (name, seg)
    assert len(res["fixes"]) == 300, len(res["fixes"])
    for name, rec in res["dispatch"].items():
        assert rec["launches"] > 0, (name, "no device records")
    counts = res["counts"]
    # the spread grid is a product grid: every K1 launch is factored
    assert counts["score_argmax"] == 0 and counts[
        "score_argmax_factored"] == k1_count(counts), counts
    return k1_count(counts), counts["windowed_correlate"], res["fixes"]


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
    log(f"scorer: kernel == plain in all 16 cases and at N=10, 25 (max|best "
        f"diff| {k1['err']:.3e}); per dispatch (pos W={cw} + vel W={vw}, "
        f"G={grid.n_pos}, factored): N=50 wrapper {k1['ms']:.4f} ms, "
        f"kernel's own {fmt_ms(k1['device_ms'])}, plain "
        f"{k1['plain_ms']:.4f} ms; N=10 wrapper {k1['ms10']:.4f} ms, "
        f"kernel's own {fmt_ms(k1['device_ms10'])}; per-point N=50 wrapper "
        f"{k1['ms_per_point']:.4f} ms, kernel's own "
        f"{fmt_ms(k1['device_ms_per_point'])} [{card}]")
    k1_sum = check_block_sum(grid, widths, dev, card)
    check_factored(dev, card)

    t0 = time.perf_counter()
    samples, hand, arr = make_capture(CAPTURE_S)
    log(f"capture: {CAPTURE_S:.0f} s synthesized in "
        f"{time.perf_counter() - t0:.1f} s")
    first = samples[:S * 600]        # 500 timed and warm-up blocks + 100
    rel = check_dispatch(first, hand, arr, grid)
    log(f"dispatch: card == cpu on 5 blocks (indices, flips equal; "
        f"windows rel diff {rel:.2e})")

    k1_launches, k5_launches, phase5_fixes = main_path(
        first, hand, arr, grid, dev, card)

    k3 = check_correlator(dev, card)
    st0, raw0, table0 = tracker_inputs(samples, hand, dev)
    k4 = check_tracker(st0, raw0, table0, card)
    del raw0
    k2 = check_surface(grid, widths, dev, card)
    counts, k4_steps, rx_cold, k5_steps = check_cold_start(
        samples, hand, arr, grid, dev, card)

    k1_by_path = {"batched": k1_launches}
    k1s_by_path = {}
    k5_by_path = {"batched": k5_launches, "cold start":
                  counts["windowed_correlate"], "per-block": k5_steps}
    for path, check, k1_paths in (
            ("integrated", check_integrated, k1s_by_path),
            ("survey", check_survey, k1s_by_path),
            ("refined", check_refined, k1_by_path)):
        k1_paths[path], k5_by_path[path] = check(samples, hand, arr, grid,
                                                 dev, card)
    assert all(n > 0 for n in k1_by_path.values()), k1_by_path

    k4c = check_coherent(st0, samples, table0, card)
    k4b = check_batched(st0, samples, hand, table0, card)
    k3w = check_windows(samples, hand, dev, card)
    k4c_by_path = {"coherent cold start": check_coherent_cold_start(
        samples, hand, arr, dev, card)}
    k4c_by_path["weak start"] = check_weak_start(dev, card)
    loop_launches, loop = check_weak_decode(dev, card)
    k3w_launches = check_vector(samples, hand, arr, rx_cold, dev, card)

    k2_by_path = {"cold start": counts["score_surface"]}
    k4_by_path = {"cold start": counts["track_chunk"]}
    k2_by_path["fft engine"] = check_fft_engine(samples, hand, arr, grid,
                                                dev, card)
    fl = check_fleet(samples, hand, dev, card)
    k1_by_path["fleet"] = fl["k1"]
    k4_by_path["fleet"], k4_by_path["align"] = fl["k4"], fl["k4_align"]
    live = check_live_fleet(samples, hand, arr, dev, card)
    k2_by_path["live fleet"], k4_by_path["live fleet"] = live["k2"], \
        live["k4"]
    mc = check_montecarlo(samples, hand, dev, card)
    if k1_count(mc):                # the sweeps' DPE runs are integrated
        k1_by_path["montecarlo"] = k1_count(mc)
    k1s_by_path["montecarlo"] = k1_count(mc, K1_SUM_KEYS)
    k2_by_path["montecarlo"] = mc["score_surface"]
    k5_by_path.update({"fleet": fl["k5"], "live fleet": live["k5"],
                       "montecarlo": mc["windowed_correlate"]})
    t0 = time.perf_counter()
    cl = check_cli(samples, hand, dev, card)
    log(f"CLI phase: wall {time.perf_counter() - t0:.3f} s [{card}]")
    k1_by_path["cli"] = k1_count(cl)
    k1s_by_path["cli"] = k1_count(cl, K1_SUM_KEYS)
    k2_by_path["cli"] = cl["score_surface"]
    k4_by_path["cli"] = cl["track_chunk"]
    k4c_by_path["cli"] = cl["track_chunk_coherent"]
    k3_by_path = {"cold start": counts["correlate_window"],
                  "cli": cl["correlate_window"]}
    k4b_by_path = {"track(2000, batch_k=4)": k4b.pop("launches"),
                   "cli": cl["track_chunk_batched"]}
    k3w_by_path = {"vector": k3w_launches, "cli": cl["correlate_windows"]}
    k5_by_path["cli"] = cl.get("windowed_correlate", 0)
    bl = check_bench(samples, hand, arr, grid, dev, card)
    k1_by_path["bench"] = k1_count(bl)
    k2_by_path["bench"] = bl.get("score_surface", 0)
    k4_by_path["bench"] = bl.get("track_chunk", 0)
    k5_by_path["bench"] = bl.get("windowed_correlate", 0)
    dyn = check_dynamics(samples, dev, card)
    k1_by_path["dynamics"] = k1_count(dyn)
    k2_by_path["dynamics"] = dyn.get("score_surface", 0)
    k4_by_path["dynamics"] = dyn.get("track_chunk", 0)
    k5_by_path["dynamics"] = dyn.get("windowed_correlate", 0)
    cvc = check_card_vs_cpu(first, hand, arr, grid, card)
    k1_by_path["card vs cpu"] = k1_count(cvc)
    k2_by_path["card vs cpu"] = cvc.get("score_surface", 0)
    k5_by_path["card vs cpu"] = cvc.get("windowed_correlate", 0)
    mesh = check_mesh(samples, hand, arr, grid, dev, card, phase5_fixes)
    k1_by_path["mesh"] = k1_count(mesh)
    k1s_by_path["mesh"] = k1_count(mesh, K1_SUM_KEYS)
    k2_by_path["mesh"] = mesh.get("score_surface", 0)
    k5_by_path["mesh"] = mesh.get("windowed_correlate", 0)
    # last: after this phase's runs torch.profiler has shown no device
    # activity in a window (an H100 with torch 2.11), so the device records
    # of phases 5, 9 and 11 come before it
    k5 = check_k5(first, hand, arr, grid, dev, card)
    for by_path in (k1_by_path, k1s_by_path, k2_by_path, k4_by_path,
                    k4c_by_path, k4b_by_path, k3w_by_path, k5_by_path):
        assert all(n > 0 for n in by_path.values()), by_path

    # no single PyTorch call computes any of these functions: library_ms is
    # null throughout
    rows = [("K1", k1_by_path, k1),
            ("K1 block-summed", k1s_by_path, k1_sum), ("K2", k2_by_path, k2),
            ("K3", k3_by_path, k3), ("K4", k4_by_path, k4),
            ("K4 coherent", k4c_by_path, k4c),
            ("K4 batch_k", k4b_by_path, k4b),
            ("K3 windows", k3w_by_path, k3w), ("K5", k5_by_path, k5),
            ("navbits loop", {"weak decode": loop_launches}, loop)]
    kernels = [dict(KERNELS[k], launches=sum(by_path.values()),
                    max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    **r["bound"], library_ms=None, device_ms=r["device_ms"],
                    launches_by_path=by_path) for k, by_path, r in rows]
    kernels[0].update(ms_n10=k1["ms10"], device_ms_n10=k1["device_ms10"],
                      ms_per_point=k1["ms_per_point"],
                      device_ms_per_point=k1["device_ms_per_point"])
    kernels[1].update({k: v for k, v in k1_sum.items()
                       if k not in ("err", "ms", "plain_ms", "device_ms",
                                    "bound", "bound_ms")})
    kernels[7].update({k: v for k, v in k3w.items()
                       if k not in ("err", "ms", "plain_ms", "device_ms",
                                    "bound")})
    kernels[8].update({k: v for k, v in k5.items()
                        if k not in ("err", "ms", "plain_ms", "device_ms",
                                     "bound")})
    for k in kernels:
        log(f"{k['name']}: {k['ms']:.4f} ms against a bound of "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']}; "
            f"{100.0 * k['bound_ms'] / k['ms']:.2f} % of it) [{card}]")
    log(f"profiler: {TAKES['windows']} windows taken for the device records "
        f"and the kernels' own times, {TAKES['empty']} of them showing none "
        f"of the kernels sought and {TAKES['miscounted']} another count of a "
        f"kernel's launches than the calls made (each then taken again, "
        f"three times at most a reading)")
    # the cold-start path launches K3 standalone no time: its body runs as
    # K4's device code, once per tracked 1 ms step of each K4 launch
    kernels[3]["steps_inside_track_chunk"] = k4_steps
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2]))
    sys.exit(main())
