"""The port's benchmark: `bench.py`'s protocol, run on the port.

    python3 bench_torch.py [n_blocks [lookahead [group_k [depth]]]] [--device cuda|cpu]
    navlab-dpe-torch bench --blocks N

End-to-end DPE real-time factor on the demo-equivalent scenario: the 2.5 MHz
/ 8-PRN synthetic capture of `io/scenario.make_scenario(nav_data=True,
cn0_dbhz=47.0)`, 45 s (2250 blocks) by default, held on the device as an
int16 [blocks, 50000, 2] tensor, through `DPEReceiver.run_batched` on the
25^4 + 25^4 spread grid with `DPEConfig(ekf_mode="alpha", ekf_alpha=0.3)`:

- both dispatch signatures (per block, and coherent groups of `group_k`)
  are warmed first, so kernel builds, cuFFT plans and allocator growth
  fall outside the clock;
- a timed pass takes a fresh receiver through an untimed advance over the
  `2 * lookahead` warm-up blocks, then 200 per-block blocks, then the rest
  in coherent groups of `group_k` (lookahead 50, `pipeline_depth` 4); each
  segment's clock stops after its last drain, a host fetch, so the
  device's work is inside it; the headline is the median of
  NAVLAB_BENCH_REPEATS (default 3) passes, with their min and max;
- scalar tracking: K4 over 2000 ms int16 chunks uploaded before the
  clock, a host fetch after each, the first chunk warming;
- cold-start time to first fix (`_ttff`): acquire -> track 30 s, then 2 s
  at a time to 8/8 ephemerides (never past the capture's end) ->
  save_handoff -> `DPEReceiver.run(1)`, run twice, the second timed;
  skipped for a capture shorter than 36 s, or with NAVLAB_BENCH_SKIP_TTFF;
- on-device parity (`_parity_block`, skipped with
  NAVLAB_BENCH_SKIP_PARITY): on one capture block with the receiver's
  channel geometry, the correlator the receiver runs (K5 on the card)
  against the direct form `ops/correlate.windowed_correlate_direct`, and
  K1 against its plain version over the first 4096 grid points.

The last line of standard output is one JSON object with every key that
`bench.py` prints (`BENCH_PY_KEYS`), the same metric and unit strings and
the same meaning, plus `card` (nvidia-smi's name and power limit, or "cpu"),
`device_count` and `launches` (the kernel launches of the timed passes, the
scalar segment and the timed cold start). Numbers are not rounded. Comments
go to standard error. A failed phase raises: nothing is caught. The device
is "cuda" unless the caller asks for "cpu"; without a card it raises.

Differences from `bench.py`: the capture (the same samples as bench.py's)
is cached under its own name (`bench_torch_capture_<samples>.dat` in the
temporary directory's `navlab_tpu_fixtures/`); nothing moves the run to the
CPU; TTFF and parity are not wrapped in try/except; the parity's scorer
check holds K1 (the port's streaming argmax) to its plain version, under
bench.py's key `pallas_score_max_rel`.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device
from .models.grid import spread_grid

FS = 2.5e6
S = 50000              # samples per 20 ms block
T = 0.02               # seconds per block
N_SHORT = 200          # per-block segment, the round-over-round comparison
TRACK_CHUNK_MS = 2000  # the scalar segment's K4 chunk
PARITY_POINTS = 4096   # grid points of the parity block's K1 check
CACHE_DIR = os.path.join(tempfile.gettempdir(), "navlab_tpu_fixtures")
CACHE_PREFIX = "bench_torch_capture_"

# every key of bench.py's JSON line (bench.py:268-294), in its order
BENCH_PY_KEYS = (
    "metric", "value", "unit", "vs_baseline", "protocol", "value_minmax",
    "signal_seconds", "fix_median_m", "fix_p95_m", "rtf_first_200",
    "rtf_first_200_minmax", "coherent_group_k", "pipeline_depth",
    "grouped_fix_rate_hz", "fix_median_m_grouped", "scalar_track_rtf",
    "scalar_track_rtf_minmax", "ttff", "parity")
# bench.py's _parity_block keys, and what ran ("not run: cpu" on the CPU)
PARITY_KEYS = ("backend", "corr_code_max_rel", "corr_carr_max_rel",
               "corr_flip_equal", "corr_argmax_equal",
               "pallas_score_max_rel", "kernels")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card_name(device: torch.device) -> str:
    """nvidia-smi's "name, power limit" of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def protocol(n_blocks: int, lookahead: int,
             group_k: int) -> tuple[int, int, int]:
    """bench.py's repair of odd argv combinations: group_k must divide the
    lookahead (else their gcd), and the grouped segment is trimmed to a
    multiple of group_k. Returns (n_blocks, group_k, the per-block
    segment's blocks)."""
    if group_k > 1 and lookahead % group_k:
        gk = math.gcd(group_k, lookahead)
        log(f"group_k {group_k} does not divide lookahead {lookahead}; "
            f"using group_k={gk}")
        group_k = max(1, gk)
    n_short = min(N_SHORT, n_blocks)
    rem = (n_blocks - n_short) % group_k if group_k > 1 else 0
    if rem:
        log(f"trimming {rem} blocks so the grouped segment is a multiple "
            f"of group_k={group_k}")
        n_blocks -= rem
    return n_blocks, group_k, n_short


def bench_capture(n_blocks: int):
    """(samples int16 I/Q, truth handoff, ephemerides) of the bench
    scenario, n_blocks blocks long: the first n_blocks of a cached capture
    at least that long, or synthesized in one piece as bench.py does (the
    same samples as bench.py's capture of that length) and cached."""
    from .io.rawfile import DTYPE_IQ16
    from .io.scenario import make_scenario
    from .io.synth import release_workspace

    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n = S * n_blocks
    if os.path.isdir(CACHE_DIR):
        for name in sorted(os.listdir(CACHE_DIR)):
            if not (name.startswith(CACHE_PREFIX) and name.endswith(".dat")):
                continue
            path = os.path.join(CACHE_DIR, name)
            if os.path.getsize(path) >= DTYPE_IQ16.itemsize * n:
                log(f"cached capture: {path}")
                return np.fromfile(path, DTYPE_IQ16, count=n), hand, arr
    log(f"synthesizing {n / FS:.1f} s of 8-PRN capture...")
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    del iq
    release_workspace()             # ~8 GB of one-shot synthesis buffers
    path = os.path.join(CACHE_DIR, f"{CACHE_PREFIX}{n}.dat")
    try:
        os.makedirs(CACHE_DIR, exist_ok=True)
        samples.tofile(f"{path}.{os.getpid()}.tmp")
        os.replace(f"{path}.{os.getpid()}.tmp", path)
    except OSError as e:       # a read-only temporary directory: no cache
        log(f"capture not cached: {e}")
    return samples, hand, arr


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    from .ops import _build
    return {k: v for k, v in _build.launch_counts().items() if v}


def run(samples, hand, arr, grid, n_blocks: int, lookahead: int = 50,
        group_k: int = 5, depth: int = 4, device="cuda",
        errors_out: list | None = None) -> dict:
    """bench.py's protocol on the port over `samples` (int16 I/Q holding
    2 * lookahead + n_blocks blocks), the truth handoff `hand`, the
    ephemerides `arr` and `grid`. Returns the JSON object bench.py prints,
    with `card`, `device_count` and `launches` added. `errors_out`, if a
    list, receives each timed pass's fix errors [m] (per-block segment, then
    grouped) as one list a pass."""
    from .io.rawfile import SampleFile
    from .libgnss.cacode import ca_table
    from .models.dpe import DPEConfig, DPEReceiver
    from .ops import _build, tracking

    dev = resolve_device(device)
    n_blocks, group_k, n_short = protocol(n_blocks, lookahead, group_k)
    warmup = 2 * lookahead
    repeats = max(1, int(os.environ.get("NAVLAB_BENCH_REPEATS", "3")))
    if samples.shape[0] < S * (warmup + n_blocks):
        raise ValueError(f"capture holds {samples.shape[0] // S} blocks; the "
                         f"protocol needs {warmup + n_blocks}")
    card = card_name(dev)
    log(f"device: {dev} [{card}]")

    def fresh_rx():
        return DPEReceiver(SampleFile(samples=samples, fs=FS),
                           copy.deepcopy(hand), grid=grid,
                           eph=copy.deepcopy(arr),
                           config=DPEConfig(ekf_mode="alpha", ekf_alpha=0.3),
                           device=dev)

    raw_dev = torch.from_numpy(samples.view(np.int16).reshape(-1, S, 2)
                               ).to(dev)
    rx = fresh_rx()
    rx.run_batched(lookahead, lookahead=lookahead, raw_blocks_dev=raw_dev,
                   start_block=0)
    rx.run_batched(lookahead, lookahead=lookahead, raw_blocks_dev=raw_dev,
                   start_block=lookahead, group_k=group_k)
    _sync(dev)

    def timed_pass():
        """One two-segment pass with a fresh receiver: (rtf of the pass,
        rtf of the per-block segment, fix errors, per-block fixes)."""
        r = fresh_rx()
        pipe = dict(lookahead=lookahead, raw_blocks_dev=raw_dev,
                    pipeline=True, pipeline_depth=depth)
        # the handoff describes sample 0: advance the state, untimed, over
        # the warm-up blocks to the segment's start
        r.run_batched(warmup, start_block=0, **pipe)
        n_warm = len(r.fixes)
        t0 = time.perf_counter()
        r.run_batched(n_short, start_block=warmup, **pipe)
        w_short = time.perf_counter() - t0
        n_sf = len(r.fixes) - n_warm
        t1 = time.perf_counter()
        if n_blocks > n_short:
            r.run_batched(n_blocks - n_short, start_block=warmup + n_short,
                          group_k=group_k, **pipe)
        w = w_short + (time.perf_counter() - t1)
        e = [float(np.linalg.norm(f.x_ecef[0:3] - hand.x_ecef[0:3]))
             for f in r.fixes[n_warm:]]
        return n_blocks * T / w, n_short * T / w_short, e, n_sf

    _build.reset_launch_counts()
    passes = [timed_pass() for _ in range(repeats)]
    launches = {"passes": _launches()}
    if errors_out is not None:
        errors_out.extend(p[2] for p in passes)
    rtfs = sorted(p[0] for p in passes)
    rtfs_short = sorted(p[1] for p in passes)
    rtf = float(np.median(rtfs))
    rtf_short = float(np.median(rtfs_short))
    _, _, errs, n_short_fixes = passes[0]    # fixes identical across passes
    errs_grouped = errs[n_short_fixes:]
    signal_s = n_blocks * T
    n_scored = n_short + (n_blocks - n_short) / group_k
    gridpts_s = (n_scored * (grid.n_pos + grid.n_vel) * len(hand.prn_list)
                 / (signal_s / rtf))
    log(f"{n_blocks} blocks ({signal_s:.0f}s signal): rtf median {rtf:.2f}x "
        f"of {repeats} passes [{rtfs[0]:.2f}, {rtfs[-1]:.2f}]; median fix "
        f"error {np.median(errs):.2f} m (p95 {np.percentile(errs, 95):.2f}); "
        f"grouped-K{group_k} segment median "
        f"{np.median(errs_grouped) if errs_grouped else float('nan'):.2f} m; "
        f"first-{n_short}-block rtf {rtf_short:.2f}x [{rtfs_short[0]:.2f}, "
        f"{rtfs_short[-1]:.2f}] (per-block fixes); grid-point-channel "
        f"evals/s {gridpts_s:.3e} [{card}]")

    # scalar tracking: K4 over 2000 ms chunks of the capture, from the
    # truth handoff's channel state; uploads before the clock, a host fetch
    # after each chunk, the first chunk warming
    scalar_rtf, scalar_rtfs = None, []
    ms_blocks = samples.view(np.int16).reshape(-1, 2500, 2)
    n_chunks = min(ms_blocks.shape[0] // TRACK_CHUNK_MS, 5)
    if n_chunks >= 2:
        rf = SampleFile(samples=samples, fs=FS)
        tab = torch.from_numpy(ca_table(hand.prn_list).astype(np.float32)
                               ).to(dev)
        st = tracking.init_state(rc=hand.rc, ri=hand.ri, fc=hand.fc,
                                 fi=hand.fi, device=dev)
        chunks = [torch.from_numpy(
            ms_blocks[i * TRACK_CHUNK_MS:(i + 1) * TRACK_CHUNK_MS].copy()
        ).to(dev) for i in range(n_chunks)]
        st, lg = tracking.track_chunk(st, chunks[0], tab, FS, rf.fcaid)
        float(lg.iP.sum())
        _build.reset_launch_counts()
        for ch in chunks[1:]:
            t0 = time.perf_counter()
            st, lg = tracking.track_chunk(st, ch, tab, FS, rf.fcaid)
            float(lg.iP.sum())
            scalar_rtfs.append(TRACK_CHUNK_MS * 1e-3
                               / (time.perf_counter() - t0))
        launches["scalar"] = _launches()
        scalar_rtfs.sort()
        scalar_rtf = float(np.median(scalar_rtfs))
        log(f"scalar tracking: median {scalar_rtf:.1f}x of "
            f"{len(scalar_rtfs)} chunks [{scalar_rtfs[0]:.1f}, "
            f"{scalar_rtfs[-1]:.1f}] ({len(hand.prn_list)} channels)")

    ttff = None
    if samples.shape[0] < int(36.0 * FS):
        ttff = {"skipped": "capture shorter than the ~31 s LNAV "
                           "subframe-1-3 wait; run the full-length bench"}
    elif not os.environ.get("NAVLAB_BENCH_SKIP_TTFF"):
        ttff, launches["ttff"] = _ttff(samples, hand, grid, dev)
        log(f"ttff: {ttff}")

    parity = None
    if not os.environ.get("NAVLAB_BENCH_SKIP_PARITY"):
        parity = _parity_block(samples, hand, arr, grid, dev)
        log(f"parity: {parity}")

    return {
        "metric": "dpe_real_time_factor",
        "value": rtf,
        "unit": "x_realtime_2.5MHz_8prn_25^4grid",
        "vs_baseline": rtf / 1.0,
        "protocol": {"passes": repeats, "stat": "median",
                     "warmup": "one warm batch per dispatch signature"},
        "value_minmax": [rtfs[0], rtfs[-1]],
        "signal_seconds": signal_s,
        "fix_median_m": float(np.median(errs)),
        "fix_p95_m": float(np.percentile(errs, 95)),
        "rtf_first_200": rtf_short,
        "rtf_first_200_minmax": [rtfs_short[0], rtfs_short[-1]],
        "coherent_group_k": group_k,
        "pipeline_depth": depth,
        "grouped_fix_rate_hz": 1.0 / (group_k * T),
        "fix_median_m_grouped": (float(np.median(errs_grouped))
                                 if errs_grouped else None),
        "scalar_track_rtf": scalar_rtf,
        "scalar_track_rtf_minmax": ([scalar_rtfs[0], scalar_rtfs[-1]]
                                    if scalar_rtfs else None),
        "ttff": ttff,
        "parity": parity,
        "card": card,
        "device_count": torch.cuda.device_count() if dev.type == "cuda"
        else 0,
        "launches": launches,
    }


def _ttff(samples, hand, grid, dev):
    """Cold-start time to first fix (bench.py `_ttff`): acquisition,
    closed-loop tracking 30 s then 2 s at a time until every channel's
    ephemeris decodes (at most 44 s, and never past 2 s before the
    capture's end), handoff, first DPE fix. Run twice: the first warms the
    kernels, the second, a cold receiver state, is timed. Returns (wall
    seconds, signal seconds consumed, first-fix error, ephemerides decoded)
    as a dict, and the second run's launches."""
    from .io.rawfile import SampleFile
    from .models.dpe import DPEConfig, DPEReceiver
    from .models.scalar import ScalarReceiver
    from .ops import _build

    prns = list(hand.prn_list)
    most_ms = min(44_000, int(samples.shape[0] / FS * 1e3) - 2_000)

    def pipeline():
        rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), prns,
                            device=dev)
        rx.acquire(verbose=False)
        rx.track(30_000)
        signal_ms = 30_000
        good = rx.decode_ephemerides(verbose=False)
        while len(good) < len(prns) and signal_ms + 2_000 <= most_ms:
            rx.track(2_000)
            signal_ms += 2_000
            good = rx.decode_ephemerides(verbose=False)
        if len(good) < len(prns):
            raise RuntimeError(f"only {len(good)}/{len(prns)} ephemerides "
                               f"decoded in {signal_ms} ms")
        h = rx.save_handoff("")
        drx = DPEReceiver(SampleFile(samples=samples, fs=FS), h, grid=grid,
                          eph=rx.eph_array(), config=DPEConfig(), device=dev)
        fix = drx.run(1)[0]
        signal_s = h.bytes_read / 4 / FS + T
        return signal_s, float(np.linalg.norm(
            np.asarray(fix.x_ecef[0:3]) - hand.x_ecef[0:3])), len(good)

    pipeline()
    _sync(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    signal_s, fix_m, n_eph = pipeline()
    wall = time.perf_counter() - t0
    return ({"ttff_s": wall, "signal_s": signal_s, "first_fix_m": fix_m,
             "eph_decoded": n_eph}, _launches())


def _rel(a, b) -> float:
    """bench.py's max relative difference: max |a - b| over max |b|."""
    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    return float(np.max(np.abs(a - b) / (np.abs(b).max() + 1e-30)))


def _parity_block(samples, hand, arr, grid, dev):
    """The hot path's numerics against their oracles on `dev`, on the
    capture's first block with the channel geometry a receiver prepares
    for it: the correlator the receivers run (`windowed_correlate`: K5 on
    the card, its plain version on the CPU) against the direct form, and
    K1 (`score_argmax`) against its plain version over the first
    PARITY_POINTS points of both manifolds. On the CPU no kernel runs and
    both sides of the scorer check are the plain version."""
    from .io.rawfile import SampleFile
    from .models.dpe import DPEConfig, DPEReceiver
    from .ops import _build, correlate, score

    rx = DPEReceiver(SampleFile(samples=samples[:2 * S].copy(), fs=FS),
                     copy.deepcopy(hand), grid=grid, eph=copy.deepcopy(arr),
                     config=DPEConfig(), device=dev)
    fpk, ipk, *_ = rx._prepare_block()
    f = torch.from_numpy(fpk.astype(np.float32)).to(dev)        # [11, C]
    i = torch.from_numpy(ipk.astype(np.float32)).to(dev)        # [3, C]
    raw = torch.from_numpy(samples[:S].view(np.int16).reshape(1, S, 2)
                           .copy()).to(dev)
    d = rx._dev
    args = (raw[..., 0], raw[..., 1], d.chips, f[0][None], i[0][None],
            f[1][None], f[2][None], d.time_idc, i[1][None], i[2][None])
    kw = dict(carr_fftpts=rx.carr_fftpts, period=rx.period,
              n_periods=rx.S // rx.period, code_win=rx.code_win,
              carr_win=rx.carr_win)
    before = _build.launch_counts()
    fast = correlate.windowed_correlate(*args, **kw)
    direct = correlate.windowed_correlate_direct(*args, **kw)
    out = {
        "backend": dev.type,
        "corr_code_max_rel": _rel(fast.code_mag, direct.code_mag),
        "corr_carr_max_rel": _rel(fast.carr_mag, direct.carr_mag),
        "corr_flip_equal": bool(torch.equal(fast.flip_used.cpu(),
                                            direct.flip_used.cpu())),
        "corr_argmax_equal": bool(torch.equal(
            fast.code_mag.argmax(-1).cpu(), direct.code_mag.argmax(-1).cpu())),
    }

    # K1 (here the key bench.py gives its Pallas scorer) against the plain
    # version: the best score, and the plain surface at the kernel's first
    # index, which differs from the best only where the index does
    g = slice(0, PARITY_POINTS)
    los = f[3:6].T[None]
    rels = []
    for win, center, coef, r0, o3, o1 in (
            (fast.code_mag, f[7], f[8], f[6], d.d_enu, d.dt_m),
            (fast.carr_mag, f[9], f[10], None, d.dv_enu, d.dtdot)):
        sargs = (win, los, center[None], coef[None],
                 None if r0 is None else r0[None], o3[g], o1[g])
        best, arg = score.score_argmax(*sargs)
        surface = score.score_surface_plain(*sargs)
        plain_best = surface.max(dim=1).values
        rels += [_rel(best, plain_best),
                 _rel(surface.gather(1, arg.long()[:, None])[:, 0],
                      plain_best)]
    out["pallas_score_max_rel"] = max(rels)
    after = _build.launch_counts()
    ran = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    if dev.type == "cuda":
        if ran != {"windowed_correlate": 1, "score_argmax": 2}:
            raise RuntimeError(f"parity block launched {ran}, not K5 once "
                               f"and K1 twice")
        out["kernels"] = ran
    else:
        out["kernels"] = "not run: cpu"
    return out


def main(argv=None) -> int:
    """bench.py's argv (n_blocks lookahead group_k depth) and --device;
    prints the JSON line."""
    p = argparse.ArgumentParser(prog="bench_torch.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("n_blocks", nargs="?", type=int, default=2250)
    p.add_argument("lookahead", nargs="?", type=int, default=50)
    p.add_argument("group_k", nargs="?", type=int, default=5)
    p.add_argument("depth", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n_blocks, group_k, _ = protocol(args.n_blocks, args.lookahead,
                                    args.group_k)
    samples, hand, arr = bench_capture(n_blocks + 2 * args.lookahead)
    result = run(samples, hand, arr, spread_grid(), n_blocks,
                 lookahead=args.lookahead, group_k=group_k, depth=args.depth,
                 device=dev)
    print(json.dumps(result), flush=True)
    return 0
