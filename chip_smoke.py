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
   every case of manifold x l_power x interp x weighted, with both times;
4. one fused dispatch on the card against the same dispatch on the CPU;
5. the batched main path: DPEReceiver.run_batched on the first 10 s of a
   40 s synthetic capture held on the card as int16 [B, S, 2]: 100 warm-up
   blocks, 200 blocks per block (lookahead 50, pipeline depth 4), 200 blocks
   in coherent groups of 5; K1 launch counts, fix errors against truth,
   wall time and real-time factor;
6. K3 (correlate_window) against its plain version: seeded state and raw,
   C=8, S=2500;
7. K4 (track_chunk) against its plain version on one 2000 ms chunk of the
   capture from the acquisition result: cp/ncp/lock equal, signs equal
   after step 5, rc within 1e-3 chips, fi within 0.1 Hz, prompt sums within
   1e-3 of each channel's peak; ms per chunk and real-time factor;
8. K2 (score_surface) against its plain version: N=1, G=390 625, both
   manifolds x quadratic/linear x l_power 1/2, argmax equal, rtol 1e-6;
9. the cold-start path on the card, twice (the second timed: cold receiver
   state, warm kernels): ScalarReceiver acquire -> track 30 s, then 2 s at
   a time to 8/8 ephemerides (checked against the scenario's) -> scalar
   PVT -> save_handoff -> DPEReceiver.run(1), then 50 more per-block steps;
   K2/K3/K4 launch counts, errors, TTFF wall, tracking real-time factor.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from navlab_dpe_sdr_tpu.constants import F_CA, F_L1
from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import release_workspace
from navlab_dpe_sdr_tpu.libgnss.cacode import ca_table
from navlab_dpe_sdr_tpu.models.grid import spread_grid
from navlab_dpe_sdr_tpu_torch.models.dpe import (DPEConfig, DPEReceiver,
                                                 device_state)
from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
from navlab_dpe_sdr_tpu_torch.ops import _build, score, track, tracking
from navlab_dpe_sdr_tpu_torch.ops import dpe as dpe_ops
from navlab_dpe_sdr_tpu_torch.ops import dpe_real

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
KERNELS = {
    "K1": dict(name="score_argmax", route="cuda", source=SCORE_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_score.py:166"),
    "K2": dict(name="score_surface", route="cuda", source=SCORE_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_score.py:43"),
    "K3": dict(name="correlate_window", route="cuda", source=TRACK_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_track.py:50"),
    "K4": dict(name="track_chunk", route="cuda", source=TRACK_SRC,
               replaces="navlab_dpe_sdr_tpu/ops/pallas_track.py:181"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def scorer_inputs(rng, manifold: str, width: int, grid, dev):
    """Main-path-shaped scorer operands made with numpy from the seed."""
    n, c = N_BLOCKS, 8
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
    """Phase 3: kernel vs plain on the card, every case; returns
    (max |best diff|, kernel ms, plain ms) per dispatch (both manifolds,
    quadratic, l_power 1, argmax: the main path's calls)."""
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    times = {}
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
                    log(line)
    k_ms = times[("pos", False)][0] + times[("vel", False)][0]
    p_ms = times[("pos", False)][1] + times[("vel", False)][1]
    return max_err, k_ms, p_ms


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


def make_capture(seconds: float):
    """int16 I/Q capture of the seeded 8-PRN scenario, synthesized in 1 s
    pieces (each piece's noise is seeded by its first sample)."""
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
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
    """Phase 6: K3 against its plain version; (max |diff|, ms, plain ms)."""
    rng = np.random.default_rng(SEED)
    c, s = 8, 2500
    tab = torch.from_numpy(ca_table(range(1, c + 1)).astype(np.float32)
                           ).to(dev)
    st = tracking.init_state(
        rc=rng.random(c) * 1023.0, ri=rng.random(c),
        fc=F_CA + rng.standard_normal(c), fi=rng.standard_normal(c) * 1000.0,
        device=dev)
    raw = torch.from_numpy(np.clip(np.round(rng.standard_normal((s, 2))
                                            * 64.0), -32768, 32767)
                           .astype(np.int16)).to(dev)
    rawf = raw.float()
    times = track.window_times(s, FS, dev)
    args = (st.rc, st.dfc, st.ri, st.fi, tab)

    def kernel():
        return track.correlate_window(raw, *args, FS)

    def plain():
        return track.correlate_window_plain(rawf[:, 0], rawf[:, 1], *args,
                                            times, FS)[0]

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    assert rel < 1e-5, rel
    k_ms, p_ms = cuda_ms(kernel, 200), cuda_ms(plain, 20)
    log(f"K3 correlate_window: C={c}, S={s}: max|diff| {err:.3e} (rel "
        f"{rel:.3e}, limit 1e-5); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
        f"per window [{card}]")
    return err, k_ms, p_ms


def check_tracker(samples, hand, dev, card):
    """Phase 7: K4 against its plain version on one 2000 ms chunk from the
    acquisition result; (max |float log diff|, kernel ms, plain ms)."""
    rx = ScalarReceiver(SampleFile(samples=samples, fs=FS), hand.prn_list,
                        device=dev)
    res = rx.acquire(verbose=False)
    assert all(r.found for r in res), [r.cppm for r in res]
    raw = torch.from_numpy(samples[:TRACK_MS * 2500].view(np.int16)
                           .reshape(TRACK_MS, 2500, 2).copy()).to(dev)
    fcaid = F_CA / F_L1
    st0 = rx.state

    def kernel():
        return tracking.track_chunk_packed(st0, raw, rx.code_table, FS, fcaid)

    _, lfk, lik = kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lfp, lip = tracking.track_chunk_plain(st0, raw, rx.code_table, FS,
                                             fcaid)
    torch.cuda.synchronize()
    p_ms = (time.perf_counter() - t0) * 1e3
    k_ms = cuda_ms(kernel, 3)
    lf_k, lf_p = lfk.cpu().numpy(), lfp.cpu().numpy()
    li_k, li_p = lik.cpu().numpy(), lip.cpu().numpy()
    np.testing.assert_array_equal(li_k, li_p)           # cp, ncp, lock
    rows = {k: i for i, k in enumerate(tracking.LOG_F_ROWS)}
    sg = [rows["sign0"], rows["sign1"]]
    np.testing.assert_array_equal(lf_k[5:, sg], lf_p[5:, sg])
    drc = np.abs(lf_k[:, rows["rc"]] - lf_p[:, rows["rc"]])
    assert np.minimum(drc, 1023.0 - drc).max() < 1e-3
    assert np.abs(lf_k[:, rows["fi"]] - lf_p[:, rows["fi"]]).max() < 0.1
    for name in ("iP", "qP"):
        r = rows[name]
        peak = np.abs(lf_p[:, r]).max(axis=0)
        assert (np.abs(lf_k[:, r] - lf_p[:, r]) / peak).max() < 1e-3, name
    err = float(np.abs(lf_k - lf_p).max())
    equal = bool(np.array_equal(lf_k, lf_p) and np.array_equal(li_k, li_p))
    log(f"K4 track_chunk: {TRACK_MS} ms x {len(hand.prn_list)} channels from "
        f"acquisition: logs {'bit-equal' if equal else 'within limits'} "
        f"(max|float diff| {err:.3e}); kernel {k_ms:.3f} ms per chunk "
        f"({TRACK_MS / k_ms:.1f}x real time), plain {p_ms:.1f} ms "
        f"({TRACK_MS / p_ms:.2f}x) [{card}]")
    return err, k_ms, p_ms


def check_surface(grid, widths, dev, card):
    """Phase 8: K2 against its plain version, N=1, G=390 625; (max |diff|,
    kernel ms, plain ms) of one block (both manifolds, quadratic, l_power
    1: the per-block step's calls)."""
    rng = np.random.default_rng(SEED + 2)
    max_err, k_ms, p_ms = 0.0, 0.0, 0.0
    for manifold in ("pos", "vel"):
        args = [None if a is None else a[:1].contiguous() for a in
                scorer_inputs(rng, manifold, widths[manifold], grid, dev)]
        for interp in ("quadratic", "linear"):
            for l_power in (1, 2):
                kw = dict(interp=interp, l_power=l_power)
                got = score.score_surface(*args, **kw)
                want = score.score_surface_plain(*args, **kw)
                torch.cuda.synchronize()
                assert int(got.argmax()) == int(want.argmax())
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                if interp == "quadratic" and l_power == 1:
                    km = cuda_ms(lambda: score.score_surface(*args, **kw),
                                 50)
                    pm = cuda_ms(lambda: score.score_surface_plain(
                        *args, **kw), 5)
                    k_ms, p_ms = k_ms + km, p_ms + pm
                    log(f"K2 score_surface {manifold} W={widths[manifold]}"
                        f": kernel {km:.4f} ms, plain {pm:.4f} ms [{card}]")
    log(f"K2 score_surface: N=1, G={grid.n_pos}, both manifolds x "
        f"quadratic/linear x l_power 1/2: argmax equal, max|diff| "
        f"{max_err:.3e} (rtol 1e-6); per block {k_ms:.4f} ms vs plain "
        f"{p_ms:.4f} ms [{card}]")
    return max_err, k_ms, p_ms


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
    return counts, rx.mcount


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

    grid = spread_grid()
    cw, vw = dpe_ops.auto_windows(grid.d_enu, grid.dt_m, grid.dv_enu,
                                  grid.dtdot, FS, CARR_FFTPTS)
    widths = {"pos": cw, "vel": vw}
    k1_err, k1_ms, k1_plain = check_scorer(grid, widths, dev)
    log(f"scorer: kernel == plain in all 16 cases (max|best diff| "
        f"{k1_err:.3e}); per dispatch (pos W={cw} + vel W={vw}, N=50, "
        f"G={grid.n_pos}): kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms "
        f"[{card}]")

    t0 = time.perf_counter()
    samples, hand, arr = make_capture(CAPTURE_S)
    log(f"capture: {CAPTURE_S:.0f} s synthesized in "
        f"{time.perf_counter() - t0:.1f} s")
    first = samples[:S * 500]
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
    del raw_dev, rx

    k3_err, k3_ms, k3_plain = check_correlator(dev, card)
    k4_err, k4_ms, k4_plain = check_tracker(samples, hand, dev, card)
    k2_err, k2_ms, k2_plain = check_surface(grid, widths, dev, card)
    counts, k4_steps = check_cold_start(samples, hand, arr, grid, dev, card)

    rows = [("K1", k1_launches, k1_err, k1_ms, k1_plain),
            ("K2", counts["score_surface"], k2_err, k2_ms, k2_plain),
            ("K3", counts["correlate_window"], k3_err, k3_ms, k3_plain),
            ("K4", counts["track_chunk"], k4_err, k4_ms, k4_plain)]
    kernels = [dict(KERNELS[k], launches=n, max_abs_err=e, ms=m, plain_ms=p)
               for k, n, e, m, p in rows]
    # the cold-start path launches K3 standalone no time: its body runs as
    # K4's device function, once per tracked 1 ms step of each K4 launch
    kernels[2]["steps_inside_track_chunk"] = k4_steps
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
