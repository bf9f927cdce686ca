#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (navlab_dpe_sdr_tpu_torch) on one
CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
1. the card: nvidia-smi name and power limit;
2. build the port's CUDA kernels from ops/csrc and time the build;
3. the score_argmax kernel against its plain PyTorch version on the card
   at the main path's shapes (N=50 blocks, C=8 channels, the spread grid's
   390 625 points per manifold, code/carrier windows of the receiver),
   every case of manifold x l_power x interp x weighted, with both times;
4. one fused dispatch on the card against the same dispatch on the CPU;
5. the main path: DPEReceiver.run_batched on a 10 s synthetic capture held
   on the card as int16 [B, S, 2]: 100 warm-up blocks, 200 blocks per
   block (lookahead 50, pipeline depth 4), 200 blocks in coherent groups
   of 5; launch counts, fix errors against truth, wall time and real-time
   factor.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from navlab_dpe_sdr_tpu.io.rawfile import DTYPE_IQ16, SampleFile
from navlab_dpe_sdr_tpu.io.scenario import make_scenario
from navlab_dpe_sdr_tpu.io.synth import release_workspace
from navlab_dpe_sdr_tpu.models.grid import spread_grid
from navlab_dpe_sdr_tpu_torch.models.dpe import (DPEConfig, DPEReceiver,
                                                 device_state)
from navlab_dpe_sdr_tpu_torch.ops import _build, score
from navlab_dpe_sdr_tpu_torch.ops import dpe as dpe_ops
from navlab_dpe_sdr_tpu_torch.ops import dpe_real

SEED = 20261016
FS = 2.5e6
S = 50000
CARR_FFTPTS = 8 * (1 << S.bit_length())
N_BLOCKS = 50          # blocks per dispatch on the main path (lookahead)
T = 0.02               # seconds per block
KERNEL = dict(name="score_argmax", route="cuda",
              source="navlab_dpe_sdr_tpu_torch/ops/csrc/score_argmax.cu",
              replaces="navlab_dpe_sdr_tpu/ops/pallas_score.py:166")


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


def make_capture(n_blocks: int):
    sim, hand, arr = make_scenario(nav_data=True, cn0_dbhz=47.0)
    n = S * n_blocks
    iq = sim.generate(n)
    samples = np.empty(n, DTYPE_IQ16)
    samples["i"] = np.clip(np.round(iq.real), -32768, 32767)
    samples["q"] = np.clip(np.round(iq.imag), -32768, 32767)
    del iq
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

    t0 = time.perf_counter()
    lib = _build.build("score_argmax")
    log(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    grid = spread_grid()
    cw, vw = dpe_ops.auto_windows(grid.d_enu, grid.dt_m, grid.dv_enu,
                                  grid.dtdot, FS, CARR_FFTPTS)
    max_err, k_ms, p_ms = check_scorer(grid, {"pos": cw, "vel": vw}, dev)
    log(f"scorer: kernel == plain in all 16 cases (max|best diff| "
        f"{max_err:.3e}); per dispatch (pos W={cw} + vel W={vw}, N=50, "
        f"G={grid.n_pos}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
        f"[{card}]")

    t0 = time.perf_counter()
    samples, hand, arr = make_capture(500)
    log(f"capture: 500 blocks synthesized in "
        f"{time.perf_counter() - t0:.1f} s")
    rel = check_dispatch(samples, hand, arr, grid)
    log(f"dispatch: card == cpu on 5 blocks (indices, flips equal; "
        f"windows rel diff {rel:.2e})")

    rx = receiver(samples, hand, arr, grid, dev)
    raw_dev = torch.from_numpy(samples.view(np.int16).reshape(-1, S, 2)
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
    score.reset_launch_count()
    for name, start, group_k in (("per-block", 100, 1),
                                 ("grouped K=5", 300, 5)):
        before = score.launch_count()
        n_fix0 = len(rx.fixes)
        t0 = time.perf_counter()
        rx.run_batched(200, start_block=start, group_k=group_k, **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = score.launch_count() - before
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
    launches = score.launch_count()
    assert launches > 0 and len(rx.fixes) == n_warm + 240
    total = sum(segments)
    log(f"main path: 400 blocks in {total:.3f} s, {400 * T / total:.2f}x "
        f"real time [{card}]")

    log(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max_err, ms=k_ms,
        plain_ms=p_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
