"""Weak-signal cold starts over and over on the same capture: raw samples
to the first integrated DPE fix.

Each cold start is a new `ScalarReceiver` on the capture from sample 0,
with the loops of the configuration's coherent update
(`ops/tracking.cadence_loops(coh_ms)`): the deep acquisition search
(`acquire(deep_ms=..., n_coh_ms=...)`), tracking `first_ms` then `step_ms`
at a time in coh_ms updates until every channel's ephemeris decodes (never
past `most_ms`), the handoff, a new `DPEReceiver` on it with the decoded
ephemerides and the configuration's grid and filter, and its first fix,
`run_integrated(1, blocks_per_fix)` (noncoherent: the block-summed
scorer). Cold starts run back to back until the window's seconds are
spent; the last one is finished. `ttff_s` is the window's wall seconds
over the cold starts completed in it. A cold start that raises, or decodes
fewer ephemerides than it has channels, counts as failed.

Correctness: `judged_starts` cold starts of the window, drawn from the
seed (a reservoir, so that no more are held), record the deep search's
magnitudes and fine Dopplers, the acquisition's code phases and Dopplers,
two tracking chunks (one drawn from the seed among the start's chunks, and
the last before the handoff), the log row the handoff is taken at, the
handoff, and the fix: the DPE receiver's state before and after it, the
correlator's windows of its blocks and the scorer's cells and bests. They
are judged after the window (harness/check_weak.py).

Counts, over the window: the cold starts, the Dopplers and code-period
segments each deep search covered, K4's coherent launches and K1's
block-summed launches; in a traced run the profiler's clock offset, which
places the program's spans on the device's timeline.

Workload keys: first_ms, step_ms, most_ms, chunk_ms, warmup_starts,
lead_ins, trace_seconds, judged_starts, limits. Configuration keys:
acquisition (deep_ms, n_coh_ms), tracking (coh_ms), dpe
(blocks_per_fix), grid, receiver, scenario.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..harness import check, check_weak, program, roofline, roofline_deep
from ..harness.trace import MARK, patched
from .coldstart import ColdStartFailed


def clock_offset_us(dw) -> float:
    """The profiler's timeline at time.perf_counter() zero: the window
    mark's start less the host clock read as the window opened (as
    harness/trace.py `DeviceWindow.reduce` places the host spans)."""
    cuda = torch.autograd.DeviceType.CUDA
    mark = [e.time_range.start for e in dw.prof.events()
            if e.name == MARK and e.device_type != cuda][0]
    return mark - dw.host0 * 1e6


def run(ctx) -> dict:
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
    from navlab_dpe_sdr_tpu_torch.models.grid import make_grid
    from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
    from navlab_dpe_sdr_tpu_torch.ops import acquisition, dpe_real, tracking

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    cap = ctx.capture()
    samples = np.ascontiguousarray(cap.host).view(DTYPE_IQ16).reshape(-1)
    spec = dict(cfg["grid"])
    grid = make_grid(spec.pop("style"), **spec)
    rcfg = cfg["receiver"]
    dpe_config = DPEConfig(T=cfg["scenario"]["block_s"],
                           ekf_mode=rcfg["ekf_mode"],
                           ekf_alpha=rcfg["ekf_alpha"])
    deep_ms = int(cfg["acquisition"]["deep_ms"])
    n_coh = int(cfg["acquisition"]["n_coh_ms"])
    m = int(cfg["tracking"]["coh_ms"])
    per_fix = int(cfg["dpe"]["blocks_per_fix"])
    loops = tracking.cadence_loops(m)
    prns = list(cap.hand.prn_list)
    chunk_ms = int(wl["chunk_ms"])
    most_ms = int(wl["most_ms"])
    keep_n = int(wl["judged_starts"])
    spans, work = ctx.spans, ctx.work
    tally = {"dopplers": 0, "segments": 0, "k4_coherent": 0, "k1_sum": 0}
    rec = {"rx": None, "chunk_no": 0, "entry": None, "fix": None}

    def record_coarse(orig):
        """The deep search's magnitudes [P, D, P0] (kept on the device) and
        its work."""
        def coarse(re, im, t, code_fft_c, dopplers, n_coh_, period):
            out = orig(re, im, t, code_fft_c, dopplers, n_coh_, period)
            d, k_seg = int(dopplers.shape[0]), re.shape[0] // (n_coh_ * period)
            if spans.open:
                tally["dopplers"] += d
                tally["segments"] += k_seg
            work.add("deep", roofline_deep.deep_search_work(
                int(re.shape[0]), int(code_fft_c.shape[0]), d, n_coh_,
                period))
            if rec["entry"] is not None:
                rec["entry"]["acq"]["coarse"] = out
            return out
        return coarse

    def record_chunk(orig):
        """Every chunk becomes the start's `last` chunk, and its drawn one
        with chance 1 / (chunks so far): a draw over all its chunks."""
        def chunk(state, raw, *a, **kw):
            out = orig(state, raw, *a, **kw)
            if spans.open and kw.get("coh_ms", 1) > 1:
                tally["k4_coherent"] += 1
            entry = rec["entry"]
            rec["chunk_no"] += 1
            if entry is not None:
                steps, window = int(raw.shape[0]), int(raw.shape[1])
                got = {"sample0": rec["rx"].rawfile.sample_pos
                       - steps * window, "steps": steps, "window": window,
                       "state_in": state, "out": out}
                entry["chunks"]["last"] = got
                if ctx.rng.random() * rec["chunk_no"] < 1.0:
                    entry["chunks"]["drawn"] = got
            return out
        return chunk

    def record_k5(orig):
        def k5(*a, **kw):
            out = orig(*a, **kw)
            if rec["fix"] is not None:
                rec["fix"]["k5"] = out
            return out
        return k5

    def record_k1(orig):
        def k1(win, los, center, coef, r0, off3, off1, **kw):
            n, c, w = win.shape
            if kw.get("block_sum"):
                if spans.open:
                    tally["k1_sum"] += 1
                work.add("K1sum", roofline.scorer_work(
                    n, c, w, off3.shape[0],
                    "pos" if r0 is not None else "vel"))
            return orig(win, los, center, coef, r0, off3, off1, **kw)
        return k1

    def record_scan(orig):
        def scan(*a, **kw):
            out = orig(*a, **kw)
            if rec["fix"] is not None:
                rec["fix"]["head"] = out[0]
            return out
        return scan

    def cold_start(entry=None):
        rx = ScalarReceiver(SampleFile(samples=samples, fs=cap.fs), prns,
                            loops=loops, device=dev)
        for name in ("acquire", "track", "decode_ephemerides",
                     "save_handoff"):
            setattr(rx, name, spans.wrap(f"scalar.{name}",
                                         getattr(rx, name)))
        rec.update(rx=rx, chunk_no=0, entry=entry)
        if entry is not None:
            entry["acq"] = {}
            entry["chunks"] = {}
        res = rx.acquire(deep_ms=deep_ms, n_coh_ms=n_coh, verbose=False)
        if entry is not None:
            entry["acq"].update(rc=rx.state.rc, fi=rx.state.fi,
                                fine_fi=np.array([r.fi for r in res]))
        rx.track(int(wl["first_ms"]), chunk_ms=chunk_ms, coh_ms=m)
        signal_ms = int(wl["first_ms"])
        good = rx.decode_ephemerides(verbose=False)
        while (len(good) < len(prns)
               and signal_ms + int(wl["step_ms"]) <= most_ms):
            rx.track(int(wl["step_ms"]), chunk_ms=chunk_ms, coh_ms=m)
            signal_ms += int(wl["step_ms"])
            good = rx.decode_ephemerides(verbose=False)
        if len(good) < len(prns):
            raise ColdStartFailed(f"{len(good)}/{len(prns)} ephemerides "
                                  f"decoded in {signal_ms} ms")
        h = rx.save_handoff("")
        drx = spans.wrap("dpe.build", DPEReceiver)(
            SampleFile(samples=samples, fs=cap.fs), h, grid=grid,
            eph=rx.eph_array(), config=dpe_config, device=dev)
        fix = None
        if entry is not None:
            mc = rx.mcount - 1
            entry["obs"] = {
                **{k: np.array([rx.channels[p].col(k)[mc] for p in prns],
                               dtype=np.float64)
                   for k in ("rc", "ri", "fc", "fi", "cp")},
                "sample": int(rx._m_samp[mc]), "coh_ms": rx.coh_ms,
                "ds": rx.rawfile.ds}
            entry["handoff"] = h
            fix = {"sample0": int(h.bytes_read) // 4, "n": per_fix,
                   "pre": program.snapshot(drx)}
            rec["fix"] = fix
        fixes = spans.wrap("dpe.first_fix", drx.run_integrated)(1, per_fix)
        rec["fix"] = rec["entry"] = None
        if fix is not None:
            head = fix.pop("head")
            pa, va = dpe_real.unpack_row_indices(
                head.cpu().numpy()[None, :])
            fix.update(pa=int(pa[0]), va=int(va[0]), pb=fixes[-1].pos_score,
                       vb=fixes[-1].vel_score, fix=np.array(fixes[-1].x_ecef),
                       post=program.snapshot(drx))
            entry["fix"] = fix
        return signal_ms

    n_chunks = -(-most_ms // chunk_ms)
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(acquisition, "_deep_coarse",
                                    record_coarse))
        stack.enter_context(patched(tracking, "track_chunk_packed",
                                    record_chunk))
        stack.enter_context(patched(dpe_real, "windowed_correlate",
                                    record_k5))
        stack.enter_context(patched(dpe_real, "score_argmax", record_k1))
        stack.enter_context(patched(dpe_real, "dpe_scan_integrate",
                                    record_scan))
        for _ in range(int(wl["warmup_starts"])):
            cold_start()
        ctx.sync()
        ctx.mark_setup_done()
        seconds = ctx.window_seconds()
        starts, failed, kept = 0, 0, []
        with ctx.device_window as dw:
            for _ in range(ctx.lead_ins()):
                with dw.lead_in():
                    cold_start()
            with dw.window():
                spans.open, work.open = True, ctx.trace
                t_start = time.perf_counter()
                while True:
                    # a reservoir of judged_starts starts, uniform over the
                    # window's starts: start i enters with chance k / (i + 1)
                    slot = (len(kept) if len(kept) < keep_n else
                            int(ctx.rng.integers(starts + 1)))
                    entry = ({"start": starts, "deep_ms": deep_ms,
                              "n_coh_ms": n_coh, "coh_ms": m}
                             if slot < keep_n else None)
                    try:
                        cold_start(entry)
                        if entry is not None:
                            if slot < len(kept):
                                kept[slot] = entry
                            else:
                                kept.append(entry)
                    except ColdStartFailed as e:
                        ctx.log(f"cold start {starts} failed: {e}")
                        failed += 1
                    starts += 1
                    if time.perf_counter() - t_start >= seconds:
                        break
                ctx.sync()
                wall = time.perf_counter() - t_start
                spans.open = work.open = False
        ctx.window_closed()
    completed = starts - failed
    ctx.log(f"{starts} weak cold starts in {wall:.4f} s, {failed} failed; "
            f"{n_chunks} chunks of {chunk_ms} ms at most each")
    counts = {"starts": starts, "completed": completed,
              **{f"{k}_per_start": v / max(starts, 1)
                 for k, v in tally.items()}}
    if ctx.trace:
        counts["clock_offset_us"] = clock_offset_us(dw)

    # the program's recorded tensors to the host, then the reference
    for entry in kept:
        acq = entry["acq"]
        acq["coarse"] = acq["coarse"].cpu().numpy()
        acq["rc"], acq["fi"] = acq["rc"].cpu().numpy(), acq["fi"].cpu().numpy()
        for ch in {id(c): c for c in entry["chunks"].values()}.values():
            st, logf, _ = ch.pop("out")
            ch["state_out"] = {k: v.cpu().numpy()
                               for k, v in st._asdict().items()}
            ch["logf"] = logf.cpu().numpy()
            ch["state_in"] = {k: v.cpu().numpy()
                              for k, v in ch["state_in"]._asdict().items()}
        k5 = entry["fix"]["k5"]
        entry["fix"]["k5"] = {"code_mag": k5.code_mag, "carr_mag":
                              k5.carr_mag}
    ctx.free_device()
    R = check.Reference(cfg, cap, dev)
    numbers, control = {}, {}
    for entry in sorted(kept, key=lambda e: e["start"]):
        got = check_weak.judge(R, entry, limits=wl["limits"], log=ctx.log)
        at = sorted({c["sample0"] for c in entry["chunks"].values()})
        ctx.log(f"judged weak cold start {entry['start']} (chunks at "
                f"samples {at}): {got}")
        check.merge(numbers, got)
        if ctx.control:
            for name, variant in check_weak.CONTROLS.items():
                check.merge(control.setdefault(name, {}),
                            check_weak.judge(R, entry, variant))
    return dict(attempted=starts, failed=failed,
                end_to_end={"ttff_s": wall / completed if completed
                            else None},
                counts=counts, numbers=numbers, control_numbers=control)
