"""A live receiver fed by a paced radio: one 20 ms block due every 20 ms,
open loop.

The benchmark's own pacer hands `DPEReceiver.step(raw_block)` the capture's
host int16 blocks in order, from the truth handoff at sample 0. Block k is
due when its last sample would have arrived from the radio: t0 + (k + 1) T;
between blocks the pacer sleeps until the next is due, as the program's own
radios do (`io/frontend.SimulatedRadio`, `io/netsource`), so the core's
wake-up after the wait is part of each fix's latency.
The schedule never slides: a step that runs late delays the blocks queued
behind it, and their latency counts the wait. A fix's latency is the time
`step` returns it minus its block's due time; `fix_latency_p95_ms` is the
95th percentile over every block of the window, and a fix later than the
budget (workload `budget_ms`) counts as failed.

Correctness: steps drawn from the seed are recorded (the receiver's state
before and after, the correlator's windows and the scorer's cells) and
judged against the reference after the window (harness/check.py
`judge_step`).

Workload keys: warmup_steps, lead_ins, trace_seconds, budget_ms,
judged_steps, limits.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from ..harness import check, program, roofline
from ..harness.trace import patched


def run(ctx) -> dict:
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    T = cfg["scenario"]["block_s"]
    cap = ctx.capture()
    template = program.dpe_receiver(cfg, cap, dev)
    spans, work = ctx.spans, ctx.work
    rec = {"want": None}

    def record_step(orig):
        def device_step(*a, **kw):
            if spans.open:
                spans.spans["step.host_prep"].append(
                    (rec["t_step"], time.perf_counter()))
            out = orig(*a, **kw)
            if rec["want"] is not None:
                rec["want"]["out"] = out
            return out
        return device_step

    def record_k5(orig):
        def k5(*a, **kw):
            n, s = a[0].shape
            c = a[2].shape[0]
            period, n_periods = a[11], a[12]
            cw, vw = kw["code_win"], kw["carr_win"]
            idx = a[4]
            work.add("K5", lambda: roofline.correlator_work(
                n, c, s, period, n_periods, cw, vw,
                roofline.tail_samples(idx, period, n_periods), False))
            return orig(*a, **kw)
        return k5

    def record_k2(orig):
        def k2(win, los, center, coef, r0, off3, off1, **kw):
            n, c, w = win.shape
            work.add("K2", roofline.scorer_work(
                n, c, w, off3.shape[0], "pos" if r0 is not None else "vel"))
            return orig(win, los, center, coef, r0, off3, off1, **kw)
        return k2

    def step(r, k):
        rec["t_step"] = time.perf_counter()
        return r.step(cap.host[k])

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(dpe_real, "dpe_device_step_real",
                                    record_step))
        stack.enter_context(patched(dpe_real, "windowed_correlate",
                                    record_k5))
        stack.enter_context(patched(dpe_real, "score_surface_argmax",
                                    record_k2))
        warm = program.fresh(template)
        for k in range(int(wl["warmup_steps"])):
            step(warm, k)
        ctx.sync()
        ctx.mark_setup_done()
        n = int(round(ctx.window_seconds() / T))
        if n > cap.blocks:
            raise ValueError(f"a {ctx.window_seconds()} s window needs {n} "
                             f"blocks; the capture holds {cap.blocks}")
        judged = set(ctx.rng.choice(n, size=min(n, int(wl["judged_steps"])),
                                    replace=False).tolist())
        lat = np.empty(n)
        late = np.empty(n)
        records = []
        with ctx.device_window as dw:
            for _ in range(ctx.lead_ins()):
                with dw.lead_in():
                    step(program.fresh(template), 0)
            r = program.fresh(template)
            with dw.window():
                spans.open, work.open = True, ctx.trace
                t0 = time.perf_counter()
                for k in range(n):
                    due = t0 + (k + 1) * T
                    entry = None
                    if k in judged:
                        entry = {"sample0": k * cap.S,
                                 "pre": program.snapshot(r)}
                    waited = time.perf_counter()
                    if waited < due:            # sleep, as the radios do
                        time.sleep(due - waited)
                    start = time.perf_counter()
                    rec["want"] = entry
                    fix = step(r, k)
                    done = time.perf_counter()
                    rec["want"] = None
                    lat[k] = done - due
                    late[k] = start - due
                    if spans.open:
                        spans.spans["pacer.wait"].append((waited, start))
                        spans.spans["step"].append((start, done))
                    if entry is not None:
                        out = entry.pop("out")
                        entry.update(
                            pa=int(out[1]), va=int(out[3]),
                            pb=fix.pos_score, vb=fix.vel_score,
                            code_mag=out[5], carr_mag=out[6],
                            fix=np.array(fix.x_ecef),
                            post=program.snapshot(r))
                        records.append(entry)
                spans.open = work.open = False
        ctx.window_closed()
    del r, warm, template
    budget = float(wl["budget_ms"]) / 1e3
    failed = int((lat > budget).sum())
    ctx.log(f"{n} blocks paced at {T * 1e3:.0f} ms: latency p50 "
            f"{np.percentile(lat, 50) * 1e3:.4f} ms, p95 "
            f"{np.percentile(lat, 95) * 1e3:.4f} ms, max "
            f"{lat.max() * 1e3:.4f} ms, {failed} over {budget * 1e3:.0f} ms; "
            f"the pacer's lateness max {late.max() * 1e3:.4f} ms")

    ctx.free_device()
    R = check.Reference(cfg, cap, dev)
    numbers, control = {}, {}
    for entry in records:
        check.merge(numbers, check.judge_step(R, entry))
        if ctx.control:
            for name, variant in check.CONTROLS.items():
                check.merge(control.setdefault(name, {}),
                            check.control_step(R, entry, **variant))
    ctx.log(f"judged {len(records)} steps: {numbers}")
    return dict(attempted=n, failed=failed,
                end_to_end={"fix_latency_p95_ms":
                            float(np.percentile(lat, 95)) * 1e3},
                counts={"steps": n, "blocks": n}, numbers=numbers,
                control_numbers=control)
