"""Offline post-processing of recordings: whole passes of the batched DPE
receiver over the capture held on the device.

Each pass is a fresh receiver at the truth handoff running
`run_batched(blocks, lookahead, group_k, pipeline=True, pipeline_depth)`
over the whole capture; its clock runs only inside that call, which ends
in the receiver's own host fetch of its last dispatch, so the device's
work is inside it. Passes run until the window's seconds are spent; the
last one is finished. The rate (named by the workload's `rate_metric`) is
the signal seconds of all the passes over their on-clock seconds.

Correctness: in every pass one dispatch, drawn from the seed, is recorded:
the receiver's state before and after its preparation and its drain, the
correlator's windows of its blocks, the scorer's rows and the fixes. After
the window a sample of those, drawn from the seed, is judged against the
reference (harness/check.py `judge_dispatch`).

Workload keys: rate_metric, blocks, lookahead, group_k, pipeline_depth,
warmup_passes, lead_ins, trace_seconds, judged_dispatches, limits.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..harness import check, program, roofline
from ..harness.trace import patched


def run(ctx) -> dict:
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    cap = ctx.capture()
    blocks = min(int(wl["blocks"]), cap.blocks)
    look, gk, depth = wl["lookahead"], wl["group_k"], wl["pipeline_depth"]
    per_pass = -(-blocks // look)
    template = program.dpe_receiver(cfg, cap, dev)
    spans, work = ctx.spans, ctx.work

    rec = {"want": None, "by_fetch": {}, "done": []}

    def record_k5(orig):
        def k5(*a, **kw):
            out = orig(*a, **kw)
            if rec["want"] is not None:
                rec["want"]["k5"] = out
            n, s = a[0].shape
            c = a[2].shape[0]
            period, n_periods = a[11], a[12]
            cw = kw.get("code_win", a[13] if len(a) > 13 else None)
            vw = kw.get("carr_win", a[14] if len(a) > 14 else None)
            cplx = kw.get("complex_out", False)
            idx = a[4]
            work.add("K5", lambda: roofline.correlator_work(
                n, c, s, period, n_periods, cw, vw,
                roofline.tail_samples(idx, period, n_periods), cplx))
            return out
        return k5

    def record_k1(orig):
        def k1(win, los, center, coef, r0, off3, off1, **kw):
            n, c, w = win.shape
            work.add("K1", roofline.scorer_work(
                n, c, w, off3.shape[0], "pos" if r0 is not None else "vel"))
            return orig(win, los, center, coef, r0, off3, off1, **kw)
        return k1

    def attach(r, pass_no: int, pick: int | None):
        """Wrap the receiver's layers: spans (traced run) and the record of
        dispatch `pick` of this pass."""
        count = {"dispatch": 0}
        disp, drain = r._dispatch_batch, r._drain_batch
        r._prepare_batch = spans.wrap("receiver._prepare_batch",
                                      r._prepare_batch)

        def dispatch(*a, **kw):
            mine = count["dispatch"] == pick
            count["dispatch"] += 1
            if mine:
                entry = {"pass": pass_no, "n": a[0], "start": a[2] + a[3],
                         "pre_prep": program.snapshot(r)}
                rec["want"] = entry
            try:
                out = disp(*a, **kw)
            finally:
                rec["want"] = None
            if mine:
                entry["post_prep"] = program.snapshot(r)
                rec["by_fetch"][id(out[0])] = entry
            return out

        def drain_(fetch, preps, **kw):
            entry = rec["by_fetch"].pop(id(fetch), None)
            if entry is not None:
                entry["pre_drain"] = program.snapshot(r)
                n0 = len(r.fixes)
            drain(fetch, preps, **kw)
            if entry is not None:
                rows = np.array(fetch.host.cpu().numpy() if torch.is_tensor(
                    fetch.host) else fetch.host)
                pas, vas = dpe_real.unpack_row_indices(rows)
                entry.update(pa=pas, va=vas, pb=rows[:, 1], vb=rows[:, 3],
                             fixes=np.array([f.x_ecef for f in r.fixes[n0:]]),
                             post_drain=program.snapshot(r))
                rec["done"].append(entry)

        r._dispatch_batch = spans.wrap("receiver._dispatch_batch", dispatch)
        r._drain_batch = spans.wrap("receiver._drain_batch", drain_)

    def one_pass(r):
        t0 = time.perf_counter()
        r.run_batched(blocks, lookahead=look, raw_blocks_dev=cap.raw,
                      start_block=0, pipeline=True, group_k=gk,
                      pipeline_depth=depth)
        return time.perf_counter() - t0

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(dpe_real, "windowed_correlate",
                                    record_k5))
        stack.enter_context(patched(dpe_real, "score_argmax", record_k1))
        for _ in range(int(wl["warmup_passes"])):
            one_pass(program.fresh(template))
        ctx.sync()
        ctx.mark_setup_done()
        seconds = ctx.window_seconds()
        passes, on_clock = 0, 0.0
        with ctx.device_window as dw:
            for _ in range(ctx.lead_ins()):
                with dw.lead_in():
                    one_pass(program.fresh(template))
            with dw.window():
                spans.open, work.open = True, ctx.trace
                t_start = time.perf_counter()
                while True:
                    r = program.fresh(template)
                    attach(r, passes, int(ctx.rng.integers(per_pass)))
                    on_clock += one_pass(r)
                    passes += 1
                    if time.perf_counter() - t_start >= seconds:
                        break
                spans.open = work.open = False
        ctx.window_closed()
    del r, template
    signal_s = passes * blocks * cfg["scenario"]["block_s"]
    ctx.log(f"{passes} passes of {blocks} blocks: {signal_s:.2f} s of signal "
            f"in {on_clock:.4f} s on the clock")

    # the reference, after the window and with the program's state freed
    ctx.free_device()
    R = check.Reference(cfg, cap, dev)
    pick = ctx.rng.permutation(len(rec["done"]))[:int(wl["judged_dispatches"])]
    numbers, control = {}, {}
    for i in sorted(pick):
        entry = rec["done"][i]
        got = check.judge_dispatch(R, entry, gk)
        ctx.log(f"judged pass {entry['pass']} blocks {entry['start']}.."
                f"{entry['start'] + entry['n'] - 1}: {got}")
        check.merge(numbers, got)
        if ctx.control:
            for name, variant in check.CONTROLS.items():
                check.merge(control.setdefault(name, {}),
                            check.control_dispatch(R, entry, gk, **variant))
    return dict(attempted=passes * blocks, failed=0,
                end_to_end={wl["rate_metric"]: signal_s / on_clock},
                counts={"blocks": passes * blocks, "passes": passes},
                numbers=numbers, control_numbers=control)

