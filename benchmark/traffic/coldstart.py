"""Cold starts over and over on the same capture: raw samples to the first
DPE fix.

Each cold start is a new `ScalarReceiver` on the capture from sample 0:
acquisition, tracking `first_ms` then `step_ms` at a time until every
channel's ephemeris decodes (never past `most_ms`), the handoff, a new
`DPEReceiver` on it with the decoded ephemerides and the configuration's
grid and filter, and its first step. Cold starts run back to back until
the window's seconds are spent; the last one is finished. `ttff_s` is the
window's wall seconds over the cold starts completed in it. A cold start
that raises, or decodes fewer ephemerides than it has channels, counts as
failed.

Correctness: every cold start records the acquisition's code phases and
Dopplers, two tracking chunks (the tracker's state before and after each
and its log): one drawn from the seed among all the chunks of the start,
and the last before the handoff; the log row the handoff is taken at, the
handoff, and the first fix's step. After the window a sample of the cold
starts, drawn from the seed, is judged (harness/check_coldstart.py).

Workload keys: first_ms, step_ms, most_ms, chunk_ms, warmup_starts,
lead_ins, trace_seconds, judged_starts, limits.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from ..harness import check, check_coldstart, program
from ..harness.trace import patched


class ColdStartFailed(RuntimeError):
    pass


def run(ctx) -> dict:
    from navlab_dpe_sdr_tpu_torch.io.rawfile import DTYPE_IQ16, SampleFile
    from navlab_dpe_sdr_tpu_torch.models.dpe import DPEConfig, DPEReceiver
    from navlab_dpe_sdr_tpu_torch.models.grid import make_grid
    from navlab_dpe_sdr_tpu_torch.models.scalar import ScalarReceiver
    from navlab_dpe_sdr_tpu_torch.ops import dpe_real, tracking

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    cap = ctx.capture()
    samples = np.ascontiguousarray(cap.host).view(DTYPE_IQ16).reshape(-1)
    spec = dict(cfg["grid"])
    grid = make_grid(spec.pop("style"), **spec)
    rcfg = cfg["receiver"]
    dpe_config = DPEConfig(T=cfg["scenario"]["block_s"],
                           ekf_mode=rcfg["ekf_mode"],
                           ekf_alpha=rcfg["ekf_alpha"])
    prns = list(cap.hand.prn_list)
    chunk_ms = int(wl["chunk_ms"])
    most_ms = int(wl["most_ms"])
    spans = ctx.spans
    rec = {"rx": None, "chunk_no": 0, "entry": None, "want_step": None}

    def record_chunk(orig):
        """Every chunk becomes the start's `last` chunk, and its drawn one
        with chance 1 / (chunks so far): a draw over all its chunks."""
        def chunk(state, raw, *a, **kw):
            out = orig(state, raw, *a, **kw)
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

    def record_step(orig):
        def device_step(*a, **kw):
            out = orig(*a, **kw)
            if rec["want_step"] is not None:
                rec["want_step"]["out"] = out
            return out
        return device_step

    def cold_start(entry=None):
        rx = ScalarReceiver(SampleFile(samples=samples, fs=cap.fs), prns,
                            device=dev)
        for name in ("acquire", "track", "decode_ephemerides",
                     "save_handoff"):
            setattr(rx, name, spans.wrap(f"scalar.{name}",
                                         getattr(rx, name)))
        rec.update(rx=rx, chunk_no=0, entry=entry)
        rx.acquire(T=cfg["acquisition"]["block_s"], verbose=False)
        if entry is not None:
            entry["acq"] = {"rc": rx.state.rc, "fi": rx.state.fi}
            entry["chunks"] = {}
        rx.track(int(wl["first_ms"]), chunk_ms=chunk_ms)
        signal_ms = int(wl["first_ms"])
        good = rx.decode_ephemerides(verbose=False)
        while (len(good) < len(prns)
               and signal_ms + int(wl["step_ms"]) <= most_ms):
            rx.track(int(wl["step_ms"]), chunk_ms=chunk_ms)
            signal_ms += int(wl["step_ms"])
            good = rx.decode_ephemerides(verbose=False)
        if len(good) < len(prns):
            raise ColdStartFailed(f"{len(good)}/{len(prns)} ephemerides "
                                  f"decoded in {signal_ms} ms")
        h = rx.save_handoff("")
        drx = spans.wrap("dpe.build", DPEReceiver)(
            SampleFile(samples=samples, fs=cap.fs), h, grid=grid,
            eph=rx.eph_array(), config=dpe_config, device=dev)
        step = None
        if entry is not None:
            mc = rx.mcount - 1
            entry["obs"] = {
                **{k: np.array([rx.channels[p].col(k)[mc] for p in prns],
                               dtype=np.float64)
                   for k in ("rc", "ri", "fc", "fi", "cp")},
                "sample": int(rx._m_samp[mc]), "coh_ms": rx.coh_ms,
                "ds": rx.rawfile.ds}
            entry["handoff"] = h
            step = {"sample0": int(h.bytes_read) // 4,
                    "pre": program.snapshot(drx)}
            rec["want_step"] = step
        fix = spans.wrap("dpe.first_fix", drx.run)(1)[0]
        rec["want_step"] = None
        rec["entry"] = None
        if step is not None:
            out = step.pop("out")
            step.update(pa=int(out[1]), va=int(out[3]), pb=fix.pos_score,
                        vb=fix.vel_score, code_mag=out[5], carr_mag=out[6],
                        fix=np.array(fix.x_ecef),
                        post=program.snapshot(drx))
            entry["step"] = step
        return signal_ms

    n_chunks = -(-most_ms // chunk_ms)
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(tracking, "track_chunk_packed",
                                    record_chunk))
        stack.enter_context(patched(dpe_real, "dpe_device_step_real",
                                    record_step))
        for _ in range(int(wl["warmup_starts"])):
            cold_start()
        ctx.sync()
        ctx.mark_setup_done()
        seconds = ctx.window_seconds()
        starts, failed, records = 0, 0, []
        with ctx.device_window as dw:
            for _ in range(ctx.lead_ins()):
                with dw.lead_in():
                    cold_start()
            with dw.window():
                spans.open, ctx.work.open = True, ctx.trace
                t_start = time.perf_counter()
                while True:
                    entry = {"start": starts}
                    try:
                        cold_start(entry)
                        records.append(entry)
                    except ColdStartFailed as e:
                        ctx.log(f"cold start {starts} failed: {e}")
                        failed += 1
                    starts += 1
                    if time.perf_counter() - t_start >= seconds:
                        break
                ctx.sync()
                wall = time.perf_counter() - t_start
                spans.open = ctx.work.open = False
        ctx.window_closed()
    completed = starts - failed
    ctx.log(f"{starts} cold starts in {wall:.4f} s, {failed} failed; "
            f"{n_chunks} chunks of {chunk_ms} ms at most each")

    # the program's recorded tensors to the host, then the reference
    for entry in records:
        entry["acq"] = {k: v.cpu().numpy() for k, v in entry["acq"].items()}
        for ch in {id(c): c for c in entry["chunks"].values()}.values():
            st, logf, _ = ch.pop("out")
            ch["state_out"] = {k: v.cpu().numpy()
                               for k, v in st._asdict().items()}
            ch["logf"] = logf.cpu().numpy()
            ch["state_in"] = {k: v.cpu().numpy()
                              for k, v in ch["state_in"]._asdict().items()}
    ctx.free_device()
    R = check.Reference(cfg, cap, dev)
    pick = ctx.rng.permutation(len(records))[:int(wl["judged_starts"])]
    numbers, control = {}, {}
    for i in sorted(pick):
        got = check_coldstart.judge(R, records[i])
        at = sorted({c["sample0"] for c in records[i]["chunks"].values()})
        ctx.log(f"judged cold start {records[i]['start']} (chunks at "
                f"samples {at}): {got}")
        check.merge(numbers, got)
        if ctx.control:
            for name, variant in check_coldstart.CONTROLS.items():
                check.merge(control.setdefault(name, {}),
                            check_coldstart.judge(R, records[i], variant))
    return dict(attempted=starts, failed=failed,
                end_to_end={"ttff_s": wall / completed if completed
                            else None},
                counts={"starts": starts, "completed": completed},
                numbers=numbers, control_numbers=control)
