"""What decides `correct` in a weak-signal cold start: the reference
follows the start step by step from what each stage handed the next.

- `acq_code_gap_chips`, `acq_doppler_gap_hz`: the acquisition's code
  phases and Dopplers at sample 0 against the scenario's truth
  (harness/check_coldstart.py); their limits are the configuration's
  guarantee: the 8 ms loops' measured pull-in (0.6 chip, where every
  channel still decodes; from 0.8 chip some are lost), and the 8 ms
  Costas discriminator's linear range (a quarter cycle an update);
- `deep_bin_gap`: the deep search worked out again in float64
  (reference/acquisition.py) over the same samples: how far below the
  reference's largest magnitude the reference's own magnitude at the code
  phase and Doppler the program picked lies, and the same of the fine
  carrier bin the program picked (the reference's fine search taken about
  the program's code phase and Doppler: power summed over the segments),
  relative to the largest; 0 where the program picked the reference's
  cells or exact ties of them;
- `deep_z_gap`: the detection statistic z from the program's magnitudes
  against the reference's, relative;
- `track_gap`, `track_state_gap_m`: two tracking chunks (one drawn from the
  seed, the last before the handoff) run again by the plain coherent
  tracker (reference/coherent_tracker.py) from the tracker's state before
  each (harness/check_coldstart.py `track_gaps`); `track_gap` also takes
  the logged prompt segment sums, which the soft nav-bit decode reads
  (`segment_gap`), relative to the same prompt peak;
- `eph_gap_m`, `handoff_gap_m`: as in harness/check_coldstart.py;
- the integrated fix: from the DPE receiver's state before it, the
  preparation of its blocks block by block (reference/receiver.py), each
  block's windows (reference/device.py `correlate`), the block-summed
  surfaces' best over the grid (reference/integrated.py) and the update
  with the program's cells referenced to the last block; `window_gap`,
  `best_gap`, `score_gap`, `fix_gap_m` and `state_gap_m` as in
  harness/check.py, with the correlator's float32 ties (a packed code
  phase's rounding, a nav-bit flip) taken as the program took them
  (harness/ties.py).

The controls put the reference in the program's place a step down:
`tf32` (the fix's correlator products in TF32), `f32_host` (the host's
state, the handoff, the decoded values and the fix's host algebra in
float32), `bf16_sums` (the tracker's sums in bfloat16) and `f16_search`
(the deep search's time table, baseband and folds in float16).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frozen.constants import F_CA, F_L1, L_CA
from ..reference import acquisition as ref_acq
from ..reference import coherent_tracker as coh
from ..reference import device as ref_dev
from ..reference import integrated as ref_int
from ..reference import tracker as ref_trk
from . import check, check_coldstart, ties

CONTROLS = {"tf32": dict(tf32=True), "f32_host": dict(round_to=np.float32),
            "bf16_sums": dict(round_sums=torch.bfloat16),
            "f16_search": dict(search_round=torch.float16)}


def deep_dopplers(n_coh: int) -> np.ndarray:
    """The deep search's Doppler grid: half a bin of the coherent length
    (500 / n_coh Hz) over +/-6 kHz."""
    step = 500.0 / n_coh
    n_side = int(np.ceil(6000.0 / step))
    return np.arange(-n_side, n_side + 1) * step


def capture_samples(R: check.Reference, n: int) -> np.ndarray:
    """The capture's first n samples as complex128 on the host."""
    iq = R.cap.raw.reshape(-1, 2)[:n].cpu().numpy().astype(np.float64)
    return iq[:, 0] + 1j * iq[:, 1]


def search_cells(mags: np.ndarray, fs: float):
    """[(code index, Doppler index, z)] of each PRN's magnitudes."""
    return [ref_acq.peak(np.asarray(m, np.float64), fs) for m in mags]


def deep_gaps(R: check.Reference, acq: dict, deep_ms: int, n_coh: int,
              search_round=None) -> dict:
    """`deep_bin_gap` and `deep_z_gap` of the program's recorded search
    (`acq`: its magnitudes [P, D, P0] and fine Dopplers [P] in Hz), or with
    search_round of the control's search in its place."""
    fs = R.fs
    period = int(round(fs * 1e-3))
    dop = deep_dopplers(n_coh)
    x = capture_samples(R, int(round(deep_ms * 1e-3 * fs)))
    chips = R.chips.cpu().numpy()
    ref = ref_acq.deep_search(x, chips, fs, dop, n_coh, R.device
                              ).cpu().numpy()
    if search_round is None:
        got, fine_hz = acq["coarse"], acq["fine_fi"]
    else:
        got = ref_acq.deep_search(x, chips, fs, dop, n_coh, R.device,
                                  round_to=search_round).cpu().numpy()
        fine_hz = None
    bin_hz = ref_acq.fine_layout(fs, n_coh, dop)[2]
    fcaid = F_CA / F_L1
    bins = z_gap = 0.0
    for i, ((cr, dr, zr), (cp, dp, zp)) in enumerate(zip(
            search_cells(ref, fs), search_cells(got, fs))):
        top = ref[i, dr, cr]
        bins = max(bins, float((top - ref[i, dp, cp]) / top))
        z_gap = max(z_gap, abs(zp - zr) / abs(zr))
        k, power = ref_acq.fine_power(x, chips[i], L_CA - cp / fs * F_CA,
                                      F_CA + fcaid * dop[dp], dop[dp], fs,
                                      n_coh, dop, R.device)
        j = (int(np.argmax(power)) if fine_hz is None else
             int(np.flatnonzero(k == int(round(fine_hz[i] / bin_hz)))[0]))
        bins = max(bins, float((power.max() - power[j]) / power.max()))
    return {"deep_bin_gap": bins, "deep_z_gap": z_gap}


def segment_gap(logf_a, logf_b, m: int) -> float:
    """The largest difference between two logs' prompt segment sums (the
    rows after the m + 1 signs), relative to each channel's largest prompt
    magnitude in logf_b."""
    peak = np.hypot(logf_b[:, 2], logf_b[:, 3]).max(axis=0)    # [C]
    d = np.abs(logf_a[:, 15 + m:] - logf_b[:, 15 + m:]).max(axis=(0, 1))
    return float((d / peak).max())


def replay_chunk(R: check.Reference, chunk: dict, m: int, round_sums=None):
    """The plain coherent tracker over the recorded chunk from its recorded
    state: (state after [numpy dict], logf [steps, 15 + m + 2 (m + 2), C])."""
    steps, s = chunk["steps"], chunk["window"]
    raw = R.cap.raw.reshape(-1, 2)[chunk["sample0"]:chunk["sample0"]
                                   + steps * s].reshape(steps, s, 2)
    st = ref_trk.state_from_numpy(chunk["state_in"], R.device)
    out, logf, _ = coh.track_chunk(st, raw, R.chips, R.fs, F_CA / F_L1,
                                   coh.cadence_loops(m), m,
                                   round_sums=round_sums)
    return ({k: v.cpu().numpy() for k, v in out._asdict().items()},
            logf.cpu().numpy())


def reference_fix(R: check.Reference, rec: dict, judged=None,
                  round_to=None, tf32: bool = False) -> dict:
    """The reference (or, with round_to / tf32, the control) of one
    recorded integrated fix over rec["n"] blocks from sample
    rec["sample0"], with the judged cells (its own where None)."""
    n = rec["n"]
    rr = R.receiver(round_to, rec["eph"])
    check.start_cache_batched(rr, rec["start"])
    rr.load(rec["pre"])
    preps = rr.prepare_batch(n)
    fpk = np.stack([p[0] for p in preps])
    ipk = np.stack([p[1] for p in preps])
    win = R.correlate(rec["sample0"], fpk, ipk, tf32)
    keep = torch.as_tensor(ipk[:, 0] != 0, device=R.device)
    mags = win.mags()
    fp = torch.as_tensor(fpk, dtype=torch.float32, device=R.device)
    los = fp[:, 3:6].transpose(1, 2)
    c = fp.shape[2]
    chunk = max(4096, check.SCORE_ELEMS // (n * c))
    best, args, at = [], [], []
    for m, (w, center, coef, r0, o3, o1) in enumerate((
            (mags[0], fp[:, 7], fp[:, 8], fp[:, 6], R.d_enu, R.dt_m),
            (mags[1], fp[:, 9], fp[:, 10], None, R.dv_enu, R.dtdot))):
        top, arg = ref_int.best_summed(w, los, center, coef, r0, o3, o1,
                                       chunk)
        best.append(top[None])
        args.append(int(arg))
        if judged is not None:
            g = int(judged[m])
            at.append(ref_int.summed(w, los, center, coef, r0,
                                     o3[g:g + 1], o1[g:g + 1]))
    cell = tuple(args) if judged is None else tuple(int(j) for j in judged)
    fixes = rr.drain(preps, [cell], R.grid, group_k=n)
    return dict(win=win, keep=keep, best=tuple(best), args=tuple(args),
                at=tuple(at) if at else None, fixes=fixes,
                states=(rr.snapshot(),))


def judge_fix(R: check.Reference, rec: dict) -> dict:
    ref = reference_fix(R, rec, judged=(rec["pa"], rec["va"]))
    k5 = rec["k5"]
    judged = dict(best=([rec["pb"]], [rec["vb"]]), fixes=rec["fix"][None],
                  states=(rec["post"],))
    judged["window_gap"] = check._window_gap(
        (k5["code_mag"], None, k5["carr_mag"], None), ref["win"],
        ref["keep"], False)
    return check.gaps(judged, ref)


def control_fix(R: check.Reference, rec: dict, **variant) -> dict:
    ctl = reference_fix(R, rec, **variant)
    ref = reference_fix(R, rec, judged=ctl["args"])
    m = ctl["win"].mags()
    judged = dict(best=tuple(b.cpu().numpy() for b in ctl["best"]),
                  fixes=ctl["fixes"], states=ctl["states"])
    judged["window_gap"] = check._window_gap((m[0], None, m[1], None),
                                             ref["win"], ref["keep"], False)
    return check.gaps(judged, ref)


def judge(R: check.Reference, rec: dict, variant: dict | None = None,
          limits: dict | None = None, log=None):
    """The numbers of one recorded weak cold start: the program's (variant
    None) or a control's (a `CONTROLS` variant in the program's place; it
    replaces no acquisition, so it has no numbers against the truth). With
    the cell's limits, the program's fix is judged with the correlator's
    float32 ties taken as the program took them (harness/ties.py)."""
    v = variant or {}
    out = {}
    if variant is None:
        out["acq_code_gap_chips"], out["acq_doppler_gap_hz"] = (
            check_coldstart.acquisition_gaps(rec["acq"], R.cap.hand))
    if variant is None or "search_round" in v:
        out.update(deep_gaps(R, rec["acq"], rec["deep_ms"], rec["n_coh_ms"],
                             v.get("search_round")))
    else:                       # the plain search in the program's place
        out.update(deep_bin_gap=0.0, deep_z_gap=0.0)
    m = rec["coh_ms"]
    for ch in {id(c): c for c in rec["chunks"].values()}.values():
        ref_state, ref_log = replay_chunk(R, ch, m)
        if variant is None:
            got_state, got_log = ch["state_out"], ch["logf"]
        else:
            got_state, got_log = replay_chunk(R, ch, m, v.get("round_sums"))
        check.merge(out, dict(zip(("track_gap", "track_state_gap_m"),
                                  check_coldstart.track_gaps(
                                      got_state, got_log, ref_state,
                                      ref_log))))
        check.merge(out, {"track_gap": segment_gap(got_log, ref_log, m)})
    h_prog = check_coldstart.frozen_handoff(rec["handoff"])
    ref_h = check_coldstart.reference_handoff(rec["obs"], h_prog)
    got_h = (h_prog if variant is None else
             check_coldstart.reference_handoff(rec["obs"], h_prog,
                                               v.get("round_to")))
    out["handoff_gap_m"] = check_coldstart.handoff_gap(got_h, ref_h)
    out["eph_gap_m"] = check_coldstart.eph_gap_m(
        h_prog.eph_fields, R.cap.eph, float(h_prog.rx_time),
        v.get("round_to"))
    fix = dict(rec["fix"], eph=h_prog.eph_array(), start=h_prog)
    if variant is None and limits is None:
        out.update(judge_fix(R, fix))
    elif variant is None:
        k5 = fix["k5"]
        out.update(ties.judge(judge_fix, R, fix,
                              (k5["code_mag"], k5["carr_mag"]), limits, log))
    else:
        out.update(control_fix(R, fix, **{
            k: x for k, x in v.items() if k in ("tf32", "round_to")}))
    return out
