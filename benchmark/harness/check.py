"""What decides `correct`: the program's outputs against the reference's.

The reference follows the program step by step: from a snapshot of the
program's receiver taken before an operation (a batched dispatch's
preparation, its drain, or a per-block step) it works out again, from the
same samples and with its own copies of the host algebra and the plain
device algebra, what the operation should hand the device and what it
should leave, and judges what the program produced there:

- `window_gap`: the correlator's windows of every block (complex, or their
  magnitudes where the timed path keeps only those), the largest
  difference over a channel's window, relative to that window's largest
  value; channels whose nav-bit boundary is sample 0 (a degenerate tie of
  the flip) are left out;
- `best_gap`: the scorer's best score of each fix, relative to the
  reference's best over the whole grid;
- `score_gap`: how far below the reference's best the reference's own
  score of the grid cell the program chose lies, relative to that best (0
  where the program chose the reference's argmax or an exact tie of it);
- `fix_gap_m`: the fix (the alpha EKF's state after the update with the
  program's cells), the largest difference of its position and clock [m];
- `state_gap_m`: the receiver's state after each operation, in metres
  (reference/receiver.py `state_gap_m`).

The control puts the reference in the program's place in the precision
below the configuration's, and is judged in the same way: `CONTROLS` has
two, the correlator's products in TF32 (the device's float32 one step
down) and the host's state rounded to float32 after every operation (the
host's float64 one step down).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frozen.libgnss.cacode import ca_table
from ..frozen.models import grid as frozen_grid
from ..reference import device as ref_dev
from ..reference.receiver import RefReceiver, auto_windows, state_gap_m

CONTROLS = {"tf32": dict(tf32=True), "f32_host": dict(round_to=np.float32)}
CORR_BLOCKS = 10          # blocks a reference correlator call
SCORE_ELEMS = 1 << 26     # scores a reference chunk holds


def make_grid(spec: dict):
    spec = dict(spec)
    style = spec.pop("style")
    return frozen_grid.make_grid(style, **spec)


class Reference:
    """The reference's fixed inputs for one cell: grid, windows, chip and
    time tables on the device."""

    def __init__(self, config: dict, cap, device):
        sc = config["scenario"]
        self.device = device
        self.grid = make_grid(config["grid"])
        self.fs, self.T = sc["fs"], sc["block_s"]
        self.S = int(round(self.T * self.fs))
        self.carr_fftpts = 8 * (1 << self.S.bit_length())
        self.period = int(round(1e-3 * self.fs))
        self.code_win, self.carr_win = auto_windows(
            self.grid.d_enu, self.grid.dt_m, self.grid.dv_enu,
            self.grid.dtdot, self.fs, self.carr_fftpts)
        self.alpha = config["receiver"]["ekf_alpha"]
        self.cap = cap
        f32 = dict(dtype=torch.float32, device=device)
        g = self.grid
        self.d_enu = torch.as_tensor(g.d_enu, **f32)
        self.dt_m = torch.as_tensor(g.dt_m, **f32)
        self.dv_enu = torch.as_tensor(g.dv_enu, **f32)
        self.dtdot = torch.as_tensor(g.dtdot, **f32)
        self.chips = torch.as_tensor(ca_table(list(cap.hand.prn_list)), **f32)
        self.time_idc = torch.as_tensor(np.arange(self.S) / self.fs, **f32)

    def receiver(self, round_to=None, eph=None) -> RefReceiver:
        return RefReceiver(self.cap.eph if eph is None else eph, self.fs,
                           self.T, self.code_win, self.carr_win, self.alpha,
                           round_to)

    def correlate(self, sample0: int, fpk, ipk, tf32: bool):
        """Windows of the blocks that start at sample sample0 with the
        packed parameters fpk [N, 11, C], ipk [N, 3, C] (numpy)."""
        fp = torch.as_tensor(fpk, dtype=torch.float32, device=self.device)
        ip = torch.as_tensor(ipk, dtype=torch.int64, device=self.device)
        flat = self.cap.raw.reshape(-1, 2)
        parts = []
        with ref_dev.matmul_precision(tf32):
            for a in range(0, fp.shape[0], CORR_BLOCKS):
                b = min(fp.shape[0], a + CORR_BLOCKS)
                raw = flat[sample0 + a * self.S:sample0 + b * self.S].reshape(
                    b - a, self.S, 2)
                parts.append(ref_dev.correlate(
                    raw[..., 0], raw[..., 1], self.chips, fp[a:b, 0],
                    ip[a:b, 0], fp[a:b, 1], fp[a:b, 2], self.time_idc,
                    ip[a:b, 1], ip[a:b, 2], self.carr_fftpts, self.period,
                    self.S // self.period, self.code_win, self.carr_win))
        return ref_dev.Windows(*(torch.cat(x) for x in zip(*parts)))

    def score(self, mags, fpk, judged=None):
        """Per manifold ((best, arg), score at the judged cells) of each row
        of the window magnitudes (code, carrier) with the rows' geometry
        fpk [R, 11, C]."""
        fp = torch.as_tensor(fpk, dtype=torch.float32, device=self.device)
        los = fp[:, 3:6].transpose(1, 2)
        out = []
        for m, (win, center, coef, r0, o3, o1) in enumerate((
                (mags[0], fp[:, 7], fp[:, 8], fp[:, 6], self.d_enu,
                 self.dt_m),
                (mags[1], fp[:, 9], fp[:, 10], None, self.dv_enu,
                 self.dtdot))):
            rows, c = win.shape[:2]
            chunk = max(4096, SCORE_ELEMS // (rows * c))
            top, arg = ref_dev.best(win, los, center, coef, r0, o3, o1,
                                    chunk)
            at = None
            if judged is not None:
                idx = torch.as_tensor(judged[m], device=self.device)
                at = torch.stack([
                    ref_dev.scores(win[i:i + 1], los[i:i + 1],
                                   center[i:i + 1], coef[i:i + 1],
                                   None if r0 is None else r0[i:i + 1],
                                   o3[idx[i]][None], o1[idx[i]][None])[0, 0]
                    for i in range(rows)])
            out.append(((top, arg), at))
        return out


def start_cache_batched(rr: RefReceiver, hand) -> None:
    """Start the reference's satellite-state cache where the batched
    receiver starts its own: at its first dispatch from the handoff, from
    the earliest transmit time of that dispatch's initial guess."""
    eph = rr.eph
    phi0 = 1023.0 * (hand.cp - eph.cp_timestamp) + hand.rc
    rr.start_cache(eph.tow_timestamp + (phi0 + hand.fc * (1.0 * rr.T))
                   / 1.023e6)


def start_cache_step(rr: RefReceiver, hand) -> None:
    """The same for the per-block step: its first channel prediction."""
    T = rr.T
    cp_pred = hand.cp + np.floor((hand.rc + hand.fc * T) / 1023.0)
    rc_pred = np.mod(hand.rc + hand.fc * T, 1023.0)
    eph = rr.eph
    rr.start_cache(eph.tow_timestamp + 1e-3 * (cp_pred - eph.cp_timestamp)
                   + rc_pred / 1.023e6)


def _window_gap(judged, ref: ref_dev.Windows, keep, complex_win: bool):
    """Largest |judged - ref| over a channel's window, relative to the
    window's largest |ref|, over the kept (block, channel) pairs."""
    worst = 0.0
    pairs = (((judged[0], judged[1]), (ref.code_re, ref.code_im)),
             ((judged[2], judged[3]), (ref.carr_re, ref.carr_im)))
    for (jre, jim), (rre, rim) in pairs:
        if complex_win:
            diff = torch.hypot(jre - rre, jim - rim)
        else:
            diff = (jre - torch.hypot(rre, rim)).abs()
        scale = torch.hypot(rre, rim).amax(-1)
        gap = (diff.amax(-1) / scale)[keep]
        if gap.numel():
            worst = max(worst, float(gap.max()))
    return worst


def gaps(judged: dict, ref: dict) -> dict:
    """The five numbers of one judged operation against the reference."""
    out = {"window_gap": judged.get("window_gap", 0.0)}
    best_gap = score_gap = 0.0
    for m in range(2):
        top = ref["best"][m].double()
        best_gap = max(best_gap, float(
            ((torch.as_tensor(judged["best"][m], dtype=torch.float64,
                              device=top.device) - top).abs() / top).max()))
        score_gap = max(score_gap, float(
            ((top - ref["at"][m].double()) / top).max()))
    out["best_gap"] = best_gap
    out["score_gap"] = score_gap
    out["fix_gap_m"] = float(np.abs(
        np.asarray(judged["fixes"])[:, :4] - ref["fixes"][:, :4]).max())
    out["state_gap_m"] = max(state_gap_m(a, b) for a, b in
                             zip(judged["states"], ref["states"]))
    return out


def merge(into: dict, new: dict) -> dict:
    for k, v in new.items():
        into[k] = max(into.get(k, 0.0), v)
    return into


# -- the batched dispatch -----------------------------------------------------

def reference_dispatch(R: Reference, rec: dict, group_k: int, judged=None,
                       round_to=None, tf32: bool = False) -> dict:
    """The reference (or, with round_to / tf32, the control) of one
    recorded dispatch: its preparation from the state before it, the
    windows, the scores, and its drain from the state before the drain
    with the judged cells (its own when judged is None)."""
    rr = R.receiver(round_to)
    start_cache_batched(rr, R.cap.hand)
    rr.load(rec["pre_prep"])
    preps = rr.prepare_batch(rec["n"])
    post_prep = rr.snapshot()
    fpk = np.stack([p[0] for p in preps])
    ipk = np.stack([p[1] for p in preps])
    win = R.correlate(rec["start"] * R.S, fpk, ipk, tf32)
    keep = torch.as_tensor(ipk[:, 0] != 0, device=R.device)
    if group_k > 1:
        scored = ref_dev.coherent_sum(win, group_k)
        fpk_rows = fpk[group_k - 1::group_k]
    else:
        scored, fpk_rows = win, fpk
    (pos, pos_at), (vel, vel_at) = R.score(scored.mags(), fpk_rows, judged)
    args = (pos[1].cpu().numpy(), vel[1].cpu().numpy())
    cells = list(zip(*(judged if judged is not None else args)))
    rr.load(rec["pre_drain"])
    fixes = rr.drain(preps, cells, R.grid, group_k)
    return dict(win=win, keep=keep, best=(pos[0], vel[0]), args=args,
                at=(pos_at, vel_at), fixes=fixes,
                states=(post_prep, rr.snapshot()))


def judge_dispatch(R: Reference, rec: dict, group_k: int) -> dict:
    """The program's recorded dispatch against the reference."""
    prog = rec["k5"]
    complex_win = group_k > 1
    judged_cells = (rec["pa"], rec["va"])
    ref = reference_dispatch(R, rec, group_k, judged=judged_cells)
    if complex_win:
        jw = (prog.code_re, prog.code_im, prog.carr_re, prog.carr_im)
    else:
        jw = (prog.code_mag, None, prog.carr_mag, None)
    judged = dict(best=(rec["pb"], rec["vb"]), fixes=rec["fixes"],
                  states=(rec["post_prep"], rec["post_drain"]))
    judged["window_gap"] = _window_gap(jw, ref["win"], ref["keep"],
                                       complex_win)
    return gaps(judged, ref)


def control_dispatch(R: Reference, rec: dict, group_k: int,
                     **variant) -> dict:
    """The control (a `CONTROLS` variant) of one recorded dispatch: the
    reference in the program's place in the precision below the
    configuration's, judged alike."""
    ctl = reference_dispatch(R, rec, group_k, **variant)
    ref = reference_dispatch(R, rec, group_k, judged=ctl["args"])
    w = ctl["win"]
    complex_win = group_k > 1
    if complex_win:
        jw = (w.code_re, w.code_im, w.carr_re, w.carr_im)
    else:
        m = w.mags()
        jw = (m[0], None, m[1], None)
    judged = dict(best=(ctl["best"][0].cpu().numpy(),
                        ctl["best"][1].cpu().numpy()),
                  fixes=ctl["fixes"], states=ctl["states"])
    judged["window_gap"] = _window_gap(jw, ref["win"], ref["keep"],
                                       complex_win)
    return gaps(judged, ref)


# -- the per-block step -------------------------------------------------------

def reference_step(R: Reference, rec: dict, judged=None, round_to=None,
                   tf32: bool = False) -> dict:
    """The reference (or the control) of one recorded per-block step: from
    the state before it (`pre`), over the block at sample `sample0`, with
    the ephemerides `eph` and the receiver's start `start` (the cell's
    truth handoff unless the record names others)."""
    rr = R.receiver(round_to, rec.get("eph"))
    start_cache_step(rr, rec.get("start", R.cap.hand))
    rr.load(rec["pre"])
    fpk, ipk, r_e2n = rr.step_prepare()
    win = R.correlate(rec["sample0"], fpk[None], ipk[None], tf32)
    keep = torch.as_tensor(ipk[None, 0] != 0, device=R.device)
    (pos, pos_at), (vel, vel_at) = R.score(win.mags(), fpk[None], judged)
    args = (pos[1].cpu().numpy(), vel[1].cpu().numpy())
    cell = (judged[0][0], judged[1][0]) if judged is not None else (
        args[0][0], args[1][0])
    fix = rr.step_finish(r_e2n, cell, R.grid)
    return dict(win=win, keep=keep, best=(pos[0], vel[0]), args=args,
                at=(pos_at, vel_at), fixes=fix[None],
                states=(rr.snapshot(),))


def judge_step(R: Reference, rec: dict) -> dict:
    ref = reference_step(R, rec, judged=([rec["pa"]], [rec["va"]]))
    jw = (rec["code_mag"][None], None, rec["carr_mag"][None], None)
    judged = dict(best=([rec["pb"]], [rec["vb"]]), fixes=rec["fix"][None],
                  states=(rec["post"],))
    judged["window_gap"] = _window_gap(jw, ref["win"], ref["keep"], False)
    return gaps(judged, ref)


def control_step(R: Reference, rec: dict, **variant) -> dict:
    ctl = reference_step(R, rec, **variant)
    ref = reference_step(R, rec, judged=ctl["args"])
    m = ctl["win"].mags()
    judged = dict(best=(ctl["best"][0].cpu().numpy(),
                        ctl["best"][1].cpu().numpy()),
                  fixes=ctl["fixes"], states=ctl["states"])
    judged["window_gap"] = _window_gap((m[0], None, m[1], None), ref["win"],
                                       ref["keep"], False)
    return gaps(judged, ref)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}) over the
    cell's limits; a number the run did not produce fails."""
    out = {}
    for k, limit in limits.items():
        v = numbers.get(k)
        v = float(v) if v is not None and np.isfinite(v) else None
        out[k] = {"value": v, "limit": float(limit)}
    return all(within(v) for v in out.values()), out


def within(entry: dict) -> bool:
    """A compared number {value, limit} within its limit (a missing value
    is not)."""
    return entry["value"] is not None and entry["value"] <= entry["limit"]
