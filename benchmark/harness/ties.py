"""Float32 ties in what the correlator is handed or decides, judged as the
program took them.

Two of the correlator's inputs and decisions are discontinuous, so that
values the limits let differ by a rounding can move a window far past
the window limits:

- the code phase rc_mid: the host works it out in float64 and packs it in
  float32; where the reference's float64 value (reference/receiver.py
  `_pack`'s rc_mid) lies within the state limit (`state_gap_m`, in chips)
  of the midpoint between two float32 values, the program's may round to
  the other one. A replica sample whose chip
  index carry (reference/device.py `period_replicas`) sits between the two
  then takes the next chip in every code period: 20 samples of a block,
  ~3e-3 of a window's peak at the demo's noise;
- the nav-bit flip, decided from the whole block's two lag-0 sums (flip
  where |c0 - 2 c0t| > |c0|); where the two magnitudes lie within the
  `window_gap` limit of each other (relative), float32 sums in another
  order may decide it the other way, and the two decisions' windows differ
  by twice the tail's part. harness/check.py leaves out only the exact tie
  (the boundary at sample 0).

`judge` looks again at a judged operation that passes one of its limits:
for each block and channel with such a tie it works out the reference's
windows the other way too, and takes whichever of the two lies nearer the
program's windows. The reference is then worked out again with those
choices and held to every limit as before. A block and channel with no
tie keeps the reference's own inputs and decision.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import device as ref_dev
from ..reference import flip_decided

M_PER_CHIP = 299792458.0 / 1.023e6


def correlate(R, sample0: int, fpk, ipk, tf32: bool, use_flip=None):
    """R.correlate (harness/check.py `Reference`) with the flips use_flip
    [N, C] where given: (windows, each decision's margin [N, C])."""
    from .check import CORR_BLOCKS
    fp = torch.as_tensor(fpk, dtype=torch.float32, device=R.device)
    ip = torch.as_tensor(ipk, dtype=torch.int64, device=R.device)
    flat = R.cap.raw.reshape(-1, 2)
    wins, margins = [], []
    with ref_dev.matmul_precision(tf32):
        for a in range(0, fp.shape[0], CORR_BLOCKS):
            b = min(fp.shape[0], a + CORR_BLOCKS)
            raw = flat[sample0 + a * R.S:sample0 + b * R.S].reshape(
                b - a, R.S, 2)
            w, m = flip_decided.correlate(
                raw[..., 0], raw[..., 1], R.chips, fp[a:b, 0], ip[a:b, 0],
                fp[a:b, 1], fp[a:b, 2], R.time_idc, ip[a:b, 1], ip[a:b, 2],
                R.carr_fftpts, R.period, R.S // R.period, R.code_win,
                R.carr_win, None if use_flip is None else use_flip[a:b])
            wins.append(w)
            margins.append(m)
    return (ref_dev.Windows(*(torch.cat(x) for x in zip(*wins))),
            torch.cat(margins))


def other_rounding(rc: np.ndarray, tol: float):
    """(the float32 value on the other side of each rc's float32 rounding,
    whether rc lies within tol of the midpoint between the two)."""
    own = rc.astype(np.float32)
    up = own.astype(np.float64) <= rc
    alt = np.where(up, np.nextafter(own, np.float32(np.inf)),
                   np.nextafter(own, np.float32(-np.inf)))
    mid = (own.astype(np.float64) + alt.astype(np.float64)) / 2.0
    return alt.astype(np.float64), np.abs(rc - mid) <= tol


def _gap(prog, win) -> torch.Tensor:
    """Per block and channel: the largest window difference relative to
    the window's largest magnitude, code and carrier."""
    out = []
    for j, r in zip(prog, win.mags()):
        j = j.to(r.device)
        out.append((j - r).abs().amax(-1) / r.amax(-1))
    return torch.maximum(*out)


def judge(judge_one, R, rec, prog, limits: dict, log=None) -> dict:
    """judge_one(R, rec), the numbers of one recorded operation whose
    reference calls R.correlate once (and packs its blocks' parameters
    with R.receiver()'s `_pack`), with the ties the program took the
    other way taken as it took them (module docstring). prog: the
    program's window magnitudes (code [N, C, W], carrier [N, C, W'])."""
    calls, rcs = [], []
    own_correlate, own_receiver = R.correlate, R.receiver

    def receiver(*a, **kw):
        rr = own_receiver(*a, **kw)
        pack = rr._pack

        def packing(rc_mid, *b):
            rcs.append(np.array(rc_mid, np.float64))
            return pack(rc_mid, *b)
        rr._pack = packing
        return rr
    R.correlate = lambda *a: calls.append(a) or own_correlate(*a)
    R.receiver = receiver
    try:
        got = judge_one(R, rec)
    finally:
        del R.correlate, R.receiver
    if len(calls) != 1 or all(got[k] <= v for k, v in limits.items()
                              if k in got):
        return got
    sample0, fpk, ipk, tf32 = calls[0]
    rc64 = (np.stack(rcs) if len(rcs) == fpk.shape[0]
            else np.asarray(fpk[:, 0], np.float64))
    own, margin = correlate(R, sample0, fpk, ipk, tf32)
    best = _gap(prog, own)
    use_flip = own.flip.clone()
    flipped, _ = correlate(R, sample0, fpk, ipk, tf32, ~own.flip)
    gap = _gap(prog, flipped)
    take = (margin <= float(limits["window_gap"])) & (gap < best)
    use_flip[take] = ~own.flip[take]
    best = torch.where(take, gap, best)
    alt, near = other_rounding(
        rc64, float(limits["state_gap_m"]) / M_PER_CHIP)
    rc = np.asarray(fpk[:, 0], np.float64).copy()
    if near.any():
        fpk_alt = np.array(fpk, np.float64)
        fpk_alt[:, 0] = np.where(near, alt, rc)
        moved, _ = correlate(R, sample0, fpk_alt, ipk, tf32)
        gap = _gap(prog, moved)
        swap = torch.as_tensor(near, device=gap.device) & (gap < best)
        use_flip[swap] = moved.flip[swap]
        rc = np.where(swap.cpu().numpy(), alt, rc)
    changed = (use_flip != own.flip).cpu().numpy() | (rc != fpk[:, 0])
    if not changed.any():
        return got

    def decided(s0, f, i, t):
        f = np.array(f, np.float64)
        f[:, 0] = rc
        return correlate(R, s0, f, i, t, use_flip)[0]
    R.correlate = decided
    try:
        again = judge_one(R, rec)
    finally:
        del R.correlate
    if log is not None:
        at = [(int(b), int(c),
               "rc_mid" if rc[b, c] != fpk[b, 0, c] else "flip",
               float(margin[b, c])) for b, c in zip(*np.nonzero(changed))]
        log(f"ties taken as the program took them (block, channel, which, "
            f"flip margin): {at}; {got} -> {again}")
    return again
