"""The plain reference of the scalar tracker at coherent updates of m code
periods (PyTorch, float32): one closed-loop DLL/PLL/FLL update a window of
m periods, over a chunk.

The loop algebra is reference/tracker.py's at m (the polarity hypothesis
test over the m + 2 segments, the lock detector and loop filters rescaled
to the m ms update, the m + 1 nav-bit signs); the correlation sums run in
the coherent kernel's order (navlab_dpe_sdr_tpu_torch/ops/track.py
`_window_order_sum` over the WINDOW_WARPS warps of the kernel's
WINDOW_LANES lanes), which the port's `track_window_kernel` is held to
bit for bit on the card. `round_sums` makes the control, as in
reference/tracker.py. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracker as base
from .tracker import F_CA32, L_CA32, TWO_PI, LoopConfig, TrackState

WINDOW_LANES = 2560     # the coherent kernel's correlating lanes a channel
WINDOW_WARPS = WINDOW_LANES // 32   # all of them take one window at m > 1


def _window_order_sum(prod, warps: int):
    """Sum over the last axis (a window's S samples) in the coherent
    kernel's order: warp w takes the contiguous 32 R samples from w 32 R
    (R = ceil(S / (32 warps))), lane i its samples w 32 R + i + 32 r added
    in turn, a warp-shuffle tree reduces each warp, then the warps are
    added in turn."""
    s = prod.shape[-1]
    r = -(-s // (32 * warps))
    p = torch.nn.functional.pad(prod, (0, warps * 32 * r - s))
    p = p.reshape(p.shape[:-1] + (warps, r, 32))
    acc = p[..., 0, :]
    for i in range(1, r):
        acc = acc + p[..., i, :]
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    acc = acc[..., 0]
    tot = acc[..., 0]
    for wi in range(1, warps):
        tot = tot + acc[..., wi]
    return tot


def correlate_window(raw_re, raw_im, rc, dfc, ri, fi, code_table, time_idc,
                     fs: float, m: int):
    """Sums [C, 3 tap (E, P, L), m + 2 seg, 2 (re, im)] f32 and ncp [C]
    int32 of one window of m code periods (reference/tracker.py
    `correlate_window_plain`'s operations, summed in the coherent kernel's
    order)."""
    c = code_table.shape[0]
    s = raw_re.shape[0]
    n_seg = int(m) + 2
    ang = TWO_PI * (fi[:, None] * time_idc[None, :] + ri[:, None])
    wc, ws = torch.cos(ang), torch.sin(ang)
    bb_re = raw_re[None, :] * wc + raw_im[None, :] * ws
    bb_im = raw_im[None, :] * wc - raw_re[None, :] * ws

    base_idx = time_idc * F_CA32
    rc_mid = rc + dfc * float(np.float32(m * 0.5e-3))
    taps = []
    for phase in (rc_mid + 0.5, rc_mid, rc_mid - 0.5):
        idx = torch.remainder(torch.floor(base_idx[None, :] + phase[:, None]),
                              L_CA32).long()
        taps.append(torch.gather(code_table, 1, idx))
    repl = torch.stack(taps, dim=2)                         # [C, S, 3]

    fc = F_CA32 + dfc
    ratio = torch.full_like(fc, float(np.float32(fs))) / fc
    cols = torch.arange(s, dtype=torch.float32, device=raw_re.device)
    seg = torch.zeros((c, s), dtype=torch.long, device=raw_re.device)
    for k in range(1, n_seg):
        bk = (float(np.float32(k * 1023)) - rc) * ratio
        seg = seg + (cols[None, :] >= bk[:, None]).long()
    segm = (seg[:, :, None]
            == torch.arange(n_seg, device=raw_re.device)).float()
    w = (repl[:, :, :, None] * segm[:, :, None, :]).reshape(c, s, 3 * n_seg)
    bb = torch.stack([bb_re, bb_im], dim=1)                 # [C, 2, S]
    prod = bb[:, :, None, :] * w.transpose(1, 2)[:, None]   # [C, 2, 3n, S]
    total = _window_order_sum(prod, WINDOW_WARPS)
    sums = total.reshape(c, 2, 3, n_seg).permute(0, 2, 3, 1)
    ncp = torch.floor((float(np.float32(s / fs)) * fc + rc)
                      * float(np.float32(1.0 / 1023))).to(torch.int32)
    return sums.contiguous(), ncp


def _step(st: TrackState, raw_re, raw_im, code_table, time_idc, fs: float,
          fcaid: float, loops: LoopConfig, m: int, round_sums=None):
    """One closed-loop update over an m-period window (reference/tracker.py
    `_step_plain` with the coherent kernel's sums)."""
    sums, ncp = correlate_window(raw_re, raw_im, st.rc, st.dfc, st.ri, st.fi,
                                 code_table, time_idc, fs, m)
    if round_sums is not None:          # the control: sums a step down
        sums = sums.to(round_sums).float()
    e_s, p_s, l_s = sums[:, 0], sums[:, 1], sums[:, 2]
    e_r, p_r, l_r, signs, pa_re, pa_im = base._polarity_combine(
        st, e_s, p_s, l_s, ncp, m)
    st1, lock, lockval, snr = base._lock_snr_update(
        st._replace(p_a_re=pa_re, p_a_im=pa_im), p_r, m)
    t_up = float(np.float32(m * base.T_MS))
    st2 = st1._replace(rc=torch.remainder(st.rc + st.dfc * t_up, L_CA32),
                       ri=torch.remainder(st.ri + st.fi * t_up, 1.0),
                       cp=st.cp + ncp)
    st3, dpc, dpi = base._loops_update(st2, e_r, p_r, l_r, fcaid, loops, m)
    logf, logi = base._log_rows(e_r, p_r, l_r, st.rc, st.ri, st.dfc, st.fi,
                                lockval, snr, dpc, dpi, signs, st.cp, ncp,
                                lock)
    # a coherent window's row also carries its prompt segment sums
    logf = torch.cat([logf, p_s.reshape(p_s.shape[0], -1).T])
    return st3, logf, logi


def track_chunk(state: TrackState, raw_chunk, code_table, fs: float,
                fcaid: float, loops: LoopConfig, coh_ms: int,
                round_sums=None):
    """(final state, logf [steps, 15 + m + 2 (m + 2), C], logi
    [steps, 3, C]) over raw_chunk [steps, m P0, 2], each window coh_ms
    (> 1) code periods: the base rows, the m + 1 signs and the prompt's
    m + 2 segment sums (in-phase, quadrature)."""
    m = int(coh_ms)
    s = raw_chunk.shape[1]
    time_idc = base.window_times(s, fs, raw_chunk.device)
    rows_f, rows_i = [], []
    st = state
    for k in range(raw_chunk.shape[0]):
        raw = raw_chunk[k].float()
        st, lf, li = _step(st, raw[:, 0], raw[:, 1], code_table, time_idc,
                           fs, fcaid, loops, m, round_sums)
        rows_f.append(lf)
        rows_i.append(li)
    return st, torch.stack(rows_f), torch.stack(rows_i)


def cadence_loops(coh_ms: int) -> LoopConfig:
    """The loops of an m ms update (the receiver's documented coherent
    settings): the PLL narrowed to 48 / m Hz with 12 / m Hz of FLL
    assist, second order, the DLL at its 1 ms bandwidth."""
    m = int(coh_ms)
    if m == 1:
        return LoopConfig()
    return LoopConfig(order=2, bn_code=base.BN_CODE_DEFAULT, bn_carr=48.0 / m,
                      bn_carr_freq=12.0 / m)
