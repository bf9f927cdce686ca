"""The reference correlator (reference/device.py `correlate`) with the
nav-bit flip decisions given, and the margin of each decision.

`correlate` works out every block and channel's windows as
reference/device.py does, in the same operations and order, so that with
`use_flip` None its windows and flips are those of device.py bit for bit.
With `use_flip` [N, C] it takes those flips instead of deciding them. It
also returns each decision's margin: how far apart the magnitudes of the
whole block's two lag-0 sums (flip, no flip) lie, relative to the larger.
Nothing here imports the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .device import (_SLIVER, _TWO_PI, S0_SPLIT, Windows, _dft_twiddles,
                     period_replicas)


def correlate(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri, time_idc,
              pos_start, vel_start, carr_fftpts: int, period: int,
              n_periods: int, code_win: int, carr_win: int, use_flip=None):
    """(Windows of N blocks [N, S], margin [N, C]); flips from use_flip
    [N, C] bool where given, else decided as reference/device.py does."""
    raw_re, raw_im = raw_re.float(), raw_im.float()
    n, s = raw_re.shape
    c = chips.shape[0]
    dev = raw_re.device
    idx_next = idx_next.long()
    pos_start = pos_start.long()
    vel_start = vel_start.long()

    ang = _TWO_PI * (fi[..., None] * time_idc + ri[..., None])  # [N, C, S]
    wc, ws = torch.cos(ang), torch.sin(ang)
    bb_re = raw_re[:, None, :] * wc + raw_im[:, None, :] * ws
    bb_im = raw_im[:, None, :] * wc - raw_re[:, None, :] * ws

    p_repl = period_replicas(chips, rc_mid, period)         # [N, C, P0]
    repl = p_repl.repeat(1, 1, n_periods)                   # [N, C, S]
    cols = torch.arange(s, device=dev)
    tail = (cols >= idx_next[..., None]).float()            # [N, C, S]

    def fold(x):
        return x.reshape(n, c, n_periods, period).sum(2)

    fold_re, fold_im = fold(bb_re), fold(bb_im)
    fold_tail_re, fold_tail_im = fold(bb_re * tail), fold(bb_im * tail)

    m_signed = pos_start[..., None] + torch.arange(code_win, device=dev) \
        - s // 2                                            # [N, C, W]
    q = torch.arange(period, device=dev)
    lag = torch.gather(
        p_repl[:, :, None, :].expand(n, c, code_win, period), 3,
        torch.remainder(q - m_signed[..., None], period))   # [N, C, W, P0]

    def corr_with(fr, fi_):
        return ((lag * fr[:, :, None, :]).sum(-1),
                (lag * fi_[:, :, None, :]).sum(-1))

    nf_re, nf_im = corr_with(fold_re, fold_im)
    t_re, t_im = corr_with(fold_tail_re, fold_tail_im)

    sl_start = (idx_next - _SLIVER // 2).clamp(0, s - _SLIVER)   # [N, C]
    sliver_pos = sl_start[..., None] + torch.arange(_SLIVER, device=dev)
    sliver_re = torch.gather(bb_re, 2, sliver_pos)          # [N, C, SL]
    sliver_im = torch.gather(bb_im, 2, sliver_pos)
    in_tail_m = (sliver_pos[:, :, None, :]
                 >= (idx_next[..., None] + m_signed)[..., None])
    in_tail_0 = sliver_pos >= idx_next[..., None]
    delta = in_tail_m.float() - in_tail_0[:, :, None, :].float()
    repl2 = torch.cat([p_repl, p_repl], dim=-1)             # [N, C, 2 P0]
    sl_q0 = torch.remainder(sl_start[..., None] - m_signed, period)
    sliver_repl_m = torch.gather(
        repl2[:, :, None, :].expand(n, c, code_win, 2 * period), 3,
        sl_q0[..., None] + torch.arange(_SLIVER, device=dev))  # [N,C,W,SL]
    corr_t_re = t_re + (delta * sliver_re[:, :, None, :]
                        * sliver_repl_m).sum(-1)
    corr_t_im = t_im + (delta * sliver_im[:, :, None, :]
                        * sliver_repl_m).sum(-1)
    fl_re = nf_re - 2.0 * corr_t_re
    fl_im = nf_im - 2.0 * corr_t_im

    flip_sign = 1.0 - 2.0 * tail
    c0nf_re = (bb_re * repl).sum(-1)
    c0nf_im = (bb_im * repl).sum(-1)
    c0fl_re = (bb_re * repl * flip_sign).sum(-1)
    c0fl_im = (bb_im * repl * flip_sign).sum(-1)
    p_fl = c0fl_re ** 2 + c0fl_im ** 2
    p_nf = c0nf_re ** 2 + c0nf_im ** 2
    a_fl, a_nf = torch.sqrt(p_fl), torch.sqrt(p_nf)
    margin = (a_fl - a_nf).abs() / torch.maximum(a_fl, a_nf)
    if use_flip is None:
        use_flip = p_fl > p_nf
    else:
        use_flip = use_flip.to(dev).bool()
    w_re = torch.where(use_flip[..., None], fl_re, nf_re)
    w_im = torch.where(use_flip[..., None], fl_im, nf_im)

    repl_chosen = torch.where(use_flip[..., None], repl * flip_sign, repl)
    y_base_re = (raw_re - raw_re.mean(1, keepdim=True))[:, None, :] \
        * repl_chosen
    y_base_im = (raw_im - raw_im.mean(1, keepdim=True))[:, None, :] \
        * repl_chosen
    y_re = y_base_re * wc + y_base_im * ws
    y_im = y_base_im * wc - y_base_re * ws
    s0_n = S0_SPLIT
    s1_n = -(-s // s0_n)
    pad = s1_n * s0_n - s
    y_re_p = F.pad(y_re, (0, pad)).reshape(n, c, s1_n, s0_n)
    y_im_p = F.pad(y_im, (0, pad)).reshape(n, c, s1_n, s0_n)
    a_cos, a_sin, b_cos, b_sin = _dft_twiddles(vel_start, carr_fftpts, s1_n,
                                               s0_n, carr_win)
    z_re = a_cos @ y_re_p + a_sin @ y_im_p                  # [N, C, W, s0]
    z_im = a_cos @ y_im_p - a_sin @ y_re_p
    x_re = (z_re * b_cos + z_im * b_sin).sum(-1)
    x_im = (z_im * b_cos - z_re * b_sin).sum(-1)
    return Windows(w_re, w_im, x_re, x_im, use_flip), margin
