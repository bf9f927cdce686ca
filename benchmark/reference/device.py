"""The plain reference of the receiver's device side (PyTorch, float32).

- `correlate`: the windowed correlator in its direct, unfactorized form
  (navlab_dpe_sdr_tpu_torch/ops/correlate.py `windowed_correlate_direct`,
  the oracle the program's correlator is held to): the carrier wiped off
  the whole block, folds by code period (whole and nav-bit tail), the
  lag-shifted replicas, the boundary arc, the flip decided from the full
  lag-0 sums, and the carrier window by a two-stage DFT of the wiped,
  replica-multiplied samples. Out: the complex windows of each block and
  channel, and the flips.
- `coherent_sum`: a group's blocks summed with data-aided nav-bit alignment
  (ops/dpe_real.py `coherent_sum`).
- `scores`: the manifold score of grid points, the 3-tap quadratic
  interpolation of each channel's window magnitude summed over the channels
  (ops/score.py `score_points`, quadratic), and `best` the (maximum, first
  index at it) over a whole grid, in chunks.

Float32 matrix products run in full float32 unless `tf32` says otherwise:
the control computes the correlator's products in TF32, the precision
below the float32 that the configuration states. Nothing here imports the
program.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

L_CA = 1023
_SLIVER = 128            # samples about the nav-bit boundary handled exactly
_TWO_PI = float(np.float32(2.0 * np.pi))
S0_SPLIT = 256           # the carrier DFT's inner split


class Windows(NamedTuple):
    code_re: torch.Tensor     # [N, C, code_win]
    code_im: torch.Tensor
    carr_re: torch.Tensor     # [N, C, carr_win]
    carr_im: torch.Tensor
    flip: torch.Tensor        # [N, C] bool

    def mags(self):
        return (torch.sqrt(self.code_re ** 2 + self.code_im ** 2),
                torch.sqrt(self.carr_re ** 2 + self.carr_im ** 2))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@functools.lru_cache(maxsize=4)
def _chip_index_consts(period: int):
    """floor/frac of the nominal chip index k * L_CA / period, formed in
    float64 and rounded to float32."""
    base0 = (np.arange(period) * float(L_CA) / period).astype(np.float32)
    floor_base = np.floor(base0).astype(np.int64)
    frac_base = (base0 - floor_base.astype(np.float32)).astype(np.float32)
    return floor_base, frac_base


def period_replicas(chips, rc_mid, period: int):
    """One-period +/-1 replicas [..., C, P0] gathered from the chip table
    chips [C, 1023] at the mid-block code phase rc_mid [..., C]."""
    floor_np, frac_np = _chip_index_consts(period)
    dev = chips.device
    floor_base = torch.from_numpy(floor_np).to(dev)
    frac_base = torch.from_numpy(frac_np).to(dev)
    fl = torch.floor(rc_mid)
    carry = (frac_base + (rc_mid - fl)[..., None]) >= 1.0
    chip = torch.remainder(floor_base + fl.long()[..., None] + carry.long(),
                           L_CA)
    rows = torch.arange(chips.shape[0], device=dev)[:, None]
    return chips[rows, chip]


def _dft_twiddles(vel_start, f_total: int, s1_n: int, s0_n: int,
                  carr_win: int):
    dev = vel_start.device
    j = torch.arange(carr_win, device=dev)
    k = torch.remainder(vel_start[..., None] + j - f_total // 2, f_total)
    scale = float(np.float32(2.0 * np.pi / f_total))
    s1 = torch.arange(s1_n, device=dev)
    k256 = torch.remainder(k * s0_n, f_total)
    ang_a = torch.remainder(k256[..., None] * s1, f_total).float() * scale
    s0 = torch.arange(s0_n, device=dev)
    ang_b = torch.remainder(k[..., None] * s0, f_total).float() * scale
    return (torch.cos(ang_a), torch.sin(ang_a), torch.cos(ang_b),
            torch.sin(ang_b))


def correlate(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri, time_idc,
              pos_start, vel_start, carr_fftpts: int, period: int,
              n_periods: int, code_win: int, carr_win: int):
    """The windows of N blocks [N, S] (see the module docstring)."""
    raw_re, raw_im = raw_re.float(), raw_im.float()
    n, s = raw_re.shape
    c = chips.shape[0]
    dev = raw_re.device
    idx_next = idx_next.long()
    pos_start = pos_start.long()
    vel_start = vel_start.long()

    # carrier wipeoff, w = exp(-2 pi i (fi t + ri))
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

    # window lags; row (c, w) of the lag matrix is p[(q - m) mod P0] over q
    m_signed = pos_start[..., None] + torch.arange(code_win, device=dev) \
        - s // 2                                            # [N, C, W]
    q = torch.arange(period, device=dev)
    lag = torch.gather(
        p_repl[:, :, None, :].expand(n, c, code_win, period), 3,
        torch.remainder(q - m_signed[..., None], period))   # [N, C, W, P0]

    def corr_with(fr, fi_):
        return ((lag * fr[:, :, None, :]).sum(-1),
                (lag * fi_[:, :, None, :]).sum(-1))

    nf_re, nf_im = corr_with(fold_re, fold_im)              # no-flip window
    t_re, t_im = corr_with(fold_tail_re, fold_tail_im)      # tail part

    # boundary arc: samples within +/- _SLIVER/2 of idx_next change their
    # tail membership with the lag m
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
    fl_re = nf_re - 2.0 * corr_t_re                         # flip window
    fl_im = nf_im - 2.0 * corr_t_im

    # flip decision at lag 0 over the whole block
    flip_sign = 1.0 - 2.0 * tail
    c0nf_re = (bb_re * repl).sum(-1)
    c0nf_im = (bb_im * repl).sum(-1)
    c0fl_re = (bb_re * repl * flip_sign).sum(-1)
    c0fl_im = (bb_im * repl * flip_sign).sum(-1)
    use_flip = (c0fl_re ** 2 + c0fl_im ** 2) > (c0nf_re ** 2 + c0nf_im ** 2)
    w_re = torch.where(use_flip[..., None], fl_re, nf_re)
    w_im = torch.where(use_flip[..., None], fl_im, nf_im)

    # carrier window: wiped, mean-removed, replica-multiplied samples through
    # a two-stage DFT with integer-exact twiddle phases
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
    return Windows(w_re, w_im, x_re, x_im, use_flip)


def coherent_sum(w: Windows, group_k: int) -> Windows:
    """Each group of group_k consecutive blocks summed coherently, each block
    aligned against the running sum by the sign of the central taps' dot
    product (the first: +1). Returns the groups' windows and the flips of
    each group's last block."""
    g = w.code_re.shape[0] // group_k
    parts = [x.reshape((g, group_k) + x.shape[1:]) for x in w]
    cre_all, cim_all, vre_all, vim_all, flips = parts
    mc = cre_all.shape[-1] // 2
    mv = vre_all.shape[-1] // 2
    sl_c = slice(mc - 1, mc + 2)
    sl_v = slice(mv - 1, mv + 2)
    a_cre = torch.zeros_like(cre_all[:, 0])
    a_cim = torch.zeros_like(a_cre)
    a_vre = torch.zeros_like(vre_all[:, 0])
    a_vim = torch.zeros_like(a_vre)
    for k in range(group_k):
        cre, cim = cre_all[:, k], cim_all[:, k]
        vre, vim = vre_all[:, k], vim_all[:, k]
        dot = ((cre[..., sl_c] * a_cre[..., sl_c]
                + cim[..., sl_c] * a_cim[..., sl_c]).sum(-1)
               + (vre[..., sl_v] * a_vre[..., sl_v]
                  + vim[..., sl_v] * a_vim[..., sl_v]).sum(-1))
        sgn = torch.where(dot >= 0.0, 1.0, -1.0)[..., None]
        a_cre = a_cre + sgn * cre
        a_cim = a_cim + sgn * cim
        a_vre = a_vre + sgn * vre
        a_vim = a_vim + sgn * vim
    return Windows(a_cre, a_cim, a_vre, a_vim, flips[:, -1])


def scores(win_mag, los_enu, center, coef, r0, o3, o1):
    """Scores [N, G'] of the grid points o3 [G', 3], o1 [G'] against the
    window magnitudes win_mag [N, C, W] with the geometry los_enu [N, C, 3],
    center/coef [N, C] and r0 [N, C] (position) or None (velocity): per
    channel the window read at idx = center + coef (range + o1) by 3-tap
    quadratic interpolation about k = clip(round(idx), 1, W - 2), summed
    over the channels in channel order."""
    x, y, z = o3[:, 0], o3[:, 1], o3[:, 2]
    l0, l1, l2 = (los_enu[..., j:j + 1] for j in range(3))
    u = l0 * x + l1 * y + l2 * z                               # [N, C, G']
    if r0 is not None:
        d2 = x * x + y * y + z * z
        rng = -u + (d2 - u * u) * (1.0 / (2.0 * r0))[..., None]
    else:
        rng = -u
    idx = center[..., None] + coef[..., None] * (rng + o1)
    w = win_mag.shape[-1]
    k0 = torch.round(idx).clamp(1.0, w - 2.0)
    d = idx - k0
    k = k0.long()
    wm, wp = win_mag[..., :-2], win_mag[..., 2:]
    cb = F.pad(0.5 * (wp - wm), (1, 1))
    cc = F.pad(0.5 * (wp + wm) - win_mag[..., 1:-1], (1, 1))
    vals = (torch.gather(win_mag, 2, k)
            + d * (torch.gather(cb, 2, k) + d * torch.gather(cc, 2, k)))
    acc = vals[:, 0]
    for c in range(1, vals.shape[1]):
        acc = acc + vals[:, c]
    return acc


def best(win_mag, los_enu, center, coef, r0, off3, off1, chunk: int):
    """(maximum [N], first index at it [N]) of `scores` over the whole grid
    off3 [G, 3], off1 [G], chunk points at a time."""
    n = win_mag.shape[0]
    top = torch.full((n,), float("-inf"), device=win_mag.device)
    arg = torch.zeros((n,), dtype=torch.int64, device=win_mag.device)
    for g0 in range(0, off3.shape[0], chunk):
        s = scores(win_mag, los_enu, center, coef, r0, off3[g0:g0 + chunk],
                   off1[g0:g0 + chunk])
        ca = torch.argmax(s, dim=1)
        cb = torch.gather(s, 1, ca[:, None])[:, 0]
        take = cb > top
        top = torch.where(take, cb, top)
        arg = torch.where(take, ca + g0, arg)
    return top, arg
