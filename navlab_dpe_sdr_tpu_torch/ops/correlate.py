"""The windowed correlator of the real DPE engine (K5).

`windowed_correlate` is the contract of the JAX package's
`windowed_correlate` (navlab_dpe_sdr_tpu/ops/dpe_real.py:420, XLA matmuls
on the TPU): for each of N blocks and C channels, the period replica, the
carrier split ang(s) = A(p) + B(tau) per code period, the whole and
nav-bit-tail folds over the code periods with the exact boundary-period
term, the rotation by e^{-iB}, `code_win` lags against shifted replicas,
the +/-64-sample boundary-arc correction, the flip decision at lag 0, and
the carrier window: replica-wiped, mean-removed samples through the 256-way
mixed DFT split to `carr_win` bins. Out: magnitudes (`RealBlockOut`) or
split re/im windows (`RealBlockOutC`, for coherent sums) and the flips.

On a CUDA tensor it launches the hand-written Hopper kernel of
`csrc/windowed_correlate.cu` (`windowed_correlate_cuda`); on a CPU tensor
it runs `windowed_correlate_plain`, the same algebra in plain PyTorch
(batched products). There is no fallback between the two. The kernel reads
an int16 capture slice directly (its I and Q as views of [N, S, 2]) and the
per-(block, channel) parameters by their strides, the integer ones as the
float32 rows `pack_params` uploads them in, so a dispatch launches it alone,
with no conversions or slicing copies before it: one launch, a cluster of
`windowed_cluster()` thread blocks per (channel, block) that runs the code
and the carrier phases. It takes periods up to 27 508 samples (front ends
to 27.5 MHz; the shared memory of a thread block sets the limit) and
power-of-two DFT lengths, and refuses others.

The kernel sums every (block, channel) window over the thread blocks of its
own cluster in an order fixed by the cluster size and the thread count, so
a block's windows and flip are the same bits whichever blocks or channels
share the launch: a mesh rank's share of a batch correlates to one
device's bits (parallel/mesh.py). The
plain version on the card, whose cuBLAS products pick their algorithm by
the batch count, is not; on the CPU it is. Kernel and plain version agree
within 1e-5 of each channel's window maximum, with equal flips and code
argmaxes, not to the bit: their sums run in different orders.

Differences of the plain version from the JAX module, all in form, not in
result:
- the block axis N is written out instead of the vmap in `_batch_correlate`;
- replicas are a direct gather from the chip table (the one-hot roll of
  `_period_replicas` exists only because the TPU lacked gather), with the
  chip index built from the same float32 tables, so it is bit-identical;
- the carrier DFT always takes the 256-way mixed split
  (`_dft_twiddles_mixed`): the branch CPU-JAX runs and the one complex_out
  always takes (the period split is ROADMAP Queue 1 item 2);
- integer DFT phases are int64 (same values, no overflow).

Float32 matrix products on CUDA run in full float32, as the JAX CPU
reference does: TF32 (about three decimal digits) is switched off here.

`windowed_correlate_direct` is the oracle of both: the JAX
`_windowed_correlate_direct` (dpe_real.py:176), which wipes the carrier off
the whole block before folding. No receiver path calls it; the bench's
parity block (navlab_dpe_sdr_tpu_torch/bench.py) holds the kernel to it on
the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import L_CA
from . import _build
from .dpe import CARR_WIN, CODE_WIN

torch.backends.cuda.matmul.allow_tf32 = False

_SLIVER = 128  # samples around the nav-bit boundary handled exactly
# the boundary-arc flip correction is exact only for window lags
# |m| <= _SLIVER/2; receivers must keep code_win within this span
SLIVER_LIMIT = _SLIVER
_TWO_PI = float(np.float32(2.0 * np.pi))
S0_SPLIT = 256   # the mixed DFT split's s0 (csrc: windowed_split())
# the kernel's clock split of a thread block (csrc: kClocks), the last the
# block's whole time; `windowed_correlate_cuda(..., clocks=)` fills it
CLOCK_NAMES = ("setup", "folds", "lag sums", "twiddles A", "barrier 1",
               "rank sums", "arc", "DFT", "barrier 2",
               "z over ranks + twiddles B", "sum over s0 + bins out",
               "barrier 3", "whole")


@functools.lru_cache(maxsize=4)
def _base0(period: int) -> np.ndarray:
    """The nominal per-sample chip index k * L_CA / period, formed in
    float64 and rounded to float32 ([P0], as the JAX `_chip_lookup_consts`
    forms it)."""
    return (np.arange(period) * float(int(L_CA)) / period).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _base0_on(period: int, dev: torch.device) -> torch.Tensor:
    """_base0(period) on `dev`, uploaded once (the kernel's replica table)."""
    return torch.from_numpy(_base0(period)).to(dev)


@functools.lru_cache(maxsize=4)
def _chip_index_consts(period: int):
    """floor/frac of the nominal per-sample chip index k * L_CA / period,
    formed in float32 exactly as the JAX `_chip_lookup_consts` forms them.
    Returns numpy (floor_base [P0] int64, frac_base [P0] float32)."""
    base0 = _base0(period)
    floor_base = np.floor(base0).astype(np.int64)
    frac_base = (base0 - floor_base.astype(np.float32)).astype(np.float32)
    return floor_base, frac_base


def period_replicas(chips, rc_mid, period: int):
    """One-period +/-1 replicas by a direct gather from the chip table.

    chips [C, 1023] f32; rc_mid [..., C] f32 mid-block code phase ->
    [..., C, P0] f32. The chip index is floor_base + floor(rc) + carry with
    carry = [frac_base + frac(rc) >= 1] in float32 (not floor(base0 + rc)
    in one f32 expression, which disagrees at chip edges)."""
    floor_np, frac_np = _chip_index_consts(period)
    dev = chips.device
    floor_base = torch.from_numpy(floor_np).to(dev)
    frac_base = torch.from_numpy(frac_np).to(dev)
    fl = torch.floor(rc_mid)
    frac_rc = rc_mid - fl
    carry = (frac_base + frac_rc[..., None]) >= 1.0       # [..., C, P0]
    chip = torch.remainder(floor_base + fl.long()[..., None] + carry.long(),
                           int(L_CA))
    rows = torch.arange(chips.shape[0], device=dev)[:, None]
    return chips[rows, chip]


class RealBlockOut(NamedTuple):
    code_mag: torch.Tensor    # [N, C, code_win]
    carr_mag: torch.Tensor    # [N, C, carr_win]
    flip_used: torch.Tensor   # [N, C] bool


class RealBlockOutC(NamedTuple):
    """Complex (split re/im) window variant — for coherent integration."""
    code_re: torch.Tensor     # [N, C, code_win]
    code_im: torch.Tensor
    carr_re: torch.Tensor     # [N, C, carr_win]
    carr_im: torch.Tensor
    flip_used: torch.Tensor   # [N, C] bool


def _dft_twiddles_mixed(vel_start, fi, ri, dt_s, f_total: int, s1_n: int,
                        s0_n: int, carr_win: int, t0):
    """Two-stage (s0_n-way split) carrier-DFT twiddles with the wipeoff
    folded in ([N, C, W, s1_n] and [N, C, W, s0_n]); JAX
    `_dft_twiddles_mixed` with int64 bin phases."""
    dev = fi.device
    j = torch.arange(carr_win, device=dev)
    k = torch.remainder(vel_start[..., None] + j - f_total // 2,
                        f_total)                           # [N, C, W]
    scale = float(np.float32(2.0 * np.pi / f_total))

    s1 = torch.arange(s1_n, device=dev)
    k256 = torch.remainder(k * s0_n, f_total)
    ph_a = torch.remainder(k256[..., None] * s1, f_total).float()
    t_a = (s1.float() * float(s0_n)) * dt_s
    ang_a = ph_a * scale + _TWO_PI * fi[..., None, None] * t_a

    s0 = torch.arange(s0_n, device=dev)
    ph_b = torch.remainder(k[..., None] * s0, f_total).float()
    t_b = t0 + s0.float() * dt_s
    ang_b = ph_b * scale + _TWO_PI * (fi[..., None, None] * t_b
                                      + ri[..., None, None])
    return (torch.cos(ang_a), torch.sin(ang_a),
            torch.cos(ang_b), torch.sin(ang_b))


def _shifted_rows(p_repl, start, length: int, n_rows: int):
    """[..., n_rows, length] rows r = p_repl[(start + n_rows-1-r + j) mod P0]
    over j: one gathered span + n_rows static shifts (consecutive lags)."""
    period = p_repl.shape[-1]
    span = torch.arange(length + n_rows - 1, device=p_repl.device)
    ext = torch.gather(p_repl, -1,
                       torch.remainder(start[..., None] + span, period))
    return ext.unfold(-1, length, 1).flip(-2)


def windowed_correlate(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri,
                       time_idc, pos_start, vel_start, carr_fftpts: int,
                       period: int, n_periods: int,
                       code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                       complex_out: bool = False):
    """Windowed code correlation + windowed carrier DFT for N blocks.

    raw_re/raw_im [N, S] int16 (views of an [N, S, 2] capture) or f32;
    chips [C, 1023] f32; rc_mid/fi/ri [N, C] f32; idx_next/pos_start/
    vel_start [N, C] integers (idx_next = S for no flip): any integer dtype
    or float32 on the CPU, float32 (the packed rows) on the card; time_idc
    [S] f32,
    uniform (t0 + s*dt). Returns RealBlockOut, or RealBlockOutC with
    complex_out.

    CPU tensors -> `windowed_correlate_plain`; CUDA tensors -> the K5
    kernel (`windowed_correlate_cuda`), or an exception."""
    args = (raw_re, raw_im, chips, rc_mid, idx_next, fi, ri, time_idc,
            pos_start, vel_start, carr_fftpts, period, n_periods, code_win,
            carr_win, complex_out)
    dev = raw_re.device
    if dev.type == "cpu":
        return windowed_correlate_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"windowed_correlate runs on cpu or cuda, not {dev}")
    return windowed_correlate_cuda(*args)


def windowed_correlate_plain(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri,
                             time_idc, pos_start, vel_start,
                             carr_fftpts: int, period: int, n_periods: int,
                             code_win: int = CODE_WIN,
                             carr_win: int = CARR_WIN,
                             complex_out: bool = False):
    """Plain PyTorch `windowed_correlate` (any device). Same algebra as the
    JAX `windowed_correlate` (ops/dpe_real.py:420): carrier phase A(p) +
    B(tau) per code period, folds as [4C, P] x [P, P0] products, exact
    boundary-period and boundary-arc terms, flip decision at lag 0."""
    raw_re, raw_im = raw_re.float(), raw_im.float()
    n, s = raw_re.shape
    c = chips.shape[0]
    dev = raw_re.device
    idx_next = idx_next.long()
    pos_start = pos_start.long()
    vel_start = vel_start.long()
    p_repl = period_replicas(chips, rc_mid, period)         # [N, C, P0]

    # per-period carrier factorization: ang(s) = A(p) + B(tau)
    tt = time_idc[: n_periods * period].reshape(n_periods, period)
    t_p = tt[:, 0] - time_idc[0]                            # [P]
    t_tau = tt[0]                                           # [P0]
    ang_a = _TWO_PI * fi[..., None] * t_p                   # [N, C, P]
    ca_, sa_ = torch.cos(ang_a), torch.sin(ang_a)
    ang_b = _TWO_PI * (fi[..., None] * t_tau + ri[..., None])
    cb_, sb_ = torch.cos(ang_b), torch.sin(ang_b)           # [N, C, P0]

    raw_p = raw_re.reshape(n, n_periods, period)
    raw_ip = raw_im.reshape(n, n_periods, period)

    # tail membership by period: periods after the boundary period p_b
    # flip whole; p_b itself flips from sample offset r_off
    p_b = torch.div(idx_next, period, rounding_mode="floor")   # [N, C]
    r_off = idx_next - p_b * period
    p_idx = torch.arange(n_periods, device=dev)
    maskp = (p_idx > p_b[..., None]).float()                # [N, C, P]

    wts = torch.cat([ca_, sa_, ca_ * maskp, sa_ * maskp], dim=1)  # [N,4C,P]
    fr = torch.bmm(wts, raw_p)                              # [N, 4C, P0]
    fq = torch.bmm(wts, raw_ip)
    rs_re = fr[:, 0:c] + fq[:, c:2 * c]
    rs_im = fq[:, 0:c] - fr[:, c:2 * c]
    ts_re = fr[:, 2 * c:3 * c] + fq[:, 3 * c:4 * c]
    ts_im = fq[:, 2 * c:3 * c] - fr[:, 3 * c:4 * c]

    # exact boundary-period tail term: step(tau >= r_off) * raw(p_b, tau)
    p_bc = p_b.clamp(0, n_periods - 1)
    valid = ((p_b >= 0) & (p_b < n_periods)).float()
    bidx = torch.arange(n, device=dev)[:, None]
    raw_b_re = raw_p[bidx, p_bc]                            # [N, C, P0]
    raw_b_im = raw_ip[bidx, p_bc]
    ca_b = torch.gather(ca_, 2, p_bc[..., None])            # [N, C, 1]
    sa_b = torch.gather(sa_, 2, p_bc[..., None])
    tau_idx = torch.arange(period, device=dev)
    gmask = valid[..., None] * (tau_idx >= r_off[..., None]).float()
    ts_re = ts_re + gmask * (ca_b * raw_b_re + sa_b * raw_b_im)
    ts_im = ts_im + gmask * (ca_b * raw_b_im - sa_b * raw_b_re)

    # rotate by e^{-iB(tau)}: the folded baseband and its tail part
    fold_re = rs_re * cb_ + rs_im * sb_
    fold_im = rs_im * cb_ - rs_re * sb_
    fold_tail_re = ts_re * cb_ + ts_im * sb_
    fold_tail_im = ts_im * cb_ - ts_re * sb_

    # window lags m_w = m0 + w; row w is p_repl[(q - m_w) mod P0]
    m0 = pos_start - s // 2                                 # [N, C]
    m_signed = m0[..., None] + torch.arange(code_win, device=dev)
    lag = _shifted_rows(p_repl, m0.neg() - (code_win - 1), period,
                        code_win)                           # [N, C, W, P0]

    def corr_with(frr, fii):
        return ((lag @ frr[..., None])[..., 0],
                (lag @ fii[..., None])[..., 0])

    nf_re, nf_im = corr_with(fold_re, fold_im)              # no-flip window
    t_re, t_im = corr_with(fold_tail_re, fold_tail_im)      # tail part

    # boundary-arc correction over +/- _SLIVER/2 samples around idx_next
    sl_start = (idx_next - _SLIVER // 2).clamp(0, s - _SLIVER)   # [N, C]
    sliver_pos = sl_start[..., None] + torch.arange(_SLIVER, device=dev)
    raw_sl_re = torch.gather(raw_re, 1, sliver_pos.reshape(n, -1)
                             ).reshape(n, c, _SLIVER)
    raw_sl_im = torch.gather(raw_im, 1, sliver_pos.reshape(n, -1)
                             ).reshape(n, c, _SLIVER)
    # sample times from the endpoints (t0 + f32(s) * dt), as the JAX form
    dt_s = (time_idc[s - 1] - time_idc[0]) / float(s - 1)
    t_sl = time_idc[0] + sliver_pos.float() * dt_s
    ang_sl = _TWO_PI * (fi[..., None] * t_sl + ri[..., None])
    wc_sl, ws_sl = torch.cos(ang_sl), torch.sin(ang_sl)
    sliver_re = raw_sl_re * wc_sl + raw_sl_im * ws_sl
    sliver_im = raw_sl_im * wc_sl - raw_sl_re * ws_sl

    in_tail_m = (sliver_pos[:, :, None, :]
                 >= (idx_next[..., None] + m_signed)[..., None])  # [N,C,W,SL]
    in_tail_0 = sliver_pos >= idx_next[..., None]           # [N, C, SL]
    delta = in_tail_m.float() - in_tail_0[:, :, None, :].float()
    sliver_repl_m = _shifted_rows(p_repl, sl_start - m0 - (code_win - 1),
                                  _SLIVER, code_win)        # [N, C, W, SL]
    corr_t_re = t_re + (delta * sliver_re[:, :, None, :]
                        * sliver_repl_m).sum(-1)
    corr_t_im = t_im + (delta * sliver_im[:, :, None, :]
                        * sliver_repl_m).sum(-1)

    fl_re = nf_re - 2.0 * corr_t_re                         # flip window
    fl_im = nf_im - 2.0 * corr_t_im

    # flip decision at lag 0, read off the folds
    c0nf_re = (p_repl * fold_re).sum(-1)
    c0nf_im = (p_repl * fold_im).sum(-1)
    c0t_re = (p_repl * fold_tail_re).sum(-1)
    c0t_im = (p_repl * fold_tail_im).sum(-1)
    c0fl_re = c0nf_re - 2.0 * c0t_re
    c0fl_im = c0nf_im - 2.0 * c0t_im
    use_flip = (c0fl_re ** 2 + c0fl_im ** 2) > (c0nf_re ** 2 + c0nf_im ** 2)

    w_re = torch.where(use_flip[..., None], fl_re, nf_re)
    w_im = torch.where(use_flip[..., None], fl_im, nf_im)

    # ---- carrier windowed DFT, 256-way mixed split (wipeoff in twiddles)
    mean_re = raw_re.mean(dim=1)[:, None, None]
    mean_im = raw_im.mean(dim=1)[:, None, None]
    repl = p_repl.repeat(1, 1, n_periods)                   # [N, C, S]
    cols = torch.arange(s, device=dev)
    flip_sign = 1.0 - 2.0 * (cols >= idx_next[..., None]).float()
    repl_chosen = torch.where(use_flip[..., None], repl * flip_sign, repl)
    yb_re = (raw_re[:, None, :] - mean_re) * repl_chosen    # [N, C, S]
    yb_im = (raw_im[:, None, :] - mean_im) * repl_chosen
    s0_n = S0_SPLIT
    s1_n = -(-s // s0_n)
    pad = s1_n * s0_n - s
    yb_re_p = F.pad(yb_re, (0, pad)).reshape(n, c, s1_n, s0_n)
    yb_im_p = F.pad(yb_im, (0, pad)).reshape(n, c, s1_n, s0_n)
    a_cos, a_sin, b_cos, b_sin = _dft_twiddles_mixed(
        vel_start, fi, ri, dt_s, carr_fftpts, s1_n, s0_n, carr_win,
        t0=time_idc[0])
    z_re = a_cos @ yb_re_p + a_sin @ yb_im_p                # [N, C, W, s0]
    z_im = a_cos @ yb_im_p - a_sin @ yb_re_p
    x_re = (z_re * b_cos + z_im * b_sin).sum(-1)
    x_im = (z_im * b_cos - z_re * b_sin).sum(-1)
    if complex_out:
        return RealBlockOutC(code_re=w_re, code_im=w_im, carr_re=x_re,
                             carr_im=x_im, flip_used=use_flip)
    return RealBlockOut(code_mag=torch.sqrt(w_re * w_re + w_im * w_im),
                        carr_mag=torch.sqrt(x_re * x_re + x_im * x_im),
                        flip_used=use_flip)


def _dft_twiddles(vel_start, f_total: int, s1_n: int, s0_n: int,
                  carr_win: int):
    """Two-stage windowed-DFT twiddles without the wipeoff ([N, C, W, s1_n]
    and [N, C, W, s0_n]); JAX `_dft_twiddles` with int64 bin phases."""
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


def windowed_correlate_direct(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri,
                              time_idc, pos_start, vel_start,
                              carr_fftpts: int, period: int, n_periods: int,
                              code_win: int = CODE_WIN,
                              carr_win: int = CARR_WIN,
                              complex_out: bool = False):
    """The direct (unfactorized) windowed correlator, an oracle: the JAX
    `_windowed_correlate_direct` (navlab_dpe_sdr_tpu/ops/dpe_real.py:176) in
    plain PyTorch over N blocks, on any device. It wipes the carrier off the
    whole [N, C, S] baseband, folds it by code period (whole and nav-bit
    tail), correlates the folds against the lag-shifted replicas, corrects
    the boundary arc, decides the flip from the full-length lag-0 sums, and
    takes the carrier window by a two-stage DFT of the wiped, replica-
    multiplied samples. Arguments and outputs are `windowed_correlate`'s.
    No receiver path calls it: it holds the factorized forms (the plain
    version and K5) to the straightforward algebra, at [N, C, S] memory."""
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
    if complex_out:
        return RealBlockOutC(code_re=w_re, code_im=w_im, carr_re=x_re,
                             carr_im=x_im, flip_used=use_flip)
    return RealBlockOut(code_mag=torch.sqrt(w_re * w_re + w_im * w_im),
                        carr_mag=torch.sqrt(x_re * x_re + x_im * x_im),
                        flip_used=use_flip)


# -- the kernel (csrc/windowed_correlate.cu) ---------------------------------

class _FParam(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sn", ctypes.c_longlong),
                ("sc", ctypes.c_longlong)]


class _CorrArgs(ctypes.Structure):
    """The kernel's arguments (CorrArgs in csrc/windowed_correlate.cu)."""
    _fields_ = ([("raw_re", ctypes.c_void_p), ("raw_im", ctypes.c_void_p),
                 ("raw_sn", ctypes.c_longlong), ("raw_ss", ctypes.c_longlong)]
                + [(k, ctypes.c_int) for k in (
                    "raw_i16", "n_blocks", "n_chan", "n_samples", "period",
                    "n_periods", "code_win", "carr_win", "complex_out")]
                + [("carr_fftpts", ctypes.c_longlong),
                   ("chips", ctypes.c_void_p), ("chips_sc", ctypes.c_longlong),
                   ("time_idc", ctypes.c_void_p), ("base0", ctypes.c_void_p)]
                + [(k, _FParam) for k in ("rc", "fi", "ri", "idx_next",
                                          "pos_start", "vel_start")]
                + [(k, ctypes.c_void_p) for k in (
                    "code0", "code1", "carr0", "carr1", "flip", "clk")])


def _bind(lib: ctypes.CDLL) -> None:
    lib.windowed_correlate_launch.argtypes = [ctypes.POINTER(_CorrArgs),
                                              ctypes.c_void_p]
    lib.windowed_correlate_launch.restype = ctypes.c_int
    lib.windowed_error_string.argtypes = [ctypes.c_int]
    lib.windowed_error_string.restype = ctypes.c_char_p
    for f in (lib.windowed_split, lib.windowed_cluster,
              lib.windowed_clock_words):
        f.argtypes = []
        f.restype = ctypes.c_int
    lib.windowed_shared_bytes.argtypes = [ctypes.c_int]
    lib.windowed_shared_limit.argtypes = []
    for f in (lib.windowed_shared_bytes, lib.windowed_shared_limit):
        f.restype = ctypes.c_longlong
    if lib.windowed_split() != S0_SPLIT:
        raise RuntimeError(f"csrc/windowed_correlate.cu splits the DFT "
                           f"{lib.windowed_split()} ways, the plain "
                           f"version {S0_SPLIT}")
    if lib.windowed_clock_words() != len(CLOCK_NAMES):
        raise RuntimeError(f"csrc/windowed_correlate.cu splits a block's "
                           f"clocks {lib.windowed_clock_words()} ways, "
                           f"CLOCK_NAMES {len(CLOCK_NAMES)}")


def _lib() -> ctypes.CDLL:
    return _build.load("windowed_correlate", _bind)


def windowed_cluster() -> int:
    """The kernel's thread blocks per (channel, block): its cluster size
    (builds the kernel on first use)."""
    return _lib().windowed_cluster()


def _pairs(raw_re, raw_im) -> bool:
    """Whether raw_re/raw_im are the I and Q of one int16 [N, S, 2] tensor
    whose pairs the kernel reads as 4-byte words."""
    return (raw_re.dtype == raw_im.dtype == torch.int16
            and raw_re.stride() == raw_im.stride()
            and raw_re.stride(1) == 2 and raw_re.stride(0) % 2 == 0
            and raw_im.data_ptr() == raw_re.data_ptr() + 2
            and raw_re.data_ptr() % 4 == 0)


def _f32(t, dev, shape, name):
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need float32 {list(shape)} on {dev}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")
    return t


def _fparam(t, dev, shape, name) -> _FParam:
    t = _f32(t, dev, shape, name)
    return _FParam(t.data_ptr(), t.stride(0), t.stride(1))


def windowed_correlate_cuda(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri,
                            time_idc, pos_start, vel_start,
                            carr_fftpts: int, period: int, n_periods: int,
                            code_win: int = CODE_WIN,
                            carr_win: int = CARR_WIN,
                            complex_out: bool = False, clocks=None):
    """K5 on the card: one call launches one kernel, a cluster per
    (channel, block), on the current stream (one launch in
    `_build.launch_counts()`, "windowed_correlate"). Arguments as
    `windowed_correlate`; the
    parameters are read by their strides (slices of a packed parameter
    tensor go in as they are), all float32: idx_next, pos_start and
    vel_start as the packed rows carry them, integers held exactly. The
    samples are the I and Q views of one int16 [N, S, 2] tensor, or two
    float32 [N, S] tensors of equal strides; anything else raises, as does
    a shape whose thread block needs more shared memory than the card
    gives one (before any launch), windows or periods the kernel does not
    take (the launch's cudaErrorInvalidValue), and a cluster launch the
    card refuses (its CUDA error). `clocks`, a zeroed contiguous int64
    [N, C, R, len(CLOCK_NAMES)] tensor (R = `windowed_cluster()`), receives
    each thread block's clock64() split; the path never passes it."""
    dev = raw_re.device
    if dev.type != "cuda":
        raise ValueError(f"windowed_correlate_cuda needs a CUDA tensor, "
                         f"got {dev}")
    if raw_re.dim() != 2 or raw_re.shape != raw_im.shape \
            or raw_im.device != dev:
        raise ValueError(f"raw_re/raw_im: need two [N, S] tensors on {dev}, "
                         f"got {list(raw_re.shape)}, {list(raw_im.shape)}")
    n, s = (int(x) for x in raw_re.shape)
    c = int(chips.shape[0])
    if s != n_periods * period:
        raise ValueError(f"S={s} is not n_periods x period = "
                         f"{n_periods} x {period}")
    i16 = _pairs(raw_re, raw_im)
    if not i16 and not (raw_re.dtype == raw_im.dtype == torch.float32
                        and raw_re.stride() == raw_im.stride()):
        raise ValueError(f"raw_re/raw_im: need the I and Q views of one "
                         f"int16 [N, S, 2] tensor or float32 of equal "
                         f"strides, got {raw_re.dtype} {raw_re.stride()} and "
                         f"{raw_im.dtype} {raw_im.stride()}")
    _f32(chips, dev, (c, int(L_CA)), "chips")
    _f32(time_idc, dev, (s,), "time_idc")
    if chips.stride(1) != 1 or time_idc.stride(0) != 1:
        raise ValueError("chips rows and time_idc must be contiguous")
    lib = _lib()
    need = lib.windowed_shared_bytes(int(period))
    limit = lib.windowed_shared_limit()
    if need > limit:
        raise ValueError(f"period {period} x {n_periods}: a K5 thread block "
                         f"would need {need} bytes of shared memory, the "
                         f"card gives one {limit} (periods up to 27 508 "
                         f"samples)")
    if carr_fftpts < 2 or carr_fftpts >= 1 << 32 \
            or carr_fftpts & (carr_fftpts - 1):
        raise ValueError(f"carr_fftpts={carr_fftpts}: the kernel takes a "
                         f"power of two below 2^32 (the DFT phases are "
                         f"masks)")
    shape = (n, c)
    clk_shape = (n, c, lib.windowed_cluster(), len(CLOCK_NAMES))
    if clocks is not None and (
            clocks.device != dev or clocks.dtype != torch.int64
            or tuple(clocks.shape) != clk_shape
            or not clocks.is_contiguous()):
        raise ValueError(f"clocks: need contiguous int64 {list(clk_shape)} "
                         f"on {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    code = [torch.empty((n, c, code_win), **f32)
            for _ in range(2 if complex_out else 1)]
    carr = [torch.empty((n, c, carr_win), **f32)
            for _ in range(2 if complex_out else 1)]
    flip = torch.empty(shape, dtype=torch.bool, device=dev)
    args = _CorrArgs(
        raw_re.data_ptr(), raw_im.data_ptr(), raw_re.stride(0),
        raw_re.stride(1), int(i16), n, c, s, int(period), int(n_periods),
        int(code_win), int(carr_win), int(complex_out), int(carr_fftpts),
        chips.data_ptr(), chips.stride(0), time_idc.data_ptr(),
        _base0_on(int(period), dev).data_ptr(),
        _fparam(rc_mid, dev, shape, "rc_mid"), _fparam(fi, dev, shape, "fi"),
        _fparam(ri, dev, shape, "ri"),
        _fparam(idx_next, dev, shape, "idx_next"),
        _fparam(pos_start, dev, shape, "pos_start"),
        _fparam(vel_start, dev, shape, "vel_start"),
        code[0].data_ptr(), code[-1].data_ptr(), carr[0].data_ptr(),
        carr[-1].data_ptr(), flip.data_ptr(),
        None if clocks is None else clocks.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.windowed_correlate_launch(ctypes.byref(args), stream)
    if rc != 0:
        msg = lib.windowed_error_string(rc).decode()
        raise RuntimeError(f"windowed_correlate kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    _build.count_launch("windowed_correlate")
    if complex_out:
        return RealBlockOutC(code[0], code[1], carr[0], carr[1], flip)
    return RealBlockOut(code[0], carr[0], flip)
