"""Real-arithmetic windowed DPE engine on torch tensors.

Port of navlab_dpe_sdr_tpu/ops/dpe_real.py: the windowed code correlation
(per-code-period folds, the nav-bit tail fold and its exact boundary arc,
lag windows) and the windowed carrier DFT, then manifold scoring with a
streaming argmax (ops/score.py), batched over N blocks in one call, per
block (`dpe_batch_blocks`) or integrated over the batch
(`dpe_scan_integrate`), and the multi-epoch joint argmax of the survey
solve (`score_joint_argmax`).

Differences from the JAX module, all in form, not in result:
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
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import L_CA

from .dpe import CARR_WIN, CODE_WIN, ManifoldParams
from .score import INTERP_MODES, score_argmax, score_surface_argmax

torch.backends.cuda.matmul.allow_tf32 = False

_SLIVER = 128  # samples around the nav-bit boundary handled exactly
# the boundary-arc flip correction is exact only for window lags
# |m| <= _SLIVER/2; receivers must keep code_win within this span
SLIVER_LIMIT = _SLIVER
_TWO_PI = float(np.float32(2.0 * np.pi))


@functools.lru_cache(maxsize=4)
def _chip_index_consts(period: int):
    """floor/frac of the nominal per-sample chip index k * L_CA / period,
    formed in float32 exactly as the JAX `_chip_lookup_consts` forms them.
    Returns numpy (floor_base [P0] int64, frac_base [P0] float32)."""
    l_ca = int(L_CA)
    base0 = (np.arange(period) * float(l_ca) / period).astype(np.float32)
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

    raw_re/raw_im [N, S] f32; chips [C, 1023] f32; rc_mid/fi/ri [N, C] f32;
    idx_next/pos_start/vel_start [N, C] int (idx_next = S for no flip);
    time_idc [S] f32, uniform (t0 + s*dt). Returns RealBlockOut, or
    RealBlockOutC with complex_out. Same algebra as the JAX
    `windowed_correlate` (ops/dpe_real.py:420): carrier phase A(p) + B(tau)
    per code period, folds as [4C, P] x [P, P0] products, exact
    boundary-period and boundary-arc terms, flip decision at lag 0."""
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
    s0_n = 256
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


def score_manifolds_mag(code_mag, carr_mag, params: ManifoldParams, d_enu,
                        dt_m, dv_enu, dtdot, l_power: int = 1,
                        interp: str = "quadratic"):
    """(pos_scores [G], pos_arg, vel_scores [G], vel_arg) of one block's
    magnitude windows code_mag/carr_mag [C, W] (the JAX
    `score_manifolds_mag`): each surface and its first-occurrence argmax
    from one `score_surface_argmax` call (K2)."""
    los = params.los_enu[None]
    pos, _, pos_arg = score_surface_argmax(
        code_mag[None], los, params.pos_center[None], params.pos_coef[None],
        params.r0[None], d_enu, dt_m, interp=interp, l_power=l_power)
    vel, _, vel_arg = score_surface_argmax(
        carr_mag[None], los, params.vel_center[None], params.vel_coef[None],
        None, dv_enu, dtdot, interp=interp, l_power=l_power)
    return pos[0], pos_arg[0], vel[0], vel_arg[0]


def dpe_device_step_real(raw_re, raw_im, chips, rc_mid, idx_next, fi, ri,
                         time_idc, pos_start, vel_start,
                         params: ManifoldParams, d_enu, dt_m, dv_enu, dtdot,
                         carr_fftpts: int, period: int, n_periods: int,
                         l_power: int = 1, interp: str = "quadratic",
                         code_win: int = CODE_WIN, carr_win: int = CARR_WIN):
    """One block's fused DPE step (the JAX `dpe_device_step_real`):
    `windowed_correlate` at N = 1, then both score surfaces.

    raw_re/raw_im [S] f32; rc_mid/fi/ri [C] f32; idx_next/pos_start/
    vel_start [C] int. Returns (pos_scores [G], pos_arg, vel_scores [G],
    vel_arg, flip_used [C], code_mag [C, code_win], carr_mag [C, carr_win]).
    """
    out = windowed_correlate(
        raw_re[None], raw_im[None], chips, rc_mid[None], idx_next[None],
        fi[None], ri[None], time_idc, pos_start[None], vel_start[None],
        carr_fftpts, period, n_periods, code_win=code_win, carr_win=carr_win)
    code_mag, carr_mag = out.code_mag[0], out.carr_mag[0]
    pos, pos_arg, vel, vel_arg = score_manifolds_mag(
        code_mag, carr_mag, params, d_enu, dt_m, dv_enu, dtdot,
        l_power=l_power, interp=interp)
    return (pos, pos_arg, vel, vel_arg, out.flip_used[0], code_mag,
            carr_mag)


# ---------------------------------------------------------------------------
# Batched multi-block dispatch (deferred feedback)
# ---------------------------------------------------------------------------

FPK_ROWS = 11  # rc_mid, fi, ri, los_e, los_n, los_u, r0, pos_c, pos_k, vel_c, vel_k
IPK_ROWS = 3   # idx_next, pos_start, vel_start
START_ROW = FPK_ROWS + IPK_ROWS
PK_ROWS = START_ROW + 1  # + start row: ONE upload per batch.
# The int rows ride as float32 (all values < 2^24, exact).


def pack_params(fpk, ipk, start: int) -> np.ndarray:
    """[N,11,C] f64/f32 + [N,3,C] int + scalar start -> [N, 15, C] f32."""
    n, _, c = fpk.shape
    pk = np.empty((n, PK_ROWS, c), np.float32)
    pk[:, :FPK_ROWS] = fpk
    pk[:, FPK_ROWS:START_ROW] = ipk
    pk[:, START_ROW] = np.float32(start)
    return pk


def unpack_params(pk):
    """pk [N, 15, C] f32 tensor -> (fpk [N,11,C] f32, ipk [N,3,C] int64).
    The start row is read on the host, from the packed numpy array, so
    slicing the capture never waits on the device."""
    return pk[:, :FPK_ROWS], pk[:, FPK_ROWS:START_ROW].long()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`; to a CUDA device as an
    asynchronous copy from pinned memory on the current stream."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:   # a memmap window of a capture file
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def batch_correlate(raw_all_i16, start: int, fpk, ipk, chips, time_idc,
                    carr_fftpts: int, period: int, n_periods: int,
                    n_blocks: int, code_win: int = CODE_WIN,
                    carr_win: int = CARR_WIN, complex_out: bool = False):
    """Slice n_blocks from the device capture [B, S, 2] and correlate them
    (JAX `_batch_correlate` without a mesh)."""
    if start < 0 or start + n_blocks > raw_all_i16.shape[0]:
        raise ValueError(f"capture holds {raw_all_i16.shape[0]} blocks; "
                         f"requested {start}..{start + n_blocks}")
    raw = raw_all_i16[start:start + n_blocks]               # [N, S, 2]
    return windowed_correlate(
        raw[..., 0].float(), raw[..., 1].float(), chips, fpk[:, 0],
        ipk[:, 0], fpk[:, 1], fpk[:, 2], time_idc, ipk[:, 1], ipk[:, 2],
        carr_fftpts, period, n_periods, code_win=code_win,
        carr_win=carr_win, complex_out=complex_out)


def coherent_sum(outc: RealBlockOutC) -> RealBlockOut:
    """Coherent sum over each group's K blocks with data-aided nav-bit
    alignment (JAX `_coherent_sum`, ops/dpe_real.py:1327).

    Fields of outc are [G, K, C, W] ([G, K, C] for flip_used). Each block
    is aligned against the RUNNING sum by the sign of the central taps'
    dot product (first block: +1). Returns magnitudes [G, C, W] and the
    group's last-block flips [G, C]."""
    mc = outc.code_re.shape[-1] // 2
    mv = outc.carr_re.shape[-1] // 2
    sl_c = slice(mc - 1, mc + 2)
    sl_v = slice(mv - 1, mv + 2)
    a_cre = torch.zeros_like(outc.code_re[:, 0])
    a_cim = torch.zeros_like(a_cre)
    a_vre = torch.zeros_like(outc.carr_re[:, 0])
    a_vim = torch.zeros_like(a_vre)
    for k in range(outc.code_re.shape[1]):
        cre, cim = outc.code_re[:, k], outc.code_im[:, k]
        vre, vim = outc.carr_re[:, k], outc.carr_im[:, k]
        dot = ((cre[..., sl_c] * a_cre[..., sl_c]
                + cim[..., sl_c] * a_cim[..., sl_c]).sum(-1)
               + (vre[..., sl_v] * a_vre[..., sl_v]
                  + vim[..., sl_v] * a_vim[..., sl_v]).sum(-1))   # [G, C]
        sgn = torch.where(dot >= 0.0, 1.0, -1.0)[..., None]
        a_cre = a_cre + sgn * cre
        a_cim = a_cim + sgn * cim
        a_vre = a_vre + sgn * vre
        a_vim = a_vim + sgn * vim
    return RealBlockOut(code_mag=torch.sqrt(a_cre ** 2 + a_cim ** 2),
                        carr_mag=torch.sqrt(a_vre ** 2 + a_vim ** 2),
                        flip_used=outc.flip_used[:, -1])


WMEAN_COLS = 8  # pos weighted-mean offsets [4] + vel weighted-mean [4]


def weighted_cols(pres, vres):
    """[..., 8] score-weighted-mean offsets sum(w*offset)/sum(w) per
    manifold from (best, arg, wsum4, wtot) results."""
    pmean = pres[2] / pres[3][..., None].clamp_min(1e-30)
    vmean = vres[2] / vres[3][..., None].clamp_min(1e-30)
    return torch.cat([pmean, vmean], dim=-1)


def pack_rows(out: RealBlockOut, pa, pb, va, vb, return_windows: bool,
              wmean=None):
    """One float32 row per block so the host needs a single fetch.

    Argmax indices are BITCAST into the f32 lanes (`unpack_row_indices` on
    the host): float32 holds integers exactly only to 2^24.
    Layout: [head 4][flips C][wmean 8, only when weighted][windows]."""
    n = pa.shape[0]
    head = torch.stack([pa.to(torch.int32).view(torch.float32), pb,
                        va.to(torch.int32).view(torch.float32), vb], dim=1)
    parts = [head, out.flip_used.float()]
    if wmean is not None:
        parts.append(wmean)
    if return_windows:
        parts += [out.code_mag.reshape(n, -1), out.carr_mag.reshape(n, -1)]
    return torch.cat(parts, dim=1)


def unpack_row_indices(rows: np.ndarray) -> tuple:
    """Host-side decode of the bitcast argmax indices in packed rows:
    (pos_idx [N] int, vel_idx [N] int)."""
    r = np.ascontiguousarray(rows[:, 0], dtype=np.float32)
    pas = r.view(np.int32).astype(np.int64)
    r = np.ascontiguousarray(rows[:, 2], dtype=np.float32)
    vas = r.view(np.int32).astype(np.int64)
    return pas, vas


def dpe_batch_blocks(raw_all_i16, pk: np.ndarray, chips, time_idc,
                     d_enu, dt_m, dv_enu, dtdot, carr_fftpts: int,
                     period: int, n_periods: int, n_blocks: int,
                     l_power: int = 1, interp: str = "quadratic",
                     return_windows: bool = True,
                     code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                     group_k: int = 1, use_argmax: bool = True):
    """Block-batched fused DPE (JAX `dpe_batch_blocks` without a mesh).

    raw_all_i16: device-resident int16 capture [B, S, 2]; pk: host packed
    parameters [N, 15, C] (pack_params), uploaded here in one copy; chips,
    time_idc and the grid tensors live on the capture's device. Correlates
    all n_blocks, optionally sums each group of group_k blocks coherently
    (one row per group, referenced to its last block), scores both
    manifolds (two `score_argmax` calls) and returns one packed f32 row
    per block or group (pack_rows)."""
    if group_k > 1 and n_blocks % group_k:
        raise ValueError(f"n_blocks {n_blocks} % group_k {group_k} != 0")
    start = int(pk[0, START_ROW, 0])
    fpk, ipk = unpack_params(to_device(pk, raw_all_i16.device))
    corr = functools.partial(
        batch_correlate, raw_all_i16, start, fpk, ipk, chips, time_idc,
        carr_fftpts, period, n_periods, n_blocks, code_win, carr_win)
    if group_k > 1:
        g = n_blocks // group_k
        outc = corr(complex_out=True)
        out = coherent_sum(RealBlockOutC(
            *(x.reshape((g, group_k) + x.shape[1:]) for x in outc)))
        fpk = fpk[group_k - 1::group_k]                     # [G, 11, C]
    else:
        out = corr()
    los_enu = fpk[:, 3:6].transpose(1, 2)                   # [N, C, 3]
    weighted = not use_argmax
    pres = score_argmax(out.code_mag, los_enu, fpk[:, 7], fpk[:, 8],
                        fpk[:, 6], d_enu, dt_m, interp=interp,
                        l_power=l_power, weighted=weighted)
    vres = score_argmax(out.carr_mag, los_enu, fpk[:, 9], fpk[:, 10],
                        None, dv_enu, dtdot, interp=interp,
                        l_power=l_power, weighted=weighted)
    wmean = weighted_cols(pres, vres) if weighted else None
    return pack_rows(out, pres[1], pres[0], vres[1], vres[0],
                     return_windows, wmean=wmean)


def dpe_scan_integrate(raw_all_i16, pk: np.ndarray, chips, time_idc,
                       d_enu, dt_m, dv_enu, dtdot, carr_fftpts: int,
                       period: int, n_periods: int, n_blocks: int,
                       l_power: int = 1, interp: str = "quadratic",
                       code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                       coherent: bool = False, return_windows: bool = False,
                       use_argmax: bool = True):
    """Multi-block score integration in one dispatch (JAX
    `dpe_scan_integrate` without a mesh): one argmax per batch of n_blocks.

    Noncoherent: the score surfaces of all blocks are summed per grid point
    inside the scorer (`score_argmax(block_sum=True)`; no [N, G] surface
    exists). Coherent: the complex windows are summed over the batch with
    data-aided nav-bit alignment (`coherent_sum`) and scored once, with the
    last block's geometry. Returns (head, flips [N, C] bool[, code_mag
    [C, Wc], carr_mag [C, Wv]]): head [4] f32 is (pos argmax bitcast, pos
    peak, vel argmax bitcast, vel peak), 12 long with the weighted-mean
    offsets of the integrated surfaces when use_argmax is False; with
    return_windows the windows summed over the batch."""
    start = int(pk[0, START_ROW, 0])
    fpk, ipk = unpack_params(to_device(pk, raw_all_i16.device))
    out = batch_correlate(raw_all_i16, start, fpk, ipk, chips, time_idc,
                          carr_fftpts, period, n_periods, n_blocks, code_win,
                          carr_win, complex_out=coherent)
    flips = out.flip_used
    if coherent:
        out = coherent_sum(RealBlockOutC(*(x[None] for x in out)))
        fpk = fpk[-1:]
    los_enu = fpk[:, 3:6].transpose(1, 2)
    weighted = not use_argmax
    pres = score_argmax(out.code_mag, los_enu, fpk[:, 7], fpk[:, 8],
                        fpk[:, 6], d_enu, dt_m, interp=interp,
                        l_power=l_power, weighted=weighted, block_sum=True)
    vres = score_argmax(out.carr_mag, los_enu, fpk[:, 9], fpk[:, 10], None,
                        dv_enu, dtdot, interp=interp, l_power=l_power,
                        weighted=weighted, block_sum=True)
    # the indices are bitcast, never value-converted: a dense manifold has
    # more points than float32 counts exactly
    head = torch.stack([pres[1].view(torch.float32), pres[0],
                        vres[1].view(torch.float32), vres[0]])
    if weighted:
        head = torch.cat([head, weighted_cols(pres, vres)])
    if return_windows:
        return head, flips, out.code_mag.sum(dim=0), out.carr_mag.sum(dim=0)
    return head, flips


def score_joint_argmax(win_mag, los_enu, centers, coefs, r0, off3, off1,
                       interp: str = "quadratic", l_power: int = 1,
                       has_r0: bool = True):
    """Multi-epoch joint (max, argmax): one candidate state scored against
    many epochs' integrated windows, each with its own geometry (JAX
    `score_joint_argmax` without a mesh). The epoch axis is the scorer's
    block axis: win_mag [B, C, W], los_enu [B, C, 3], centers/coefs/r0
    [B, C]; off3 [G, 3], off1 [G] are displacements from one common
    reference state. Returns scalars (best f32, arg int32)."""
    return score_argmax(win_mag, los_enu, centers, coefs,
                        r0 if has_r0 else None, off3, off1, interp=interp,
                        l_power=l_power, block_sum=True)
