"""The plain reference of the scalar tracker at 1 ms updates (PyTorch,
float32): one closed-loop DLL/PLL step a code period, over a chunk.

A frozen copy of navlab_dpe_sdr_tpu_torch/ops/tracking.py's plain tracker
(`track_chunk_plain` at coh_ms = 1 and what it calls) and of
ops/track.py's plain correlator, which the port's K4 kernel is held to bit
for bit on the card: the correlation sums run in the 1 ms kernel's order
(`_kernel_order_sum` over KERNEL_THREADS lanes). `round_sums` makes the
control: each window's correlation sums rounded to bfloat16, the precision
below the float32 that the configuration states. Nothing here imports the
program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..frozen.constants import F_CA, L_CA

T_MS = 1e-3
SNR_N = 20
LOCK_K = 1.5
LOCK_LPF = 0.0247
LOCK_LOSS_TH = 50
LOCK_LOCK_TH = 240
BN_CODE_DEFAULT = 3.0
BN_CARR_DEFAULT = 40.0
TWO_PI = float(np.float32(2.0 * np.pi))
F_CA32 = float(np.float32(F_CA))
L_CA32 = float(np.float32(L_CA))
KERNEL_THREADS = 1280     # the 1 ms kernel's correlating threads a channel
FLOAT_FIELDS = ("rc", "dfc", "ri", "fi", "dfc_bias", "fi_bias", "p_a_re",
                "p_a_im", "lf_code_h", "lf_carr_h", "lf_code_h2",
                "lf_carr_h2", "lock_i", "lock_q", "prev_p_re", "prev_p_im")
INT_FIELDS = ("cp", "losscount", "lockcount", "lock", "snr_fill")


class LoopConfig(NamedTuple):
    """Loop-filter configuration (same fields and defaults as the JAX
    LoopConfig; critically damped constants, reference loopfilter.py)."""
    order: int = 2            # 2 or 3
    bn_code: float = BN_CODE_DEFAULT
    bn_carr: float = BN_CARR_DEFAULT
    bn_carr_freq: float = 0.0  # FLL-assist bandwidth
    boxcar: bool = False       # boxcar instead of bilinear integrators


def _loop_coeffs(order: int, bn: float, bn_f: float):
    """(Kap, Kvp, Kpp, Kaf, Kvf) for one loop in float64 (the JAX
    `_loop_coeffs`); callers cast them to f32."""
    if order == 2:
        w0p = bn / 0.53
        w0f = bn_f / 0.25
        return 0.0, w0p ** 2, 1.414 * w0p, 0.0, w0f
    if order == 3:
        w0p = bn / 0.7845
        w0f = bn_f / 0.53
        return w0p ** 3, 1.1 * w0p ** 2, 2.4 * w0p, w0f ** 2, 1.414 * w0f
    raise ValueError(f"unsupported loop-filter order {order}")


class TrackState(NamedTuple):
    """Per-channel tracking carry (tensors shaped [C]; rings [C, SNR_N])."""
    rc: torch.Tensor        # code phase [chips]
    dfc: torch.Tensor       # fc - F_CA [chips/s]
    ri: torch.Tensor        # carrier phase [cycles]
    fi: torch.Tensor        # carrier Doppler [Hz]
    dfc_bias: torch.Tensor  # loop-filter operating points
    fi_bias: torch.Tensor
    cp: torch.Tensor        # completed code periods (int32)
    p_a_re: torch.Tensor    # carried partial prompt correlation
    p_a_im: torch.Tensor
    lf_code_h: torch.Tensor
    lf_carr_h: torch.Tensor
    lf_code_h2: torch.Tensor
    lf_carr_h2: torch.Tensor
    lock_i: torch.Tensor
    lock_q: torch.Tensor
    losscount: torch.Tensor
    lockcount: torch.Tensor
    lock: torch.Tensor
    snr_z: torch.Tensor     # [C, SNR_N] power ring, oldest first
    snr_v: torch.Tensor     # [C, SNR_N] variance ring
    snr_fill: torch.Tensor
    prev_p_re: torch.Tensor
    prev_p_im: torch.Tensor


# ---------------------------------------------------------------------------
# The closed-loop tail of one step (plain PyTorch; in the kernel:
# polarity_combine, carrier_step, code_step, advance, monitor_and_log)
# ---------------------------------------------------------------------------

def _div(x, c: float):
    """x / c as a true f32 division on every device (a CUDA tensor divided
    by a Python scalar is multiplied by its reciprocal instead)."""
    return x / torch.full_like(x, c)


def _ring_sum(ring):
    """Sum of a [C, SNR_N] ring, oldest to newest (the kernel's order)."""
    tot = ring[:, 0]
    for i in range(1, ring.shape[1]):
        tot = tot + ring[:, i]
    return tot


def _polarity_combine(state: TrackState, e_s, p_s, l_s, ncp, m: int = 1):
    """Receiver-synchronous combination with nav-bit polarity resolution
    (the JAX `_polarity_combine`). Segment sums are [C, m + 2, 2]; signs
    [C, m + 1]. m = 1 is the reference's 3-segment decision tree; m > 1 the
    flip-location hypothesis test (argmax over the m + 2 single-flip
    hypotheses of the combined window energy, first index on a tie)."""
    sums = e_s + p_s + l_s
    n_seg = int(m) + 2

    def mag2(x):
        return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]

    one = torch.ones_like(state.rc)
    if m == 1:
        flip01 = mag2(sums[:, 0] + sums[:, 1]) < mag2(sums[:, 0] - sums[:, 1])
        flip12 = mag2(sums[:, 1] + sums[:, 2]) < mag2(sums[:, 1] - sums[:, 2])
        g1 = torch.where(flip01, -one, one)
        g2 = torch.where(flip01, -one, torch.where(flip12, -one, one))
        g = [one, g1, g2]
    else:
        # hypothesis j: segments k >= j flipped (j = 0: no flip); the
        # combined sum under j >= 1 is 2 cum_{j-1} - tot. Sums in segment
        # order, as the kernel adds them.
        tot = sums[:, 0]
        for k in range(1, n_seg):
            tot = tot + sums[:, k]
        best = mag2(tot)
        jstar = torch.zeros_like(state.cp)
        cum = sums[:, 0]
        for j in range(1, n_seg):
            cand = mag2(2.0 * cum - tot)
            better = cand > best
            jstar = torch.where(better, torch.full_like(jstar, j), jstar)
            best = torch.where(better, cand, best)
            cum = cum + sums[:, j]
        g = [one] + [torch.where((jstar == 0) | (k < jstar), one, -one)
                     for k in range(1, n_seg)]

    def comb(x):
        acc = x[:, 0]
        for k in range(1, n_seg):
            acc = acc + g[k][:, None] * x[:, k]
        return acc

    e_r, p_r, l_r = comb(e_s), comb(p_s), comb(l_s)
    signs = torch.stack([-torch.sign(state.p_a_re + p_s[:, 0, 0])]
                        + [-torch.sign(p_s[:, k, 0])
                           for k in range(1, n_seg - 1)], dim=1)

    def pick(part):
        carry = state.p_a_re if part == 0 else state.p_a_im
        zero = torch.zeros_like(carry)
        acc = torch.where(ncp == 0, carry + p_s[:, 0, part], zero)
        for k in range(1, n_seg):
            acc = acc + torch.where(ncp == k, p_s[:, k, part], zero)
        return acc

    return e_r, p_r, l_r, signs, pick(0), pick(1)


def _lock_consts(m: int):
    """(lpf, loss_th, lock_th) of an m ms update: the detector's time
    constants of the 1 ms design. lpf is formed in float64; the thresholds
    round half to even (Python's round), as in the JAX package."""
    return (1.0 - (1.0 - LOCK_LPF) ** m, max(1, round(LOCK_LOSS_TH / m)),
            max(1, round(LOCK_LOCK_TH / m)))


def _lock_snr_update(state: TrackState, p_r, m: int = 1):
    """Kaplan-Hegarty lock detector + variance-summing C/N0 meter (the JAX
    `_lock_snr_update(m)`: LPF and thresholds rescaled to the m ms update,
    predetection time m T_MS)."""
    ip, qp = p_r[:, 0], p_r[:, 1]
    lpf, loss_th, lock_th = _lock_consts(m)
    li = lpf * torch.abs(ip) + (1 - lpf) * state.lock_i
    lq = lpf * torch.abs(qp) + (1 - lpf) * state.lock_q
    in_lock = _div(li, LOCK_K) > lq
    zero = torch.zeros_like(state.losscount)
    losscount = torch.where(in_lock, zero, state.losscount + 1)
    lockcount = torch.where(in_lock, state.lockcount + 1, zero)
    lock = torch.where(in_lock & (state.lockcount > lock_th),
                       torch.ones_like(state.lock),
                       torch.where(~in_lock & (state.losscount > loss_th),
                                   torch.zeros_like(state.lock), state.lock))
    lockval = _div(li, LOCK_K) - lq

    z = ip * ip + qp * qp
    snr_z = torch.cat([state.snr_z[:, 1:], z[:, None]], dim=1)
    z_mean = _div(_ring_sum(snr_z), float(SNR_N))
    v = (z - z_mean) * (z - z_mean)
    snr_v = torch.cat([state.snr_v[:, 1:], v[:, None]], dim=1)
    z_var = _div(_ring_sum(snr_v), float(SNR_N))
    carrier = torch.sqrt(torch.clamp_min(z_mean * z_mean - z_var, 0.0))
    noise_var = torch.clamp_min(_div(z_mean - carrier, 2.0), 1e-12)
    logarg = torch.clamp_min(
        carrier / (float(np.float32(2.0 * (SNR_N * m * T_MS))) * noise_var),
        1.0)
    snr = 10.0 * torch.log10(logarg)

    new = state._replace(lock_i=li, lock_q=lq, losscount=losscount,
                         lockcount=lockcount, lock=lock, snr_z=snr_z,
                         snr_v=snr_v, snr_fill=state.snr_fill + 1)
    return new, lock, lockval, snr


def _lf_step(h, h2, xp, xf, coeffs, boxcar: bool, t_s: float = T_MS):
    """One loop-filter update (the JAX `_lf_step`) with integrator gain t_s,
    the update period m T_MS."""
    kap, kvp, kpp, kaf, kvf = (float(np.float32(c)) for c in coeffs)
    t = float(np.float32(t_s))

    def integ(acc, x):
        acc_new = acc + t * x
        return acc_new, (acc_new if boxcar else (acc_new + acc) * 0.5)

    if kap == 0.0 and kaf == 0.0:      # pure 2nd order: h2 unused
        acc_out = 0.0
        h2_new = h2
    else:
        h2_new, acc_out = integ(h2, kap * xp + kaf * xf)
    h_new, vel_out = integ(h, acc_out + kvp * xp + kvf * xf)
    return h_new, h2_new, vel_out + kpp * xp


def _loops_update(state: TrackState, e_r, p_r, l_r, fcaid: float,
                  loops: LoopConfig, m: int = 1):
    """DLL/PLL discriminators -> loop filters -> new fc/fi (the JAX
    `_loops_update(m)`: filter gain m T_MS, FLL normalised by
    2 pi m T_MS)."""
    ip, qp = p_r[:, 0], p_r[:, 1]
    zero = torch.zeros_like(ip)
    dpi = torch.where(ip != 0.0,
                      _div(torch.atan(qp / torch.where(ip == 0, 1.0, ip)),
                           TWO_PI), zero)
    e_env = torch.sqrt(e_r[:, 0] * e_r[:, 0] + e_r[:, 1] * e_r[:, 1])
    l_env = torch.sqrt(l_r[:, 0] * l_r[:, 0] + l_r[:, 1] * l_r[:, 1])
    denom = e_env + l_env
    dpc = torch.where(denom != 0.0,
                      (e_env - l_env) / (2.0 * torch.clamp_min(denom, 1e-30)),
                      zero)
    if loops.bn_carr_freq > 0.0:
        cross = state.prev_p_re * qp - ip * state.prev_p_im
        dot = state.prev_p_re * ip + state.prev_p_im * qp
        sgn = torch.where(dot < 0.0, -torch.ones_like(dot),
                          torch.ones_like(dot))
        xf = _div(torch.atan2(sgn * cross, sgn * dot),
                  float(np.float32(2.0 * np.pi * m * T_MS)))
    else:
        xf = zero
    t_s = m * T_MS
    lf_carr_h, lf_carr_h2, di = _lf_step(
        state.lf_carr_h, state.lf_carr_h2, dpi, xf,
        _loop_coeffs(loops.order, loops.bn_carr, loops.bn_carr_freq),
        loops.boxcar, t_s)
    lf_code_h, lf_code_h2, dc = _lf_step(
        state.lf_code_h, state.lf_code_h2, dpc, zero,
        _loop_coeffs(loops.order, loops.bn_code, 0.0), loops.boxcar, t_s)

    fi_new = state.fi_bias + di
    dfc_new = (state.dfc_bias + dc
               + float(np.float32(fcaid)) * (state.fi_bias + di))
    return state._replace(fi=fi_new, dfc=dfc_new, lf_carr_h=lf_carr_h,
                          lf_code_h=lf_code_h, lf_carr_h2=lf_carr_h2,
                          lf_code_h2=lf_code_h2,
                          prev_p_re=ip, prev_p_im=qp), dpc, dpi


@functools.lru_cache(maxsize=8)
def window_times(s: int, fs: float, device) -> torch.Tensor:
    """[S] f32 sample times k/fs, formed in float64 and rounded once
    (ops/tracking.py:695 as written; compiled by XLA inside the scan it
    becomes f32(k) * f32(1/fs), one ulp off in ~15 % of the samples).
    Cached per (S, fs, device): callers only read it."""
    return torch.from_numpy((np.arange(s) / fs).astype(np.float32)).to(device)


def correlate_window_plain(raw_re, raw_im, rc, dfc, ri, fi, code_table,
                           time_idc, fs: float, m: int = 1,
                           lanes: int = KERNEL_THREADS):
    """Plain PyTorch K3: sums [C, 3 tap (E, P, L), m + 2 seg, 2 (re, im)]
    f32 and ncp [C] int32 of one window of m code periods raw_re/raw_im
    [S] f32, per-channel rc/dfc/ri/fi [C] f32, code_table [C, 1023] f32,
    time_idc [S] f32.

    The f32 operations are those of the JAX `_correlate_step(m)` (gather
    replicas at the mid-window phase rc + dfc m/2 ms, the m + 1 segment
    boundaries k L_CA at the true fc), and those of the kernels in the
    kernels' order, sums included: the 1 ms kernels' (`_kernel_order_sum`
    over `lanes`: KERNEL_THREADS, or WINDOWS_LANES for K3's windows mode)
    (the m = 1 kernel's thread count)."""
    c = code_table.shape[0]
    s = raw_re.shape[0]
    n_seg = int(m) + 2
    ang = TWO_PI * (fi[:, None] * time_idc[None, :] + ri[:, None])
    wc, ws = torch.cos(ang), torch.sin(ang)
    bb_re = raw_re[None, :] * wc + raw_im[None, :] * ws
    bb_im = raw_im[None, :] * wc - raw_re[None, :] * ws

    base = time_idc * F_CA32
    rc_mid = rc + dfc * float(np.float32(m * 0.5e-3))
    taps = []
    for phase in (rc_mid + 0.5, rc_mid, rc_mid - 0.5):
        idx = torch.remainder(torch.floor(base[None, :] + phase[:, None]),
                              L_CA32).long()
        taps.append(torch.gather(code_table, 1, idx))
    repl = torch.stack(taps, dim=2)                         # [C, S, 3]

    fc = F_CA32 + dfc
    ratio = torch.full_like(fc, float(np.float32(fs))) / fc
    cols = torch.arange(s, dtype=torch.float32, device=raw_re.device)
    seg = torch.zeros((c, s), dtype=torch.long, device=raw_re.device)
    for k in range(1, n_seg):
        bk = (float(np.float32(k * L_CA)) - rc) * ratio
        seg = seg + (cols[None, :] >= bk[:, None]).long()
    segm = (seg[:, :, None]
            == torch.arange(n_seg, device=raw_re.device)).float()
    w = (repl[:, :, :, None] * segm[:, :, None, :]).reshape(c, s, 3 * n_seg)
    bb = torch.stack([bb_re, bb_im], dim=1)                 # [C, 2, S]
    prod = bb[:, :, None, :] * w.transpose(1, 2)[:, None]   # [C, 2, 3n, S]
    total = _kernel_order_sum(prod, lanes)
    sums = total.reshape(c, 2, 3, n_seg).permute(0, 2, 3, 1)
    ncp = torch.floor((float(np.float32(s / fs)) * fc + rc)
                      * float(np.float32(1.0 / L_CA))).to(torch.int32)
    return sums.contiguous(), ncp


def _kernel_order_sum(prod, lanes: int = KERNEL_THREADS):
    """Sum over the last axis in the kernel's order: each of `lanes`
    threads adds every lanes-th term in turn, a warp-shuffle tree reduces
    each warp, then the warps are added in turn. The products are exact
    (chips are +/-1, segments 0/1), so the sums, and the closed loop they
    drive, match the kernel's bit for bit where the elementwise functions
    do."""
    s = prod.shape[-1]
    pad = (-s) % lanes
    p = torch.nn.functional.pad(prod, (0, pad))
    p = p.reshape(p.shape[:-1] + (-1, lanes))
    acc = p[..., 0, :]
    for r in range(1, p.shape[-2]):
        acc = acc + p[..., r, :]
    acc = acc.reshape(acc.shape[:-1] + (lanes // 32, 32))
    for half in (16, 8, 4, 2, 1):
        acc = acc[..., :half] + acc[..., half:2 * half]
    acc = acc[..., 0]
    tot = acc[..., 0]
    for wi in range(1, acc.shape[-1]):
        tot = tot + acc[..., wi]
    return tot


def _log_rows(e_r, p_r, l_r, rc, ri, dfc, fi, lockval, snr, dpc, dpi, signs,
              cp, ncp, lock):
    """One packed log row: floats [15 + m, C], ints [3, C]."""
    logf = torch.cat([torch.stack([
        e_r[:, 0], e_r[:, 1], p_r[:, 0], p_r[:, 1], l_r[:, 0], l_r[:, 1],
        rc, ri, F_CA32 + dfc, fi, lockval, snr, dpc, dpi]), signs.T])
    return logf, torch.stack([cp, ncp, lock.to(torch.int32)])


def _step_plain(st: TrackState, raw_re, raw_im, code_table, time_idc,
                fs: float, fcaid: float, loops: LoopConfig, m: int = 1,
                round_sums=None):
    """One closed-loop update over an m-period window (the scan body,
    ops/tracking.py:698-724): returns (state', log floats [15 + m, C], log
    ints [3, C])."""
    sums, ncp = correlate_window_plain(
        raw_re, raw_im, st.rc, st.dfc, st.ri, st.fi, code_table, time_idc, fs,
        m)
    if round_sums is not None:          # the control: sums a step down
        sums = sums.to(round_sums).float()
    e_s, p_s, l_s = sums[:, 0], sums[:, 1], sums[:, 2]
    e_r, p_r, l_r, signs, pa_re, pa_im = _polarity_combine(st, e_s, p_s,
                                                           l_s, ncp, m)
    st1, lock, lockval, snr = _lock_snr_update(
        st._replace(p_a_re=pa_re, p_a_im=pa_im), p_r, m)
    t_up = float(np.float32(m * T_MS))
    st2 = st1._replace(rc=torch.remainder(st.rc + st.dfc * t_up, L_CA32),
                       ri=torch.remainder(st.ri + st.fi * t_up, 1.0),
                       cp=st.cp + ncp)
    st3, dpc, dpi = _loops_update(st2, e_r, p_r, l_r, fcaid, loops, m)
    logf, logi = _log_rows(e_r, p_r, l_r, st.rc, st.ri, st.dfc, st.fi,
                           lockval, snr, dpc, dpi, signs, st.cp, ncp, lock)
    return st3, logf, logi


def track_chunk_plain(state: TrackState, raw_chunk, code_table, fs: float,
                      fcaid: float, loops: LoopConfig = LoopConfig(),
                      coh_ms: int = 1, round_sums=None):
    """Plain PyTorch tracker: (final state, logf [steps, 15 + m, C],
    logi [steps, 3, C]) over raw_chunk [steps, S, 2] (int16 or f32), each
    window coh_ms code periods."""
    m = int(coh_ms)
    s = raw_chunk.shape[1]
    time_idc = window_times(s, fs, raw_chunk.device)
    rows_f, rows_i = [], []
    st = state
    for k in range(raw_chunk.shape[0]):
        raw = raw_chunk[k].float()
        st, lf, li = _step_plain(st, raw[:, 0], raw[:, 1], code_table,
                                 time_idc, fs, fcaid, loops, m, round_sums)
        rows_f.append(lf)
        rows_i.append(li)
    return st, torch.stack(rows_f), torch.stack(rows_i)


def state_from_numpy(fields: dict, device) -> TrackState:
    out = {}
    for name in TrackState._fields:
        dt = np.int32 if name in INT_FIELDS else np.float32
        out[name] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(fields[name], dtype=dt)).copy()).to(device)
    return TrackState(**out)
