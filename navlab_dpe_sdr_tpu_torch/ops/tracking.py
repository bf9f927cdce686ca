"""Scalar tracking engine on torch devices: E/P/L correlation + DLL/PLL.

Port of navlab_dpe_sdr_tpu/ops/tracking.py with direct code-table lookups
(the JAX "gather" strategy, the one its non-TPU backends run). All channels
advance together through a chunk of windows; the carry is a `TrackState`
of [C] tensors and the log a `TrackLog` of [steps, C] tensors, field for
field as in JAX, with the same precision design (f32 residual phases
dfc = fc - F_CA). The modes are the JAX package's:

- `track_chunk(coh_ms=m)`: one loop update per window of m code periods
  (m = 1, or m = 2..10 for coherent predetection integration: m + 2
  segments, the single-flip hypothesis test, m-scaled lock detector,
  C/N0 meter and loop filters);
- `track_chunk_batched(batch_k=k)`: k 1 ms windows correlated from the
  rates frozen at the batch start, then k sequential 1 ms updates;
- `track_open_loop`: open-loop E/P/L of consecutive 1 ms windows at
  externally steered phases (vector tracking).

Each runs its plain version (a Python loop of torch ops) on a CPU tensor
and a hand-written kernel (ops/track.py, csrc/track_chunk.cu) on a CUDA
tensor: K4 for the first two, K3's windows mode for the third. There is no
fallback between them. The TPU replica strategies and their calibration
are not ported (ROADMAP "Not to port").
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..constants import F_CA, L_CA
from ..device import resolve_device
from . import track as _track
from .track import F_CA32, L_CA32, TWO_PI, correlate_window_plain

T_MS = 1e-3
SNR_N = 20            # running-average window (reference channel.py:62)
LOCK_K = 1.5
LOCK_LPF = 0.0247
LOCK_LOSS_TH = 50
LOCK_LOCK_TH = 240

BN_CODE_DEFAULT = 3.0      # Hz
BN_CARR_DEFAULT = 40.0     # Hz

T_MS32 = float(np.float32(T_MS))


class LoopConfig(NamedTuple):
    """Loop-filter configuration (same fields and defaults as the JAX
    LoopConfig; critically damped constants, reference loopfilter.py)."""
    order: int = 2            # 2 or 3
    bn_code: float = BN_CODE_DEFAULT
    bn_carr: float = BN_CARR_DEFAULT
    bn_carr_freq: float = 0.0  # FLL-assist bandwidth
    boxcar: bool = False       # boxcar instead of bilinear integrators


def cadence_loops(coh_ms: int = 1) -> LoopConfig:
    """The JAX CLI's loop defaults at an update cadence of coh_ms ms
    (navlab_dpe_sdr_tpu/cli.py cmd_track): the 1 ms PLL (Bn 40 Hz) is
    marginal at longer updates, so coherent mode narrows it to 48/m Hz and
    adds 12/m Hz of FLL assist."""
    m = int(coh_ms)
    if m == 1:
        return LoopConfig()
    return LoopConfig(order=2, bn_code=BN_CODE_DEFAULT, bn_carr=48.0 / m,
                      bn_carr_freq=12.0 / m)


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


class TrackLog(NamedTuple):
    """Per-step outputs ([steps, C]; signs [steps, C, m + 1])."""
    iE: torch.Tensor
    qE: torch.Tensor
    iP: torch.Tensor
    qP: torch.Tensor
    iL: torch.Tensor
    qL: torch.Tensor
    rc: torch.Tensor
    ri: torch.Tensor
    fc: torch.Tensor
    fi: torch.Tensor
    cp: torch.Tensor
    ncp: torch.Tensor
    signs: torch.Tensor
    lock: torch.Tensor
    lockval: torch.Tensor
    snr: torch.Tensor
    dpc: torch.Tensor
    dpi: torch.Tensor


FLOAT_FIELDS = ("rc", "dfc", "ri", "fi", "dfc_bias", "fi_bias", "p_a_re",
                "p_a_im", "lf_code_h", "lf_carr_h", "lf_code_h2",
                "lf_carr_h2", "lock_i", "lock_q", "prev_p_re", "prev_p_im")
INT_FIELDS = ("cp", "losscount", "lockcount", "lock", "snr_fill")
RING_FIELDS = ("snr_z", "snr_v")
# packed log rows (one fetch each): floats [steps, log_f_rows(m), C] (the
# m + 1 nav-bit signs after the base rows, then at m > 1 the prompt's m + 2
# segment sums, in-phase and quadrature each), ints [steps, 3, C]
LOG_F_BASE = ("iE", "qE", "iP", "qP", "iL", "qL", "rc", "ri", "fc", "fi",
              "lockval", "snr", "dpc", "dpi")
LOG_I_ROWS = ("cp", "ncp", "lock")


def log_f_rows(m: int = 1) -> tuple:
    """Names of the float log rows of an m-period window: the base rows,
    the m + 1 nav-bit signs, and at m > 1 the prompt's m + 2 segment sums
    (the soft values of a weak channel's nav bits, models/navbits.py)."""
    m = int(m)
    segs = (tuple(f"pseg{j}{q}" for j in range(m + 2) for q in "iq")
            if m > 1 else ())
    return LOG_F_BASE + tuple(f"sign{k}" for k in range(m + 1)) + segs


LOG_F_ROWS = log_f_rows(1)


def init_state(rc, ri, fc, fi, cp=None, device="cuda") -> TrackState:
    """TrackState from acquisition results (sets the loop biases), on
    `device` (a missing CUDA device raises)."""
    dev = resolve_device(device)
    rc = np.asarray(rc, dtype=np.float32)
    c = rc.shape[0]
    fi = np.asarray(fi, dtype=np.float32)
    dfc = (np.asarray(fc, dtype=np.float64) - F_CA).astype(np.float32)
    zeros = np.zeros(c, np.float32)
    izeros = np.zeros(c, np.int32)
    return state_from_numpy(dict(
        rc=rc, dfc=dfc, ri=np.asarray(ri, dtype=np.float32), fi=fi,
        dfc_bias=dfc, fi_bias=fi,
        cp=izeros if cp is None else np.asarray(cp, np.int32),
        p_a_re=zeros, p_a_im=zeros, lf_code_h=zeros, lf_carr_h=zeros,
        lf_code_h2=zeros, lf_carr_h2=zeros, lock_i=zeros, lock_q=zeros,
        losscount=izeros, lockcount=izeros, lock=izeros,
        snr_z=np.zeros((c, SNR_N), np.float32),
        snr_v=np.zeros((c, SNR_N), np.float32),
        snr_fill=izeros, prev_p_re=zeros, prev_p_im=zeros), dev)


def state_from_numpy(fields, device) -> TrackState:
    """TrackState on `device` from a mapping of field name -> array (a JAX
    TrackState's `_asdict()` through np.asarray, or a save_state record):
    a JAX tracker's carry resumes here."""
    dev = resolve_device(device)
    out = {}
    for name in TrackState._fields:
        dt = np.int32 if name in INT_FIELDS else np.float32
        arr = np.ascontiguousarray(np.asarray(fields[name], dtype=dt))
        out[name] = torch.from_numpy(arr.copy()).to(dev)
    for name in FLOAT_FIELDS + INT_FIELDS:          # .mat vectors are 2-D
        out[name] = out[name].reshape(-1)
    c = out["rc"].shape[0]
    for name in RING_FIELDS:
        out[name] = out[name].reshape(c, SNR_N)
    return TrackState(**out)


def state_to_numpy(state: TrackState) -> dict:
    """{field name: numpy array}, the inverse of `state_from_numpy`."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def pack_state(state: TrackState):
    """(floats [C, 16], ints [C, 5] int32, rings [C, 2, SNR_N]) — the
    kernel's carry layout."""
    stf = torch.stack([getattr(state, k).float() for k in FLOAT_FIELDS], 1)
    sti = torch.stack([getattr(state, k).to(torch.int32)
                       for k in INT_FIELDS], 1)
    rings = torch.stack([state.snr_z, state.snr_v], 1).float()
    return stf.contiguous(), sti.contiguous(), rings.contiguous()


def unpack_state(stf, sti, rings) -> TrackState:
    out = {k: stf[:, i] for i, k in enumerate(FLOAT_FIELDS)}
    out.update({k: sti[:, i] for i, k in enumerate(INT_FIELDS)})
    out["snr_z"], out["snr_v"] = rings[:, 0], rings[:, 1]
    return TrackState(**out)


def unpack_log(logf, logi, m: int = 1) -> TrackLog:
    """TrackLog views into the packed logs of m-period windows, logf
    [steps, log_f_rows(m), C] and logi [steps, 3, C]."""
    f = {k: logf[:, i] for i, k in enumerate(LOG_F_BASE)}
    n = len(LOG_F_BASE)
    return TrackLog(
        iE=f["iE"], qE=f["qE"], iP=f["iP"], qP=f["qP"], iL=f["iL"],
        qL=f["qL"], rc=f["rc"], ri=f["ri"], fc=f["fc"], fi=f["fi"],
        cp=logi[:, 0], ncp=logi[:, 1],
        signs=logf[:, n:n + int(m) + 1].transpose(1, 2), lock=logi[:, 2],
        lockval=f["lockval"], snr=f["snr"], dpc=f["dpc"], dpi=f["dpi"])


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


def _log_rows(e_r, p_r, l_r, rc, ri, dfc, fi, lockval, snr, dpc, dpi, signs,
              cp, ncp, lock, p_s=None):
    """One packed log row: floats [log_f_rows(m), C] (p_s, the prompt's
    segment sums [C, m + 2, 2], given at m > 1), ints [3, C]."""
    rows = [torch.stack([
        e_r[:, 0], e_r[:, 1], p_r[:, 0], p_r[:, 1], l_r[:, 0], l_r[:, 1],
        rc, ri, F_CA32 + dfc, fi, lockval, snr, dpc, dpi]), signs.T]
    if p_s is not None:
        rows.append(p_s.reshape(p_s.shape[0], -1).T)
    logf = torch.cat(rows)
    return logf, torch.stack([cp, ncp, lock.to(torch.int32)])


def _step_plain(st: TrackState, raw_re, raw_im, code_table, time_idc,
                fs: float, fcaid: float, loops: LoopConfig, m: int = 1):
    """One closed-loop update over an m-period window (the scan body,
    ops/tracking.py:698-724): returns (state', log floats
    [log_f_rows(m), C], log ints [3, C])."""
    sums, ncp = correlate_window_plain(
        raw_re, raw_im, st.rc, st.dfc, st.ri, st.fi, code_table, time_idc, fs,
        m, _track.window_warps(m) if m > 1 else None)
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
                           lockval, snr, dpc, dpi, signs, st.cp, ncp, lock,
                           p_s if m > 1 else None)
    return st3, logf, logi


def check_coh_ms(coh_ms) -> int:
    """coh_ms as an int in 1..10 (the JAX range check: more than 10 periods
    would let a window span two nav-bit boundaries, which the single-flip
    test cannot represent)."""
    m = int(coh_ms)
    if not 1 <= m <= _track.MAX_COH_MS:
        raise ValueError(f"coh_ms must be in 1..{_track.MAX_COH_MS}, got {m}")
    return m


def _check_chunk(raw_chunk, coh_ms: int) -> int:
    m = check_coh_ms(coh_ms)
    if raw_chunk.dim() != 3 or raw_chunk.shape[-1] != 2:
        raise ValueError(f"raw_chunk must be [steps, S, 2] (re, im), got "
                         f"{tuple(raw_chunk.shape)}")
    if raw_chunk.shape[1] % m:
        raise ValueError(f"a window of {raw_chunk.shape[1]} samples is not "
                         f"{m} whole code periods")
    return m


def track_chunk_plain(state: TrackState, raw_chunk, code_table, fs: float,
                      fcaid: float, loops: LoopConfig = LoopConfig(),
                      coh_ms: int = 1):
    """Plain PyTorch tracker: (final state, logf [steps, log_f_rows(m), C],
    logi [steps, 3, C]) over raw_chunk [steps, S, 2] (int16 or f32), each
    window coh_ms code periods."""
    m = check_coh_ms(coh_ms)
    s = raw_chunk.shape[1]
    time_idc = _track.window_times(s, fs, raw_chunk.device)
    rows_f, rows_i = [], []
    st = state
    for k in range(raw_chunk.shape[0]):
        raw = raw_chunk[k].float()
        st, lf, li = _step_plain(st, raw[:, 0], raw[:, 1], code_table,
                                 time_idc, fs, fcaid, loops, m)
        rows_f.append(lf)
        rows_i.append(li)
    return st, torch.stack(rows_f), torch.stack(rows_i)


def _batch_phase(x, rate, w: int, period: float):
    """mod(x + (rate T_MS) w, period): the phase the batch predicts for its
    window w from the batch-start phase x and frozen rate (the JAX
    `_correlate_windows_batched`)."""
    return torch.remainder(x + (rate * T_MS32) * float(w), period)


def track_chunk_batched_plain(state: TrackState, raw_chunk, code_table,
                              fs: float, fcaid: float,
                              loops: LoopConfig = LoopConfig(),
                              batch_k: int = 4):
    """Plain PyTorch batch_k tracker (the JAX `track_chunk_batched`): each
    batch correlates batch_k 1 ms windows at the phases predicted from the
    rates frozen at its start, then runs batch_k sequential 1 ms updates;
    the log rows take fc/fi/cp from the state before each update and rc/ri
    from the prediction, and the batch closes with the frozen-rate carry of
    rc/ri. Returns (final state, logf [steps, 16, C], logi [steps, 3, C])."""
    k = int(batch_k)
    steps, s = raw_chunk.shape[0], raw_chunk.shape[1]
    if k < 1 or steps % k:
        raise ValueError(f"steps {steps} not divisible by batch_k {k}")
    time_idc = _track.window_times(s, fs, raw_chunk.device)
    warps = _track.window_warps(1, k)      # the kernel's sum order
    rows_f, rows_i = [], []
    st = state
    for b0 in range(0, steps, k):
        dfc0, fi0, rc0, ri0 = st.dfc, st.fi, st.rc, st.ri
        for w in range(k):
            rc_w = _batch_phase(rc0, dfc0, w, L_CA32)
            ri_w = _batch_phase(ri0, fi0, w, 1.0)
            raw = raw_chunk[b0 + w].float()
            sums, ncp = correlate_window_plain(raw[:, 0], raw[:, 1], rc_w,
                                               dfc0, ri_w, fi0, code_table,
                                               time_idc, fs, warps=warps)
            stw = st._replace(rc=rc_w, ri=ri_w)
            e_r, p_r, l_r, signs, pa_re, pa_im = _polarity_combine(
                stw, sums[:, 0], sums[:, 1], sums[:, 2], ncp)
            st1, lock, lockval, snr = _lock_snr_update(
                stw._replace(p_a_re=pa_re, p_a_im=pa_im), p_r)
            st2 = st1._replace(cp=st.cp + ncp)
            st3, dpc, dpi = _loops_update(st2, e_r, p_r, l_r, fcaid, loops)
            lf, li = _log_rows(e_r, p_r, l_r, rc_w, ri_w, st.dfc, st.fi,
                               lockval, snr, dpc, dpi, signs, st.cp, ncp,
                               lock)
            rows_f.append(lf)
            rows_i.append(li)
            st = st3
        st = st._replace(rc=torch.remainder(rc_w + dfc0 * T_MS32, L_CA32),
                         ri=torch.remainder(ri_w + fi0 * T_MS32, 1.0))
    return st, torch.stack(rows_f), torch.stack(rows_i)


def kernel_params(s: int, fs: float, fcaid: float, loops: LoopConfig,
                  m: int = 1, batch_k: int = 1) -> _track.TrackParams:
    """The K4 kernel's scalars for this configuration (windows of s samples
    and m code periods; batch_k windows a batch), each the f32 value the
    plain path (and the JAX scan) uses."""
    f32 = lambda x: float(np.float32(x))   # noqa: E731
    lpf, loss_th, lock_th = _lock_consts(m)
    carr = _loop_coeffs(loops.order, loops.bn_carr, loops.bn_carr_freq)
    code = _loop_coeffs(loops.order, loops.bn_code, 0.0)
    return _track.TrackParams(
        fs=f32(fs), win_s=f32(s / fs), inv_lca=f32(1.0 / L_CA),
        t_up=f32(m * T_MS), fcaid=f32(fcaid), lpf=f32(lpf),
        one_m_lpf=f32(1 - lpf), snr_den=f32(2.0 * (SNR_N * m * T_MS)),
        fll_norm=f32(2.0 * np.pi * m * T_MS),
        carr=(ctypes.c_float * 5)(*map(f32, carr)),
        code=(ctypes.c_float * 5)(*map(f32, code)),
        boxcar=int(bool(loops.boxcar)), fll=int(loops.bn_carr_freq > 0.0),
        carr_h2=int(not (carr[0] == 0.0 and carr[3] == 0.0)),
        code_h2=int(not (code[0] == 0.0 and code[3] == 0.0)),
        loss_th=loss_th, lock_th=lock_th, half_win=f32(m * 0.5e-3), m=m,
        batch_k=int(batch_k))


def _device_of(raw_chunk, what: str) -> torch.device:
    dev = raw_chunk.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    return dev


def track_chunk_packed(state: TrackState, raw_chunk, code_table, fs: float,
                       fcaid: float, loops: LoopConfig = LoopConfig(),
                       coh_ms: int = 1, clocks=None, batch_k: int = 1):
    """(final state, logf [steps, log_f_rows(m), C] f32, logi [steps, 3, C]
    int32): the packed form of `track_chunk` (coh_ms = m) and, with
    batch_k > 1, of `track_chunk_batched`, so a caller fetches the whole log
    in two copies. CPU tensors -> the plain versions; CUDA tensors -> K4,
    or an exception. `clocks` (a measurement's int64 [C, 6] CUDA tensor, any
    mode) is handed to `ops/track.track_chunk_cuda`."""
    m = _check_chunk(raw_chunk, coh_ms)
    kb = int(batch_k)
    if kb > 1 and m > 1:
        raise ValueError("batch_k applies to the 1 ms cadence only")
    dev = _device_of(raw_chunk, "track_chunk")
    if dev.type == "cpu":
        if clocks is not None:
            raise ValueError("clocks are the kernel's: CUDA tensors only")
        if kb > 1:
            return track_chunk_batched_plain(state, raw_chunk, code_table,
                                             fs, fcaid, loops, kb)
        return track_chunk_plain(state, raw_chunk, code_table, fs, fcaid,
                                 loops, m)
    params = kernel_params(int(raw_chunk.shape[1]), fs, fcaid, loops, m, kb)
    stf, sti, rings, logf, logi = _track.track_chunk_cuda(
        *pack_state(state), raw_chunk, code_table, fs, params, clocks)
    return unpack_state(stf, sti, rings), logf, logi


def track_chunk(state: TrackState, raw_chunk, code_table, fs: float,
                fcaid: float, loops: LoopConfig = LoopConfig(),
                coh_ms: int = 1):
    """Track a chunk of consecutive coh_ms-long windows raw_chunk
    [steps, S, 2] (int16 or f32 I/Q, on the state's device; S = coh_ms
    samples-per-ms). Returns (final_state, TrackLog stacked over steps), the
    contract of the JAX `track_chunk`."""
    st, logf, logi = track_chunk_packed(state, raw_chunk, code_table, fs,
                                        fcaid, loops, coh_ms)
    return st, unpack_log(logf, logi, coh_ms)


def track_chunk_batched(state: TrackState, raw_chunk, code_table, fs: float,
                        fcaid: float, loops: LoopConfig = LoopConfig(),
                        batch_k: int = 4):
    """track_chunk with batch_k-window batched correlation (the JAX
    `track_chunk_batched` contract: per-1-ms log rows, steps a multiple of
    batch_k)."""
    st, logf, logi = track_chunk_packed(state, raw_chunk, code_table, fs,
                                        fcaid, loops, batch_k=batch_k)
    return st, unpack_log(logf, logi)


def _open_loop_state(rc, ri, dfc, fi) -> TrackState:
    """The zero carry the JAX `track_open_loop` correlates each window
    with: only the phases and rates are set."""
    c = rc.shape[0]
    fields = {k: torch.zeros_like(rc) for k in FLOAT_FIELDS}
    fields.update({k: torch.zeros(c, dtype=torch.int32, device=rc.device)
                   for k in INT_FIELDS})
    fields.update({k: torch.zeros((c, SNR_N), device=rc.device)
                   for k in RING_FIELDS})
    fields.update(rc=rc, dfc=dfc, ri=ri, fi=fi, dfc_bias=dfc, fi_bias=fi)
    return TrackState(**fields)


def track_open_loop_plain(rc, dfc, ri, fi, raw_chunk, code_table, fs: float):
    """Plain PyTorch open-loop correlation: [W, C, 3 (E, P, L), 2 (re, im)]
    over W consecutive 1 ms windows raw_chunk [W, S, 2], window w at the
    phases of the f32 recurrence rc_{w+1} = mod(rc_w + dfc T_MS, L_CA),
    ri_{w+1} = mod(ri_w + fi T_MS, 1), each combined over the nav-bit
    hypotheses with a zero prompt carry. Sums in K3's windows-mode order
    (WINDOWS_LANES lanes)."""
    s = raw_chunk.shape[1]
    time_idc = _track.window_times(s, fs, raw_chunk.device)
    out = []
    for w in range(raw_chunk.shape[0]):
        raw = raw_chunk[w].float()
        sums, ncp = correlate_window_plain(raw[:, 0], raw[:, 1], rc, dfc, ri,
                                           fi, code_table, time_idc, fs,
                                           lanes=_track.WINDOWS_LANES)
        e_r, p_r, l_r, _, _, _ = _polarity_combine(
            _open_loop_state(rc, ri, dfc, fi), sums[:, 0], sums[:, 1],
            sums[:, 2], ncp)
        out.append(torch.stack([e_r, p_r, l_r], dim=1))
        rc = torch.remainder(rc + dfc * T_MS32, L_CA32)
        ri = torch.remainder(ri + fi * T_MS32, 1.0)
    return torch.stack(out)


def track_open_loop(rc, dfc, ri, fi, raw_chunk, code_table, fs: float):
    """Open-loop E/P/L correlation over consecutive 1 ms windows (the JAX
    `track_open_loop`): channels steered externally, no discriminators or
    loop filters. rc/dfc/ri/fi [C] f32 (dfc = fc - F_CA), raw_chunk
    [W, S, 2] int16 or f32 on their device. Returns (e, p, l), each
    [W, C, 2] f32 (re, im). CPU tensors -> `track_open_loop_plain`; CUDA
    tensors -> K3's windows mode (one launch), or an exception."""
    if raw_chunk.dim() != 3 or raw_chunk.shape[-1] != 2:
        raise ValueError(f"raw_chunk must be [W, S, 2] (re, im), got "
                         f"{tuple(raw_chunk.shape)}")
    dev = _device_of(raw_chunk, "track_open_loop")
    if dev.type == "cpu":
        out = track_open_loop_plain(rc, dfc, ri, fi, raw_chunk, code_table,
                                    fs)
    else:
        out = _track.correlate_windows_cuda(raw_chunk, rc, dfc, ri, fi,
                                            code_table, fs)
    return out[:, :, 0], out[:, :, 1], out[:, :, 2]
