"""Scalar tracking engine on torch devices: E/P/L correlation + DLL/PLL.

Port of navlab_dpe_sdr_tpu/ops/tracking.py at the 1 ms cadence (coh_ms = 1)
with direct code-table lookups (the JAX "gather" strategy, the one its
non-TPU backends run). All channels advance together through a chunk of
1 ms windows; the carry is a `TrackState` of [C] tensors and the log a
`TrackLog` of [steps, C] tensors, field for field as in JAX, with the same
precision design (f32 residual phases dfc = fc - F_CA).

`track_chunk` runs `track_chunk_plain` (a Python loop of torch ops over the
steps) on a CPU tensor and the hand-written kernel K4 (ops/track.py,
csrc/track_chunk.cu) on a CUDA tensor; there is no fallback between them.
Coherent windows (coh_ms > 1), the k-window batched tracker and open-loop
correlation raise NotImplementedError (ROADMAP Queue 1 item 13). The TPU
replica strategies and their calibration are not ported (ROADMAP "Not to
port").
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from navlab_dpe_sdr_tpu.constants import F_CA, L_CA

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

UNPORTED_ITEM = "ROADMAP Queue 1 item 13 (coherent, batched and open-loop " \
                "tracking)"


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


class TrackLog(NamedTuple):
    """Per-step outputs ([steps, C]; signs [steps, C, 2])."""
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
# packed log rows (one fetch each): floats [steps, 16, C], ints [steps, 3, C]
LOG_F_ROWS = ("iE", "qE", "iP", "qP", "iL", "qL", "rc", "ri", "fc", "fi",
              "lockval", "snr", "dpc", "dpi", "sign0", "sign1")
LOG_I_ROWS = ("cp", "ncp", "lock")


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


def unpack_log(logf, logi) -> TrackLog:
    """TrackLog views into the packed logs logf [steps, 16, C] and
    logi [steps, 3, C]."""
    f = {k: logf[:, i] for i, k in enumerate(LOG_F_ROWS)}
    return TrackLog(
        iE=f["iE"], qE=f["qE"], iP=f["iP"], qP=f["qP"], iL=f["iL"],
        qL=f["qL"], rc=f["rc"], ri=f["ri"], fc=f["fc"], fi=f["fi"],
        cp=logi[:, 0], ncp=logi[:, 1],
        signs=logf[:, 14:16].transpose(1, 2), lock=logi[:, 2],
        lockval=f["lockval"], snr=f["snr"], dpc=f["dpc"], dpi=f["dpi"])


# ---------------------------------------------------------------------------
# The closed-loop tail of one step (plain PyTorch; the kernel's track_tail)
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


def _polarity_combine(state: TrackState, e_s, p_s, l_s, ncp):
    """Receiver-synchronous combination with nav-bit polarity resolution,
    m = 1 (the JAX `_polarity_combine`). Segment sums are [C, 3, 2]."""
    sums = e_s + p_s + l_s

    def mag2(x):
        return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]

    flip01 = mag2(sums[:, 0] + sums[:, 1]) < mag2(sums[:, 0] - sums[:, 1])
    flip12 = mag2(sums[:, 1] + sums[:, 2]) < mag2(sums[:, 1] - sums[:, 2])
    one = torch.ones_like(state.rc)
    g1 = torch.where(flip01, -one, one)
    g2 = torch.where(flip01, -one, torch.where(flip12, -one, one))

    def comb(x):
        acc = x[:, 0]
        acc = acc + g1[:, None] * x[:, 1]
        return acc + g2[:, None] * x[:, 2]

    e_r, p_r, l_r = comb(e_s), comb(p_s), comb(l_s)
    signs = torch.stack([-torch.sign(state.p_a_re + p_s[:, 0, 0]),
                         -torch.sign(p_s[:, 1, 0])], dim=1)

    def pick(part):
        carry = state.p_a_re if part == 0 else state.p_a_im
        zero = torch.zeros_like(carry)
        acc = torch.where(ncp == 0, carry + p_s[:, 0, part], zero)
        for k in (1, 2):
            acc = acc + torch.where(ncp == k, p_s[:, k, part], zero)
        return acc

    return e_r, p_r, l_r, signs, pick(0), pick(1)


def _lock_snr_update(state: TrackState, p_r):
    """Kaplan-Hegarty lock detector + variance-summing C/N0 meter, m = 1
    (the JAX `_lock_snr_update`)."""
    ip, qp = p_r[:, 0], p_r[:, 1]
    lpf = 1.0 - (1.0 - LOCK_LPF) ** 1
    li = lpf * torch.abs(ip) + (1 - lpf) * state.lock_i
    lq = lpf * torch.abs(qp) + (1 - lpf) * state.lock_q
    in_lock = _div(li, LOCK_K) > lq
    zero = torch.zeros_like(state.losscount)
    losscount = torch.where(in_lock, zero, state.losscount + 1)
    lockcount = torch.where(in_lock, state.lockcount + 1, zero)
    lock = torch.where(in_lock & (state.lockcount > LOCK_LOCK_TH),
                       torch.ones_like(state.lock),
                       torch.where(~in_lock & (state.losscount > LOCK_LOSS_TH),
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
        carrier / (float(np.float32(2.0 * (SNR_N * T_MS))) * noise_var), 1.0)
    snr = 10.0 * torch.log10(logarg)

    new = state._replace(lock_i=li, lock_q=lq, losscount=losscount,
                         lockcount=lockcount, lock=lock, snr_z=snr_z,
                         snr_v=snr_v, snr_fill=state.snr_fill + 1)
    return new, lock, lockval, snr


def _lf_step(h, h2, xp, xf, coeffs, boxcar: bool):
    """One loop-filter update (the JAX `_lf_step` at t_s = T_MS)."""
    kap, kvp, kpp, kaf, kvf = (float(np.float32(c)) for c in coeffs)
    t = float(np.float32(T_MS))

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
                  loops: LoopConfig):
    """DLL/PLL discriminators -> loop filters -> new fc/fi (the JAX
    `_loops_update`, m = 1)."""
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
                  float(np.float32(2.0 * np.pi * T_MS)))
    else:
        xf = zero
    lf_carr_h, lf_carr_h2, di = _lf_step(
        state.lf_carr_h, state.lf_carr_h2, dpi, xf,
        _loop_coeffs(loops.order, loops.bn_carr, loops.bn_carr_freq),
        loops.boxcar)
    lf_code_h, lf_code_h2, dc = _lf_step(
        state.lf_code_h, state.lf_code_h2, dpc, zero,
        _loop_coeffs(loops.order, loops.bn_code, 0.0), loops.boxcar)

    fi_new = state.fi_bias + di
    dfc_new = (state.dfc_bias + dc
               + float(np.float32(fcaid)) * (state.fi_bias + di))
    return state._replace(fi=fi_new, dfc=dfc_new, lf_carr_h=lf_carr_h,
                          lf_code_h=lf_code_h, lf_carr_h2=lf_carr_h2,
                          lf_code_h2=lf_code_h2,
                          prev_p_re=ip, prev_p_im=qp), dpc, dpi


def _step_plain(st: TrackState, raw_re, raw_im, code_table, time_idc,
                fs: float, fcaid: float, loops: LoopConfig):
    """One 1 ms closed-loop step (the scan body, ops/tracking.py:698-724):
    returns (state', log floats [16, C], log ints [3, C])."""
    sums, ncp = correlate_window_plain(raw_re, raw_im, st.rc, st.dfc, st.ri,
                                       st.fi, code_table, time_idc, fs)
    e_s, p_s, l_s = sums[:, 0], sums[:, 1], sums[:, 2]
    e_r, p_r, l_r, signs, pa_re, pa_im = _polarity_combine(st, e_s, p_s,
                                                           l_s, ncp)
    st1, lock, lockval, snr = _lock_snr_update(
        st._replace(p_a_re=pa_re, p_a_im=pa_im), p_r)
    t_up = float(np.float32(T_MS))
    st2 = st1._replace(rc=torch.remainder(st.rc + st.dfc * t_up, L_CA32),
                       ri=torch.remainder(st.ri + st.fi * t_up, 1.0),
                       cp=st.cp + ncp)
    st3, dpc, dpi = _loops_update(st2, e_r, p_r, l_r, fcaid, loops)
    logf = torch.stack([e_r[:, 0], e_r[:, 1], p_r[:, 0], p_r[:, 1],
                        l_r[:, 0], l_r[:, 1], st.rc, st.ri, F_CA32 + st.dfc,
                        st.fi, lockval, snr, dpc, dpi, signs[:, 0],
                        signs[:, 1]])
    logi = torch.stack([st.cp, ncp, lock.to(torch.int32)])
    return st3, logf, logi


def _check_chunk(raw_chunk, coh_ms: int):
    if int(coh_ms) != 1:
        raise NotImplementedError(
            f"coh_ms={coh_ms} (coherent predetection integration) is not "
            f"ported yet: {UNPORTED_ITEM}")
    if raw_chunk.dim() != 3 or raw_chunk.shape[-1] != 2:
        raise ValueError(f"raw_chunk must be [steps, S, 2] (re, im), got "
                         f"{tuple(raw_chunk.shape)}")


def track_chunk_plain(state: TrackState, raw_chunk, code_table, fs: float,
                      fcaid: float, loops: LoopConfig = LoopConfig()):
    """Plain PyTorch tracker: (final state, logf [steps, 16, C],
    logi [steps, 3, C]) over raw_chunk [steps, S, 2] (int16 or f32)."""
    s = raw_chunk.shape[1]
    time_idc = _track.window_times(s, fs, raw_chunk.device)
    rows_f, rows_i = [], []
    st = state
    for k in range(raw_chunk.shape[0]):
        raw = raw_chunk[k].float()
        st, lf, li = _step_plain(st, raw[:, 0], raw[:, 1], code_table,
                                 time_idc, fs, fcaid, loops)
        rows_f.append(lf)
        rows_i.append(li)
    return st, torch.stack(rows_f), torch.stack(rows_i)


def kernel_params(s: int, fs: float, fcaid: float,
                  loops: LoopConfig) -> _track.TrackParams:
    """The K4 kernel's scalars for this configuration, each the f32 value
    the plain path (and the JAX scan) uses."""
    f32 = lambda x: float(np.float32(x))   # noqa: E731
    lpf = 1.0 - (1.0 - LOCK_LPF) ** 1
    carr = _loop_coeffs(loops.order, loops.bn_carr, loops.bn_carr_freq)
    code = _loop_coeffs(loops.order, loops.bn_code, 0.0)
    return _track.TrackParams(
        fs=f32(fs), win_s=f32(s / fs), inv_lca=f32(1.0 / L_CA),
        t_up=f32(T_MS), fcaid=f32(fcaid), lpf=f32(lpf), one_m_lpf=f32(1 - lpf),
        snr_den=f32(2.0 * (SNR_N * T_MS)),
        fll_norm=f32(2.0 * np.pi * T_MS),
        carr=(ctypes.c_float * 5)(*map(f32, carr)),
        code=(ctypes.c_float * 5)(*map(f32, code)),
        boxcar=int(bool(loops.boxcar)), fll=int(loops.bn_carr_freq > 0.0),
        carr_h2=int(not (carr[0] == 0.0 and carr[3] == 0.0)),
        code_h2=int(not (code[0] == 0.0 and code[3] == 0.0)),
        loss_th=LOCK_LOSS_TH, lock_th=LOCK_LOCK_TH)


def track_chunk_packed(state: TrackState, raw_chunk, code_table, fs: float,
                       fcaid: float, loops: LoopConfig = LoopConfig(),
                       coh_ms: int = 1):
    """(final state, logf [steps, 16, C] f32, logi [steps, 3, C] int32):
    the packed form of `track_chunk`, so a caller fetches the whole log in
    two copies. CPU tensors -> `track_chunk_plain`; CUDA tensors -> K4, or
    an exception."""
    _check_chunk(raw_chunk, coh_ms)
    dev = raw_chunk.device
    if dev.type == "cpu":
        return track_chunk_plain(state, raw_chunk, code_table, fs, fcaid,
                                 loops)
    if dev.type != "cuda":
        raise ValueError(f"track_chunk runs on cpu or cuda, not {dev}")
    params = kernel_params(int(raw_chunk.shape[1]), fs, fcaid, loops)
    stf, sti, rings, logf, logi = _track.track_chunk_cuda(
        *pack_state(state), raw_chunk, code_table, fs, params)
    return unpack_state(stf, sti, rings), logf, logi


def track_chunk(state: TrackState, raw_chunk, code_table, fs: float,
                fcaid: float, loops: LoopConfig = LoopConfig(),
                coh_ms: int = 1):
    """Track a chunk of consecutive 1 ms windows raw_chunk [steps, S, 2]
    (int16 or f32 I/Q, on the state's device). Returns (final_state,
    TrackLog stacked over steps), the contract of the JAX `track_chunk`."""
    st, logf, logi = track_chunk_packed(state, raw_chunk, code_table, fs,
                                        fcaid, loops, coh_ms)
    return st, unpack_log(logf, logi)


def track_chunk_batched(*args, **kwargs):
    raise NotImplementedError(
        f"track_chunk_batched (batch_k > 1) is not ported yet: "
        f"{UNPORTED_ITEM}")


def track_open_loop(*args, **kwargs):
    raise NotImplementedError(
        f"track_open_loop (vector tracking) is not ported yet: "
        f"{UNPORTED_ITEM}")
