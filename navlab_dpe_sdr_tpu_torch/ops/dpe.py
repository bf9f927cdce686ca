"""DPE score-window sizing, the per-block manifold geometry and the FFT
DPE engine (port of navlab_dpe_sdr_tpu/ops/dpe.py).

`auto_windows`, `nominal_code_fft` and `replica_shift_parts` are host-side
numpy, copied verbatim. The FFT engine is the per-block cross-validation
oracle of DPEConfig(engine="fft"): per channel, over one block of S samples,
a circular code correlation against dual flip / no-flip replicas (chosen
by |corr[0]|) and the zero-padded carrier FFT after code wipeoff, all
channels in one batched torch.fft call (cuFFT on the card, as the JAX
module leaves it to XLA's FFT: no Pallas kernel). The replica is a circular
fractional shift of each channel's nominal code waveform, applied in the
frequency domain: R_k = N_k exp(2 pi i k m / S), with m split on the host
into an integer and a fractional part so the phase stays exact in float32.

`score_manifolds` is `ops/dpe_real.score_manifolds_mag` on |window|: the
JAX package's two share one interpolation (`_interp_scores`), and here both
run the scorer kernel's surface mode (K2) on the card.

Complex values are complex64, exponentials of a phase are formed as the
JAX module forms them: the f32 phase times f32(2 pi), then its cosine and
sine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import C, F_CA, F_L1, L_CA

CODE_WIN = 16   # samples of code_corr kept around each channel's center.
# The position manifold spans ~+/-2 samples (|drange + dt| <~ 250 m at
# 0.00834 samples/m), so 16 leaves 4x margin while quartering the
# score-interpolation weight construction (the VPU-bound hot loop).
CARR_WIN = 48   # carrier FFT bins kept around each channel's center.
# The velocity manifold spans ~+/-15 bins on the reference grids (|dv| +
# |dtdot| <~ 13.5 m/s at 1.1 bins per m/s), leaving ~+/-9 bins (~43 Hz) of
# carrier-prediction margin; the interpolation weight tensor over the grid
# is the HBM-bandwidth bottleneck, so width is traffic.
_TWO_PI = np.float32(2.0 * np.pi)


def auto_windows(d_enu, dt_m, dv_enu, dtdot, fs: float,
                 carr_fftpts: int) -> tuple[int, int]:
    """Smallest safe (code_win, carr_win) for a given search grid.

    The scoring weight tensor is O(grid x channels x window width) of HBM
    traffic — the hot-path bottleneck — so the windows are sized to the
    grid geometry instead of a fixed worst case. Exactness bound: the
    3-tap interpolation reads k0-1..k0+1 with k0 = round(idx) clipped to
    [1, W-2]; no clipping occurs iff W >= 2*span + 4, where span is the
    max |idx - window center| =
      code:  (fs/c) * (max ||d_enu|| + curvature + max |dt|)
      carr:  (carr_fftpts/fs) * (f_L1/c) * (max ||dv_enu|| + max |dtdot|)
    (window centers are rounded to integers, covered by the +4; see
    models/dpe._prepare_block). A slack sample absorbs f32 index fuzz and
    the <~1e-5 fc-dependence of the code coefficient. The reference's
    fixed-size equivalent is the full [numChan x S] score array
    (batchcorrscores.cu:696-698) — it never pays this traffic because it
    materializes everything.
    """
    r_min = 1.9e7   # closest GPS range [m]; curvature term (d^2-u^2)/(2 r0)
    dmax = float(np.linalg.norm(d_enu, axis=1).max(initial=0.0))
    span_m = dmax + dmax * dmax / (2.0 * r_min) + float(
        np.abs(dt_m).max(initial=0.0))
    span_code = (fs / C) * 1.001 * span_m
    vmax = float(np.linalg.norm(dv_enu, axis=1).max(initial=0.0))
    span_carr = ((carr_fftpts / fs) * (F_L1 / C)
                 * (vmax + float(np.abs(dtdot).max(initial=0.0))))

    def _w(span):
        w = int(np.ceil(2.0 * span + 5.0))
        return max(8, (w + 3) // 4 * 4)     # multiple of 4, floor 8

    return _w(span_code), _w(span_carr)


class ManifoldParams(NamedTuple):
    """Per-channel scoring geometry of one block ([C] f32 tensors;
    los_enu [C, 3]), computed on the host in float64. For grid point g with
    ENU offset d and clock offset dT (meters), u = los_enu . d:
      code index = pos_center + pos_coef * (-u + (|d|^2 - u^2)/(2 r0) + dT)
      carr index = vel_center + vel_coef * (-los_enu . dv + dTdot)
    """
    los_enu: torch.Tensor
    r0: torch.Tensor
    pos_center: torch.Tensor
    pos_coef: torch.Tensor
    vel_center: torch.Tensor
    vel_coef: torch.Tensor


class BlockScores(NamedTuple):
    code_corr: torch.Tensor   # [C, S] complex64, fftshifted
    carr_fft: torch.Tensor    # [C, F] complex64, fftshifted
    flip_used: torch.Tensor   # [C] bool


def _cis(ang: torch.Tensor) -> torch.Tensor:
    """cos(ang) + i sin(ang), complex64 from the f32 phase ang."""
    return torch.complex(torch.cos(ang), torch.sin(ang))


def _shift_phase(s: int, m_int: torch.Tensor,
                 m_frac: torch.Tensor) -> torch.Tensor:
    """exp(2*pi*i*k*m/S) [C, S] for the circular fractional advance by
    m = m_int + m_frac samples ([C] int, [C] f32).

    The integer part wraps k * m_int mod S in int64 (exact); the fractional
    part rides the *signed* frequency axis (k - S for k >= S/2) or the
    upper half-spectrum chirps. The f32 phase is ph_int/S + (k_signed/S) *
    m_frac in the JAX module's order."""
    k = torch.arange(s, device=m_frac.device)
    ph_int = torch.remainder(k[None, :] * m_int.long()[:, None],
                             s).to(torch.float32)
    k_signed = torch.where(k >= s // 2, k - s, k).to(torch.float32)
    inv_s = float(np.float32(1.0 / s))
    ph = ph_int * inv_s + (k_signed * inv_s)[None, :] * m_frac[:, None]
    return _cis(ph * float(_TWO_PI))


def batch_correlate(raw: torch.Tensor, code_fft0: torch.Tensor,
                    m_int: torch.Tensor, m_frac: torch.Tensor,
                    idx_next: torch.Tensor, fi: torch.Tensor,
                    ri: torch.Tensor, time_idc: torch.Tensor,
                    carr_fftpts: int) -> BlockScores:
    """Batched code correlation + carrier FFT for one block.

    raw: [S] complex64 samples; code_fft0: [C, S] complex64 = fft of each
    channel's nominal (zero-phase) code replica; m_int/m_frac: [C]
    integer/fractional parts of the per-channel replica shift in samples;
    idx_next: [C] first sample of the next nav bit (the replica's sign flips
    there; S for no flip); fi, ri: [C] f32 Doppler / carrier phase;
    time_idc: [S] f32 sample times.
    """
    s = raw.shape[0]
    wipeoff = _cis((fi[:, None] * time_idc[None, :] + ri[:, None])
                   * float(-_TWO_PI))                   # [C, S]
    bb = raw[None, :] * wipeoff
    rfft = torch.fft.fft(bb, dim=-1)

    repl_fft = code_fft0 * _shift_phase(s, m_int, m_frac)
    repl_time = torch.fft.ifft(repl_fft, dim=-1).real

    cols = torch.arange(s, device=raw.device)
    flip_mask = cols[None, :] >= idx_next.long()[:, None]
    repl_flip = torch.where(flip_mask, -repl_time, repl_time)
    repl_flip_fft = torch.fft.fft(repl_flip.to(torch.complex64), dim=-1)

    corr = torch.fft.ifft(torch.conj(repl_fft) * rfft, dim=-1)
    corr_f = torch.fft.ifft(torch.conj(repl_flip_fft) * rfft, dim=-1)

    use_flip = corr_f[:, 0].abs() > corr[:, 0].abs()            # [C]
    code_corr = torch.fft.fftshift(
        torch.where(use_flip[:, None], corr_f, corr), dim=-1)

    repl = torch.where(use_flip[:, None], repl_flip, repl_time)
    carr_bb = (raw[None, :] - raw.mean()) * repl * wipeoff
    carr_fft = torch.fft.fftshift(
        torch.fft.fft(carr_bb, n=carr_fftpts, dim=-1), dim=-1)
    return BlockScores(code_corr=code_corr, carr_fft=carr_fft,
                       flip_used=use_flip)


def score_manifolds(code_win, carr_win, params: ManifoldParams, d_enu, dt_m,
                    dv_enu, dtdot, l_power: int = 1,
                    interp: str = "quadratic", mesh=None):
    """(pos_scores [Gp], pos_arg, vel_scores [Gv], vel_arg) of one block's
    complex windows code_win [C, CODE_WIN] / carr_win [C, CARR_WIN]: the
    magnitudes through `dpe_real.score_manifolds_mag` (K2 on the card; on
    a mesh, each rank's grid rows).

    As in the JAX module, interpolation runs on |window|; for "linear" the
    reference interpolates the complex values first, a difference far below
    the noise floor with the carrier wiped per channel."""
    from .dpe_real import score_manifolds_mag   # dpe_real imports this module

    return score_manifolds_mag(code_win.abs(), carr_win.abs(), params, d_enu,
                               dt_m, dv_enu, dtdot, l_power=l_power,
                               interp=interp, mesh=mesh)


def _slice_rows(arr: torch.Tensor, start: torch.Tensor,
                width: int) -> torch.Tensor:
    """[C, width] rows arr[c, start[c]:start[c] + width], the start clamped
    into [0, L - width] as jax.lax.dynamic_slice clamps it."""
    st = start.long().clamp(0, arr.shape[1] - width)
    idx = st[:, None] + torch.arange(width, device=arr.device)
    return torch.gather(arr, 1, idx)


def dpe_device_step(raw, code_fft0, m_int, m_frac, idx_next, fi, ri,
                    time_idc, pos_start, vel_start, params: ManifoldParams,
                    d_enu, dt_m, dv_enu, dtdot, carr_fftpts: int,
                    l_power: int = 1, interp: str = "quadratic",
                    code_win: int = CODE_WIN, carr_win: int = CARR_WIN,
                    mesh=None):
    """One block of the FFT engine: replica shift + batch correlate, the
    score windows at pos_start/vel_start [C], both manifolds scored.
    Returns (pos_scores, pos_arg, vel_scores, vel_arg, flip_used).

    With a mesh (parallel/mesh.py `sharded_dpe_step`): each 'chan' rank
    transforms its channel shard, the windows and flips are gathered over
    'chan', and each rank scores its grid rows; the results are the whole
    ones on every rank."""
    c = code_fft0.shape[0]
    cs = slice(0, c) if mesh is None else mesh.chan_rows(c)
    scores = batch_correlate(raw, code_fft0[cs], m_int[cs], m_frac[cs],
                             idx_next[cs], fi[cs], ri[cs], time_idc,
                             carr_fftpts)
    code_w = _slice_rows(scores.code_corr, pos_start[cs], code_win)
    carr_w = _slice_rows(scores.carr_fft, vel_start[cs], carr_win)
    flip_used = scores.flip_used
    if mesh is not None and mesh.chan_split(c):
        packed = torch.cat([torch.view_as_real(code_w).flatten(1),
                            torch.view_as_real(carr_w).flatten(1),
                            flip_used[:, None].float()], dim=1)
        full = mesh.gather_chan(packed[None], c)[0]         # [C, K]
        nc, nv = 2 * code_win, 2 * carr_win
        code_w = torch.view_as_complex(
            full[:, :nc].reshape(c, code_win, 2).contiguous())
        carr_w = torch.view_as_complex(
            full[:, nc:nc + nv].reshape(c, carr_win, 2).contiguous())
        flip_used = full[:, -1] != 0
    pos_scores, pos_arg, vel_scores, vel_arg = score_manifolds(
        code_w, carr_w, params, d_enu, dt_m, dv_enu, dtdot,
        l_power=l_power, interp=interp, mesh=mesh)
    return pos_scores, pos_arg, vel_scores, vel_arg, flip_used


def nominal_code_fft(chips: np.ndarray, fs: float, s: int) -> np.ndarray:
    """Host-side [C, S] FFT of each channel's nominal code replica
    (zero code phase, nominal chipping rate), float64 -> complex64."""
    t = np.arange(s) / fs
    idx = np.mod(np.floor(t * F_CA), L_CA).astype(np.int64)
    repl = chips[:, idx].astype(np.float64)          # [C, S]
    return np.fft.fft(repl, axis=-1).astype(np.complex64)


def replica_shift_parts(rc: np.ndarray, dfc: np.ndarray, fs: float,
                        T: float, s: int):
    """Split the replica shift m = (rc + dfc*T/2) * fs/F_CA into int32 +
    float32 parts (host float64)."""
    m = (rc + dfc * (T / 2.0)) * (fs / F_CA)
    m = np.mod(m, s)
    m_int = np.floor(m)
    m_frac = (m - m_int).astype(np.float32)
    return m_int.astype(np.int32), m_frac
