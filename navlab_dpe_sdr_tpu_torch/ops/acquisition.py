"""FFT acquisition on torch devices: coarse Doppler x code-phase search +
fine frequency.

Port of navlab_dpe_sdr_tpu/ops/acquisition.py (f32 / complex64 on
`torch.fft`): circular correlation by FFT along the sample axis for every
(PRN, Doppler) pair, the reference's peak metrics (cppr, cppm) and found
threshold, then a zero-padded carrier FFT per PRN for the fine frequency.
The JAX package runs these FFTs in XLA, outside any Pallas kernel, so they
are cuFFT calls here. PRNs are searched one at a time (the JAX search holds
[P, D, S] complex64 at once): the same values in 1/P of the memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import F_CA, L_CA
from ..device import resolve_device

# Doppler search grids (reference correlator.py:13-14)
DOPPLER_COHERENT = np.arange(-62, 63) * 100.0      # 125 bins x 100 Hz
DOPPLER_NONCOHERENT = np.arange(-12, 13) * 500.0   # 25 bins x 500 Hz

_TWO_PI = 2.0 * np.pi


@dataclass
class AcqResult:
    prn: int
    found: bool
    rc: float     # code phase [chips]
    ri: float     # carrier phase [cycles]
    fc: float     # code frequency [chips/s]
    fi: float     # carrier Doppler [Hz]
    cppr: float   # peak-to-second-peak ratio
    cppm: float   # peak-to-mean ratio (found iff > threshold)


def _coarse_search(samples, code_s, dopplers, time_idc, n_blocks: int,
                   coherent: bool):
    """Search powers [P, D, S/n_blocks] (the JAX `_coarse_kernel`).

    samples [S] complex64; code_s [P, S] f32 +/-1 sampled replicas;
    dopplers [D] f32; time_idc [S] f32."""
    ang = (-_TWO_PI) * dopplers[:, None] * time_idc[None, :]
    wipeoff = torch.polar(torch.ones_like(ang), ang)       # exp(-2 pi i f t)
    bb = samples[None, :] * wipeoff                        # [D, S]
    s = bb.shape[-1]
    sub = s // n_blocks
    out = []
    if coherent or n_blocks == 1:
        bb_fft = torch.fft.fft(bb, dim=-1)
        for p in range(code_s.shape[0]):
            code_fft_c = torch.conj(torch.fft.fft(code_s[p].to(bb.dtype)))
            corr = torch.fft.ifft(bb_fft * code_fft_c[None], dim=-1)
            if n_blocks > 1:
                corr = corr.reshape(corr.shape[0], n_blocks, sub).sum(dim=1)
            out.append(torch.abs(corr))
    else:
        bb_fft = torch.fft.fft(bb.reshape(bb.shape[0], n_blocks, sub),
                               dim=-1)
        for p in range(code_s.shape[0]):
            code_fft_c = torch.conj(torch.fft.fft(code_s[p, :sub].to(bb.dtype)))
            corr = torch.fft.ifft(bb_fft * code_fft_c, dim=-1)
            out.append(torch.abs(corr).sum(dim=1))
    return torch.stack(out)


def _peak_metrics(result, mask_halfwidth: int):
    """Per-PRN (code_idx, dopp_idx, peak, cppr, cppm), each [P] (the JAX
    `_peak_metrics`: 10 %-trimmed mean of the per-code maxima with the
    peak's neighbourhood masked)."""
    max_percode = result.max(dim=1).values                 # [P, S']
    code_idx = torch.argmax(max_percode, dim=1)            # first occurrence
    at_code = torch.gather(
        result, 2, code_idx[:, None, None].expand(-1, result.shape[1], 1))
    dopp_idx = torch.argmax(at_code[..., 0], dim=1)
    peak = max_percode.max(dim=1).values

    sp = max_percode.shape[1]
    pos = torch.arange(sp, device=result.device)[None, :]
    dist = torch.abs(pos - code_idx[:, None])
    dist = torch.minimum(dist, sp - dist)
    masked = torch.where(dist <= mask_halfwidth,
                         torch.zeros_like(max_percode), max_percode)
    cppr = peak / masked.max(dim=1).values
    srt = torch.sort(masked, dim=1).values
    lo = int(np.ceil(sp * 0.05))
    hi = int(np.floor(sp * 0.95))
    cppm = peak / srt[:, lo:hi].mean(dim=1)
    return code_idx, dopp_idx, peak, cppr, cppm


def _fine_freq(samples, code_repl, carr_fftpts: int, f_lo: float,
               f_hi: float):
    """(fftshifted bin index [float], phase [cycles]) of the strongest
    carrier bin inside [f_lo, f_hi] after code wipeoff (the JAX
    `_fine_freq_kernel`)."""
    bb = (samples - samples.mean()) * code_repl
    spec = torch.fft.fftshift(torch.fft.fft(bb, n=carr_fftpts))
    n = carr_fftpts
    freqs = (torch.arange(n, device=samples.device) - n // 2).float()
    keep = (freqs >= float(np.float32(f_lo))) & (freqs <= float(np.float32(f_hi)))
    mag = torch.where(keep, torch.abs(spec), torch.zeros_like(freqs))
    idx = torch.argmax(mag)
    phase = torch.angle(spec[idx]).cpu() / _TWO_PI      # f32, as in JAX
    return float(freqs[idx]), float(phase)


def acquire(samples: np.ndarray, prns, fs: float, fcaid: float,
            dopplers: np.ndarray | None = None, coherent: bool = True,
            code_table: np.ndarray | None = None, threshold: float = 2.0,
            device="cuda") -> list[AcqResult]:
    """Full acquisition for a PRN list over one complex sample window of
    n x 1 ms (typically 10 ms), on `device` (a missing CUDA device
    raises). Same contract as the JAX `acquire`."""
    from ..libgnss.cacode import ca_table

    dev = resolve_device(device)
    samples = np.asarray(samples)
    s = samples.shape[0]
    n_blocks = int(round(s / fs / 1e-3))
    if dopplers is None:
        dopplers = DOPPLER_COHERENT if coherent else DOPPLER_NONCOHERENT
    time_idc = np.arange(s) / fs
    code_idc = time_idc * F_CA

    table = ca_table(prns) if code_table is None else code_table
    chip_idx = np.mod(np.floor(code_idc), L_CA).astype(np.int64)
    code_s = table[:, chip_idx]                            # [P, S]

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    sx = torch.from_numpy(samples.astype(np.complex64)).to(dev)
    t_dev = f32(time_idc)
    result = _coarse_search(sx, f32(code_s), f32(dopplers), t_dev, n_blocks,
                            coherent)
    mask_hw = int(np.ceil(fs / F_CA))
    code_idx, dopp_idx, _, cppr, cppm = (
        x.cpu().numpy() for x in _peak_metrics(result, mask_hw))

    carr_fftpts = 8 * (1 << s.bit_length())
    bin_hz = fs / carr_fftpts
    out = []
    for i, prn in enumerate(prns):
        rc = L_CA - code_idc[code_idx[i]]
        fi = float(dopplers[dopp_idx[i]])
        fc = F_CA + fcaid * fi
        repl_idx = np.mod(np.floor(time_idc * fc + rc), L_CA).astype(np.int64)
        fbin, ri = _fine_freq(sx, f32(table[i, repl_idx]), carr_fftpts,
                              float(np.min(dopplers)) / bin_hz,
                              float(np.max(dopplers)) / bin_hz)
        fi = fbin * bin_hz
        fc = F_CA + fcaid * fi
        out.append(AcqResult(prn=int(prn), found=bool(cppm[i] > threshold),
                             rc=float(rc), ri=float(ri), fc=float(fc),
                             fi=float(fi), cppr=float(cppr[i]),
                             cppm=float(cppm[i])))
    return out
