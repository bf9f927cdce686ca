"""FFT acquisition on torch devices: coarse Doppler x code-phase search +
fine frequency.

Port of navlab_dpe_sdr_tpu/ops/acquisition.py (f32 / complex64 on
`torch.fft`): circular correlation by FFT along the sample axis for every
(PRN, Doppler) pair, the reference's peak metrics (cppr, cppm) and found
threshold, then a zero-padded carrier FFT per PRN for the fine frequency.
The JAX package runs these FFTs in XLA, outside any Pallas kernel, so they
are cuFFT calls here. PRNs are searched one at a time (the JAX search holds
[P, D, S] complex64 at once): the same values in 1/P of the memory.

`acquire_deep` is the weak-signal search (the semantics of the JAX
`acquire_real(n_coh_ms=...)`, ops/acquisition_real.py:47-90, :136-237, whose
all-real engine itself is not ported): coherent folds of n_coh_ms code
periods per segment, a circular code correlation (by FFT here, by circulant
matmul there), magnitudes summed over the segments, detection on the
deviation-normalised peak, and the fine frequency from every segment's
carrier spectrum about the coarse Doppler, summed noncoherently (where the
JAX search takes the first segment's alone). The [D, S] baseband is formed
a chunk of Dopplers at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..constants import F_CA, L_CA
from ..device import resolve_device

# Doppler search grids (reference correlator.py:13-14)
DOPPLER_COHERENT = np.arange(-62, 63) * 100.0      # 125 bins x 100 Hz
DOPPLER_NONCOHERENT = np.arange(-12, 13) * 500.0   # 25 bins x 500 Hz
# what ScalarReceiver.acquire and the CLI's `acquire --engine real` raise
REAL_ENGINE_REFUSAL = (
    "engine='real' (the all-real TPU acquisition engine, "
    "ops/acquisition_real) is not ported by design: ROADMAP "
    "'Not to port'; engine='fft' searches the same grid, and "
    "deep_ms > 0 runs the deep search on torch.fft")

_TWO_PI = 2.0 * np.pi
_TWO_PI32 = float(np.float32(_TWO_PI))


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


# Dopplers wiped off at a time by the deep search: at 400 ms and 241 Dopplers
# the whole [D, S] baseband would be 1.9 GB in f32.
_DOPPLER_CHUNK = 32


def deep_dopplers(n_coh_ms: int) -> np.ndarray:
    """The deep search's default grid: half a bin of the coherent length
    (500 / n_coh_ms Hz) over +/-6 kHz."""
    step = 500.0 / n_coh_ms
    n_side = int(np.ceil(6000.0 / step))
    return np.arange(-n_side, n_side + 1) * step


def _deep_coarse(re, im, t, code_fft_c, dopplers, n_coh: int, period: int):
    """Search magnitudes [P, D, period]: per Doppler the wiped-off baseband
    folded n_coh periods at a time into K segments, each correlated with
    every PRN's one-period code (FFT), |.| summed over the segments."""
    k_seg = re.shape[0] // (n_coh * period)
    out = []
    for d0 in range(0, dopplers.shape[0], _DOPPLER_CHUNK):
        dopp = dopplers[d0:d0 + _DOPPLER_CHUNK, None]
        ang = (_TWO_PI32 * dopp) * t[None, :]
        wc, ws = torch.cos(ang), torch.sin(ang)
        bb_re = re[None, :] * wc + im[None, :] * ws            # [d, S]
        bb_im = im[None, :] * wc - re[None, :] * ws
        del ang, wc, ws
        d = bb_re.shape[0]
        f = torch.complex(
            bb_re.reshape(d, k_seg, n_coh, period).sum(dim=2),
            bb_im.reshape(d, k_seg, n_coh, period).sum(dim=2))  # [d, K, P0]
        del bb_re, bb_im
        f_fft = torch.fft.fft(f, dim=-1)
        mags = [torch.abs(torch.fft.ifft(f_fft * cf, dim=-1)).sum(dim=1)
                for cf in code_fft_c]                           # P x [d, P0]
        out.append(torch.stack(mags))
    return torch.cat(out, dim=1)


def _deep_fine(re, im, chips, rc, fc, f_coarse, fs: float, s_fine: int,
               n_fft: int, half: int, band):
    """The deep search's fine carrier frequency of each PRN: every whole
    segment of s_fine samples, mean removed, times the PRN's code replica
    at its coarse code phase rc [chips] and rate fc [chips/s], evaluated
    at the bins of its zero-padded n_fft-point spectrum within `half` bins
    of its coarse Doppler f_coarse (inside `band`, the search's bins
    [lo, hi)), its power summed over the segments (noncoherently: the
    segments' nav bits differ). Returns (signed bin [P], the first
    segment's phase there [cycles]), read back in one fetch."""
    dev = re.device
    k_seg = re.shape[0] // s_fine
    s = k_seg * s_fine
    x = torch.complex(re[:s], im[:s]).reshape(k_seg, s_fine)
    x = x - x.mean(dim=1, keepdim=True)
    rc_t = torch.tensor(rc, dtype=torch.float64, device=dev)
    fc_t = torch.tensor(fc, dtype=torch.float64, device=dev)
    t = torch.arange(s, dtype=torch.float64, device=dev) / fs
    idx = torch.remainder(torch.floor(t[None, :] * fc_t[:, None]
                                      + rc_t[:, None]), L_CA).long()
    repl = torch.gather(chips, 1, idx)                     # [P, S]
    y = x[None] * repl.reshape(len(rc), k_seg, s_fine)      # [P, K, s_fine]
    bin_hz = fs / n_fft
    centre = np.round(np.asarray(f_coarse) / bin_hz).astype(np.int64)
    k = torch.from_numpy(centre[:, None]
                         + np.arange(-half, half + 1)[None, :]).to(dev)
    n = torch.arange(s_fine, dtype=torch.int64, device=dev)
    ang = torch.remainder(k[:, :, None] * n, n_fft).float() * float(
        np.float32(-2.0 * np.pi / n_fft))
    w = torch.polar(torch.ones_like(ang), ang)              # [P, J, s_fine]
    spec = y @ w.transpose(1, 2)                            # [P, K, J]
    power = (spec.real ** 2 + spec.imag ** 2).sum(dim=1)
    power = torch.where((k >= band[0]) & (k < band[1]), power,
                        torch.full_like(power, -1.0))
    j = torch.argmax(power, dim=1)
    first = spec[torch.arange(len(rc), device=dev), 0, j]
    got = torch.stack([torch.gather(k, 1, j[:, None])[:, 0].double(),
                       torch.angle(first).double() / _TWO_PI]).cpu().numpy()
    return got[0].astype(np.int64), got[1]


def acquire_deep(samples: np.ndarray, prns, fs: float, fcaid: float,
                 n_coh_ms: int = 10, dopplers: np.ndarray | None = None,
                 device="cuda") -> list[AcqResult]:
    """Deep (weak-signal) acquisition over one long complex capture, on
    `device` (a missing CUDA device raises): n_coh_ms coherent folds summed
    noncoherently over however many whole segments the capture holds (the
    capture is trimmed to them). Same results contract as the JAX
    `acquire_real(..., n_coh_ms=n_coh_ms)`: found is the deviation-normalised
    peak z = (peak - mean) / std of the per-code maxima outside
    +/-ceil(fs / F_CA) samples of the peak, z > 8. The fine frequency is
    searched about the coarse Doppler, one grid step either side, in the
    segments' zero-padded carrier spectra after code wipeoff, their power
    summed over the segments (`_deep_fine`; a coherent transform across
    nav-bit boundaries would self-cancel). The JAX search takes the first
    segment's spectrum alone over the whole Doppler band, whose strongest
    noise bin beats a 27 dB-Hz carrier: kHz off for most channels.
    The baseband is wiped off _DOPPLER_CHUNK Dopplers at a time."""
    from ..libgnss.cacode import ca_table

    dev = resolve_device(device)
    samples = np.asarray(samples)
    period = int(round(fs * 1e-3))
    n_coh = int(n_coh_ms)
    n_seg = samples.shape[0] // (n_coh * period)
    if n_seg < 1:
        raise ValueError("capture shorter than one coherent segment")
    samples = samples[:n_seg * n_coh * period]
    if dopplers is None:
        dopplers = deep_dopplers(n_coh)
    s = samples.shape[0]
    t = np.arange(s) / fs

    tab = ca_table(prns)
    pidx = np.mod(np.floor(np.arange(period) / fs * F_CA), L_CA).astype(int)
    period_codes = tab[:, pidx].astype(np.float32)          # [P, P0]

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    re, im = f32(samples.real), f32(samples.imag)
    t32 = f32(t)
    code_fft_c = torch.conj(torch.fft.fft(f32(period_codes).to(
        torch.complex64), dim=-1))                         # [P, P0]
    with tracing.span("scalar.acquire.deep.coarse"):
        result = _deep_coarse(re, im, t32, code_fft_c, f32(dopplers), n_coh,
                              period).cpu().numpy()

    s_fine = n_coh * period
    carr_fftpts = 8 * (1 << s_fine.bit_length())
    bin_hz = fs / carr_fftpts
    band = (int(np.floor(np.min(dopplers) / bin_hz)),
            int(np.ceil(np.max(dopplers) / bin_hz)) + 1)
    step = (float(np.median(np.diff(np.sort(dopplers))))
            if len(dopplers) > 1 else 500.0 / n_coh)
    with tracing.span("scalar.acquire.deep.fine"):
        mask_hw = int(np.ceil(fs / F_CA))
        code_idc_period = np.arange(period) / fs * F_CA
        pos = np.arange(period)
        cells = []
        for i in range(len(prns)):
            r = result[i]
            max_percode = r.max(axis=0)
            code_idx = int(np.argmax(max_percode))
            dopp_idx = int(np.argmax(r[:, code_idx]))
            peak = max_percode[code_idx]
            dist = np.minimum(np.abs(pos - code_idx),
                              period - np.abs(pos - code_idx))
            masked = np.where(dist <= mask_hw, 0.0, max_percode)
            srt = np.sort(masked)
            floor = max_percode[dist > mask_hw]
            cells.append(dict(
                rc=L_CA - code_idc_period[code_idx],
                f_coarse=float(dopplers[dopp_idx]),
                cppr=peak / masked.max(),
                cppm=peak / srt[int(period * 0.05):int(period * 0.95)].mean(),
                z=(peak - floor.mean()) / max(floor.std(), 1e-12)))
        fbin, phase = _deep_fine(
            re, im, torch.from_numpy(tab.astype(np.float32)).to(dev),
            [c["rc"] for c in cells],
            [F_CA + fcaid * c["f_coarse"] for c in cells],
            [c["f_coarse"] for c in cells], fs, s_fine, carr_fftpts,
            int(np.ceil(step / bin_hz)), band)
        out = []
        for i, (prn, c) in enumerate(zip(prns, cells)):
            fi = fbin[i] * bin_hz
            out.append(AcqResult(prn=int(prn), found=bool(c["z"] > 8.0),
                                 rc=float(c["rc"]), ri=float(phase[i]),
                                 fc=float(F_CA + fcaid * fi), fi=float(fi),
                                 cppr=float(c["cppr"]),
                                 cppm=float(c["cppm"])))
    return out
