"""The plain reference of the deep (weak-signal) acquisition search
(float64, PyTorch).

- `deep_search`: the search magnitudes [P, D, P0] of a capture: for each
  Doppler the carrier wiped off in float64, the baseband folded `n_coh`
  code periods at a time into segments, each segment's circular
  correlation with every PRN's one-period code (by complex128 FFTs), the
  magnitudes summed over the segments (noncoherently).
- `peak`: the cell a search picks from its magnitudes (the first largest
  per-code maximum, then the first Doppler at that code phase) and its
  detection statistic z, the peak's deviation above the per-code maxima
  outside the peak's neighbourhood.
- `fine_power`: the fine carrier search about a coarse cell: each
  segment's zero-padded carrier spectrum, with the code at that cell wiped
  off, within one grid step of its Doppler (a direct DFT with
  integer-exact phases), the power summed over the segments.

`round_to` = torch.float16 makes the control: the time table, the
wiped-off baseband and the folds in float16, the precision below the
float32 that the configuration states for the device. Nothing here imports
the program.
"""

from __future__ import annotations

import numpy as np
import torch

F_CA = 1.023e6
L_CA = 1023
DOPPLER_CHUNK = 8        # Dopplers wiped off at a time


def period_codes(chips: np.ndarray, fs: float) -> np.ndarray:
    """One code period of each PRN sampled at fs: [P, P0] +/-1, the chip
    of sample k floor(k F_CA / fs)."""
    period = int(round(fs * 1e-3))
    idx = np.mod(np.floor(np.arange(period) / fs * F_CA), L_CA).astype(int)
    return np.asarray(chips, np.float64)[:, idx]


def _rounded(x: torch.Tensor, round_to):
    if round_to is None:
        return x
    if x.is_complex():
        return torch.complex(x.real.to(round_to).double(),
                             x.imag.to(round_to).double())
    return x.to(round_to).double()


def deep_search(samples, chips, fs: float, dopplers, n_coh: int, device,
                round_to=None) -> torch.Tensor:
    """Search magnitudes [P, D, P0] (float64) of `samples` (complex, the
    whole segments of n_coh periods that it holds) against the chip table
    `chips` [P, 1023] over `dopplers` [D] Hz."""
    period = int(round(fs * 1e-3))
    k_seg = len(samples) // (n_coh * period)
    s = k_seg * n_coh * period
    x = torch.as_tensor(np.asarray(samples[:s], np.complex128),
                        device=device)
    t = _rounded(torch.arange(s, dtype=torch.float64, device=device) / fs,
                 round_to)
    dop = torch.as_tensor(np.asarray(dopplers, np.float64), device=device)
    folds = []
    for d0 in range(0, dop.shape[0], DOPPLER_CHUNK):
        ang = (-2.0 * np.pi) * dop[d0:d0 + DOPPLER_CHUNK, None] * t[None, :]
        bb = _rounded(x[None, :] * torch.polar(torch.ones_like(ang), ang),
                      round_to)
        folds.append(_rounded(
            bb.reshape(-1, k_seg, n_coh, period).sum(dim=2), round_to))
    f_fft = torch.fft.fft(torch.cat(folds), dim=-1)       # [D, K, P0]
    codes = torch.as_tensor(period_codes(chips, fs), device=device)
    # r[tau] = sum_q f[q] code[q - tau] (circular), in complex128
    code_fft_c = torch.conj(torch.fft.fft(codes.to(torch.complex128),
                                          dim=-1))
    return torch.stack([torch.fft.ifft(f_fft * cf, dim=-1).abs().sum(dim=1)
                        for cf in code_fft_c])            # [P, D, P0]


def peak(mags: np.ndarray, fs: float) -> tuple[int, int, float]:
    """(code index, Doppler index, z) of one PRN's magnitudes [D, P0]."""
    period = mags.shape[1]
    max_percode = mags.max(axis=0)
    code_idx = int(np.argmax(max_percode))
    dopp_idx = int(np.argmax(mags[:, code_idx]))
    pos = np.arange(period)
    dist = np.minimum(np.abs(pos - code_idx), period - np.abs(pos - code_idx))
    floor = max_percode[dist > int(np.ceil(fs / F_CA))]
    z = (max_percode[code_idx] - floor.mean()) / max(floor.std(), 1e-12)
    return code_idx, dopp_idx, float(z)


def fine_layout(fs: float, n_coh: int, dopplers):
    """(samples of a segment, transform length, Hz a bin, the bins either
    side of the coarse Doppler searched (one grid step), the search's
    signed bins [lo, hi))."""
    s_fine = n_coh * int(round(fs * 1e-3))
    n_fft = 8 * (1 << s_fine.bit_length())
    bin_hz = fs / n_fft
    step = (float(np.median(np.diff(np.sort(dopplers))))
            if len(dopplers) > 1 else 500.0 / n_coh)
    band = (int(np.floor(np.min(dopplers) / bin_hz)),
            int(np.ceil(np.max(dopplers) / bin_hz)) + 1)
    return s_fine, n_fft, bin_hz, int(np.ceil(step / bin_hz)), band


def fine_power(samples, chip_row, rc: float, fc: float, f_coarse: float,
               fs: float, n_coh: int, dopplers, device):
    """(signed bins [J], power [J]) of the fine carrier search about the
    coarse Doppler f_coarse: every whole segment's mean-removed samples
    times the code replica at code phase rc [chips] and rate fc
    [chips/s], its zero-padded spectrum at the bins within one grid step
    of f_coarse and inside the search's band (a direct DFT with
    integer-exact phases), the power summed over the segments."""
    s_fine, n_fft, bin_hz, half, band = fine_layout(fs, n_coh, dopplers)
    k_seg = len(samples) // s_fine
    s = k_seg * s_fine
    x = np.asarray(samples[:s], np.complex128).reshape(k_seg, s_fine)
    x = x - x.mean(axis=1, keepdims=True)
    t = np.arange(s) / fs
    idx = np.mod(np.floor(t * fc + rc), L_CA).astype(int)
    y = torch.as_tensor(x * np.asarray(chip_row, np.float64)[idx].reshape(
        k_seg, s_fine), device=device)
    centre = int(np.round(f_coarse / bin_hz))
    k = np.arange(centre - half, centre + half + 1)
    k = k[(k >= band[0]) & (k < band[1])]
    kt = torch.as_tensor(k, device=device)
    n = torch.arange(s_fine, dtype=torch.int64, device=device)
    ph = torch.remainder(kt[:, None] * n[None, :], n_fft).double()
    w = torch.polar(torch.ones_like(ph), ph * (-2.0 * np.pi / n_fft))
    spec = y @ w.T                                        # [K, J]
    return k, (spec.abs() ** 2).sum(dim=0).cpu().numpy()
