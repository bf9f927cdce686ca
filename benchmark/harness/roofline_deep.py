"""The yardstick of the deep acquisition search: the work of one search,
counted from its shapes, for the least time of harness/roofline.py.

Operations: a complex FFT of N points counts 5 N log2 N; the carrier
wipe-off 7 a (Doppler, sample) (the angle's product, four products and
two sums of the complex rotation), the fold 2 a (Doppler, sample); the
correlation of a segment with a PRN's code 6 a bin (the complex product
with the code's spectrum), its magnitude 3 a lag and its sum over the
segments 1 a lag; the fine search, for each PRN, 2 a sample for the code
wipe-off and 8 a (sample, bin) for every segment's zero-padded spectrum at
the bins within one Doppler step (500 / n_coh Hz) of the coarse Doppler.
Bytes: the capture's samples and the time table read once, the search's
magnitudes written once, and each PRN's replica read once."""

from __future__ import annotations

import math


def fft_ops(n: int) -> float:
    return 5.0 * n * math.log2(n)


def deep_search_work(n_samples: int, n_prns: int, n_dopplers: int,
                     n_coh: int, period: int):
    """(operations, bytes) of one deep search over n_samples complex
    samples (its whole segments of n_coh periods of `period` samples),
    n_prns PRNs and n_dopplers Dopplers."""
    k_seg = n_samples // (n_coh * period)
    s = k_seg * n_coh * period
    d, p = n_dopplers, n_prns
    ops = d * s * (7 + 2)                               # wipe-off, fold
    ops += d * k_seg * fft_ops(period)                  # the folds' FFTs
    ops += p * d * k_seg * (6 * period + fft_ops(period) + 3 * period
                            + period)                   # per PRN
    n_fft = 8 * (1 << (n_coh * period).bit_length())
    bin_hz = 1e3 * period / n_fft
    bins = 2 * math.ceil(500.0 / n_coh / bin_hz) + 1
    ops += p * s * (2 + 8 * bins)                       # the fine search
    nbytes = s * (4 + 4 + 4)                            # re, im, time
    nbytes += 4 * p * d * period                        # the magnitudes
    nbytes += 4 * p * s                                 # the replicas
    return float(ops), float(nbytes)
