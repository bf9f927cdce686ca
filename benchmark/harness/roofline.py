"""The yardstick of the kernels: the card's peaks and the work of a call.

The operation counts are those the port's kernels are held to on the card
(chip_smoke.py: `OPS_PER_POINT_CHANNEL`, `OPS_K5`, `k5_bound`), counted
from the plain algebra of each computation and its shapes, so the same
work is counted whatever implements it. A fused multiply-add counts as
two operations. Bytes count each input read once and each output written
once.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (dense, at the 700 W limit): float32
# outside the tensor cores, and HBM3.
PEAK_F32 = 67e12        # operations / s
PEAK_BYTES = 3.35e12    # bytes / s

# One grid point of one channel of the scorer: line-of-sight projection 5,
# range 1 (5 with the position manifold's curvature term), index 3,
# round/clip/offset 4, the per-tap form a + d (b + d c) 4, the channel sum 1.
OPS_PER_POINT_CHANNEL = {"pos": 22, "vel": 18}

# The windowed correlator, per (block, channel): the folds 8 a sample, and
# 8 more a sample of the periods after the nav-bit boundary's; the lags 16
# a (lag, tau); the lag-0 sums 8 a tau; the wipe 4 a sample; the carrier
# DFT 8 a (bin, sample).
OPS_K5 = dict(fold=8, tail=8, lag=16, lag0=8, wipe=4, dft=8)


def least_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the float32
    peak or bytes over the memory rate, whichever is longer."""
    return max(ops / PEAK_F32, nbytes / PEAK_BYTES)


def scorer_work(n: int, c: int, w: int, points: int, manifold: str):
    """(operations, bytes) of scoring n blocks of c channels (windows of
    width w) over `points` grid points of one manifold, to a best and an
    index per block."""
    ops = n * c * points * OPS_PER_POINT_CHANNEL[manifold]
    # windows, line of sight [3], centre, coefficient (and r0), offsets
    # [3] + [1] a point; out: best and index
    per_nc = w + 3 + 2 + (1 if manifold == "pos" else 0)
    nbytes = 4 * (n * c * per_nc + 4 * points + 2 * n)
    return ops, nbytes


def correlator_work(n: int, c: int, s: int, period: int, n_periods: int,
                    code_win: int, carr_win: int, tail_samples: int,
                    complex_out: bool):
    """(operations, bytes) of one windowed-correlator call over n blocks of
    s samples and c channels; `tail_samples` sums, over the (block,
    channel) pairs, the samples of the code periods after the one holding
    the nav-bit boundary."""
    o = OPS_K5
    ops = (n * c * ((o["fold"] + o["wipe"] + o["dft"] * carr_win) * s
                    + (o["lag"] * code_win + o["lag0"]) * period)
           + o["tail"] * tail_samples)
    wins = (2 if complex_out else 1) * (code_win + carr_win)
    # int16 I/Q in, the chip table, the time table, six parameter rows a
    # (block, channel); the float32 windows and the one-byte flips out
    nbytes = (4 * n * s + 4 * c * 1023 + 4 * s + 4 * n * c * (6 + wins)
              + n * c)
    return ops, nbytes


def tail_samples(idx_next, period: int, n_periods: int) -> int:
    """The samples after the nav-bit boundary's code period, summed over
    the (block, channel) pairs of idx_next (samples, S where no bit
    boundary falls in the block)."""
    import torch
    p_b = torch.div(idx_next.long(), period, rounding_mode="floor")
    return int(((n_periods - 1 - p_b).clamp(0, n_periods) * period).sum())
