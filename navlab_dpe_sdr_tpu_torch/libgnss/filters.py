"""Generic single-parameter digital filters.

Standalone counterpart of the reference's pygnss libgnss/filters.py
(RunningAverageFilter, Bilinear/BoxcarIntegrator, LowPassFilter:8-161,
FIRfilter:163-197). Re-designed functionally: every filter is a pure
`update(state, x) -> (state', y)` over an explicit state, so the same code
runs vectorized over channel batches on host numpy or on device tensors
(no Python-object state to carry). Thin stateful wrappers
reproduce the reference's OO call surface for host-side use.

Equations (Misra & Enge p.478; Kaplan & Hegarty pp.181, 234):
  boxcar:    h' = h + k*x;          y = h'
  bilinear:  h' = h + k*x;          y = (h + h')/2
  low-pass:  h' = k*x + (1-k)*h;    y = h'
  running avg over N: y = mean of the last N samples (ring state)
  FIR: streaming 'valid' convolution with a (b)-tap kernel (overlap carry)

The port's own copy of navlab_dpe_sdr_tpu/libgnss/filters.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


# -- functional cores ------------------------------------------------------

def boxcar_update(h, x, k: float):
    """(h', y): boxcar z-transform integrator."""
    h_new = h + k * x
    return h_new, h_new


def bilinear_update(h, x, k: float):
    """(h', y): bilinear z-transform integrator."""
    h_new = h + k * x
    return h_new, (h_new + h) * 0.5


def lowpass_update(h, x, k: float):
    """(h', y): 1st-order IIR low-pass, y = k*x + (1-k)*y_prev."""
    h_new = k * x + (1.0 - k) * h
    return h_new, h_new


class RunAvgState(NamedTuple):
    ring: np.ndarray   # [..., N] last N samples
    avg: np.ndarray    # [...] current mean


def running_average_init(n: int, average=0.0, shape=()) -> RunAvgState:
    avg = np.broadcast_to(np.asarray(average, np.float64), shape).copy()
    ring = np.repeat(avg[..., None], n, axis=-1).copy()
    return RunAvgState(ring=ring, avg=avg)


def running_average_update(state: RunAvgState, x) -> tuple[RunAvgState, object]:
    """(state', y): mean of the last N samples after pushing x.

    Works on numpy state; on the device the same expression runs on a
    tensor ring with torch.cat (see ops/tracking.py SNR rings).
    """
    n = state.ring.shape[-1]
    avg = state.avg + (x - state.ring[..., 0]) / n
    ring = np.concatenate([state.ring[..., 1:],
                           np.asarray(x)[..., None]], axis=-1)
    return RunAvgState(ring=ring, avg=avg), avg


class FIRState(NamedTuple):
    b: np.ndarray      # taps
    tail: np.ndarray   # last len(b)-1 inputs (streaming carry)


def fir_init(b) -> FIRState:
    b = np.asarray(b)
    return FIRState(b=b, tail=np.zeros(len(b) - 1, dtype=b.dtype))


def fir_update(state: FIRState, block) -> tuple[FIRState, np.ndarray]:
    """(state', y): streaming 'valid' convolution over a sample block
    (reference FIRfilter.update, filters.py:192-197)."""
    block = np.asarray(block)
    ext = np.concatenate([state.tail, block])
    out = np.convolve(state.b, ext, mode="valid")
    ntail = len(state.b) - 1
    tail = ext[len(ext) - ntail:] if ntail else state.tail
    return FIRState(b=state.b, tail=tail), out


def design_lowpass_fir(num_taps: int, fs: float, f_cut: float) -> np.ndarray:
    """Hamming-windowed-sinc low-pass taps (scipy-free remez stand-in for
    the reference's front-end filter, filters.py:168-189)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    fc = f_cut / fs
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.hamming(num_taps)
    return h / np.sum(h)


# -- reference-API stateful wrappers ---------------------------------------

class RunningAverageFilter:
    """Average of the last N samples (reference filters.py:8-57)."""

    def __init__(self, N: int, average: float = 0.0):
        self.reset(N=N, average=average)

    def reset(self, N: int | None = None, average: float = 0.0):
        self.N = N if N is not None else self.N
        self._st = running_average_init(self.N, average)
        self.average = float(self._st.avg)

    def update(self, xn: float) -> float:
        self._st, y = running_average_update(self._st, xn)
        self.average = float(y)
        return self.average


class _SingleParam:
    def __init__(self, k: float, h: float = 0.0):
        self.reset(h=h, k=k)

    def reset(self, h: float = 0.0, k: float | None = None):
        self.h = h
        if k is not None:
            self.k = k


class BoxcarIntegrator(_SingleParam):
    def update(self, xn: float) -> float:
        self.h, y = boxcar_update(self.h, xn, self.k)
        return y


class BilinearIntegrator(_SingleParam):
    def update(self, xn: float) -> float:
        self.h, y = bilinear_update(self.h, xn, self.k)
        return y


class LowPassFilter(_SingleParam):
    def update(self, xn: float) -> float:
        self.h, y = lowpass_update(self.h, xn, self.k)
        return y


class FIRfilter:
    """Streaming FIR over sample blocks (reference filters.py:163-197)."""

    def __init__(self, b):
        self._st = fir_init(b)

    @property
    def b(self):
        return self._st.b

    def update(self, curr_array):
        self._st, out = fir_update(self._st, curr_array)
        return out
