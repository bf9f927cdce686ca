"""DPE score-window sizing and the per-block manifold geometry (port of
navlab_dpe_sdr_tpu/ops/dpe.py:44-88 and :157).

`auto_windows` is plain numpy, copied verbatim: the window widths are
host-side decisions made once per receiver from the grid geometry. The FFT
engine of the JAX module (batch_correlate, dpe_device_step) is not ported
yet (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import C, F_L1

CODE_WIN = 16   # samples of code_corr kept around each channel's center.
# The position manifold spans ~+/-2 samples (|drange + dt| <~ 250 m at
# 0.00834 samples/m), so 16 leaves 4x margin while quartering the
# score-interpolation weight construction (the VPU-bound hot loop).
CARR_WIN = 48   # carrier FFT bins kept around each channel's center.
# The velocity manifold spans ~+/-15 bins on the reference grids (|dv| +
# |dtdot| <~ 13.5 m/s at 1.1 bins per m/s), leaving ~+/-9 bins (~43 Hz) of
# carrier-prediction margin; the interpolation weight tensor over the grid
# is the HBM-bandwidth bottleneck, so width is traffic.


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
