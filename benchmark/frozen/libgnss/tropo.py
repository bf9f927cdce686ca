"""Tropospheric delay: standard-atmosphere two-term elevation model.

The reference carries this as dead code (pygnss satpos.py:268-277,
tropospheric_correction_standard, never called); here it is live as an
optional pseudorange correction alongside the Klobuchar iono model — see
libgnss.naveng.atmospheric_delays_m and models.dpe (DPEConfig.tropo).

The benchmark's frozen copy of navlab_dpe_sdr_tpu_torch/libgnss/tropo.py
(host float64 numpy, no torch): part of the yardstick, which imports nothing
of the program, so that a change to the program cannot move it.
"""

from __future__ import annotations

import numpy as np


def tropo_delay_m(el_rad) -> np.ndarray:
    """Tropospheric group delay [m] for satellite elevation(s) [rad].

    Standard-atmosphere dry + wet terms with the usual (sin sqrt(el^2+c))
    mapping; ~2.4 m at zenith, ~25 m at 5 degrees.
    """
    el = np.asarray(el_rad, dtype=np.float64)
    dry = 2.312 / np.sin(np.sqrt(el * el + 1.904e-3))
    wet = 0.084 / np.sin(np.sqrt(el * el + 0.6854e-3))
    return dry + wet
