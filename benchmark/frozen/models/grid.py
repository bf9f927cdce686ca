"""DPE search grids: candidate position-time and velocity-drift manifolds.

Grids are ENU + clock offsets about the current EKF state. Styles:

- "spread":  the 25^4 nonuniform grid PyGNSS actually uses — +/-110 m
  position / +/-132 m clock, +/-6 m/s velocity / +/-3 m/s drift
  (reference receiver.py:995-1026).
- "uniform": evenly spaced n^4 (reference receiver.py:968-993 and CUDARecv
  Uniform grids, batchcorrmanifold.cu:148-316).
- "arthur":  uniform interior with 3x-widened border rings (CUDARecv
  ArthurBasis, batchcorrmanifold.cu:175-246).
- "exponential": center-dense axes with geometric step growth (CUDARecv
  enumerates but never implements this style, gridhelper.h:24-28).
- CSV load (rngrid3-style custom grids, batchcorrmanifold.cu:2422-2448).

The benchmark's frozen copy of navlab_dpe_sdr_tpu_torch/models/grid.py (host
float64 numpy, no torch): part of the yardstick, which imports nothing of
the program, so that a change to the program cannot move it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import C, F_CA, F_L1

_SPREAD_POS = np.array([-22, -19, -16, -13, -10, -7, -6, -5, -4, -3, -2, -1,
                        0, 1, 2, 3, 4, 5, 6, 7, 10, 13, 16, 19, 22],
                       dtype=np.float64)
_SPREAD_VEL = np.arange(-12, 13, dtype=np.float64)

# Reference hard cap: BCM_MAX_GRID_SIZE = 2 * 75^4 total manifold points
# (cudarecv modules/src/batchcorrmanifold.h:17 of the reference). The
# streaming-argmax scorer keeps peak memory independent of grid size, so
# this is a parity guard (and a sanity rail), not a memory limit.
MAX_GRID_POINTS = 2 * 75 ** 4


@dataclass
class Grid:
    """Offsets about the reference state. d_enu [Gp,3] m; dt_m [Gp] m;
    dv_enu [Gv,3] m/s; dtdot [Gv] m/s."""
    d_enu: np.ndarray
    dt_m: np.ndarray
    dv_enu: np.ndarray
    dtdot: np.ndarray

    @property
    def n_pos(self) -> int:
        return self.d_enu.shape[0]

    @property
    def n_vel(self) -> int:
        return self.dv_enu.shape[0]


def _mesh4(axis_pos: np.ndarray, axis_t: np.ndarray):
    """Cartesian product (x, y, z, t) with x fastest-varying last — matches
    the reference's kron/tile layout (receiver.py:999-1007)."""
    n = len(axis_pos)
    z = np.kron(axis_pos, np.ones(n))
    y = np.kron(z, np.ones(n))
    x = np.kron(y, np.ones(n))
    y = np.tile(y, n)
    z = np.tile(z, n * n)
    t = np.tile(axis_t, n * n * n)
    return np.stack([x, y, z], axis=1), t


def spread_grid(scale: float = 1.0) -> Grid:
    d_enu, dt = _mesh4(_SPREAD_POS * 5.0 * scale, _SPREAD_POS * 6.0 * scale)
    dv_enu, dtdot = _mesh4(_SPREAD_VEL * 0.5, _SPREAD_VEL * 0.25)
    return Grid(d_enu=d_enu, dt_m=dt, dv_enu=dv_enu, dtdot=dtdot)


def uniform_grid(n: int = 15, pos_spacing: float | None = None,
                 vel_spacing: float | None = None) -> Grid:
    """Evenly spaced n^4 grids. Defaults reproduce the reference's
    'generate_evenly_spaced': span +/- 0.6 chips of light travel."""
    if 2 * n ** 4 > MAX_GRID_POINTS:   # guard before materializing ~GBs
        raise ValueError(
            f"grid would have {2 * n ** 4} points; cap is 2*75^4 = "
            f"{MAX_GRID_POINTS} (reference BCM_MAX_GRID_SIZE)")
    if pos_spacing is None:
        half = C / F_CA * 2.0 * 0.6
        axis = np.linspace(-half, half, n)
    else:
        axis = (np.arange(n) - (n - 1) / 2.0) * pos_spacing
    if vel_spacing is None:
        vaxis = axis / 20.0
        taxis_dot = np.linspace(-C / F_L1 * 1.2, C / F_L1 * 1.2, n)
    else:
        vaxis = (np.arange(n) - (n - 1) / 2.0) * vel_spacing
        taxis_dot = vaxis / 2.0
    d_enu, dt = _mesh4(axis, axis)
    dv_enu, dtdot = _mesh4(vaxis, taxis_dot)
    return Grid(d_enu=d_enu, dt_m=dt, dv_enu=dv_enu, dtdot=dtdot)


def arthur_axis(n: int, spacing: float, border: int = 3) -> np.ndarray:
    """Uniform interior, 3x-spacing border rings (CUDARecv ArthurBasis)."""
    half = (n - 1) // 2
    vals = []
    for k in range(-half, half + 1):
        a = abs(k)
        if a <= half - border:
            vals.append(k * spacing)
        else:
            inner = (half - border) * spacing
            vals.append(np.sign(k) * (inner + (a - (half - border)) * 3.0 * spacing))
    return np.array(vals, dtype=np.float64)


def arthur_grid(n: int = 25, pos_spacing: float = 1.0,
                vel_spacing: float = 0.1) -> Grid:
    axis = arthur_axis(n, pos_spacing)
    vaxis = arthur_axis(n, vel_spacing)
    d_enu, dt = _mesh4(axis, axis * 1.2)
    dv_enu, dtdot = _mesh4(vaxis, vaxis * 0.5)
    return Grid(d_enu=d_enu, dt_m=dt, dv_enu=dv_enu, dtdot=dtdot)


def exponential_axis(n: int, spacing: float,
                     growth: float = 1.35) -> np.ndarray:
    """Center-dense axis of exactly n points: the k-th step out from the
    center is spacing * growth^(k-1), so resolution is finest where the
    estimate already is and the span grows geometrically (CUDARecv
    enumerates this style as ManifoldGridTypes::Exponential,
    gridhelper.h:24-28, but never implements it — here it is real).

    Odd n includes the 0 center point; even n is symmetric about 0 with
    the innermost pair at +/- spacing/2 (same convention as an even
    uniform axis), so requesting n^4 grid points yields exactly n^4.
    """
    if n % 2:
        half = (n - 1) // 2
        steps = spacing * growth ** np.arange(half, dtype=np.float64)
        pos = np.concatenate([[0.0], np.cumsum(steps)])
        return np.concatenate([-pos[:0:-1], pos])
    half = n // 2
    steps = spacing * growth ** np.arange(half - 1, dtype=np.float64)
    pos = spacing / 2.0 + np.concatenate([[0.0], np.cumsum(steps)])
    return np.concatenate([-pos[::-1], pos])


def exponential_grid(n: int = 25, pos_spacing: float = 1.0,
                     vel_spacing: float = 0.1,
                     growth: float = 1.35) -> Grid:
    """n^4 + n^4 grids on exponential axes (time axis 1.2x the position
    axis, drift 0.5x velocity — same ratios as the arthur grid)."""
    if 2 * n ** 4 > MAX_GRID_POINTS:
        raise ValueError(
            f"grid would have {2 * n ** 4} points; cap is 2*75^4 = "
            f"{MAX_GRID_POINTS} (reference BCM_MAX_GRID_SIZE)")
    axis = exponential_axis(n, pos_spacing, growth)
    vaxis = exponential_axis(n, vel_spacing, growth)
    d_enu, dt = _mesh4(axis, axis * 1.2)
    dv_enu, dtdot = _mesh4(vaxis, vaxis * 0.5)
    return Grid(d_enu=d_enu, dt_m=dt, dv_enu=dv_enu, dtdot=dtdot)


def load_grid_csv(path: str, vel_grid: Grid | None = None) -> Grid:
    """Custom position grid from CSV rows `e,n,u[,dt_m]` (rngrid3-style).
    Velocity manifold defaults to the spread grid's."""
    rows = np.loadtxt(path, delimiter=",", ndmin=2)
    d_enu = rows[:, 0:3]
    dt = rows[:, 3] if rows.shape[1] > 3 else np.zeros(rows.shape[0])
    v = vel_grid or spread_grid()
    return Grid(d_enu=d_enu, dt_m=dt, dv_enu=v.dv_enu, dtdot=v.dtdot)


def dense_grid(n: int = 75, pos_spacing: float = 1.0,
               vel_spacing: float = 0.1) -> Grid:
    """Reference-cap-scale uniform grid: n^4 pos + n^4 vel points.

    Defaults give the reference's maximum supported manifold (2*75^4 ~
    63.3M points, batchcorrmanifold.h:17) at its default 1.0 m spacing
    (dpeflow.cpp:83-86) — the regime where mesh sharding pays."""
    return uniform_grid(n=n, pos_spacing=pos_spacing,
                        vel_spacing=vel_spacing)


def check_grid_size(grid: Grid) -> Grid:
    """Reference-parity guard (batchcorrmanifold.h:17, enforced at
    BCM Start, batchcorrmanifold.cu:2315-2325)."""
    total = grid.n_pos + grid.n_vel
    if total > MAX_GRID_POINTS:
        raise ValueError(
            f"grid has {total} points; cap is 2*75^4 = {MAX_GRID_POINTS} "
            "(reference BCM_MAX_GRID_SIZE)")
    return grid


def make_grid(style: str = "spread", **kw) -> Grid:
    if style == "spread":
        g = spread_grid(**kw)
    elif style == "uniform":
        g = uniform_grid(**kw)
    elif style == "arthur":
        g = arthur_grid(**kw)
    elif style == "exponential":
        g = exponential_grid(**kw)
    elif style == "dense":
        g = dense_grid(**kw)
    else:
        raise ValueError(f"unknown grid style {style!r}")
    return check_grid_size(g)
