"""8-state navigation EKF: [x y z c*dt vx vy vz c*dtdot] (meters, m/s).

Modes, matching and extending the reference's pair:

- "passthrough" (default): K = I, F = I — the measurement replaces the
  state. This is CUDARecv's shipped configuration (EnableEKF=false,
  cuekf.cu:147-159) and PyGNSS's "Debug for CUDARecv" l5 mode
  (ekf.py:23-45, 136-157).
- "alpha": fixed-gain smoother x += alpha*(z - x) — a good steady-state
  filter for a static receiver with grid-argmax measurement noise; reduces
  fix scatter ~sqrt(alpha/(2-alpha)) while converging geometrically.
- "full": a PROPERLY TUNED Kalman filter (the reference's cuekf
  StepPredict/StepUpdate structure, cuekf.cu:626-721, with its placeholder
  noise models replaced):
    * F: constant-velocity with T coupling (EKF_MakeDPERandomWalkFMatrix,
      cuekf.cu:111-139);
    * Q: continuous white-acceleration PV blocks q_a*[[T^3/3, T^2/2],
      [T^2/2, T]] per axis + a 2-state h0/h-2 oscillator model for the
      clock pair — replacing the reference's velocity-LPF heuristic
      (EKF_Update_Q, cuekf.cu:42-81);
    * R: per-measurement, from the DPE score-surface curvature around the
      argmax (models/dpe.py:_measurement_cov) — replacing the reference's
      RVal = I placeholder (batchcorrmanifold.cu:2068).

Host-side float64 numpy: an 8x8 solve per 20 ms is not device work.

The port's own copy of navlab_dpe_sdr_tpu/models/ekf.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from ..constants import C


class NavEKF:
    def __init__(self, x0: np.ndarray, T: float = 0.02,
                 mode: str = "passthrough", alpha: float = 0.3,
                 q_accel: float = 1.0, q_pos: float = 25.0,
                 clk_h0: float = 2e-19, clk_hm2: float = 2e-20):
        self.x = np.asarray(x0, dtype=np.float64).reshape(8).copy()
        self.T = float(T)
        self.mode = mode
        self.alpha = float(alpha)
        self.q_accel = float(q_accel)        # accel PSD [m^2/s^3]
        # position/clock random-walk PSD [m^2/s]. This is NOT vehicle
        # dynamics: it floors P so the gain cannot collapse while the
        # DPE argmax errors stay correlated block-to-block (the spread
        # grid recenters on the state each block, so the measurement
        # noise is far from white — an unmodeled-correlation inflation
        # term is the standard remedy).
        self.q_pos = float(q_pos)
        # oscillator Allan h-parameters -> clock phase/freq PSDs in meters
        self.sf = clk_h0 / 2.0 * C * C       # [m^2/s]
        self.sg = 2.0 * np.pi ** 2 * clk_hm2 * C * C  # [m^2/s^3]
        self.F = np.eye(8)
        if mode == "full":
            for i in range(4):
                self.F[i, i + 4] = self.T
        self.H = np.eye(8)
        self.R = np.diag([25.0] * 3 + [36.0] + [1.0] * 3 + [1.0])
        self.Q = self._make_q()
        # initial uncertainty: handoff-grade position/clock, loose velocity
        self.P = np.diag([100.0] * 3 + [400.0] + [4.0] * 3 + [4.0])
        # forward history for the RTS backward pass (mode="full" only):
        # one (x_pred, P_pred) + (x_upd, P_upd) pair per block — 2250
        # blocks of 8-state history is ~2 MB, negligible
        self.history: list = []

    def _make_q(self) -> np.ndarray:
        t = self.T
        q = np.zeros((8, 8))
        qa = self.q_accel
        for i in range(3):
            q[i, i] = qa * t ** 3 / 3.0
            q[i, i + 4] = q[i + 4, i] = qa * t ** 2 / 2.0
            q[i + 4, i + 4] = qa * t
        q[3, 3] = self.sf * t + self.sg * t ** 3 / 3.0
        q[3, 7] = q[7, 3] = self.sg * t ** 2 / 2.0
        q[7, 7] = self.sg * t
        for i in range(4):
            q[i, i] += self.q_pos * t
        return q

    def time_update(self) -> np.ndarray:
        self.x = self.F @ self.x
        if self.mode == "full":
            self.P = self.F @ self.P @ self.F.T + self.Q
            self.history.append(["p", self.x.copy(), self.P.copy()])
        return self.x

    def measurement_update(self, z: np.ndarray,
                           R: np.ndarray | None = None) -> np.ndarray:
        """z: the 8-state measurement (grid argmax / weighted mean);
        R: optional per-measurement covariance (adaptive, from the score
        surface). Falls back to the configured default."""
        z = np.asarray(z, dtype=np.float64).reshape(8)
        if self.mode == "passthrough":
            self.x = z.copy()
            return self.x
        if self.mode == "alpha":
            self.x = self.x + self.alpha * (z - self.x)
            return self.x
        r = self.R if R is None else R
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + r
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        ikh = np.eye(8) - k @ self.H
        # Joseph form: keeps P symmetric PSD with adaptive R
        self.P = ikh @ self.P @ ikh.T + k @ r @ k.T
        self.history.append(["u", self.x.copy(), self.P.copy()])
        return self.x

    def rts_smooth(self) -> np.ndarray:
        """Rauch-Tung-Striebel backward pass over the forward history
        (mode="full"): returns [N, 8] smoothed states, one per
        measurement. x_s[k] = x_u[k] + C_k (x_s[k+1] - x_p[k+1]) with
        C_k = P_u[k] F^T P_p[k+1]^{-1}. Every state estimate then uses
        the WHOLE pass (past and future measurements) — a post-processing
        accuracy mode the real-time reference cannot express, and the
        natural companion of batched/offline DPE runs."""
        if self.mode != "full":
            raise ValueError("rts_smooth needs ekf_mode='full' history")
        # the recursion requires strictly interleaved predict/update pairs
        # (one measurement per prediction). Batched/integrated modes record
        # n predictions before their updates (or one update per K
        # predictions), which breaks the pairing — refuse rather than
        # smooth with mismatched covariances.
        tags = [t for t, _, _ in self.history]
        if tags != ["p", "u"] * (len(tags) // 2):
            raise ValueError(
                "rts_smooth needs the per-block history (run()); batched/"
                "integrated runs interleave predictions and updates in "
                "batches, which the RTS pairing cannot use")
        preds = [(x, P) for tag, x, P in self.history if tag == "p"]
        upds = [(x, P) for tag, x, P in self.history if tag == "u"]
        n = min(len(preds), len(upds))
        if n == 0:
            return np.zeros((0, 8))
        xs = np.empty((n, 8))
        xs[n - 1] = upds[n - 1][0]
        x_s, p_s = upds[n - 1]
        for k in range(n - 2, -1, -1):
            x_u, p_u = upds[k]
            x_p1, p_p1 = preds[k + 1]
            c = p_u @ self.F.T @ np.linalg.inv(p_p1)
            x_s = x_u + c @ (x_s - x_p1)
            p_s = p_u + c @ (p_s - p_p1) @ c.T
            xs[k] = x_s
        return xs
