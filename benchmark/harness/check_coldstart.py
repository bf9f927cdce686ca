"""What decides `correct` in a cold start: the reference follows the cold
start step by step from what each stage handed the next.

- `acq_code_gap_chips`, `acq_doppler_gap_hz`: the acquisition's code
  phases and Dopplers at sample 0 against the scenario's truth; their
  limits are the configuration's guarantee: a start within the tracking
  loops' reach, the early-late spacing and the PLL's noise bandwidth;
- `track_gap`, `track_state_gap_m`: two tracking chunks, one drawn from the
  seed among all the chunks of the start and the last before the handoff,
  each run again by the plain tracker (reference/tracker.py) from the
  tracker's state before it, over the same samples: the chunk's
  correlations (early,
  prompt and late, relative to the channel's largest prompt magnitude in
  the chunk) and the tracker's state after it, in metres (code phase at
  C / F_CA a chip, carrier phase at the L1 wavelength, code and carrier
  rates the metres they move in a second, a code-period count that differs
  at 1e9 m);
- `eph_gap_m`: the decoded ephemerides against the ones the scenario
  broadcast: the largest difference of the satellites' positions and
  clocks [m] computed from each at the handoff's time (the broadcast set is
  the scenario's, not quantized as the navigation message quantizes it:
  the quantization is the floor of this number);
- `handoff_gap_m`: the handoff worked out again from the tracker's log row
  it is taken at (the scalar navigation solution, the propagation across
  the row's window) against the program's handoff: reference/receiver.py
  `state_gap_m`, and the position and clock of the fix;
- the first DPE fix from the program's handoff, as a live step is judged
  (harness/check.py `judge_step`).

The controls put the reference in the program's place a step down:
`bf16_sums` (the tracker's correlation sums in bfloat16), `f32_host` (the
host's state, the handoff and the decoded values in float32) and `tf32`
(the first fix's correlator products in TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frozen.constants import C, F_CA, F_L1, L_CA
from ..frozen.io.handoff import Handoff
from ..frozen.libgnss import naveng, satpos
from ..frozen.libgnss.ephemeris import ALL_FIELDS
from ..reference import tracker as ref_trk
from ..reference.receiver import state_gap_m
from . import check

CONTROLS = {"tf32": dict(tf32=True), "f32_host": dict(round_to=np.float32),
            "bf16_sums": dict(round_sums=torch.bfloat16)}


def frozen_handoff(h) -> Handoff:
    """The program's handoff as the frozen copy's object (the same numbers)."""
    out = Handoff()
    for k in ("rx_time", "rx_time_a", "bytes_read"):
        setattr(out, k, getattr(h, k))
    for k in ("x_ecef", "rc", "ri", "fc", "fi", "cp", "cp_timestamp", "tow"):
        setattr(out, k, np.array(getattr(h, k), dtype=np.float64))
    out.prn_list = list(h.prn_list)
    out.eph_fields = {k: np.array(v, dtype=np.float64)
                      for k, v in h.eph_fields.items()}
    return out


def handoff_state(h: Handoff) -> dict:
    return {"x": np.asarray(h.x_ecef, dtype=np.float64), "rc": h.rc,
            "ri": h.ri, "fc": h.fc, "fi": h.fi, "cp": h.cp,
            "rx_time": float(h.rx_time), "rx_time_a": float(h.rx_time_a),
            "mc": int(h.bytes_read)}


def _round(x, round_to):
    if round_to is None:
        return x
    return np.asarray(x).astype(round_to).astype(np.float64)


def reference_handoff(obs: dict, h_prog: Handoff, round_to=None) -> Handoff:
    """The handoff from the log row `obs` (rc, ri, fc, fi, cp at the row,
    the row's sample and window) and the decoded ephemerides of the
    program's handoff: the scalar solution at the row, propagated across
    its window."""
    eph = h_prog.eph_array()
    rx_time_a, rx_time, x_ecef, _, _ = naveng.calculate_nav_soln(
        obs["cp"], obs["rc"], obs["fi"], eph, doppler_sign=obs["ds"])
    dt = obs["coh_ms"] * 1e-3
    h = Handoff()
    h.rx_time = float(rx_time) + dt
    h.rx_time_a = float(rx_time_a) + dt
    h.x_ecef = np.asarray(x_ecef, dtype=np.float64).ravel().copy()
    h.x_ecef[0:3] += h.x_ecef[4:7] * dt
    h.x_ecef[3] += h.x_ecef[7] * dt
    h.bytes_read = int(obs["sample"] * 4)
    h.prn_list = list(h_prog.prn_list)
    rc = np.asarray(obs["rc"], dtype=np.float64)
    fc = np.asarray(obs["fc"], dtype=np.float64)
    adv = rc + fc * dt
    h.cp = np.asarray(obs["cp"], dtype=np.float64) + np.floor(adv / L_CA)
    h.rc = np.mod(adv, L_CA)
    h.ri = np.mod(np.asarray(obs["ri"], dtype=np.float64)
                  + np.asarray(obs["fi"], dtype=np.float64) * dt, 1.0)
    h.fc, h.fi = fc, np.asarray(obs["fi"], dtype=np.float64)
    for k in ("x_ecef", "rc", "ri", "fc", "fi", "cp"):
        setattr(h, k, _round(getattr(h, k), round_to))
    h.rx_time = float(_round(h.rx_time, round_to))
    h.rx_time_a = float(_round(h.rx_time_a, round_to))
    return h


def handoff_gap(a: Handoff, b: Handoff) -> float:
    sa, sb = handoff_state(a), handoff_state(b)
    sa["mc"] = sb["mc"] = 0
    gap = state_gap_m(sa, sb)
    return max(gap, 1e9 * float(a.bytes_read != b.bytes_read))


def eph_gap_m(fields: dict, broadcast, t: float, round_to=None) -> float:
    """Largest difference of the satellites' ECEF positions and clock
    terms [m] at time t between ephemeris values `fields` ({name: [K]})
    and the broadcast EphArray."""
    from ..frozen.libgnss.ephemeris import EphArray, Ephemeris

    ephs = []
    for i, prn in enumerate(broadcast.prn):
        e = Ephemeris(prn=int(prn))
        for name in ALL_FIELDS:
            setattr(e, name, float(_round(fields[name][i], round_to)))
        ephs.append(e)
    mine = EphArray(ephs)
    tt = np.full(len(ephs), float(t))
    states = []
    for arr in (mine, broadcast):
        clkb, clkd = satpos.sat_clock_correction(arr, tt)
        states.append(satpos.sat_state(arr, tt - clkb, clkb, clkd))
    d = np.abs(states[0] - states[1])
    return max(float(d[0:3].max()), float(d[3].max()) * C)


def replay_chunk(R: check.Reference, chunk: dict, round_sums=None):
    """The plain tracker over the recorded chunk from its recorded state:
    (state after [numpy dict], logf [steps, 16, C])."""
    dev = R.device
    steps, s = chunk["steps"], chunk["window"]
    flat = R.cap.raw.reshape(-1, 2)
    raw = flat[chunk["sample0"]:chunk["sample0"] + steps * s].reshape(
        steps, s, 2)
    st = ref_trk.state_from_numpy(chunk["state_in"], dev)
    out, logf, _ = ref_trk.track_chunk_plain(
        st, raw, R.chips, R.fs, F_CA / F_L1, ref_trk.LoopConfig(),
        round_sums=round_sums)
    return ({k: v.cpu().numpy() for k, v in out._asdict().items()},
            logf.cpu().numpy())


def track_gaps(state_a, logf_a, state_b, logf_b) -> tuple[float, float]:
    """(correlations relative to each channel's largest prompt magnitude,
    end state in metres) between two runs of a chunk."""
    corr_a, corr_b = logf_a[:, 0:6], logf_b[:, 0:6]           # [n, 6, C]
    peak = np.hypot(logf_b[:, 2], logf_b[:, 3]).max(axis=0)    # [C]
    corr = float((np.abs(corr_a - corr_b).max(axis=(0, 1)) / peak).max())
    chip, lam = C / F_CA, C / F_L1

    def d(k):
        return np.abs(np.asarray(state_a[k], np.float64)
                      - np.asarray(state_b[k], np.float64))

    drc = np.abs(np.mod(d("rc") + L_CA / 2, L_CA) - L_CA / 2)
    dri = np.abs(np.mod(d("ri") + 0.5, 1.0) - 0.5)
    st = max(float((drc * chip).max()), float((dri * lam).max()),
             float((d("dfc") * chip).max()), float((d("fi") * lam).max()),
             1e9 * float(d("cp").max()))
    return corr, st


def acquisition_gaps(acq: dict, hand) -> tuple[float, float]:
    """(code phase gap [chips], Doppler gap [Hz]) of the acquisition's
    `acq` (rc [chips], fi [Hz] at sample 0, per channel) against the truth
    handoff at sample 0, the largest over the channels."""
    d = np.asarray(acq["rc"], np.float64) - np.asarray(hand.rc, np.float64)
    code = np.abs(np.mod(d + L_CA / 2, L_CA) - L_CA / 2)
    dopp = np.abs(np.asarray(acq["fi"], np.float64)
                  - np.asarray(hand.fi, np.float64))
    return float(code.max()), float(dopp.max())


def judge(R: check.Reference, rec: dict, variant: dict | None = None):
    """The numbers of one recorded cold start: the program's (variant None)
    or a control's (a `CONTROLS` variant in the program's place; it
    replaces no acquisition, so it has no acquisition numbers)."""
    v = variant or {}
    out = {}
    if variant is None:
        out["acq_code_gap_chips"], out["acq_doppler_gap_hz"] = (
            acquisition_gaps(rec["acq"], R.cap.hand))
    chunks = {id(c): c for c in rec["chunks"].values()}.values()
    for ch in chunks:
        ref_state, ref_log = replay_chunk(R, ch)
        if variant is None:
            got_state, got_log = ch["state_out"], ch["logf"]
        else:
            got_state, got_log = replay_chunk(R, ch, v.get("round_sums"))
        check.merge(out, dict(zip(("track_gap", "track_state_gap_m"),
                                  track_gaps(got_state, got_log, ref_state,
                                             ref_log))))

    h_prog = frozen_handoff(rec["handoff"])
    ref_h = reference_handoff(rec["obs"], h_prog)
    got_h = (h_prog if variant is None else
             reference_handoff(rec["obs"], h_prog, v.get("round_to")))
    out["handoff_gap_m"] = handoff_gap(got_h, ref_h)
    out["eph_gap_m"] = eph_gap_m(h_prog.eph_fields, R.cap.eph,
                                 float(h_prog.rx_time), v.get("round_to"))

    step = dict(rec["step"], eph=h_prog.eph_array(), start=h_prog)
    if variant is None:
        got = check.judge_step(R, step)
    else:
        got = check.control_step(R, step, **{
            k: x for k, x in v.items() if k in ("tf32", "round_to")})
    out.update(got)
    return out
