"""Synthetic GPS L1 C/A IF-capture generator.

The reference repo's only test data was an externally simulated 45 s capture
(README.md:91) whose binary blob is not distributed. This module recreates
such captures from first principles so every stage — acquisition, tracking,
nav-data decode, PVT, DPE — can be validated against known ground truth.

Two generators:

- `synth_simple`: one PRN with constant code/carrier rates, directly in the
  receiver's own signal model. For correlator/acquisition unit tests.
- `CaptureSimulator`: full-geometry multi-satellite capture: per-satellite
  transmit-time solve (Kepler orbit + satellite clock + Sagnac/earth-rotation
  range), LNAV navigation message with parity, configurable C/N0 and receiver
  clock drift. Signal timing is solved exactly at 1 ms nodes in float64 and
  linearly interpolated per sample (interp error < 1e-16 s).

The port's own copy of navlab_dpe_sdr_tpu/io/synth.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import C, F_CA, F_L1, L_CA, OEDot
from ..libgnss import lnav, satpos
from ..libgnss.cacode import ca_code
from ..libgnss.ephemeris import EphArray


def white_noise_iq16(n: int, seed=0, sigma: float = 22.6) -> np.ndarray:
    """n samples of quantized complex white noise as DTYPE_IQ16.

    The scale is arbitrary for anything scale-invariant (noise-envelope
    calibration, null controls); 22.6 keeps int16 quantization noise
    negligible while staying far from clipping."""
    from .rawfile import DTYPE_IQ16

    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    out = np.empty(n, DTYPE_IQ16)
    out["i"] = np.clip(np.round(rng.standard_normal(n) * sigma),
                       -32768, 32767)
    out["q"] = np.clip(np.round(rng.standard_normal(n) * sigma),
                       -32768, 32767)
    return out


def synth_simple(prn: int, fs: float, n_samples: int, rc: float = 0.0,
                 ri: float = 0.0, fc: float = F_CA, fi: float = 0.0,
                 cn0_dbhz: float | None = 45.0, sigma: float = 32.0,
                 bits: np.ndarray | None = None, bit_phase_cp: int = 0,
                 seed: int = 0) -> np.ndarray:
    """Constant-rate single-PRN complex baseband signal.

    Model matches the receiver's replica exactly (correlator.py:135-147):
    chips at code_idc = t*fc + rc, carrier exp(+j*2pi*(fi*t + ri)).
    bits: optional +/-1 nav bits, one per 20 code periods, starting so that
    code period index `bit_phase_cp` (mod 20) is the bit boundary.
    """
    t = np.arange(n_samples) / fs
    fidc = t * fc + rc
    chips = ca_code(prn)[np.mod(np.floor(fidc), L_CA).astype(np.int64)]
    carrier = np.exp(2j * np.pi * (fi * t + ri))
    sig = chips * carrier
    if bits is not None:
        cp_idx = np.floor(fidc / L_CA).astype(np.int64)
        bit_idx = (cp_idx + bit_phase_cp) // 20
        sig = sig * bits[np.clip(bit_idx, 0, len(bits) - 1)]
    if cn0_dbhz is None:
        return sig
    amp = sigma * np.sqrt(10.0 ** (cn0_dbhz / 10.0) / fs)
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples))
    noise *= sigma / np.sqrt(2.0)
    return amp * sig + noise


# Shared per-sample workspace. On this host, first-touch page faults on
# fresh large allocations run ~30 MB/s — orders of magnitude below warm
# memory — so every large [n_samples] temporary is reused across calls and
# across simulator instances. Small requests (< _WS_MIN) allocate normally,
# so truth probes and short unit-test captures don't thrash the one cached
# size. Guarded by a lock: generate() itself is serialized (it is host-CPU
# bound; concurrent callers would gain nothing and corrupt the buffers).
_WS_MIN = 1_000_000
_WS: dict = {"n": 0}
_WS_LOCK = __import__("threading").Lock()


def _ws(n: int, key: str, dtype) -> np.ndarray:
    if n < _WS_MIN:
        return np.empty(n, dtype)
    if _WS["n"] != n:
        _WS.clear()
        _WS["n"] = n
    k = (key, np.dtype(dtype).str)
    a = _WS.get(k)
    if a is None:
        a = np.empty(n, dtype)
        _WS[k] = a
    return a


def release_workspace() -> None:
    """Free the shared per-sample workspace (it otherwise retains the
    buffers for the largest n seen — ~8 GB after a 115M-sample synthesis).
    Call after a one-shot bulk generation; the next generate() simply
    re-faults fresh pages."""
    _WS.clear()
    _WS["n"] = 0


def _iota(n: int) -> np.ndarray:
    if n < _WS_MIN:
        return np.arange(n, dtype=np.float64)
    a = _WS.get("iota")
    if a is None or _WS["n"] != n:
        a = _ws(n, "_iota_buf", np.float64)
        a[:] = np.arange(n)
        _WS["iota"] = a
    return a


@dataclass
class ChannelTruth:
    prn: int
    t_sv_nodes: np.ndarray       # satellite-clock transmit time at each node
    doppler0: float              # carrier Doppler at capture start [Hz]
    code_phase0: float           # code phase (chips within period) at start
    cp0: float                   # absolute code-period count at sample 0
    amplitude: float


@dataclass
class CaptureTruth:
    fs: float
    tow0: float                  # true GPS receive time of sample 0
    rx_ecef: np.ndarray          # 8-state truth (static)
    tow_frame0: float            # LNAV stream start (subframe boundary)
    channels: list = field(default_factory=list)


class CaptureSimulator:
    """Full-geometry capture generator for a static (or slowly moving)
    receiver."""

    def __init__(self, eph_arr: EphArray, rx_state_ecef: np.ndarray,
                 tow0: float, fs: float = 2.5e6,
                 cn0_dbhz=45.0, sigma: float = 32.0,
                 clock_drift: float = 0.0, nav_data: bool = True,
                 bandwidth_hz: float | None = 2.2e6,
                 accel_ecef=None, extra_delay_m=None, seed: int = 7):
        self.eph = eph_arr
        self.k = len(eph_arr)
        self.rx = np.asarray(rx_state_ecef, dtype=np.float64).reshape(-1)
        if self.rx.size == 3:
            self.rx = np.concatenate([self.rx, np.zeros(5)])
        self.tow0 = float(tow0)
        self.fs = float(fs)
        self.cn0 = np.broadcast_to(np.asarray(cn0_dbhz, dtype=np.float64),
                                   (self.k,)).copy()
        self.sigma = float(sigma)
        self.drift = float(clock_drift)   # receiver clock drift [s/s]
        # constant ECEF acceleration [m/s^2] (maneuvering-receiver tests)
        self.accel = (np.zeros(3) if accel_ecef is None
                      else np.asarray(accel_ecef, dtype=np.float64))
        # per-channel extra signal-path delay [m] (atmospheric injection:
        # iono/tropo group delay makes the signal arrive delay/C later)
        self.extra_delay_m = (np.zeros(self.k) if extra_delay_m is None
                              else np.asarray(extra_delay_m, np.float64))
        self.nav_data = nav_data
        # front-end bandwidth (double-sided). A real RF chain bandlimits the
        # rectangular chips, rounding the correlation peak — without this the
        # ideal triangle's kink makes sub-sample interpolation degenerate.
        self.bandwidth = bandwidth_hz
        self.seed = seed

        # LNAV streams start two subframes before tow0 so early t_sv is covered
        self.tow_frame0 = np.floor(self.tow0 / 6.0) * 6.0 - 12.0
        self._bit_streams: list[np.ndarray] = []

    def _ensure_bits(self, n_subframes: int) -> None:
        while True:
            have = 0 if not self._bit_streams else len(self._bit_streams[0]) // 300
            if have >= n_subframes:
                return
            self._bit_streams = [
                1 - 2 * lnav.encode_stream(self.eph.ephs[i], self.tow_frame0,
                                           n_subframes + 2)
                for i in range(self.k)
            ]
            self._bits_f32_cache = {}

    def _code_f32(self, prn: int) -> np.ndarray:
        cache = getattr(self, "_code_f32_cache", None)
        if cache is None:
            cache = self._code_f32_cache = {}
        a = cache.get(prn)
        if a is None:
            a = cache[prn] = ca_code(prn).astype(np.float32)
        return a

    def _bits_f32(self, i: int) -> np.ndarray:
        cache = getattr(self, "_bits_f32_cache", None)
        if cache is None:
            cache = self._bits_f32_cache = {}
        a = cache.get(i)
        if a is None:
            a = cache[i] = self._bit_streams[i].astype(np.float32)
        return a

    def _solve_t_sv(self, t_rx_nodes: np.ndarray) -> np.ndarray:
        """Satellite-clock transmit times for true GPS receive times.

        Solves t_sv = t_rx + clkb(t_sv) - r(t_sv)/C with the same Sagnac
        convention the nav engine applies (frames.ecef_to_eci at
        t_gps=t_tx, t_c=t_rx).
        """
        delay = np.empty((self.k, t_rx_nodes.size))
        rx_pos = self.rx[0:3]
        rx_vel = self.rx[4:7]
        for i in range(self.k):
            e = self.eph.ephs[i]
            t_sv = t_rx_nodes - 0.075
            for _ in range(4):
                clkb, _clkd = satpos.sat_clock_correction(e, t_sv)
                t_true = t_sv - clkb
                s = satpos.sat_state(e, t_true)
                otau = OEDot * (t_true - t_rx_nodes)
                co, so = np.cos(otau), np.sin(otau)
                sx = co * s[0] - so * s[1]
                sy = so * s[0] + co * s[1]
                sz = s[2]
                dt_rx = t_rx_nodes - self.tow0
                px = rx_pos[0] + rx_vel[0] * dt_rx + 0.5 * self.accel[0] * dt_rx ** 2
                py = rx_pos[1] + rx_vel[1] * dt_rx + 0.5 * self.accel[1] * dt_rx ** 2
                pz = rx_pos[2] + rx_vel[2] * dt_rx + 0.5 * self.accel[2] * dt_rx ** 2
                r = np.sqrt((sx - px) ** 2 + (sy - py) ** 2 + (sz - pz) ** 2)
                t_sv = t_rx_nodes + clkb - r / C
            # store the small delay d = t_sv - t_rx: full float64 resolution
            # survives differencing (t_sv alone has only ~6e-11 s ulp).
            # extra_delay_m arrives later -> transmitted correspondingly
            # earlier for the same receive time.
            delay[i] = clkb - (r + self.extra_delay_m[i]) / C
        return delay

    def generate(self, n_samples: int, start_sample: int = 0,
                 return_truth: bool = False):
        """Generate complex64 baseband samples [start, start+n) — see
        _generate_locked; serialized on the shared workspace lock."""
        with _WS_LOCK:
            return self._generate_locked(n_samples, start_sample,
                                         return_truth)

    def _generate_locked(self, n_samples: int, start_sample: int = 0,
                         return_truth: bool = False):
        """Generate complex64 baseband samples [start, start+n).

        Timing is solved in float64 on 1 ms nodes and interpolated as the
        small *delay* d = t_sv - t_rx (full f64 resolution; absolute TOW-scale
        times carry ~1e-10 s of representation quantization). Only the
        carrier rotation and signal accumulation run in float32 — 6e-8 cycle
        phase granularity, far below the noise floor and ~100x faster than
        complex128 exp on this host. All per-sample buffers come from a
        shared workspace: fresh page allocation dominates cost otherwise.
        """
        fs = self.fs
        n = n_samples
        node_dt = 1e-3
        n0 = int(np.floor(start_sample / fs / node_dt))
        n1 = int(np.ceil((start_sample + n_samples) / fs / node_dt)) + 1
        node_t_file = np.arange(n0, n1 + 1) * node_dt
        # receiver clock drift stretches the sampling grid in true GPS time
        t_rx_nodes = self.tow0 + node_t_file * (1.0 + self.drift)

        delay_nodes = self._solve_t_sv(t_rx_nodes)
        t_sv_nodes = t_rx_nodes[None, :] + delay_nodes

        n_sf = int(np.ceil((t_sv_nodes.max() - self.tow_frame0) / 6.0)) + 1
        if self.nav_data:
            self._ensure_bits(n_sf)

        t_file = _ws(n, "t_file", np.float64)
        t_file[:] = _iota(n)
        t_file *= 1.0 / fs
        t_file += start_sample / fs

        f64a = _ws(n, "f64a", np.float64)
        f64b = _ws(n, "f64b", np.float64)
        idx = _ws(n, "idx", np.int64)
        ph32 = _ws(n, "ph32", np.float32)
        cosb = _ws(n, "cos", np.float32)
        sinb = _ws(n, "sin", np.float32)
        chip32 = _ws(n, "chip", np.float32)
        tmp32 = _ws(n, "tmp", np.float32)
        sig_re = _ws(n, "sig_re", np.float32)
        sig_im = _ws(n, "sig_im", np.float32)
        sig_re.fill(0.0)
        sig_im.fill(0.0)

        truth_channels = []
        for i in range(self.k):
            delay = np.interp(t_file, node_t_file, delay_nodes[i])
            # ts_rel = t_sv - tow_frame0, built from small terms (exact):
            # (tow0 - tow_frame0) + t_file*(1+drift) + delay
            np.multiply(t_file, 1.0 + self.drift, out=f64a)
            f64a += delay
            f64a += self.tow0 - self.tow_frame0
            ts_rel0 = float(f64a[0])
            np.multiply(f64a, F_CA, out=f64b)
            np.floor(f64b, out=f64b)
            np.copyto(idx, f64b, casting="unsafe")
            idx %= int(L_CA)
            np.take(self._code_f32(self.eph.prn[i]), idx, out=chip32)
            if self.nav_data:
                # bit index = floor(ts_rel / 20 ms)
                np.multiply(f64a, 50.0, out=f64b)
                np.floor(f64b, out=f64b)
                np.copyto(idx, f64b, casting="unsafe")
                bits = self._bits_f32(i)
                np.clip(idx, 0, len(bits) - 1, out=idx)
                np.take(bits, idx, out=tmp32)
                chip32 *= tmp32
            # Downconversion LO derives from the same (drifting) oscillator
            # as the ADC clock, so its phase advances with receiver-clock
            # time t_lo = tow0 + t_file, not true time t_rx.  The difference
            # puts +F_L1*drift Hz on the baseband carrier — the code/carrier
            # coherence a single-oscillator receiver (and the 8-state clock
            # model, x[7] = c*d(bias)/dt) relies on.
            # phase cycles = F_L1*(t_sv - t_lo) = F_L1*(delay + drift*t_file)
            np.multiply(t_file, self.drift, out=f64a)
            f64a += delay
            f64a *= F_L1
            np.mod(f64a, 1.0, out=f64a)
            np.copyto(ph32, f64a, casting="unsafe")
            ph32 *= np.float32(2.0 * np.pi)
            np.cos(ph32, out=cosb)
            np.sin(ph32, out=sinb)
            amp = self.sigma * np.sqrt(10.0 ** (self.cn0[i] / 10.0) / fs)
            chip32 *= np.float32(amp)
            np.multiply(chip32, cosb, out=tmp32)
            sig_re += tmp32
            np.multiply(chip32, sinb, out=tmp32)
            sig_im += tmp32

            if return_truth:
                # observed Doppler in file time: F_L1 * d(delay)/dt * (1+drift)
                dop = (F_L1 * (delay_nodes[i][1] - delay_nodes[i][0])
                       / (t_rx_nodes[1] - t_rx_nodes[0]) * (1.0 + self.drift)
                       if len(node_t_file) > 1 else 0.0)
                truth_channels.append(ChannelTruth(
                    prn=int(self.eph.prn[i]),
                    t_sv_nodes=t_sv_nodes[i],
                    doppler0=float(dop),
                    code_phase0=float(np.mod(ts_rel0 * F_CA, L_CA)),
                    cp0=float(np.floor(ts_rel0 * F_CA / L_CA)),
                    amplitude=float(amp)))

        sig = np.empty(n, dtype=np.complex64)
        v = sig.view(np.float32).reshape(n, 2)
        v[:, 0] = sig_re
        v[:, 1] = sig_im

        if self.bandwidth is not None and self.bandwidth < fs:
            # brickwall-with-rolloff front-end filter (circular per chunk;
            # edge effects span a handful of samples)
            hkey = ("bwmask", n, float(self.bandwidth), float(fs))
            h = _WS.get(hkey)
            if h is None or h.shape[0] != n:
                f = np.abs(np.fft.fftfreq(n, d=1.0 / fs))
                half = self.bandwidth / 2.0
                roll = 0.1 * half
                h = np.clip((half + roll - f) / roll, 0.0, 1.0)
                h = h.astype(np.float32)
                if n >= _WS_MIN and _WS["n"] == n:   # lives with the
                    _WS[hkey] = h                    # workspace generation
            try:                      # scipy: complex64-preserving, threaded
                from scipy import fft as _sfft
                spec = _sfft.fft(sig, workers=4)
                spec *= h
                sig = _sfft.ifft(spec, workers=4, overwrite_x=True)
            except ImportError:
                spec = np.fft.fft(sig)
                spec *= h
                sig = np.fft.ifft(spec).astype(np.complex64, copy=False)

        rng = np.random.default_rng(self.seed + start_sample)
        v = sig.view(np.float32).reshape(n, 2)
        scale = np.float32(self.sigma / np.sqrt(2.0))
        noise = rng.standard_normal(n, dtype=np.float32)
        noise *= scale
        v[:, 0] += noise
        noise = rng.standard_normal(n, dtype=np.float32)
        noise *= scale
        v[:, 1] += noise

        if return_truth:
            truth = CaptureTruth(fs=fs, tow0=self.tow0, rx_ecef=self.rx,
                                 tow_frame0=self.tow_frame0,
                                 channels=truth_channels)
            return sig, truth
        return sig

    def write_capture(self, path: str, duration_s: float,
                      chunk_s: float = 1.0) -> None:
        """Stream a capture to an interleaved int16 I/Q file."""
        from .rawfile import DTYPE_IQ16
        total = int(round(duration_s * self.fs))
        chunk = int(round(chunk_s * self.fs))
        with open(path, "wb") as fo:
            done = 0
            while done < total:
                n = min(chunk, total - done)
                iq = self.generate(n, start_sample=done)
                out = np.empty(n, dtype=DTYPE_IQ16)
                out["i"] = np.clip(np.round(iq.real), -32768, 32767)
                out["q"] = np.clip(np.round(iq.imag), -32768, 32767)
                out.tofile(fo)
                done += n
