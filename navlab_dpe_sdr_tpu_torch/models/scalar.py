"""Scalar receiver on torch devices: acquisition -> tracking -> nav decode
-> PVT -> handoff.

Port of navlab_dpe_sdr_tpu/models/scalar.py. Host orchestration (float64
numpy, LNAV decode, nav solution, handoff and .mat checkpoints) is the JAX
receiver's, unchanged; the device work goes through ops/acquisition.py
(torch.fft) and ops/tracking.py (the K4 kernel on a CUDA device). Tracking
reads int16 chunks with `read_chunk_raw` and uploads chunk k+1 through
pinned memory on a copy stream while chunk k's kernel runs; the log comes
back as two packed fetches per chunk (floats and int32 counters).

`acquire` runs the FFT search, or with deep_ms > 0 the deep (weak-signal)
search of ops/acquisition.acquire_deep; `track` runs 1 ms updates,
coherent windows (coh_ms = 2..10) or the batch_k schedule, all on K4 on
the card. engine="real" (the all-real TPU search) is not ported by design
(ROADMAP "Not to port"). A JAX receiver's `save_state` checkpoint resumes
here, and the other way round.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import tracing
from ..constants import L_CA, T_CA
from ..device import resolve_device
from ..io.handoff import Handoff, write_handoff
from ..io.rawfile import SampleFile, read_windows_raw
from ..libgnss import dataparser, naveng
from ..libgnss.cacode import ca_table
from ..libgnss.ephemeris import ALL_FIELDS, EphArray, Ephemeris
from ..ops import acquisition as acq_ops
from ..ops import tracking as trk_ops
from . import navbits

LOG_FIELDS = ("iE", "qE", "iP", "qP", "iL", "qL", "rc", "ri", "fc", "fi",
              "cp", "lock", "lockval", "snr", "dpc", "dpi")
DECODE_OUTCOMES = ("hard", "too_short", "soft", "failed")


@dataclass
class ChannelLogs:
    """Per-channel measurement history (numpy, grows by chunk)."""
    prn: int
    data: dict = field(default_factory=dict)
    cp_sign: np.ndarray = field(default_factory=lambda: np.zeros(0))
    ephemeris: Ephemeris | None = None

    def append(self, **cols):
        for k, v in cols.items():
            self.data.setdefault(k, []).append(v)

    def col(self, name) -> np.ndarray:
        return (np.concatenate(self.data[name]) if self.data.get(name)
                else np.zeros(0))


class ScalarReceiver:
    """Multi-channel scalar (DLL/PLL) receiver over a SampleFile, on
    `device` (default "cuda"; a missing CUDA device raises)."""

    def __init__(self, rawfile: SampleFile, prn_list,
                 loops: trk_ops.LoopConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.rawfile = rawfile
        self.loops = loops or trk_ops.LoopConfig()
        self.prn_list = [int(p) for p in prn_list]
        self.channels = {p: ChannelLogs(prn=p) for p in self.prn_list}
        self.code_table = torch.from_numpy(
            ca_table(self.prn_list).astype(np.float32)).to(self.device)
        self.state: trk_ops.TrackState | None = None
        self.mcount = 0                  # loop updates absorbed so far
        self.coh_ms = 1                  # ms per update
        self._m_samp: list[int] = []
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.chunk_walls: list[tuple[int, float]] = []  # (ms, wall s)
        # channel-attempts of decode_ephemerides by outcome: decoded on the
        # signs, too short to frame (the soft path's gate), decoded on the
        # soft bits, or failed otherwise
        self.decode_counts = dict.fromkeys(DECODE_OUTCOMES, 0)

    # -- acquisition -------------------------------------------------------

    def acquire(self, T: float = 0.01, verbose: bool = True,
                engine: str = "auto", deep_ms: int = 0, n_coh_ms: int = 10):
        """Best-of-two-blocks acquisition (reference receiver.py:452-520)
        with the FFT engine; deep_ms > 0 searches ONE deep_ms-long capture
        with n_coh_ms coherent folds summed noncoherently across segments
        (e.g. deep_ms=400, n_coh_ms=10 acquires ~10 dB below the nominal
        search floor)."""
        if engine == "real":
            raise NotImplementedError(acq_ops.REAL_ENGINE_REFUSAL)
        if engine not in ("auto", "fft"):
            raise ValueError(f"unknown acquisition engine {engine!r}")
        if deep_ms:
            return self._acquire_deep(int(deep_ms), int(n_coh_ms), verbose)
        rf = self.rawfile
        start_pos = rf.sample_pos
        rf.set_block(T, T, verbose=False)
        block1 = rf.read_block().astype(np.complex64)
        block2 = rf.read_block().astype(np.complex64)
        rf.seek(start_pos, whence=0)
        rf.set_block(T_CA, T_CA, verbose=False)

        with tracing.span("scalar.acquire.search"):
            res1, res2 = (acq_ops.acquire(b, self.prn_list, rf.fs, rf.fcaid,
                                          device=self.device)
                          for b in (block1, block2))
        rc, ri, fc, fi = [], [], [], []
        results = []
        for r1, r2 in zip(res1, res2):
            if r2.cppm > r1.cppm:
                r = r2
                rc.append(np.mod(r.rc - r.fc * T, L_CA))
                ri.append(np.mod(r.ri - r.fi * T, 1.0))
            else:
                r = r1
                rc.append(r.rc)
                ri.append(r.ri)
            fc.append(r.fc)
            fi.append(r.fi)
            results.append(r)
            if verbose:
                print(f"PRN {r.prn:2d} found={r.found} rc={rc[-1]:8.2f} "
                      f"fi={r.fi:8.1f} cppm={r.cppm:5.2f}")
        self.state = trk_ops.init_state(rc=rc, ri=ri, fc=fc, fi=fi,
                                        device=self.device)
        return results

    def _acquire_deep(self, deep_ms: int, n_coh_ms: int, verbose: bool):
        """The deep search over the next deep_ms of the file (the JAX
        receiver's deep branch); the file stays where it was."""
        with tracing.span("scalar.acquire.deep"):
            rf = self.rawfile
            start_pos = rf.sample_pos
            rf.set_block(deep_ms * 1e-3, deep_ms * 1e-3, verbose=False)
            block = rf.read_block().astype(np.complex64)
            rf.seek(start_pos, whence=0)
            rf.set_block(T_CA, T_CA, verbose=False)
            results = acq_ops.acquire_deep(block, self.prn_list, rf.fs,
                                           rf.fcaid, n_coh_ms=n_coh_ms,
                                           device=self.device)
        if verbose:
            for r in results:
                print(f"PRN {r.prn:2d} found={r.found} rc={r.rc:8.2f} "
                      f"fi={r.fi:8.1f} cppm={r.cppm:5.2f} "
                      f"(deep {deep_ms} ms / {n_coh_ms} ms coh)")
        self.state = trk_ops.init_state(
            rc=[r.rc for r in results], ri=[r.ri for r in results],
            fc=[r.fc for r in results], fi=[r.fi for r in results],
            device=self.device)
        return results

    # -- tracking ----------------------------------------------------------

    def track(self, n_ms: int, chunk_ms: int = 2000, coh_ms: int = 1,
              batch_k: int = 1):
        """Track n_ms of data in device chunks, appending measurement logs.

        coh_ms > 1 is coherent predetection integration: one loop update
        (and one log row) per coh_ms ms; `mcount` and the log rows then
        count updates, coh_ms ms apart (self.coh_ms records the cadence),
        while cp stays the exact count of code periods. batch_k > 1 (1 ms
        cadence only) is the batch_k schedule (ops/tracking.
        track_chunk_batched). n_ms must be a multiple of either."""
        if self.state is None:
            raise RuntimeError("acquire() (or load_state) first")
        m = trk_ops.check_coh_ms(coh_ms)
        kb = int(batch_k)
        if kb < 1:
            raise ValueError(f"batch_k must be >= 1, got {kb}")
        if kb > 1 and m > 1:
            raise ValueError("batch_k applies to the 1 ms cadence only")
        step_ms = m if m > 1 else kb
        if n_ms % step_ms:
            raise ValueError(f"n_ms={n_ms} is not a multiple of "
                             f"{'coh_ms' if m > 1 else 'batch_k'}={step_ms}")
        chunk_ms = max(int(chunk_ms) - int(chunk_ms) % step_ms, step_ms)
        self.coh_ms = m
        rf = self.rawfile
        rf.set_block(T_CA, T_CA, verbose=False)
        s = rf.S
        sw = s * m                        # samples per update window

        def stage(n):
            """(n, first sample, device tensor [n, S m, 2], ready event):
            read n windows as int16 and queue their upload."""
            with tracing.span("scalar.track.stage"):
                start = rf.sample_pos
                host = np.ascontiguousarray(
                    read_windows_raw(rf, n * m).reshape(n, sw, 2))
                if not host.flags.writeable:   # a memmap window of a file
                    host = host.copy()
                t = torch.from_numpy(host)
                if self._copy_stream is None:
                    return n, start, t, None
                with torch.cuda.stream(self._copy_stream):
                    dev_t = t.pin_memory().to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
                return n, start, dev_t, ready

        done = 0
        nxt = stage(min(chunk_ms, n_ms) // m)
        while nxt is not None:
            t0 = time.perf_counter()
            n, start_samp, raw_dev, ready = nxt
            done += n * m
            if ready is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ready)
                raw_dev.record_stream(cur)
            self.state, logf, logi = trk_ops.track_chunk_packed(
                self.state, raw_dev, self.code_table, rf.fs, rf.fcaid,
                self.loops, coh_ms=m, batch_k=kb)
            # the next chunk's read and upload overlap this chunk's kernel
            nxt = (stage(min(chunk_ms, n_ms - done) // m) if done < n_ms
                   else None)
            with tracing.span("scalar.track.fetch"):    # waits for K4
                packed, ints = logf.cpu().numpy(), logi.cpu().numpy()
            with tracing.span("scalar.track.unpack"):
                self._absorb_log(packed, ints)
                self._m_samp.extend(start_samp + (np.arange(n) + 1) * sw)
                self.mcount += n
            # host wall per chunk, the log fetch included (it waits for the
            # kernel): the tracking real-time factor is n m ms / this
            self.chunk_walls.append((n * m, time.perf_counter() - t0))

    def _absorb_log(self, packed: np.ndarray, ints: np.ndarray):
        """Append one chunk's packed log, fetched to the host (packed
        [steps, log_f_rows(m), C] floats, ints [steps, 3, C]), and expand
        the m + 1 nav-bit signs of each update (one per code period the
        window touches; the first ncp of them completed) into each
        channel's cp_sign, in period order. At m > 1 each channel also keeps
        its windows' prompt segment sums (column "pseg", [steps, m + 2]
        complex), the soft decode's input."""
        m = self.coh_ms
        arrs = {k: packed[:, i] for i, k in enumerate(trk_ops.LOG_F_BASE)}
        arrs.update({k: ints[:, i] for i, k in enumerate(trk_ops.LOG_I_ROWS)})
        arrs["lock"] = arrs["lock"].astype(np.float32)
        ncp = ints[:, 1]                                   # [steps, C]
        n_base = len(trk_ops.LOG_F_BASE)
        signs = np.moveaxis(packed[:, n_base:n_base + m + 1], 1, 2)
        if m > 1:
            seg = packed[:, n_base + m + 1:].reshape(len(packed), m + 2, 2, -1)
            arrs["pseg"] = np.moveaxis(seg[:, :, 0] + 1j * seg[:, :, 1], 2, 1)
        kmax = signs.shape[2]
        k_arange = np.arange(kmax)[None, :]
        for ci, prn in enumerate(self.prn_list):
            ch = self.channels[prn]
            ch.append(**{k: arrs[k][:, ci] for k in LOG_FIELDS})
            if m > 1:
                ch.append(pseg=arrs["pseg"][:, ci])
            take = k_arange < np.minimum(ncp[:, ci], kmax)[:, None]
            if take.any():
                ch.cp_sign = np.concatenate([ch.cp_sign,
                                             signs[:, ci, :][take]])

    # -- navigation (host, from the JAX receiver, with a soft fallback) -----

    def decode_ephemerides(self, verbose: bool = True):
        """Frame + decode LNAV for each channel from its cp_sign stream.

        Where a channel's signs are too noisy for the sign framer (more
        wrong than it tolerates, models/navbits.py), its bits are decided
        from the prompt's soft values against a smooth carrier instead, and
        taken only with all 50 words passing parity and the ephemeris
        complete: for every such channel at once, in one float64 pass on
        the receiver's device (`navbits.soft_bits`), then framed and parsed
        on the host. A stream too short to frame (under
        navbits.MIN_FRAME_PERIODS) fails as the framer would, with no soft
        work. Each channel's outcome is counted in `decode_counts`. The
        result is `_parse`'s, channel by channel. The JAX receiver has no
        soft path."""
        with tracing.span("scalar.decode"):
            got, soft = {}, {}
            with tracing.span("scalar.decode.hard"):
                for prn in self.prn_list:
                    try:
                        got[prn] = self._parse_hard(prn)
                        if got[prn] is None:
                            self._check_segments(prn)
                            n = len(self.channels[prn].cp_sign)
                            if n < navbits.MIN_FRAME_PERIODS:
                                raise navbits.TooShort()
                            soft[prn] = n
                    except ValueError as e:
                        got[prn] = e
            if soft:
                with tracing.span("scalar.decode.soft"):
                    t_win = self._t_win()
                    bits = navbits.soft_bits(
                        [self._soft_args(p, t_win) for p in soft],
                        self.device)
                for (prn, n), (o, b) in zip(soft.items(), bits):
                    try:
                        got[prn] = self._take_soft(
                            prn, navbits.framed_signs(b, o, n))
                    except ValueError as e:
                        got[prn] = e
            good = []
            for prn in self.prn_list:
                res = got[prn]
                if isinstance(res, ValueError):
                    self.decode_counts["too_short" if isinstance(
                        res, navbits.TooShort) else "failed"] += 1
                    if verbose:
                        print(f"PRN {prn:2d}: decode failed: {res}")
                    continue
                eph, parity_ok = res
                self.decode_counts["soft" if prn in soft else "hard"] += 1
                self.channels[prn].ephemeris = eph
                good.append(prn)
                if verbose:
                    print(f"PRN {prn:2d}: TOW {eph.tow_timestamp:.0f} at cp "
                          f"{eph.cp_timestamp:.0f}, parity {parity_ok}/50, "
                          f"complete={eph.complete}")
        return good

    def _parse_hard(self, prn: int):
        """(ephemeris, words passing parity) of channel `prn` framed on its
        signs, or None where the sign framer failed on signs more often
        wrong than it tolerates (the soft path's channels). Raises the
        framer's error otherwise."""
        ch = self.channels[prn]
        try:
            return dataparser.parse_ephemerides(ch.cp_sign, cp_offset=0.0,
                                                prn=prn)
        except ValueError:
            if navbits.sign_disagreement(ch.cp_sign) <= navbits.HARD_ERRORS:
                raise
        return None

    def _take_soft(self, prn: int, signs: np.ndarray):
        """(ephemeris, words passing parity) parsed from channel `prn`'s
        clean soft sign stream; raises unless all 50 words pass parity and
        the ephemeris is complete."""
        eph, parity_ok = dataparser.parse_ephemerides(signs, cp_offset=0.0,
                                                      prn=prn)
        if parity_ok < navbits.WORDS or not eph.complete:
            raise ValueError(f"soft bits: parity {parity_ok}/"
                             f"{navbits.WORDS}, complete={eph.complete}")
        return eph, parity_ok

    def _parse(self, prn: int):
        """(ephemeris, words passing parity) of channel `prn` by the plain
        per-channel path, the reference `decode_ephemerides` is held to:
        framed on its signs, or, where `_parse_hard` leaves it to the soft
        path, on its soft bits (`navbits.clean_signs` of `_soft_signs`)."""
        got = self._parse_hard(prn)
        if got is not None:
            return got
        return self._take_soft(prn, navbits.clean_signs(self._soft_signs(prn)))

    def _check_segments(self, prn: int) -> None:
        """Raises ValueError unless channel `prn` logged prompt segments
        for every update (not at a 1 ms cadence, nor in a log resumed from
        a checkpoint)."""
        u = sum(len(s) for s in self.channels[prn].data.get("pseg", ()))
        if u == 0 or u != self.mcount:
            raise ValueError(f"soft bits: prompt segments logged for {u} of "
                             f"{self.mcount} updates (coherent windows only)")

    def _t_win(self) -> np.ndarray:
        """[mcount] each update window's first sample time [s]."""
        m = self.coh_ms
        rf = self.rawfile
        return (np.asarray(self._m_samp[:self.mcount], np.float64)
                - round(rf.fs * 1e-3) * m) / rf.fs

    def _soft_args(self, prn: int, t_win: np.ndarray | None = None) -> tuple:
        """`navbits.soft_periods`' arguments for channel `prn`: the prompt
        segments K4 logged for its coherent windows, its log at each
        window's start (t_win, `_t_win()` where not given), and its
        cp_sign's length. Raises `_check_segments`' error."""
        self._check_segments(prn)
        ch = self.channels[prn]
        t_win = self._t_win() if t_win is None else t_win
        return (ch.col("pseg"), ch.col("cp"), t_win, ch.col("rc"),
                ch.col("fc"), ch.col("ri"), ch.col("fi"), self.coh_ms,
                len(ch.cp_sign))

    def _soft_signs(self, prn: int) -> np.ndarray:
        """The prompt's complex sum of each completed code period of
        channel `prn`, indexed like its cp_sign, against a smooth carrier
        (navbits.soft_periods of `_soft_args`)."""
        return navbits.soft_periods(*self._soft_args(prn))

    def set_ephemerides(self, eph_by_prn: dict[int, Ephemeris]):
        for prn, eph in eph_by_prn.items():
            if prn in self.channels:
                self.channels[prn].ephemeris = eph

    def eph_array(self, prns=None) -> EphArray:
        prns = prns if prns is not None else self.prn_list
        return EphArray([self.channels[p].ephemeris for p in prns])

    def observables(self, mc: int | None = None):
        """(cp, rc, fi) per channel at measurement index mc (default
        last)."""
        mc = (self.mcount - 1) if mc is None else mc
        cp = np.array([self.channels[p].col("cp")[mc] for p in self.prn_list],
                      dtype=np.float64)
        rc = np.array([self.channels[p].col("rc")[mc] for p in self.prn_list])
        fi = np.array([self.channels[p].col("fi")[mc] for p in self.prn_list])
        return cp, rc, fi

    def nav_solution(self, mc: int | None = None, rx_time0=None,
                     rx_pos0=None):
        cp, rc, fi = self.observables(mc)
        return naveng.calculate_nav_soln(cp, rc, fi, self.eph_array(),
                                         doppler_sign=self.rawfile.ds,
                                         rx_time0=rx_time0, rx_pos0=rx_pos0)

    # -- handoff -----------------------------------------------------------

    def save_handoff(self, path: str, mc: int | None = None) -> Handoff:
        """DPE-initialization checkpoint at measurement mc: rx_time and the
        channel state at the epoch of the sample at bytes_read (the JAX
        receiver's contract; log row mc is propagated across its window)."""
        mc = (self.mcount - 1) if mc is None else mc
        rx_time_a, rx_time, x_ecef, _, _ = self.nav_solution(mc)
        dt = self.coh_ms * 1e-3          # window span of log row mc

        h = Handoff()
        h.rx_time = float(rx_time) + dt
        h.rx_time_a = float(rx_time_a) + dt
        h.x_ecef = np.asarray(x_ecef).ravel()
        h.x_ecef[0:3] += h.x_ecef[4:7] * dt
        h.x_ecef[3] += h.x_ecef[7] * dt
        h.bytes_read = int(self._m_samp[mc] * self.rawfile.datatype.itemsize)
        h.prn_list = list(self.prn_list)
        for name in ("rc", "ri", "fc", "fi", "cp"):
            setattr(h, name, np.array(
                [self.channels[p].col(name)[mc] for p in self.prn_list],
                dtype=np.float64))
        adv = h.rc + h.fc * dt
        h.cp = h.cp + np.floor(adv / L_CA)
        h.rc = np.mod(adv, L_CA)
        h.ri = np.mod(h.ri + h.fi * dt, 1.0)
        h.cp_timestamp = np.array(
            [self.channels[p].ephemeris.cp_timestamp for p in self.prn_list])
        h.tow = np.array(
            [self.channels[p].ephemeris.tow_timestamp for p in self.prn_list])
        for name in ALL_FIELDS + ("IODE", "IODC"):
            h.eph_fields[name] = np.array(
                [getattr(self.channels[p].ephemeris, name)
                 for p in self.prn_list], dtype=np.float64)
        if path:
            write_handoff(path, h)
        return h

    # -- checkpoint / resume (the JAX receiver's .mat format) --------------

    def save_state(self, dirname: str):
        """Measurement logs + the complete tracking carry, so resumed
        tracking continues the same run."""
        import scipy.io as sio

        os.makedirs(dirname, exist_ok=True)
        rec = {
            "prn_list": np.array(self.prn_list),
            "mcount": self.mcount,
            "m_samp": np.array(self._m_samp, dtype=np.int64),
            "fs": self.rawfile.fs,
            "sample_pos": self.rawfile.sample_pos,
        }
        if self.state is not None:
            for name, val in trk_ops.state_to_numpy(self.state).items():
                rec["state_" + name] = val
        sio.savemat(os.path.join(dirname, "receiver.mat"), rec)

        for prn in self.prn_list:
            ch = self.channels[prn]
            d = {"log_" + k: ch.col(k) for k in LOG_FIELDS}
            d["cp_sign"] = ch.cp_sign
            if ch.ephemeris is not None:
                for fld in ALL_FIELDS + ("IODE", "IODC", "tow_timestamp",
                                         "cp_timestamp"):
                    d["eph_" + fld] = getattr(ch.ephemeris, fld)
            sio.savemat(os.path.join(dirname, f"channel_{prn}.mat"), d)

    def load_state(self, dirname: str):
        """Restore a checkpoint written by either package's save_state and
        reposition the sample file at the next block."""
        import scipy.io as sio

        rec = sio.loadmat(os.path.join(dirname, "receiver.mat"))
        if list(rec["prn_list"].ravel()) != self.prn_list:
            raise ValueError(f"checkpoint PRNs {list(rec['prn_list'].ravel())}"
                             f" != receiver PRNs {self.prn_list}")
        self.mcount = int(rec["mcount"].ravel()[0])
        self._m_samp = list(rec["m_samp"].ravel())
        self.rawfile.seek(int(rec["sample_pos"].ravel()[0]), whence=0)
        self.state = trk_ops.state_from_numpy(
            {name: rec["state_" + name]
             for name in trk_ops.TrackState._fields}, self.device)

        for prn in self.prn_list:
            d = sio.loadmat(os.path.join(dirname, f"channel_{prn}.mat"))
            ch = self.channels[prn]
            ch.data = {k: [d["log_" + k].ravel()] for k in LOG_FIELDS}
            ch.cp_sign = d["cp_sign"].ravel()
            if "eph_sqrt_A" in d:
                e = Ephemeris(prn=prn)
                for fld in ALL_FIELDS + ("tow_timestamp", "cp_timestamp"):
                    setattr(e, fld, float(d["eph_" + fld].ravel()[0]))
                e.IODE = int(d["eph_IODE"].ravel()[0])
                e.IODC = int(d["eph_IODC"].ravel()[0])
                e.complete = True
                ch.ephemeris = e

    def get_nms_correlation(self, prn: int, ms: int, n: int):
        """Bit-synchronized E/P/L sums over the last n 1 ms correlations
        ending at measurement ms, segments between nav-bit boundaries
        sign-aligned (reference channel.get_Nms_correlation,
        channel.py:344-422). Returns (iE, iP, iL, qE, qP, qL)."""
        ch = self.channels[prn]
        if ch.ephemeris is None:
            raise ValueError("ephemeris anchor (cp_timestamp) required")
        cp = ch.col("cp")[ms - n:ms]
        cp_idc = np.mod(cp - ch.ephemeris.cp_timestamp, 20)
        bd_idc = np.where(np.diff(cp_idc) < 0)[0]
        if len(bd_idc) > 2:
            raise ValueError(f"{len(bd_idc)} bit boundaries in {n} ms")

        cols = {k: ch.col(k)[ms - n:ms].copy()
                for k in ("iE", "iP", "iL", "qE", "qP", "qL")}
        combined = (cols["iE"] + cols["iP"] + cols["iL"]
                    + 1j * (cols["qE"] + cols["qP"] + cols["qL"]))

        bounds = [0] + [int(b) + 1 for b in bd_idc] + [n]
        ref_sum = np.sum(combined[bounds[0]:bounds[1]])
        for k in range(1, len(bounds) - 1):
            seg = slice(bounds[k], bounds[k + 1])
            seg_sum = np.sum(combined[seg])
            if abs(ref_sum + seg_sum) < abs(ref_sum - seg_sum):
                for name in cols:
                    cols[name][seg] = -cols[name][seg]
                seg_sum = -seg_sum
            ref_sum = ref_sum + seg_sum
        return (cols["iE"], cols["iP"], cols["iL"],
                cols["qE"], cols["qP"], cols["qL"])
