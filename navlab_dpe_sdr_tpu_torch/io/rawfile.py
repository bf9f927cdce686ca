"""Raw IF sample file access.

`SampleFile` wraps a binary capture of complex baseband samples (interleaved
int16 I/Q by default, or "arg_pi4" phase-quantized bytes) behind a
block-oriented reader with the same windowing semantics as the reference:

- T: coherent processing window (1 ms scalar / 20 ms DPE),
- T_big: duty-cycle interval (skip T_big - T between windows),
- precomputed index arrays (sample / time / chip) per window,
- carr_fftpts = 8 * 2^ceil(log2 S) zero-padded carrier FFT length.

Reads go through numpy memmap — the host never copies more than a block.

Parity: reference pygnss/pythonreceiver/libgnss/rawfile.py:9-189 and
cudarecv/modules/src/sampleblock.cu:102-247 (int16 I/Q at fs=2.5 MHz).

The port's own copy of navlab_dpe_sdr_tpu/io/rawfile.py (host float64
numpy, no torch); tests/test_torch_hostlayers.py holds it bit-equal to
that module.
"""

from __future__ import annotations

import numpy as np

from ..constants import F_CA, F_L1, L_CA, T_CA

DTYPE_IQ16 = np.dtype([("i", np.int16), ("q", np.int16)])
DTYPE_ARG_PI4 = np.dtype([("arg_pi4", np.int8)])


def parse_metafile(metafile: str, rawfile_name: str):
    """Read capture settings from a metafile (reference rawfile.py:39-87).

    Format: per capture, a `...=<filename>` line followed by lines whose
    values (fs, fi, ds, datatype, notes) start at fixed offsets.
    """
    import os.path

    with open(metafile) as fo:
        lines = fo.read().splitlines()
    for i, line in enumerate(lines):
        name = line[line.find("=") + 1:].strip()
        if name == rawfile_name:
            abspath = os.path.join(os.path.dirname(metafile), name)
            fs = float(lines[i + 1][5:])
            fi = float(lines[i + 2][5:])
            ds = float(lines[i + 3][5:])
            dt_text = lines[i + 4][11:].strip()
            datatype = (DTYPE_ARG_PI4 if "arg_pi4" in dt_text
                        else DTYPE_IQ16)
            notes = lines[i + 5][8:] if i + 5 < len(lines) else ""
            return dict(path=abspath, fs=fs, fi=fi, ds=ds,
                        datatype=datatype, notes=notes)
    raise KeyError(f"{rawfile_name} not found in {metafile}")


class SampleFile:
    """Block reader over a raw IF capture file (or an in-memory array)."""

    @classmethod
    def from_metafile(cls, metafile: str, rawfile_name: str) -> "SampleFile":
        cfg = parse_metafile(metafile, rawfile_name)
        cfg.pop("notes", None)
        return cls(**cfg)

    def __init__(self, path: str | None = None, fs: float = 2.5e6,
                 fi: float = 0.0, ds: float = 1.0,
                 datatype: np.dtype = DTYPE_IQ16,
                 samples: np.ndarray | None = None):
        self.abspath = path
        self.fs = float(fs)
        self.fi = float(fi)
        self.ds = float(ds)
        self.fcaid = ds * F_CA / F_L1   # code-frequency aiding factor
        self.datatype = np.dtype(datatype)

        if samples is not None:
            self._raw = np.ascontiguousarray(samples)
            if self._raw.dtype != self.datatype:
                raise ValueError("samples dtype must match datatype")
        else:
            self._raw = np.memmap(path, dtype=self.datatype, mode="r")

        self._pos = 0  # sample cursor
        self.rawsnippet: np.ndarray | None = None
        self.set_block(T_CA, T_CA, verbose=False)

    # -- cursor ------------------------------------------------------------

    @property
    def n_samples(self) -> int:
        return int(self._raw.shape[0])

    @property
    def sample_pos(self) -> int:
        return self._pos

    @property
    def time_pos(self) -> float:
        return self._pos / self.fs

    @property
    def bytes_read(self) -> int:
        return self._pos * self.datatype.itemsize

    def seek(self, n_samples: int, whence: int = 1) -> None:
        self._pos = (self._pos if whence == 1 else 0) + int(n_samples)

    def seek_bytes(self, n_bytes: int) -> None:
        assert n_bytes % self.datatype.itemsize == 0
        self._pos = n_bytes // self.datatype.itemsize

    # -- windowing ---------------------------------------------------------

    def set_block(self, T: float, T_big: float | None = None,
                  verbose: bool = False) -> None:
        """Configure the processing window (reference rawfile.py:160-189)."""
        T_big = T if T_big is None else T_big
        assert T_big >= T

        self.T = float(T)
        self.N = int(round(T / T_CA))          # 1 ms sub-blocks per window
        self.S = int(round(T * self.fs))       # samples per window
        self.samp_idc = np.arange(self.S)
        self.time_idc = self.samp_idc / self.fs
        self.code_idc = self.time_idc * F_CA

        code_idc = np.arange(int(round(T_CA * self.fs))) / self.fs * F_CA
        self.code_fftidc = np.fft.fftshift(
            np.where(code_idc >= L_CA / 2.0, code_idc - L_CA, code_idc))

        self.carr_fftpts = 8 * (1 << self.S.bit_length())
        self.carr_fftidc = np.fft.fftshift(
            np.fft.fftfreq(self.carr_fftpts, d=1.0 / self.fs))

        self.T_big = float(T_big)
        self.T_skip = self.T_big - self.T
        self.S_big = int(self.T_big * self.fs)
        self.S_skip = self.S_big - self.S
        if verbose:
            print(f"block: T={self.T}s S={self.S} T_big={self.T_big}s "
                  f"carr_fftpts={self.carr_fftpts}")

    # -- reading -----------------------------------------------------------

    def _format(self, raw: np.ndarray) -> np.ndarray:
        if self.datatype == DTYPE_IQ16:
            return raw["i"].astype(np.float64) + 1j * raw["q"].astype(np.float64)
        if self.datatype == DTYPE_ARG_PI4:
            return np.exp(1j * (raw["arg_pi4"] * (np.pi / 4.0)))
        raise ValueError(f"unknown datatype {self.datatype}")

    def read_block(self) -> np.ndarray:
        """Read the next S samples as complex128 and advance the cursor."""
        if self._pos + self.S > self.n_samples:
            raise EOFError(
                f"EOF: need {self.S} samples at {self._pos}, have {self.n_samples}")
        raw = self._raw[self._pos:self._pos + self.S]
        self._pos += self.S
        self.rawsnippet = self._format(raw)
        return self.rawsnippet

    def read_block_raw(self) -> np.ndarray:
        """Next S samples as raw int16 I/Q (shape [S, 2]) without conversion —
        the device pipeline does int16 -> float on-chip."""
        if self._pos + self.S > self.n_samples:
            raise EOFError("EOF")
        raw = self._raw[self._pos:self._pos + self.S]
        self._pos += self.S
        if self.datatype == DTYPE_IQ16:
            return np.ascontiguousarray(
                raw.view(np.int16).reshape(self.S, 2))
        out = self._format(raw)
        return np.stack([out.real, out.imag], axis=-1).astype(np.float32)

    def read_chunk_raw(self, k: int) -> np.ndarray:
        """Next k windows as raw int16 I/Q ([k*S, 2]) in ONE slice.

        The hot host path for multi-second tracking chunks: a per-window
        read_block loop pays ~2000 python iterations + complex128
        conversion per 2 s chunk (measured ~0.7 s of host per signal
        second — the term that kept the live fleet consumers ~6 s behind
        delivery, r5). Requires the gapless window config (T_big == T;
        tracking always sets it)."""
        if self.S_skip:
            raise ValueError("read_chunk_raw requires T_big == T")
        n = k * self.S
        if self._pos + n > self.n_samples:
            raise EOFError(
                f"EOF: need {n} samples at {self._pos}, have "
                f"{self.n_samples}")
        raw = self._raw[self._pos:self._pos + n]
        self._pos += n
        if self.datatype == DTYPE_IQ16:
            return np.ascontiguousarray(raw.view(np.int16).reshape(n, 2))
        out = self._format(raw)
        return np.stack([out.real, out.imag], axis=-1).astype(np.float32)

    def skip_gap(self) -> None:
        """Advance over the duty-cycle gap (T_big - T)."""
        if self.S_skip:
            self.seek(self.S_skip)


def write_iq16(path: str, iq: np.ndarray) -> None:
    """Write a complex array as interleaved int16 I/Q."""
    out = np.empty(iq.shape[0], dtype=DTYPE_IQ16)
    out["i"] = np.clip(np.round(iq.real), -32768, 32767).astype(np.int16)
    out["q"] = np.clip(np.round(iq.imag), -32768, 32767).astype(np.int16)
    out.tofile(path)
