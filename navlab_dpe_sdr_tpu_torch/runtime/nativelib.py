"""ctypes bindings for the native host runtime (sample streamer + async
logger): the port of navlab_dpe_sdr_tpu/runtime/nativelib.py.

The sources are the port's own copies, `runtime/native/{sample_reader,
csv_logger}.cpp` (package data). At first use they are compiled with the
host C++ compiler ($CXX, else g++) into one shared library in the port's
build directory (ops/_build.build_dir(), listed in .gitignore), under a
name that carries a hash of the sources and the flags; nothing is built
when the module is imported. If no compiler is there, `load` raises
NativeUnavailable and the callers (io/netsource.open_tcp_source) take
their pure-Python paths. This is host code: no CUDA, no torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ..ops import _build

_DIR = pathlib.Path(__file__).resolve().parent / "native"
SOURCES = ("sample_reader.cpp", "csv_logger.cpp")
CXX_FLAGS = ("-O2", "-Wall", "-fPIC", "-shared", "-pthread")
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update((_DIR / name).read_bytes())
    return _build.build_dir() / f"libnavruntime_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise NativeUnavailable("cannot build native runtime: no C++ "
                                "compiler (set CXX or put g++ on PATH)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                          *(str(_DIR / n) for n in SOURCES)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise NativeUnavailable(f"cannot build native runtime (exit "
                                f"{res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader never sees half


def load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        lib.sr_open.restype = ctypes.c_void_p
        lib.sr_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                                ctypes.c_long, ctypes.c_double]
        lib.sr_open_tcp.restype = ctypes.c_void_p
        lib.sr_open_tcp.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_long, ctypes.c_int,
                                    ctypes.c_long, ctypes.c_double]
        lib.sr_next.restype = ctypes.c_long
        lib.sr_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.sr_depth.restype = ctypes.c_int
        lib.sr_depth.argtypes = [ctypes.c_void_p]
        lib.sr_close.argtypes = [ctypes.c_void_p]
        lib.lg_open.restype = ctypes.c_void_p
        lib.lg_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_double]
        lib.lg_open2.restype = ctypes.c_void_p
        lib.lg_open2.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_int]
        lib.lg_write.restype = ctypes.c_int
        lib.lg_write.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_double)]
        lib.lg_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class SampleStream:
    """Threaded block reader over a capture file (native ring buffer).

    Equivalent of CUDARecv's SampleBlock producer thread + 32-deep ring
    (sampleblock.cu:307-515). Yields int16 I/Q blocks of block_samples.
    """

    def __init__(self, path: str, block_samples: int, n_buffers: int = 32,
                 start_byte: int = 0, bytes_per_sample: int = 4,
                 timeout_s: float = 1.5):
        """path: a capture file, or "tcp://host:port" for the live socket
        source (reference sampleblock.cu:134-156 — working here)."""
        lib = load()
        self._lib = lib
        self.block_samples = block_samples
        self.block_bytes = block_samples * bytes_per_sample
        if path.startswith("tcp://"):
            host, _, port = path[6:].rpartition(":")
            self._h = lib.sr_open_tcp(host.encode(), int(port),
                                      self.block_bytes, n_buffers,
                                      start_byte, timeout_s)
        else:
            self._h = lib.sr_open(path.encode(), self.block_bytes,
                                  n_buffers, start_byte, timeout_s)
        if not self._h:
            raise OSError(f"sr_open failed for {path}")
        self._buf = np.empty(self.block_bytes, dtype=np.uint8)

    def next_block(self) -> np.ndarray | None:
        """Next block as int16 [S, 2], or None at EOF. Raises TimeoutError
        on watchdog expiry (reference crash semantics)."""
        got = self._lib.sr_next(self._h, self._buf.ctypes.data_as(
            ctypes.c_void_p))
        if got < 0:
            raise TimeoutError("sample stream watchdog expired")
        if got < self.block_bytes:
            return None
        return self._buf.view(np.int16).reshape(self.block_samples, 2).copy()

    @property
    def depth(self) -> int:
        return self._lib.sr_depth(self._h)

    def close(self):
        if self._h:
            self._lib.sr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncLogger:
    """Non-blocking CSV row logger (native writer thread).

    Equivalent of CUDARecv's DataLogger/XECEFLogger (datalogger.cu:45-278).
    """

    def __init__(self, path: str, n_cols: int, depth: int = 64,
                 timeout_s: float = 1.5, binary: bool = False):
        lib = load()
        self._lib = lib
        self.n_cols = n_cols
        self.binary = binary
        self._h = lib.lg_open2(path.encode(), n_cols, depth, timeout_s,
                               1 if binary else 0)
        if not self._h:
            raise OSError(f"lg_open failed for {path}")

    def write(self, row) -> None:
        arr = np.ascontiguousarray(row, dtype=np.float64)
        if arr.size != self.n_cols:
            raise ValueError(f"row of {arr.size} values, logger has "
                             f"{self.n_cols} columns")
        rc = self._lib.lg_write(self._h, arr.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise TimeoutError("logger ring full past watchdog")

    def close(self):
        if self._h:
            self._lib.lg_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PortLogger:
    """Attach an async logger to ANY receiver port (datalogger.cu:34:
    DATATYPE_ANY / VALUETYPE_ANY / VECTORLENGTH_ANY).

    `getter` produces the port value each step: any array-like of fixed
    size, real or complex (complex is interleaved re,im per element,
    datalogger.cu:241-243). Column count is latched from the first value;
    format is CSV or raw binary float64.
    """

    def __init__(self, path: str, getter, binary: bool = False,
                 depth: int = 64, timeout_s: float = 1.5):
        self.path = path
        self.getter = getter
        self.binary = binary
        self.depth = depth
        self.timeout_s = timeout_s
        self._logger: AsyncLogger | None = None
        self.rows = 0

    @staticmethod
    def _flatten(value) -> np.ndarray:
        arr = np.asarray(value)
        if np.iscomplexobj(arr):
            arr = np.stack([arr.real, arr.imag], axis=-1)
        return np.ravel(arr).astype(np.float64)

    def step(self):
        row = self._flatten(self.getter())
        if self._logger is None:
            self._logger = AsyncLogger(self.path, n_cols=row.size,
                                       depth=self.depth,
                                       timeout_s=self.timeout_s,
                                       binary=self.binary)
        self._logger.write(row)
        self.rows += 1

    def close(self):
        if self._logger is not None:
            self._logger.close()
            self._logger = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
