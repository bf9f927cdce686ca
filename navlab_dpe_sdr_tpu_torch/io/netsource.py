"""TCP sample source: stream int16 I/Q blocks from a socket.

The reference's SampleBlock has a (shipped but unused) TCP mode for live
sample delivery (sampleblock.cu:134-156). This is the working equivalent: a
client that connects to a sample server and yields fixed-size blocks, plus a
file-backed server for tests/replay.

The port's own copy of navlab_dpe_sdr_tpu/io/netsource.py (host code, no
torch); tests/test_torch_hostlayers.py holds it to that module.
"""

from __future__ import annotations

import socket
import threading

import numpy as np


def open_tcp_source(host: str, port: int, block_samples: int,
                    timeout_s: float = 1.5, start_byte: int = 0):
    """Preferred constructor: the native ring-buffered TCP source
    (runtime/native/sample_reader.cpp sr_open_tcp — producer thread +
    N-deep ring, true double buffering) when the native runtime is built,
    else the pure-Python blocking reader below."""
    try:
        from ..runtime.nativelib import SampleStream
        return SampleStream(f"tcp://{host}:{port}",
                            block_samples=block_samples,
                            start_byte=start_byte, timeout_s=timeout_s)
    except Exception:
        return TcpSampleSource(host, port, block_samples,
                               timeout_s=timeout_s, start_byte=start_byte)


class TcpSampleSource:
    """Blocking block reader over a TCP byte stream of int16 I/Q samples."""

    def __init__(self, host: str, port: int, block_samples: int,
                 timeout_s: float = 1.5, start_byte: int = 0):
        self.block_samples = block_samples
        self.block_bytes = block_samples * 4
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.settimeout(timeout_s)
        left = start_byte                 # drain the skip prefix (no lseek
        while left > 0:                   # on a socket)
            chunk = self.sock.recv(min(left, 65536))
            if not chunk:
                raise EOFError("stream ended inside start_byte prefix")
            left -= len(chunk)

    def next_block(self) -> np.ndarray | None:
        """Next [S, 2] int16 block; None on clean EOF; TimeoutError on
        watchdog expiry (reference 1.5 s fail-fast)."""
        buf = bytearray()
        while len(buf) < self.block_bytes:
            try:
                chunk = self.sock.recv(self.block_bytes - len(buf))
            except socket.timeout:
                raise TimeoutError("TCP sample stream stalled")
            if not chunk:
                return None if not buf else None
            buf.extend(chunk)
        return np.frombuffer(bytes(buf), dtype=np.int16).reshape(
            self.block_samples, 2)

    def close(self):
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileReplayServer:
    """Serve a capture file over TCP (test/replay harness)."""

    def __init__(self, path: str, port: int = 0, chunk_bytes: int = 65536):
        self.path = path
        self.chunk_bytes = chunk_bytes
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        conn, _ = self._srv.accept()
        try:
            with open(self.path, "rb") as fo:
                while True:
                    chunk = fo.read(self.chunk_bytes)
                    if not chunk:
                        break
                    conn.sendall(chunk)
        finally:
            conn.close()
            self._srv.close()

    def join(self):
        self._thread.join()


class PacedReplayServer:
    """Serve a capture over TCP at TRUE wall-clock sample rate.

    The RunLive scenario the reference defines but never demonstrates
    (sampleblock.cu:421-426: live sources deliver at the front-end rate
    and the receiver must keep up or drop): bytes leave the socket on an
    absolute schedule of fs samples/s (4 B/sample int16 I/Q), in
    pace_chunk-sample chunks. `behind_max_s` records the furthest the
    server itself ever fell behind its schedule (socket backpressure from
    a receiver that stops draining shows up here).
    """

    def __init__(self, path: str, fs: float = 2.5e6, port: int = 0,
                 start_byte: int = 0, pace_chunk: int = 12500):
        self.path = path
        self.fs = float(fs)
        self.start_byte = start_byte
        self.chunk_bytes = pace_chunk * 4
        self.bytes_per_s = self.fs * 4.0
        self.behind_max_s = 0.0
        self.bytes_sent = 0
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        import time
        conn, _ = self._srv.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            with open(self.path, "rb") as fo:
                fo.seek(self.start_byte)
                t0 = time.perf_counter()
                while True:
                    chunk = fo.read(self.chunk_bytes)
                    if not chunk:
                        break
                    target = t0 + self.bytes_sent / self.bytes_per_s
                    now = time.perf_counter()
                    if now < target:
                        time.sleep(target - now)
                    else:
                        self.behind_max_s = max(self.behind_max_s,
                                                now - target)
                    conn.sendall(chunk)
                    self.bytes_sent += len(chunk)
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            conn.close()
            self._srv.close()

    def join(self, timeout=None):
        self._thread.join(timeout)
