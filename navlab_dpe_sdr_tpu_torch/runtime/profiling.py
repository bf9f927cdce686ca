"""Process resource profiling (TmUsage equivalent).

The reference's auxil::TmUsage snapshots /proc + rusage for CPU-time and
peak-memory deltas (auxil.h:33-57, tm_usage.cpp). Same here, plus simple
throughput counters for the receiver loops.

The port's own copy of navlab_dpe_sdr_tpu/runtime/profiling.py (host code,
no torch); tests/test_torch_hostlayers.py holds it to that module.
"""

from __future__ import annotations

import resource
import time
from dataclasses import dataclass, field


def vm_peak_kb() -> int:
    try:
        with open("/proc/self/status") as fo:
            for line in fo:
                if line.startswith("VmPeak:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return -1


@dataclass
class UsageSnapshot:
    wall: float
    user: float
    system: float
    max_rss_kb: int
    vm_peak_kb: int


def snapshot() -> UsageSnapshot:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return UsageSnapshot(wall=time.time(), user=ru.ru_utime,
                         system=ru.ru_stime, max_rss_kb=ru.ru_maxrss,
                         vm_peak_kb=vm_peak_kb())


class TmUsage:
    """start()/elapsed() CPU + wall deltas (reference TmUsage semantics)."""

    def __init__(self):
        self.start()

    def start(self):
        self._t0 = snapshot()

    def elapsed(self) -> dict:
        t1 = snapshot()
        return {"wall_s": t1.wall - self._t0.wall,
                "user_s": t1.user - self._t0.user,
                "system_s": t1.system - self._t0.system,
                "max_rss_kb": t1.max_rss_kb,
                "vm_peak_kb": t1.vm_peak_kb}


@dataclass
class Counters:
    """Throughput counters (samples/s, grid-points/s — BASELINE metrics)."""
    samples: int = 0
    grid_points: int = 0
    blocks: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def add_block(self, n_samples: int, n_grid_points: int = 0):
        self.samples += n_samples
        self.grid_points += n_grid_points
        self.blocks += 1

    def rates(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"samples_per_s": self.samples / dt,
                "grid_points_per_s": self.grid_points / dt,
                "blocks_per_s": self.blocks / dt,
                "elapsed_s": dt}
