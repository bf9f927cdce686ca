"""Flow runtime: block-loop execution with timing stats and a watchdog.

The reference's Flow engine runs modules in sequence on a real-time thread,
times every iteration, keeps avg/min/top-40 max statistics, and crashes the
flow if a block stalls past 1.5 s (flow.cu:105-197, sampleblock.cu:432-447).
Here the "modules" are the receiver's step callables; the stats and
fail-fast watchdog semantics are preserved.

The port's own copy of navlab_dpe_sdr_tpu/runtime/flow.py (host code, no
torch), with one addition: FlowStats.first_s, the time of iteration 1 (where
a cold process pays for its device context and kernel loads), which the
CLI prints; tests/test_torch_hostlayers.py holds the rest to that module.
"""

from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, field


class WatchdogError(RuntimeError):
    pass


@dataclass
class FlowStats:
    """Per-iteration timing aggregator (reference flow.cu:140-191)."""
    n: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    top_max: list = field(default_factory=list)   # min-heap of the N largest
    keep_max: int = 40
    first_s: float | None = None                  # iteration 1's time

    def add(self, dt: float):
        if self.n == 0:
            self.first_s = dt
        self.n += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        if len(self.top_max) < self.keep_max:
            heapq.heappush(self.top_max, dt)
        else:
            heapq.heappushpop(self.top_max, dt)

    @property
    def avg_s(self) -> float:
        return self.total_s / max(self.n, 1)

    def summary(self) -> str:
        worst = sorted(self.top_max, reverse=True)[:5]
        return (f"{self.n} iterations: avg {self.avg_s * 1e3:.3f} ms, "
                f"min {self.min_s * 1e3:.3f} ms, "
                f"top max {[round(w * 1e3, 2) for w in worst]} ms")


class FlowRunner:
    """Run a per-block step function with timing + watchdog.

    watchdog_s: per-iteration budget; exceeded => WatchdogError (the
    reference crashes the flow at 1.5 s, README.md:108). None disables.
    max_iterations: hard cap (the reference's 3000-block DPInit stop,
    dpinit.cpp:231).
    """

    def __init__(self, step_fn, watchdog_s: float | None = 1.5,
                 max_iterations: int | None = None,
                 realtime_budget_s: float | None = None,
                 source_fn=None, warmup_iterations: int = 0):
        self.step_fn = step_fn
        self.watchdog_s = watchdog_s
        self.max_iterations = max_iterations
        # warmup_iterations: iterations exempt from the watchdog (still
        # timed). The reference does all allocation/planning in Start() so
        # its iteration 1 is steady-state (flow.cu:28-87); here the device
        # context, cuFFT plans and kernel loads land on the first step, so
        # callers may grant it grace.
        self.warmup_iterations = warmup_iterations
        self.realtime_budget_s = realtime_budget_s
        # source_fn: untimed per-iteration sample fetch. The reference
        # starts iteration timing AFTER SampleBlock returns, isolating
        # compute from I/O wait (flow.cu:132-135) — with a live-paced
        # source the wait is wall-clock sample delivery, not work.
        # source_fn returning None (or raising EOFError) ends the run;
        # its result is passed to step_fn.
        self.source_fn = source_fn
        self.stats = FlowStats()
        self.realtime_misses = 0
        self.keep_running = True

    def stop(self):
        self.keep_running = False

    def run(self, n_iterations: int | None = None, on_result=None):
        i = 0
        while self.keep_running:
            if n_iterations is not None and i >= n_iterations:
                break
            if self.max_iterations is not None and \
                    self.stats.n >= self.max_iterations:
                break
            if self.source_fn is not None:
                try:
                    blk = self.source_fn()
                except EOFError:
                    break
                if blk is None:
                    break
            t0 = time.perf_counter()
            try:
                result = (self.step_fn(blk) if self.source_fn is not None
                          else self.step_fn())
            except EOFError:
                break
            dt = time.perf_counter() - t0
            self.stats.add(dt)
            if self.realtime_budget_s is not None and dt > self.realtime_budget_s:
                self.realtime_misses += 1
            if self.watchdog_s is not None and dt > self.watchdog_s \
                    and self.stats.n > self.warmup_iterations:
                raise WatchdogError(
                    f"iteration {self.stats.n} took {dt:.3f}s "
                    f"(> {self.watchdog_s}s watchdog)")
            if on_result is not None:
                on_result(result)
            i += 1
        return self.stats
