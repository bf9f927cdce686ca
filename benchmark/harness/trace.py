"""Spans from the harness's own wrappers, and the device's side of a
window from torch.profiler.

`Spans` times calls into the program's layers on the host clock when it is
on (the traced run), and does nothing else when it is off. `Work` adds up
the operations and bytes of the kernel calls made inside the traced window,
from their arguments' shapes (harness/roofline.py). `DeviceWindow` runs the
profiler over two lead-ins and the window and reduces its device records to
what the per-layer metrics read (`LayerContext`): the busy time (the union
of kernels, copies and sets), the records' names and times, and the idle
gaps labelled with the host span open at the time.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

MARK = "bench.window"
MARK_LEAD = "bench.lead_in"
NEST = 16          # spans an idle gap's label is looked for among


class Spans:
    def __init__(self, on: bool):
        self.on = on
        self.open = False          # inside the traced window
        self.spans: dict[str, list] = defaultdict(list)

    def wrap(self, name: str, fn):
        if not self.on:
            return fn

        def timed(*a, **kw):
            if not self.open:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.spans[name].append((t0, time.perf_counter()))
        return timed


class Work:
    """(operations, bytes) of the kernel calls inside the traced window,
    by kernel; entries whose count needs device data are kept as closures
    and evaluated after the window, so that nothing waits on the device
    inside it."""

    def __init__(self):
        self.open = False
        self.calls: dict[str, list] = defaultdict(list)

    def add(self, kernel: str, count) -> None:
        if self.open:
            self.calls[kernel].append(count)

    def totals(self) -> dict:
        out = {}
        for k, counts in self.calls.items():
            ops = nbytes = 0.0
            for c in counts:
                o, b = c() if callable(c) else c
                ops += o
                nbytes += b
            out[k] = (ops, nbytes, len(counts))
        return out


@contextlib.contextmanager
def patched(module, name: str, make):
    """module.name replaced by make(original) for the block."""
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


class LayerContext:
    """What a per-layer metric reads: the window's device records and busy
    time, the host spans inside it, the counts of the traffic driver and
    the kernels' work."""

    def __init__(self, window_s, busy_s, events, spans, counts, work):
        self.window_s = window_s
        self.busy_s = busy_s
        self.events = events          # [(name, start_us, end_us)]
        self.spans = spans            # {name: [(t0, t1)]} host seconds
        self.counts = counts          # {"blocks": ..., "steps": ...}
        self.work = work              # {kernel: (ops, bytes, calls)}

    def device_s(self, *patterns) -> float:
        return sum(e - s for n, s, e in self.events
                   if any(p in n for p in patterns)) / 1e6

    def device_records(self, *patterns) -> int:
        return sum(1 for n, _, _ in self.events
                   if not patterns or any(p in n for p in patterns))

    def span_s(self, name: str) -> float:
        return sum(t1 - t0 for t0, t1 in self.spans.get(name, ()))

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))


class DeviceWindow:
    """torch.profiler over the lead-ins and the window (trace on), or
    nothing (trace off). Use: `with dw.lead_in(): ...` twice, then `with
    dw.window(): ...`, then `dw.reduce(...)` after leaving `dw`."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = device
        self.prof = None
        self.host0 = self.host1 = None

    def __enter__(self):
        if self.on:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def lead_in(self):
        with (torch.profiler.record_function(MARK_LEAD) if self.on
              else contextlib.nullcontext()):
            yield
            self._sync()

    @contextlib.contextmanager
    def window(self):
        self._sync()
        with (torch.profiler.record_function(MARK) if self.on
              else contextlib.nullcontext()):
            self.host0 = time.perf_counter()
            yield
            self._sync()
            self.host1 = time.perf_counter()

    def reduce(self, spans: Spans, counts: dict, work: Work,
               top: int = 10):
        """(LayerContext, device dict entries, breakdown) of the window."""
        cuda = torch.autograd.DeviceType.CUDA
        evs = self.prof.events()
        mark = [e.time_range for e in evs
                if e.name == MARK and e.device_type != cuda][0]
        w0, w1 = mark.start, mark.end
        recs = sorted(
            ((e.name, e.time_range.start, e.time_range.end) for e in evs
             if e.device_type == cuda and not e.name.startswith("bench.")
             and w0 <= e.time_range.start <= w1), key=lambda r: r[1])
        # the union of the device's busy intervals inside the window
        busy, gaps, cur = 0.0, [], None
        edge = w0
        for _, s, e in recs:
            e = min(e, w1)
            if cur is None or s > cur[1]:
                if cur is not None:
                    busy += cur[1] - cur[0]
                gaps.append((edge if cur is None else cur[1], s))
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        if cur is not None:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], w1))
        else:
            gaps.append((w0, w1))
        window_s = (w1 - w0) / 1e6
        # host spans inside the window, and the idle gaps labelled with the
        # innermost span open at each gap's middle
        off = w0 - self.host0 * 1e6
        inside = {k: [(a, b) for a, b in v
                      if self.host0 <= a and b <= self.host1]
                  for k, v in spans.spans.items()}
        flat = sorted((a * 1e6 + off, b * 1e6 + off, k)
                      for k, v in inside.items() for a, b in v)
        starts = [f[0] for f in flat]
        idle = defaultdict(float)
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) / 2.0
            # spans nest a few deep at most: look at the last few that
            # start before the middle, and take the shortest holding it
            i = bisect.bisect_right(starts, mid)
            near = [f for f in flat[max(0, i - NEST):i] if f[1] >= mid]
            label = (min(near, key=lambda f: f[1] - f[0])[2] if near
                     else "host outside the spans")
            idle[label] += (b - a) / 1e6
        by_name = defaultdict(float)
        for n, s, e in recs:
            by_name[n[:120]] += (e - s) / 1e6
        breakdown = {
            "device_ops": [[n, v] for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, v] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        }
        ctx = LayerContext(window_s, busy / 1e6, recs, inside, counts,
                           work.totals())
        return ctx, {"busy_s": busy / 1e6, "window_s": window_s}, breakdown
