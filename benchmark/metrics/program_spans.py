"""The program's own spans (navlab_dpe_sdr_tpu_torch/tracing.py) inside a
traced window, for the `program_span` metrics that read them.

The program records its spans on time.perf_counter(), the clock of the
harness's spans, while a torch profiler runs: over the traced run's
lead-ins and its window. The window here runs from the earliest start to
the latest end of the harness's spans inside it (`ctx.spans`), which leaves
the lead-ins out. Each reader gives None where the program has no recorder
(a checkout older than it), where the recorder dropped records, or where a
span it reads never opened in the window.
"""

from __future__ import annotations


def inside(ctx, name: str) -> list[tuple[float, float]] | None:
    """(start, end) of each of the program's spans named `name` inside the
    window, or None."""
    try:
        from navlab_dpe_sdr_tpu_torch import tracing
    except ImportError:
        return None
    edges = [t for v in ctx.spans.values() for t in v]
    if not edges or tracing.dropped():
        return None
    lo = min(a for a, _ in edges)
    hi = max(b for _, b in edges)
    got = [(s.t0, s.t1) for s in tracing.spans(name)
           if lo <= s.t0 and s.t1 <= hi]
    return got or None


def ms_per(ctx, count: str, *names: str) -> float | None:
    """Milliseconds the spans named `names` take in the window, summed,
    over the traffic driver's count `count` (blocks, steps, starts)."""
    n = ctx.counts.get(count)
    if not n:
        return None
    total = 0.0
    for name in names:
        got = inside(ctx, name)
        if got is None:
            return None
        total += sum(b - a for a, b in got)
    return 1e3 * total / n
