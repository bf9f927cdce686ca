"""The deep search's share of its roofline [%]: the least time the card
could run the window's deep searches in (operations over the float32 peak
or bytes over the memory rate, whichever is longer, counted from the
searches' shapes by harness/roofline_deep.py), over the device time of
the profiler's records that start inside the program's
`scalar.acquire.deep` spans (the search's kernels and copies; the search
ends in blocking reads, so its device work lies inside them). The spans
are placed on the device's timeline by the traffic driver's count
`clock_offset_us`. None where the program has no such span in the window.
Moves `ttff_s`."""

from benchmark.harness.roofline import least_s

from .program_spans import inside

WORKLOADS = ["weak27.coldstart"]


def device_s(ctx, name: str) -> float | None:
    """Seconds of the device records that start inside the spans `name`."""
    off = ctx.counts.get("clock_offset_us")
    got = inside(ctx, name)
    if off is None or got is None:
        return None
    bounds = sorted((a * 1e6 + off, b * 1e6 + off) for a, b in got)
    total, j = 0.0, 0
    for _, s, e in ctx.events:          # sorted by start
        while j < len(bounds) and bounds[j][1] < s:
            j += 1
        if j == len(bounds):
            break
        if bounds[j][0] <= s:
            total += e - s
    return total / 1e6


def read(ctx):
    t = device_s(ctx, "scalar.acquire.deep")
    work = ctx.work.get("deep")
    if not t or not work:
        return None
    return 100.0 * least_s(work[0], work[1]) / t
