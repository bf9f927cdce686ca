"""Host milliseconds a fix from the device step's call until its argmaxes
are on the host: the program's `dpe.step.device` spans (the wrappers and
launches of K5 and K2, then the first blocking read, its own
`dpe.step.wait` span inside) in the traced window, over its steps. The
device's own work is a small part of it: it moves with the dispatch's host
cost more than with the kernels. Moves `fix_latency_p95_ms`."""

from .program_spans import ms_per

WORKLOADS = ["spread25.live_1x"]


def read(ctx):
    return ms_per(ctx, "steps", "dpe.step.device")
