"""Host milliseconds a fix after its argmaxes are on the host: the
program's `dpe.step.update` spans (the peak reads, the EKF update, the
steering, the flip row's fetch and the fix) in the traced window, over its
steps. Moves `fix_latency_p95_ms`."""

from .program_spans import ms_per

WORKLOADS = ["spread25.live_1x"]


def read(ctx):
    return ms_per(ctx, "steps", "dpe.step.update")
