"""Host milliseconds a fix before the device is called: the program's
`dpe.step.prep` spans (in `DPEReceiver.step`, from its entry to the device
step's call: the block's upload, the float64 time update, the channel
prediction, the manifold geometry and the packed upload) in the traced
window, over its steps. Moves `fix_latency_p95_ms`."""

from .program_spans import ms_per

WORKLOADS = ["spread25.live_1x"]


def read(ctx):
    return ms_per(ctx, "steps", "dpe.step.prep")
