"""Host milliseconds a fix before the device is called: in each per-block
step, from the harness's call of `DPEReceiver.step` to the step's call of
the device step (`dpe_device_step_real`): the float64 time update, channel
prediction and manifold geometry. Over the steps of the traced window.
Moves `fix_latency_p95_ms`."""

WORKLOADS = ["spread25.live_1x"]


def read(ctx):
    steps = ctx.counts.get("steps")
    if not steps or not ctx.span_count("step.host_prep"):
        return None
    return 1e3 * ctx.span_s("step.host_prep") / steps
