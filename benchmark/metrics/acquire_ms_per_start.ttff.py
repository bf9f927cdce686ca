"""Milliseconds a cold start spends in acquisition (`ScalarReceiver.acquire`:
two blocks read, the FFT search of each on the device and its fetch, the
best of the two), from the harness's `scalar.acquire` spans over the cold
starts of the traced window. Moves `ttff_s`."""

WORKLOADS = ["spread25.coldstart"]


def read(ctx):
    starts = ctx.counts.get("starts")
    if not starts or not ctx.span_count("scalar.acquire"):
        return None
    return 1e3 * ctx.span_s("scalar.acquire") / starts
