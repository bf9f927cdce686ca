"""Seconds a cold start spends in `ScalarReceiver.track` (the upload of
the samples, K4's chunks and the log's fetch and unpacking), from the
harness's wrapper, over the cold starts of the traced window. Moves
`ttff_s`."""

WORKLOADS = ["spread25.coldstart"]


def read(ctx):
    starts = ctx.counts.get("starts")
    if not starts or not ctx.span_count("scalar.track"):
        return None
    return ctx.span_s("scalar.track") / starts
