"""Milliseconds a cold start spends building its DPE receiver
(`DPEReceiver.__init__`, with the score windows sized over the grid and the
grid's upload), from the harness's `dpe.build` spans over the cold starts
of the traced window. Moves `ttff_s`."""

WORKLOADS = ["spread25.coldstart"]


def read(ctx):
    starts = ctx.counts.get("starts")
    if not starts or not ctx.span_count("dpe.build"):
        return None
    return 1e3 * ctx.span_s("dpe.build") / starts
