"""K4's device milliseconds a cold start: the profiler's records named
`track_chunk_kernel` or `track_window_kernel` in the traced window, over
its cold starts. Moves `ttff_s`."""

WORKLOADS = ["spread25.coldstart"]
KERNELS = ("track_chunk_kernel", "track_window_kernel")


def read(ctx):
    starts = ctx.counts.get("starts")
    t = ctx.device_s(*KERNELS)
    if not starts or not t:
        return None
    return 1e3 * t / starts
