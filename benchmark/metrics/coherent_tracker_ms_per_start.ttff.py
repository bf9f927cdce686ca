"""K4's coherent kernel's device milliseconds a weak cold start: the
profiler's records named `track_window_kernel` (8 ms windows, one launch
a 2 s chunk) in the traced window, over its cold starts. Moves
`ttff_s`."""

WORKLOADS = ["weak27.coldstart"]
KERNELS = ("track_window_kernel",)


def read(ctx):
    starts = ctx.counts.get("starts")
    t = ctx.device_s(*KERNELS)
    if not starts or not t:
        return None
    return 1e3 * t / starts
