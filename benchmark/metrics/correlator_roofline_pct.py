"""K5's share of its roofline [%]: the least time the card could
correlate the window's blocks in (harness/roofline.py, from the calls'
shapes and nav-bit boundaries), over the device time of the records named
`windowed_correlate` in the traced window."""

from benchmark.harness.roofline import least_s

KERNELS = ("windowed_correlate",)


def read(ctx):
    t = ctx.device_s(*KERNELS)
    work = ctx.work.get("K5")
    if not t or not work:
        return None
    return 100.0 * least_s(work[0], work[1]) / t
