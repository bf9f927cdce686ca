"""K1's share of its roofline [%]: the least time the card could score
the window's blocks in (operations over the float32 peak or bytes over the
memory rate, whichever is longer, counted from the calls' shapes by
harness/roofline.py), over the device time of the records named
`score_kernel` (K1; no K2 runs on the batched path) in the traced window."""

from benchmark.harness.roofline import least_s

KERNELS = ("score_kernel",)


def read(ctx):
    t = ctx.device_s(*KERNELS)
    work = ctx.work.get("K1")
    if not t or not work:
        return None
    return 100.0 * least_s(work[0], work[1]) / t
