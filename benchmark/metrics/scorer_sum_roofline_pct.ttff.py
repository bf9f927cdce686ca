"""K1's block-summed share of its roofline [%] in the weak cold start:
the least time the card could score the window's integrated fixes in
(harness/roofline.py `scorer_work` at the fixes' N blocks, from the calls'
shapes), over the device time of the records named `score_kernel` (K1;
only its block-summed modes run on this path) in the traced window.
Moves `ttff_s`."""

from benchmark.harness.roofline import least_s

WORKLOADS = ["weak27.coldstart"]
KERNELS = ("score_kernel",)


def read(ctx):
    t = ctx.device_s(*KERNELS)
    work = ctx.work.get("K1sum")
    if not t or not work:
        return None
    return 100.0 * least_s(work[0], work[1]) / t
