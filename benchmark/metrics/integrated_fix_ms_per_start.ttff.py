"""Milliseconds a weak cold start spends in its integrated fix: the
program's `dpe.integrate` spans (one a fix, holding `.prepare`, the
float64 preparation of its blocks; `.dispatch`, the staged samples taken
and the correlator and block-summed scorer enqueued; `.wait`, the fetch
of the fix's row; `.update`, the measurement and the steering) in the
traced window, over its cold starts. Moves `ttff_s`."""

from .program_spans import ms_per

WORKLOADS = ["weak27.coldstart"]


def read(ctx):
    return ms_per(ctx, "starts", "dpe.integrate")
