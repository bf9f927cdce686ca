"""Milliseconds a weak cold start spends in the deep acquisition search:
the program's `scalar.acquire.deep` spans (the capture's read, the folded
coarse search over every Doppler and its fetch, the per-PRN fine carrier
searches and their reads) in the traced window, over its cold starts.
Moves `ttff_s`."""

from .program_spans import ms_per

WORKLOADS = ["weak27.coldstart"]


def read(ctx):
    return ms_per(ctx, "starts", "scalar.acquire.deep")
