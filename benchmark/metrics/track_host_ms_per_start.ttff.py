"""Host milliseconds a cold start spends around K4 without waiting for
it: the program's `scalar.track.stage` (each chunk's read, pinning and
upload enqueue) and `scalar.track.unpack` (each chunk's log unpacked into
the channels and the sample bookkeeping) spans in the traced window, over
its cold starts. The log's fetch, which waits for K4, is left out. Moves
`ttff_s`."""

from .program_spans import ms_per

WORKLOADS = ["spread25.coldstart"]


def read(ctx):
    return ms_per(ctx, "starts", "scalar.track.stage", "scalar.track.unpack")
