"""Host milliseconds a block spent enqueueing the coherent sums of the
grouped dispatch: the program's `dpe.dispatch.coherent_sum` spans (around
`coherent_sum` in `ops/dpe_real.dpe_batch_blocks`, its eager loop over the
group's blocks) in the traced window, over its blocks. Moves `rtf`."""

from .program_spans import ms_per

WORKLOADS = ["spread25.offline_k5"]


def read(ctx):
    return ms_per(ctx, "blocks", "dpe.dispatch.coherent_sum")
