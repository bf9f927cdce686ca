"""Host milliseconds a block spent in the scorer's calls of a batched
dispatch: the program's `dpe.dispatch.score` spans (around `_score_both` in
`ops/dpe_real.dpe_batch_blocks`: K1's two wrapper calls, position and
velocity) in the traced window, over its blocks. Moves `rtf`."""

from .program_spans import ms_per

WORKLOADS = ["spread25.offline_k5"]


def read(ctx):
    return ms_per(ctx, "blocks", "dpe.dispatch.score")
