"""Host milliseconds a block that the batched receiver waits for its
dispatches' rows: the program's `dpe.drain.wait` spans (the drain's wait
on the fetch's event) in the traced window, over its blocks. Time the
device has not yet finished the dispatch in: it moves with the device's
work (K5, K1), not with the host's."""

from .program_spans import ms_per


def read(ctx):
    return ms_per(ctx, "blocks", "dpe.drain.wait")
