"""Host milliseconds a block of the batched receiver's own work, without
its waits: the program's `dpe.prepare` (the float64 preparation of a
dispatch's blocks) and `dpe.drain.update` (the measurement updates and the
steering after the rows are in) spans in the traced window, over its
blocks."""

from .program_spans import ms_per


def read(ctx):
    return ms_per(ctx, "blocks", "dpe.prepare", "dpe.drain.update")
