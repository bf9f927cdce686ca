"""Device records a block: the profiler's kernel, copy and set records
inside the traced window, over its blocks."""


def read(ctx):
    blocks = ctx.counts.get("blocks")
    n = ctx.device_records()
    if not blocks or not n:
        return None
    return n / blocks
