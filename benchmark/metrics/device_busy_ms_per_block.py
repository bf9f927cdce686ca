"""Device milliseconds a block: the union of the profiler's kernel, copy
and set records inside the traced window, over its blocks. A statistic of
device time, steadier from run to run than the host's clock."""


def read(ctx):
    blocks = ctx.counts.get("blocks")
    if not blocks or not ctx.device_records():
        return None
    return 1e3 * ctx.busy_s / blocks
